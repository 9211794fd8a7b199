#!/usr/bin/env python3
"""Where kernel A's FFT and Bluestein paths spend their time, by varying one
knob at a time.

    python3 scripts/mfcc_fft_experiments.py

At the main path's chunk, (2048, 16000) f32 clips at n_fft 400, times the
kernel (CUDA events, 20 launches after warm-up) while changing:
  * n_mfcc (40, 13, 1): the DCT's share, which scales with it;
  * thread groups per block (8, 4, 2, 1), each transforming its own frame
    pairs with its own barrier: how much of the time is latency;
  * the batch (264 clips = one wave of 2 blocks on each of 132 SMs, 2048);
  * the input type (f32, int16): the load's share;
  * n_fft 2048 at hop 512 (DABA's and FlowMur's settings).
At Ultrasonic's chunk, (2048, 44100) f32 clips at n_fft 1103, hop 441:
  * the Bluestein size L (2250, 2304, 2400, 2560), with each one's shared
    memory and blocks per SM: the measurement behind ops/mfcc.py's rule;
  * thread groups (1, 2, 4) at the chosen L;
  * the matrix-DFT kernel at the same shape (the path n_fft 1103 took before
    the Bluestein path) and the torch.stft + matmul yardstick.
Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    from audiobd_tpu_torch.dsp import MFCCParams
    from audiobd_tpu_torch.ops import mfcc as op

    if not torch.cuda.is_available():
        print("mfcc_fft_experiments: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    gen = torch.Generator(device="cuda").manual_seed(0)
    wav = torch.randn(2048, 16000, device="cuda", generator=gen) * 0.1
    pcm = torch.clamp(torch.round(wav * 32768.0), -32768, 32767).to(torch.int16)
    base = MFCCParams()
    print(f"baseline (2048, 16000) f32 n_fft 400: {time_ms(lambda: op.fused_mfcc(wav, base)):.4f} ms", flush=True)
    for n_mfcc in (13, 1):
        p = MFCCParams(n_mfcc=n_mfcc)
        print(f"n_mfcc {n_mfcc}: {time_ms(lambda: op.fused_mfcc(wav, p)):.4f} ms", flush=True)
    chosen = op.fft_groups
    try:
        for groups in (4, 2, 1):
            op.fft_groups = lambda n_fft, budget=None, groups=groups: groups
            print(f"{groups} thread groups: {time_ms(lambda: op.fused_mfcc(wav, base)):.4f} ms", flush=True)
    finally:
        op.fft_groups = chosen
    print(f"264 clips (one wave): {time_ms(lambda: op.fused_mfcc(wav[:264], base)):.4f} ms", flush=True)
    print(f"int16 input: {time_ms(lambda: op.fused_mfcc(pcm, base)):.4f} ms", flush=True)
    lib = MFCCParams(n_fft=2048, hop_length=512, parity="librosa")
    print(f"n_fft 2048 hop 512 (2048, 16000): {time_ms(lambda: op.fused_mfcc(wav, lib)):.4f} ms", flush=True)
    del pcm

    from audiobd_tpu_torch.dsp.mel import amplitude_to_db

    wav44 = torch.randn(2048, 44100, device="cuda", generator=gen) * 0.1
    us = MFCCParams(sample_rate=44100, n_fft=1103, hop_length=441)
    chosen_size, chosen_groups = op.bluestein_size, op.fft_groups
    try:
        for size in (2250, 2304, 2400, 2560):
            op.bluestein_size = lambda n_fft, size=size: size
            blocks, smem = op.fft_occupancy(us, 44100, torch.device("cuda"))
            print(f"Bluestein n_fft 1103 (2048, 44100), L {size} = {'x'.join(map(str, op.fft_radices(size)))}: "
                  f"{time_ms(lambda: op.fused_mfcc(wav44, us), 10):.4f} ms ({smem} B a block, {blocks} blocks "
                  f"per SM)", flush=True)
        op.bluestein_size = chosen_size
        for groups in (1, 2, 4):
            op.fft_groups = lambda n_fft, budget=None, groups=groups: groups
            print(f"Bluestein L {chosen_size(1103)}, {groups} thread groups: "
                  f"{time_ms(lambda: op.fused_mfcc(wav44, us), 10):.4f} ms", flush=True)
    finally:
        op.bluestein_size, op.fft_groups = chosen_size, chosen_groups
    print(f"Bluestein (chosen L {op.bluestein_size(1103)}) (2048, 44100): "
          f"{time_ms(lambda: op.fused_mfcc(wav44, us), 10):.4f} ms", flush=True)
    chosen_path = op.mfcc_path
    try:
        op.mfcc_path = lambda n_fft: "dft"
        print(f"matrix-DFT kernel n_fft 1103 (2048, 44100): {time_ms(lambda: op.fused_mfcc(wav44, us), 3):.4f} ms",
              flush=True)
    finally:
        op.mfcc_path = chosen_path
    mel_fb, dct = torch.from_numpy(us.mel_fb()).cuda(), torch.from_numpy(us.dct()).cuda()
    window = torch.hann_window(us.n_fft, periodic=True, device="cuda")

    def library():
        spec = torch.stft(wav44, us.n_fft, us.hop_length, window=window, center=True, pad_mode=us.pad_mode,
                          return_complex=True).abs().pow(2)
        return amplitude_to_db(spec.transpose(-1, -2) @ mel_fb, top_db=us.top_db) @ dct

    print(f"torch.stft + matmul yardstick n_fft 1103 (2048, 44100): {time_ms(library, 10):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
