#!/usr/bin/env python3
"""Where kernel A's FFT path spends its time, by varying one knob at a time.

    python3 scripts/mfcc_fft_experiments.py

At the main path's chunk, (2048, 16000) f32 clips at n_fft 400, times the
kernel (CUDA events, 20 launches after warm-up) while changing:
  * n_mfcc (40, 13, 1): the DCT's share, which scales with it;
  * thread groups per block (8, 4, 2, 1), each transforming its own frame
    pairs with its own barrier: how much of the time is latency;
  * the batch (264 clips = one wave of 2 blocks on each of 132 SMs, 2048);
  * the input type (f32, int16): the load's share;
  * n_fft 2048 at hop 512 (DABA's and FlowMur's settings).
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
            op.fft_groups = lambda n_fft, groups=groups: groups
            print(f"{groups} thread groups: {time_ms(lambda: op.fused_mfcc(wav, base)):.4f} ms", flush=True)
    finally:
        op.fft_groups = chosen
    print(f"264 clips (one wave): {time_ms(lambda: op.fused_mfcc(wav[:264], base)):.4f} ms", flush=True)
    print(f"int16 input: {time_ms(lambda: op.fused_mfcc(pcm, base)):.4f} ms", flush=True)
    lib = MFCCParams(n_fft=2048, hop_length=512, parity="librosa")
    print(f"n_fft 2048 hop 512 (2048, 16000): {time_ms(lambda: op.fused_mfcc(wav, lib)):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
