#!/usr/bin/env python3
"""Where kernel A's routes spend their time, by varying one knob at a time.

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
  * a 7-smooth L, 2240 = 8x8x5x7 (4 stages, the rule's), beside 2304, the
    measurement behind BLUESTEIN_PRIMES;
  * thread groups (1, 2, 4) at the chosen L;
  * the torch.stft + matmul yardstick.
At (2048, 44100) f32 clips at n_fft 2205 (3^2 x 5 x 7^2), hop 441, the
radix-7 FFT path with its buffers alone in shared memory:
  * thread groups (1, 2) and the order of the radices (3, 3, 5, 7, 7 or
    7, 7, 5, 3, 3);
  * the torch.stft + matmul yardstick.
And n_fft 4097 (L = 8232, its buffers alone in one block's shared memory)
at (256, 44100). The cluster route at (256, 44100), each beside its
torch.stft yardstick: n_fft 16384 split as chosen (2 CTAs, 128 x 128),
as 2 x 8192 on 2 CTAs (the split with the least shared memory) and as
128 x 128 on 4 CTAs; n_fft 8193 at the chosen Bluestein size (16464 on 2
CTAs), at 16800 (2 CTAs) and at bluestein_size's 16807 = 7^5, which only
a cluster of 7 splits; each with the clusters resident. Last, at the
two sizes whose layout fits everything in shared memory, n_fft 400 at
(2048, 16000) and n_fft 1103 at (2048, 44100), the route as chosen
(MODE_SHARED: twiddles, window and the FFT path's dB tile staged in shared
memory) against the same groups with only the buffers in shared memory
(MODE_LARGE: tables read through the read-only cache, dB tile in device
memory), in turns, three rounds each, so the spread between rounds is
printed beside the gap.
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
        for size in (2240, 2250, 2304, 2400, 2560):
            op.bluestein_size = lambda n_fft, primes=None, size=size: size
            route, blocks = op.fft_occupancy(us, 44100, torch.device("cuda"))
            smem = route.smem
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

    def yardstick(w, params):
        mel_fb, dct = torch.from_numpy(params.mel_fb()).cuda(), torch.from_numpy(params.dct()).cuda()
        window = torch.hann_window(params.n_fft, periodic=True, device="cuda")

        def library():
            spec = torch.stft(w, params.n_fft, params.hop_length, window=window, center=True,
                              pad_mode=params.pad_mode, return_complex=True).abs().pow(2)
            return amplitude_to_db(spec.transpose(-1, -2) @ mel_fb, top_db=params.top_db) @ dct

        return time_ms(library, 10)

    print(f"torch.stft + matmul yardstick n_fft 1103 (2048, 44100): {yardstick(wav44, us):.4f} ms", flush=True)

    wide = MFCCParams(sample_rate=44100, n_fft=2205, hop_length=441)
    chosen_radices = op.fft_radices
    try:
        for groups in (1, 2):
            op.fft_groups = lambda n_fft, budget=None, groups=groups: groups
            route, blocks = op.fft_occupancy(wide, 44100, torch.device("cuda"))
            print(f"n_fft 2205 (2048, 44100), {route.kernel.name}, {groups} thread groups: "
                  f"{time_ms(lambda: op.fused_mfcc(wav44, wide), 10):.4f} ms ({route.smem} B a block, {blocks} "
                  f"blocks per SM)", flush=True)
        op.fft_groups = chosen_groups
        op.fft_radices = lambda n, primes=(3, 5, 7): (7, 7, 5, 3, 3) if n == 2205 else chosen_radices(n, primes)
        print(f"n_fft 2205 (2048, 44100), radices 7, 7, 5, 3, 3: "
              f"{time_ms(lambda: op.fused_mfcc(wav44, wide), 10):.4f} ms", flush=True)
    finally:
        op.fft_groups, op.fft_radices = chosen_groups, chosen_radices
    print(f"n_fft 2205 (2048, 44100), as chosen: {time_ms(lambda: op.fused_mfcc(wav44, wide), 10):.4f} ms",
          flush=True)
    print(f"torch.stft + matmul yardstick n_fft 2205 (2048, 44100): {yardstick(wav44, wide):.4f} ms", flush=True)
    deep = MFCCParams(sample_rate=44100, n_fft=4097, hop_length=441)
    route, blocks = op.fft_occupancy(deep, 44100, torch.device("cuda"))
    print(f"n_fft 4097 (256, 44100), {route.kernel.name}, L {route.size}: "
          f"{time_ms(lambda: op.fused_mfcc(wav44[:256], deep), 10):.4f} ms ({blocks} blocks per SM); torch.stft "
          f"yardstick {yardstick(wav44[:256], deep):.4f} ms", flush=True)

    chosen_plan, chosen_cluster_size = op.cluster_plan, op.cluster_bluestein_size
    w256 = wav44[:256]

    def cluster_line(label, params):
        route, clusters = op.cluster_occupancy(params, 44100, torch.device("cuda"))
        plan = route.cluster
        print(f"{label} (256, 44100), L {route.size} = {plan.l1} x {plan.l2} on {plan.ctas} CTAs ({route.smem} B "
              f"a CTA, {clusters} clusters resident): {time_ms(lambda: op.fused_mfcc(w256, params), 10):.4f} ms",
              flush=True)

    c16384 = MFCCParams(sample_rate=44100, n_fft=16384, hop_length=441)
    c8193 = MFCCParams(sample_rate=44100, n_fft=8193, hop_length=441)
    try:
        cluster_line("n_fft 16384, as chosen", c16384)
        for plan in (op.ClusterPlan(16384, 2, 2, 8192), op.ClusterPlan(16384, 4, 128, 128)):
            op.cluster_plan = lambda size, plan=plan: plan if size == plan.size else chosen_plan(size)
            cluster_line("n_fft 16384", c16384)
        op.cluster_plan = chosen_plan
        cluster_line("n_fft 8193, as chosen", c8193)
        for size in (16800, 16807):
            op.cluster_bluestein_size = lambda n_fft, primes=None, size=size: size
            cluster_line("n_fft 8193", c8193)
    finally:
        op.cluster_plan, op.cluster_bluestein_size = chosen_plan, chosen_cluster_size
    for params in (c16384, c8193):
        print(f"torch.stft + matmul yardstick n_fft {params.n_fft} (256, 44100): {yardstick(w256, params):.4f} ms",
              flush=True)

    chosen_route = op.mfcc_route

    def large_route(params, n_frames):
        route = chosen_route(params, n_frames)
        smem = op.smem_bytes(op.MODE_LARGE, route.path == "bluestein", params.n_fft, route.size, route.groups,
                             params, n_frames)
        return route._replace(mode=op.MODE_LARGE, smem=smem, kernel=op.MFCC_LARGE_KERNEL)

    for label, w, params in (("n_fft 400 (2048, 16000)", wav, base), ("n_fft 1103 (2048, 44100)", wav44, us)):
        times = {"shared": [], "large": []}
        try:
            for _ in range(3):
                for mode, route_fn in (("shared", chosen_route), ("large", large_route)):
                    op.mfcc_route = route_fn
                    times[mode].append(time_ms(lambda: op.fused_mfcc(w, params), 10))
        finally:
            op.mfcc_route = chosen_route
        print(f"{label}: MODE_SHARED {', '.join(f'{t:.4f}' for t in times['shared'])} ms; MODE_LARGE, same "
              f"groups, {', '.join(f'{t:.4f}' for t in times['large'])} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
