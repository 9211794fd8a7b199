#!/usr/bin/env python3
"""Times kernels A, B, C and D of a checkout of the PyTorch/CUDA port, so
that two checkouts can be compared on one card in one call.

    python3 scripts/torch_kernel_times.py [--root DIR] [--label NAME] [--compute_dtype bfloat16]

Imports ``audiobd_tpu_torch`` from ``--root`` (default: this checkout) and
times, by CUDA events over 10 (A) or 20 (B, C, D) launches after warm-up
(C also by device time under torch.profiler: at FlowMur's shape the events
time the host's launch path),
through the wrappers the versions share:
  * A at the main path's chunk, (2048, 16000) f32, n_fft 400;
  * A at Ultrasonic's chunk, (2048, 44100) f32, n_fft 1103, hop 441;
  * A at (2048, 44100) and (64, 44100) f32, n_fft 2205, hop 441;
  * B (``conv1_bn_pool_bwd_params``, train and eval mode) at the main
    path's shape: x = the MFCC features of 256 clips, SmallCNN's block-1
    parameters (seed 35), g (256, 64, 100, 13) from a seeded generator;
  * C (``conv1_bn_pool_bwd_input``) in train mode at the same shape with
    B's h1, h2, and in eval mode at FlowMur's trigger search: x = the MFCC
    features of 256 clips at n_fft 2048, hop 512, 13 coefficients (256, 1,
    32, 13), SmallCNN's block-1 parameters at FlowMur's widths, statistics
    from the batch standing in for running ones, g (256, 64, 31, 4) seeded
    (C's two-launch version took h12 in both modes, zeros in eval mode);
  * D (``conv2_bn_pool_bwd_params``) at full width, block 2 (x (256, 64,
    100, 13), g (256, 64, 50, 7), pool padding (1, 1)) and block 3 (x (256,
    64, 50, 7), g (256, 32, 24, 4), pool padding (0, 1)), random inputs with
    many relu zeros; then five launches of each under torch.profiler, with
    the device time of each CUDA kernel it launched (D's passes); and E
    (``conv2_bn_pool_bwd_input``) on that D call's routing.
``--compute_dtype bfloat16`` times B, C, D and E in their bf16 mode instead
(g bf16 throughout, x bf16 for D and E, x f32 for B and C as the model's
input is; a checkout from before the bf16 modes has none to time).
Run it for two checkouts in turns (parent, change, change, parent) to
compare them. Prints the card's name and power limit first; needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# The timers are chip_smoke.py's, from this script's checkout (before --root
# puts another checkout first on the path).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import device_ms, time_ms  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default=None)
    parser.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    from audiobd_tpu_torch.dsp import MFCCParams
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.ops import conv1_bn_pool as op1
    from audiobd_tpu_torch.ops import conv2_bn_pool as op2
    from audiobd_tpu_torch.ops import mfcc as op
    from audiobd_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    label = f"{args.label or args.root}{'' if args.compute_dtype == 'float32' else ', bf16'}"
    dt = getattr(torch, args.compute_dtype)
    print(f"[{label}] {smi}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    wav = torch.randn(2048, 16000, device="cuda", generator=gen) * 0.1
    wav44 = torch.randn(2048, 44100, device="cuda", generator=gen) * 0.1
    for name, w, params in (
        ("A n_fft 400 (2048, 16000)", wav, MFCCParams()),
        ("A n_fft 1103 (2048, 44100)", wav44, MFCCParams(sample_rate=44100, n_fft=1103, hop_length=441)),
        ("A n_fft 2205 (2048, 44100)", wav44, MFCCParams(sample_rate=44100, n_fft=2205, hop_length=441)),
        ("A n_fft 2205 (64, 44100)", wav44[:64], MFCCParams(sample_rate=44100, n_fft=2205, hop_length=441)),
    ):
        print(f"[{label}] {name}: {time_ms(torch, lambda: op.fused_mfcc(w, params), 10):.4f} ms", flush=True)

    x = op.fused_mfcc(wav[:256], MFCCParams())[:, None].contiguous()
    xf = op.fused_mfcc(wav[:256], MFCCParams(n_mfcc=13, n_fft=2048, hop_length=512))[:, None].contiguous()
    del wav, wav44
    model = build_model("smallcnn", 10, 3072, torch.device("cuda"), seed=35, fused=True)
    w, b = model.conv1.weight.detach(), model.conv1.bias.detach()
    gamma, beta = model.bn1.weight.detach(), model.bn1.bias.detach()
    r = torch.clamp(F.conv2d(x, w, b), min=0.0)
    mu = r.mean(dim=(0, 2, 3))
    inv = torch.rsqrt((r * r).mean(dim=(0, 2, 3)) - mu * mu + op1.EPS)
    scale = gamma * inv
    shift = beta - mu * scale
    g = torch.randn(256, 64, 100, 13, device="cuda", generator=gen).to(dt)
    w5 = op1._w5(w, b)
    for mode, train in (("train", True), ("eval", False)):
        ms = time_ms(torch, lambda: op1.conv1_bn_pool_bwd_params(x, g, w5, mu, inv, scale, shift, train_bn=train), 20)
        print(f"[{label}] B {mode} (256, 1, 101, 40) x (256, 64, 100, 13): {ms:.4f} ms", flush=True)
    h12 = op1.conv1_bn_pool_bwd_params(x, g, w5, mu, inv, scale, shift, train_bn=True)[7:9].contiguous()
    c_train = lambda: op1.conv1_bn_pool_bwd_input(x, g, w5, mu, inv, scale, shift, h12, train_bn=True)  # noqa: E731
    print(f"[{label}] C train (256, 1, 101, 40) x (256, 64, 100, 13): {time_ms(torch, c_train, 20):.4f} ms, device "
          f"{device_ms(torch, c_train, 20):.4f} ms", flush=True)
    flow = build_model("smallcnn", 10, 224, torch.device("cuda"), seed=35, fused=True)
    wf, bf = flow.conv1.weight.detach(), flow.conv1.bias.detach()
    r = torch.clamp(F.conv2d(xf, wf, bf), min=0.0)
    muf = r.mean(dim=(0, 2, 3))
    invf = torch.rsqrt((r * r).mean(dim=(0, 2, 3)) - muf * muf + op1.EPS)
    scalef = flow.bn1.weight.detach() * invf
    shiftf = flow.bn1.bias.detach() - muf * scalef
    gf = torch.randn(256, 64, 31, 4, device="cuda", generator=gen).to(dt)
    w5f = op1._w5(wf, bf)
    hz = None if hasattr(op1, "input_spans") else torch.zeros(2, 64, device="cuda")
    c_eval = lambda: op1.conv1_bn_pool_bwd_input(xf, gf, w5f, muf, invf, scalef, shiftf, hz, train_bn=False)  # noqa: E731
    print(f"[{label}] C eval (256, 1, 32, 13) x (256, 64, 31, 4): {time_ms(torch, c_eval, 20):.4f} ms, device "
          f"{device_ms(torch, c_eval, 50):.4f} ms", flush=True)

    for name, (b, cin, h, w, c), pad in (("block 2", (256, 64, 100, 13, 64), (1, 1)),
                                        ("block 3", (256, 64, 50, 7, 32), (0, 1))):
        x = torch.relu(torch.randn(b, cin, h, w, device="cuda", generator=gen)).to(dt)
        weight = torch.randn(c, cin, 2, 2, device="cuda", generator=gen) * 0.1
        bias = torch.randn(c, device="cuda", generator=gen) * 0.1 - 0.2
        _, _, ho, wo, _, _ = op2.pool_dims(h, w, pad)
        g = (torch.randn(b, c, ho, wo, device="cuda", generator=gen) * 1e-3).to(dt)
        mu = torch.rand(c, device="cuda", generator=gen) * 0.3
        inv = torch.rsqrt(torch.rand(c, device="cuda", generator=gen) + 0.5)
        scale = (1.0 + 0.3 * torch.randn(c, device="cuda", generator=gen)) * inv
        shift = 0.1 * torch.randn(c, device="cuda", generator=gen) - mu * scale
        w257 = op2.w257(weight, bias)

        def launch():
            return op2.conv2_bn_pool_bwd_params(x, g, w257, mu, inv, scale, shift, pool_padding=pad)

        print(f"[{label}] D {name} x {tuple(x.shape)}: {time_ms(torch, launch, 20):.4f} ms", flush=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                launch()
            torch.cuda.synchronize()
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                entry = by_name.setdefault(e.name, [0.0, 0])
                entry[0] += e.time_range.end - e.time_range.start
                entry[1] += 1
        for kernel, (us, count) in by_name.items():
            print(f"[{label}]   {kernel[:60]}: {us / count / 1e3:.4f} ms a launch ({count} launches)", flush=True)
        out, routing = launch()
        k4 = 4 * cin
        e_call = lambda: op2.conv2_bn_pool_bwd_input(  # noqa: E731
            routing, g, w257, mu, inv, scale, out[k4 + 3 : k4 + 5].contiguous(), pool_padding=pad)
        print(f"[{label}] E {name} on D's routing: {time_ms(torch, e_call, 20):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
