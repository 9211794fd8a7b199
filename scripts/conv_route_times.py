#!/usr/bin/env python3
"""SmallCNN's f32 convolutions at 1,024 rows, by the route they reach cuDNN by.

    python3 scripts/conv_route_times.py [--names_only | --planes] [--out _bench_cache/conv_route_times.json]

On CUDA card 0, in f32 with TF32 off, for each shape below and each option,
the milliseconds of the forward, the input gradient (dgrad), the weight and
bias gradients (wgrad), and forward + backward through autograd (``all``),
each by CUDA events over ``ITERS`` calls after warm-up; then the kernels of
one ``all`` call of each option under ``torch.profiler``, by name and device
milliseconds. Options:

* ``whole``: ``F.conv2d`` on the whole batch and its backward;
* ``route``: the program's own call, ``models/layers.py::conv2d`` (its
  row-slice route where ``ROW_SLICES`` names the shape); forward and all;
* ``rows<N>``: the batch cut into slices of N rows by ``torch.split``, a
  convolution a slice, the outputs joined by ``torch.cat``;
* ``channels_last``: x, the weight and the gradient in channels-last layout;
* ``benchmark``: ``torch.backends.cudnn.flags(benchmark=True)`` around the call
  (cuDNN times its algorithms at the first call of a shape and keeps the
  fastest).

Shapes: SmallCNN's blocks 2 and 3 at the train cell's (101, 40) features, the
FlowMur surrogate's blocks 2 and 3 at the search cell's (32, 13) features, and
block 1's forward (``ops/conv1_bn_pool.py::_conv_relu``; its backward is kernel
B). Each pass also gets the device milliseconds of its kernels in one
profiled call (``<pass>_device``). A second table times dgrad and wgrad
whole against slices at other row counts. ``--names_only`` runs only the profiler pass: run it in separate processes to
see that each option picks the same kernels every time.

``--planes`` runs only a sweep of 2x2 stride-1 convolutions: block 2's
channels (64 -> 64) and block 3's (64 -> 32) over a grid of input planes that
holds every plane SmallCNN and SmallLSTM see at the five attacks' features,
and block 1's weight gradient (1 -> 64) at its four feature planes, each at
``PLANE_ROWS`` rows: dgrad and wgrad whole and in slices of
``SWEEP_SLICES`` rows, and whether the whole call's kernels are an FFT
route (a kernel name holding ``fft``, ``DSE::`` or ``region_transform``).
Everything printed also lands in ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ITERS = 10
WARMUP = 3
SLICES = (32, 64, 128, 256, 512)
# name: (x shape, weight shape, passes timed)
SHAPES = {
    "block2": ((1024, 64, 100, 13), (64, 64, 2, 2), ("fwd", "dgrad", "wgrad", "all")),
    "block3": ((1024, 64, 50, 7), (32, 64, 2, 2), ("fwd", "dgrad", "wgrad", "all")),
    "search_block2": ((1024, 64, 31, 4), (64, 64, 2, 2), ("fwd", "dgrad", "wgrad", "all")),
    "search_block3": ((1024, 64, 16, 2), (32, 64, 2, 2), ("fwd", "dgrad", "wgrad", "all")),
    "block1_fwd": ((1024, 1, 101, 40), (64, 1, 2, 2), ("fwd",)),
}
ROW_SWEEP = (256, 384, 512, 768, 2048)
SWEEP_SLICES = (128, 256, 512)
# --planes: heights and widths of the grid (the attacks' planes are
# (100, 13), (99, 13), (31, 13), (31, 4) for block 2 and (50, 7), (16, 7),
# (16, 2) for block 3), block 1's feature planes, and the rows of each call
PLANE_H = (16, 31, 50, 64, 80, 99, 100, 128)
PLANE_W = (2, 4, 7, 13, 20)
BLOCK1_PLANES = ((101, 40), (100, 40), (32, 40), (32, 13))
PLANE_ROWS = (256, 512, 1024, 2048)
FFT_NAMES = ("fft", "dse::", "region_transform")


def conv(x, w, b, rows):
    if rows is None:
        return F.conv2d(x, w, b)
    return torch.cat([F.conv2d(s, w, b) for s in torch.split(x, rows)])


def _bwd(g, x, w, mask):
    return torch.ops.aten.convolution_backward(g, x, w, [w.shape[0]], (1, 1), (0, 0), (1, 1), False, (0, 0), 1,
                                               mask)


def dgrad(g, x, w, rows):
    if rows is None:
        return _bwd(g, x, w, (True, False, False))[0]
    return torch.cat([_bwd(gs, xs, w, (True, False, False))[0]
                      for gs, xs in zip(torch.split(g, rows), torch.split(x, rows))])


def wgrad(g, x, w, rows):
    if rows is None:
        return _bwd(g, x, w, (False, True, True))[1:]
    parts = [_bwd(gs, xs, w, (False, True, True))[1:] for gs, xs in zip(torch.split(g, rows), torch.split(x, rows))]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def autograd_all(g, x, w, b, rows):
    y = conv(x, w, b, rows)
    return torch.autograd.grad(y, (x, w, b), g)


def options():
    out = {"whole": (None, "contiguous", False), "route": ("route", "contiguous", False)}
    out.update({f"rows{r}": (r, "contiguous", False) for r in SLICES})
    out["channels_last"] = (None, "channels_last", False)
    out["benchmark"] = (None, "contiguous", True)
    return out


def tensors(x_shape, w_shape, layout, device):
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(x_shape, device=device, generator=gen)
    w = torch.randn(w_shape, device=device, generator=gen) * 0.1
    b = torch.randn(w_shape[0], device=device, generator=gen) * 0.1
    n, _, h, wd = x_shape
    g = torch.randn((n, w_shape[0], h - w_shape[2] + 1, wd - w_shape[3] + 1), device=device, generator=gen)
    if layout == "channels_last":
        x, w, g = (t.contiguous(memory_format=torch.channels_last) for t in (x, w, g))
    return x.requires_grad_(), w.requires_grad_(), b.requires_grad_(), g


def call(pass_, x, w, b, g, rows, layer=None):
    if rows == "route":
        return route(pass_, x, layer, g)
    if pass_ == "fwd":
        with torch.no_grad():
            return conv(x, w, b, rows)
    if pass_ == "dgrad":
        return dgrad(g, x, w, rows)
    if pass_ == "wgrad":
        return wgrad(g, x, w, rows)
    return autograd_all(g, x, w, b, rows)


def as_layer(w, b):
    layer = torch.nn.Conv2d(w.shape[1], w.shape[0], tuple(w.shape[2:]), device=w.device)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    return layer


def route(pass_, x, layer, g):
    """The pass through ``models/layers.py::conv2d`` (the program's route for
    this shape): the forward, or forward + backward through autograd."""
    sys.path.insert(0, ROOT)
    from audiobd_tpu_torch.models.layers import conv2d

    if pass_ == "fwd":
        with torch.no_grad():
            return conv2d(layer, x, torch.float32)
    y = conv2d(layer, x, torch.float32)
    return torch.autograd.grad(y, (x, layer.weight, layer.bias), g)


def flags(benchmark: bool):
    return torch.backends.cudnn.flags(enabled=True, benchmark=benchmark, deterministic=False, allow_tf32=False)


def time_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def kernels(fn) -> list[tuple[str, float]]:
    """(name, device ms) of the kernels one call of ``fn`` launches, the
    longest first, after warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms[e.name()] += e.duration_ns() / 1e6
    return sorted(ms.items(), key=lambda kv: -kv[1])


def is_fft(names: list[tuple[str, float]]) -> bool:
    return any(any(f in n.lower() for f in FFT_NAMES) for n, _ in names)


def plane_sweep(device) -> dict:
    """The ``--planes`` table: for each (input channels, output channels,
    height, width, rows), the ms of dgrad and wgrad whole and in slices, and
    whether the whole call and the fastest slices take an FFT route."""
    cases = [(cin, cout, h, w, ("dgrad", "wgrad")) for cin, cout in ((64, 64), (64, 32))
             for h in PLANE_H for w in PLANE_W]
    cases += [(1, 64, h, w, ("wgrad",)) for h, w in BLOCK1_PLANES]
    out = {}
    with flags(False):
        for cin, cout, h, w, passes in cases:
            for n in PLANE_ROWS:
                x, wt, b, g = tensors((n, cin, h, w), (cout, cin, 2, 2), "contiguous", device)
                row = {}
                for ps in passes:
                    times = {r: time_ms(lambda ps=ps, r=r: call(ps, x, wt, b, g, r))
                             for r in (None, *SWEEP_SLICES) if r is None or r < n}
                    best = min((r for r in times if r is not None), key=times.get, default=None)
                    row[ps] = {"whole": times[None], **{f"rows{r}": times[r] for r in times if r is not None},
                               "whole_fft": is_fft(kernels(lambda ps=ps: call(ps, x, wt, b, g, None))),
                               "best": best,
                               "best_fft": None if best is None else is_fft(kernels(
                                   lambda ps=ps: call(ps, x, wt, b, g, best)))}
                key = f"{cin}x{cout}/{h}x{w}/{n}"
                out[key] = row
                text = []
                for ps, v in row.items():
                    best = "-" if v["best"] is None else f"rows{v['best']} {v['rows' + str(v['best'])]:.4f}"
                    text.append(f"{ps} whole {v['whole']:.4f}{' fft' if v['whole_fft'] else ''} best {best}"
                                f"{' fft' if v['best_fft'] else ''}")
                print(f"plane {key:<20} " + "  ".join(text), flush=True)
                del x, wt, b, g
    return out


def card() -> str:
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--names_only", action="store_true")
    p.add_argument("--planes", action="store_true")
    p.add_argument("--out", default="_bench_cache/conv_route_times.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    report = {"card": card(), "torch": torch.__version__, "cudnn": torch.backends.cudnn.version(), "times": {},
              "sweep": {}, "kernels": {}}
    print(f"card {report['card']}; torch {report['torch']}, cuDNN {report['cudnn']}")
    if args.planes:
        report["planes"] = plane_sweep(device)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        return 0
    for shape, (x_shape, w_shape, passes) in SHAPES.items():
        for opt, (rows, layout, bench) in options().items():
            x, w, b, g = tensors(x_shape, w_shape, layout, device)
            layer = as_layer(w, b) if rows == "route" else None
            with flags(bench):
                if not args.names_only:
                    row = {}
                    for ps in passes if rows != "route" else (passes[0], passes[-1]):
                        fn = lambda ps=ps: call(ps, x, w, b, g, rows, layer)  # noqa: E731
                        row[ps] = time_ms(fn)
                        row[ps + "_device"] = sum(ms for _, ms in kernels(fn))
                    report["times"][f"{shape}/{opt}"] = row
                    print(f"{shape:<14} {opt:<14} " + "  ".join(f"{ps} {ms:8.4f}" for ps, ms in row.items()))
                names = kernels(lambda: call(passes[-1], x, w, b, g, rows, layer))
            report["kernels"][f"{shape}/{opt}"] = names
            del x, w, b, g, layer
    if not args.names_only:
        for shape in ("block2", "block3", "search_block2", "search_block3"):
            x_shape, w_shape, _ = SHAPES[shape]
            for n in ROW_SWEEP:
                x, w, b, g = tensors((n, *x_shape[1:]), w_shape, "contiguous", device)
                row = {}
                with flags(False):
                    for ps in ("dgrad", "wgrad"):
                        row[f"{ps}_whole"] = time_ms(lambda ps=ps: call(ps, x, w, b, g, None))
                        row.update({f"{ps}_rows{r}": time_ms(lambda ps=ps, r=r: call(ps, x, w, b, g, r))
                                    for r in SWEEP_SLICES if r < n})
                report["sweep"][f"{shape}/{n}"] = row
                print(f"sweep {shape:<14} {n:>5} rows: " + "  ".join(f"{k} {v:8.4f}" for k, v in row.items()))
                del x, w, b, g
    for key, names in report["kernels"].items():
        print(f"kernels {key}: " + "; ".join(f"{n[:90]} {ms:.4f}" for n, ms in names[:8]))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
