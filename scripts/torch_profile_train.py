#!/usr/bin/env python3
"""Where a training epoch of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_profile_train.py [--model smallcnn|smalllstm]
        [--fused_block2 auto|on|off] [--fused_block3 auto|on|off]
        [--per_class 2000] [--batch_size 256] [--compute_dtype float32|bfloat16]
        [--trace PATH] [--flowmur | --defense] [--block1]

Builds the main path's data on the card (synthetic clips → MFCC kernel →
BadNets patch), runs one warm-up epoch of training (SmallCNN by default;
``--fused_block2/3 on`` puts blocks 2-3's backward on kernels D and E) + the
two eval passes exactly as train_attack does, then times one more such epoch
under torch.profiler. Prints the epoch's wall time, the device's busy and idle
share (union of kernel intervals over the wall time), device time by kernel,
and the hand-written kernels' share; ``--trace`` also writes the Chrome trace. Needs a CUDA device.
``--compute_dtype bfloat16`` trains the model in bf16 (TrainConfig.compute_dtype,
as a YAML's train: {compute_dtype: bfloat16} does; kernels B, D and E in their
bf16 mode); FlowMur's search keeps its f32 surrogate, as the reference does.

``--flowmur`` does the same for an epoch of FlowMur's trigger search: the
5,000 hosts of the synthetic set at FlowMur's front end (n_fft 2048, hop
512, 13 coefficients), batch 256 (19 steps, the remainder dropped), a
SmallCNN surrogate at its 224-feature width with fresh weights, frozen in
eval mode; each step is poison/flowmur.py::trigger_step (deploy → plain matmul
STFT → MFCC → surrogate → backward through kernel C → Adam). It also sums
the device time by kind: cuBLAS matrix products (the STFT's), cuDNN
convolutions (the surrogate's blocks 2-3), kernel C, the rest.

``--block1`` also times block 1's forward (``ConvStack.block1``: the fused
op, kernel G on the card) inside the epoch: the stream's milliseconds between
CUDA events around each call, by train steps and eval batches, over the
unprofiled epoch, and the device kernels of each call's subtree under the
profiler, by name.

``--defense`` times the two kinds of defense epoch on the 5% val split of
the synthetic set (800 clips at the default size, 4 steps at batch 256),
SmallCNN f32: an FT-reg SAM epoch (eval mode, two parameter gradients a
step, defend/ft_reg.py::run_reg_epoch) and a TSBD stage-D fine-tune epoch
(train mode, Adam). Each with block 1 fused (kernel B: eval mode in the SAM
epoch, train mode in the fine-tune) and unfused (cuDNN autograd), in turns
(fused, unfused, unfused, fused): the mean unprofiled epoch wall over 10
epochs and the device busy time of 3 epochs under the profiler.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# Name fragments of the __global__ functions in audiobd_tpu_torch/csrc/.
HAND_WRITTEN = ("mfcc_fft_kernel", "bwd_params_", "bwd_input", "conv2_route", "conv2_params_",
                "conv2_input_")
# Name fragments of cuDNN's convolution kernels (implicit GEMMs among them),
# tested before those of cuBLAS's matrix products.
CONV_MARKS = ("implicit_gemm", "convolve", "conv2d", "fprop", "dgrad", "wgrad", "cudnn")
GEMM_MARKS = ("gemm", "xmma", "cutlass", "sm90")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audiobd_tpu_torch.configs import make_config
    from audiobd_tpu_torch.data.speech_commands import make_synthetic_clean_data
    from audiobd_tpu_torch.poison import badnets
    from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_eval_epoch, run_train_epoch
    from audiobd_tpu_torch.train.state import Adam
    from audiobd_tpu_torch.train.trainer import build_attack_model
    from audiobd_tpu_torch.utils import random as rnd
    from audiobd_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", type=str, default="smallcnn", choices=["smallcnn", "smalllstm"])
    parser.add_argument("--fused_block2", type=str, default="auto", choices=["auto", "on", "off"])
    parser.add_argument("--fused_block3", type=str, default="auto", choices=["auto", "on", "off"])
    parser.add_argument("--per_class", type=int, default=2000)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--trace", type=str, default=None, help="write the Chrome trace here")
    parser.add_argument("--flowmur", action="store_true", help="profile an epoch of FlowMur's trigger search")
    parser.add_argument("--defense", action="store_true",
                        help="time the defenses' SAM and fine-tune epochs with block 1 fused and unfused")
    parser.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--block1", action="store_true",
                        help="time block 1's forward inside the epoch's train steps and eval batches")
    args = parser.parse_args()

    cfg = make_config("flowmur" if args.flowmur else "badnets", batch_size=args.batch_size, model=args.model,
                      fused_block2=args.fused_block2, fused_block3=args.fused_block3,
                      compute_dtype=args.compute_dtype)
    device = resolve_device(cfg.device)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        clean = make_synthetic_clean_data(cfg, n_per_class=args.per_class)
        poisoned = None if args.flowmur or args.defense else badnets.poison(cfg, clean, save=False)
        os.chdir(REPO)
    if args.defense:
        return defense_epochs(cfg, clean, device)
    if args.flowmur:
        epoch, n_train, what = flowmur_search_epoch(cfg, clean, device)
    else:
        model = build_attack_model(cfg, device)
        opt = Adam(model.parameters(), cfg.train.learning_rate)
        sets = [DeviceDataset(s, device) for s in (poisoned.bd_train, poisoned.clean_test, poisoned.bd_test)]
        np_rng = rnd.np_rng(cfg.train.seed, "shuffle")
        n_train = len(sets[0])
        what = (f"model {cfg.model}, {cfg.train.compute_dtype}, fused_block2 {cfg.train.fused_block2}, fused_block3 "
                f"{cfg.train.fused_block3}; batch {cfg.train.batch_size}; train clips {n_train}, eval clips "
                f"{len(sets[1]) + len(sets[2])}")

        def epoch():
            run_train_epoch(model, opt, sets[0], cfg.train.batch_size, np_rng)
            run_eval_epoch(model, sets[1], cfg.train.batch_size)
            run_eval_epoch(model, sets[2], cfg.train.batch_size)

    epoch()  # warm-up: cuDNN algorithm choice, allocator, kernel binding
    torch.cuda.synchronize()
    block1_calls = watch_block1(torch) if args.block1 else None
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if block1_calls is not None:
        for mode, events in sorted(block1_calls.items()):
            ms = [a.elapsed_time(b) for a, b in events]
            print(f"block 1's forward in {mode}: {len(ms)} calls, stream ms a call mean {sum(ms) / len(ms):.4f}, "
                  f"min {min(ms):.4f}, max {max(ms):.4f} (CUDA events around ConvStack.block1)")
        block1_calls.clear()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(BLOCK1_RANGE)]  # the ranges' device-side copies are no kernels
    if not kernels:
        print("torch.profiler recorded no device kernels: no breakdown", file=sys.stderr)
        return 1
    busy = busy_us(kernels)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    first = min(s for s, _ in spans)
    last = max(e for _, e in spans)
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    total = sum(v[0] for v in by_name.values())

    print(f"device {torch.cuda.get_device_name(0)}; {what}")
    print(f"epoch wall (no profiler) {plain_wall * 1e3:.1f} ms = {n_train / plain_wall:.0f} train clips/s")
    print(f"epoch wall (profiled) {wall * 1e3:.1f} ms; device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / 1e3 / (wall * 1e3):.1f}% of wall, idle {100 - 100 * busy / 1e3 / (wall * 1e3):.1f}%); "
          f"first-to-last kernel {(last - first) / 1e3:.1f} ms; {len(kernels)} kernel launches")
    print(f"device time by kernel (sum {total / 1e3:.1f} ms):")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / total:5.1f}% {count:6d}x  {name[:110]}")
    own = [(n, v) for n, v in by_name.items() if any(k in n for k in HAND_WRITTEN)]
    print(f"hand-written kernels of csrc/ (sum {sum(v[0] for _, v in own) / 1e3:.1f} ms):")
    for name, (us, count) in sorted(own, key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:110]}")
    if args.flowmur:
        kinds: dict[str, list] = defaultdict(lambda: [0.0, 0])
        for name, (us, count) in by_name.items():
            low = name.lower()
            kind = ("kernel C" if "bwd_input" in name
                    else "cuDNN convolutions" if any(k in low for k in CONV_MARKS)
                    else "matrix products (cuBLAS)" if any(k in low for k in GEMM_MARKS)
                    else "the rest")
            kinds[kind][0] += us
            kinds[kind][1] += count
        print("device time by kind:")
        for kind, (us, count) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
            print(f"  {us / 1e3:9.3f} ms {100 * us / total:5.1f}% {count:6d}x  {kind}")
    if args.block1:
        block1_kernels(torch, prof)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


BLOCK1_RANGE = "block1.forward."


def watch_block1(torch) -> dict:
    """Wraps ``ConvStack.block1`` from here on: each call inside a
    ``record_function`` range named by the model's mode, and, while the
    returned dict is not None, a CUDA event pair appended to it under that
    mode."""
    from audiobd_tpu_torch.models.zoo import ConvStack

    calls: dict[str, list] = defaultdict(list)
    inner = ConvStack.block1

    def block1(self, x):
        mode = "train steps" if self.training else "eval batches"
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(BLOCK1_RANGE + ("train" if self.training else "eval")):
            start.record()
            out = inner(self, x)
            end.record()
        calls[mode].append((start, end))
        return out

    ConvStack.block1 = block1
    return calls


def block1_kernels(torch, prof) -> None:
    """The device kernels launched inside each ``watch_block1`` range of the
    profiled epoch, by mode and name: milliseconds and launches a call."""
    def kernels(e):
        found = list(e.kernels)
        for child in e.cpu_children:
            found += kernels(child)
        return found

    ranges = [e for e in prof.events()
              if e.name.startswith(BLOCK1_RANGE) and e.device_type == torch.autograd.DeviceType.CPU]
    for mode in sorted({e.name for e in ranges}):
        calls = [e for e in ranges if e.name == mode]
        by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
        for e in calls:
            for k in kernels(e):
                by_name[k.name][0] += k.duration
                by_name[k.name][1] += 1
        total = sum(v[0] for v in by_name.values()) / len(calls) / 1e3
        print(f"{mode}: {len(calls)} calls; device ms a call {total:.4f} over "
              f"{sum(v[1] for v in by_name.values()) / len(calls):.2f} kernels a call:")
        for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
            print(f"  {us / len(calls) / 1e3:9.4f} ms {count / len(calls):5.2f}x  {name[:110]}")


def busy_us(kernels) -> float:
    """Device busy time in µs: the union of the kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def defense_epochs(cfg, clean, device) -> int:
    """``--defense``: see the module docstring."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audiobd_tpu_torch.defend.ft_reg import run_reg_epoch
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.ops import conv1_bn_pool as op
    from audiobd_tpu_torch.train.loop import ArraySet
    from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_train_epoch
    from audiobd_tpu_torch.train.state import SGD, Adam
    from audiobd_tpu_torch.utils import random as rnd

    n = len(clean.train_label)
    val_idx = rnd.np_rng(cfg.train.seed, "defense_val").choice(n, size=int(n * 0.05), replace=False)
    val = DeviceDataset(ArraySet(clean.train_mfcc[val_idx], clean.train_label[val_idx]), device)
    bs = min(cfg.train.batch_size, len(val))
    print(f"device {torch.cuda.get_device_name(0)}; defense epochs on the val split: {len(val)} clips, batch {bs}, "
          f"{-(-len(val) // bs)} steps an epoch; SmallCNN f32")

    def epochs(fused: bool):
        model = build_model("smallcnn", cfg.num_classes, 3072, device, cfg.train.seed, fused=fused)
        sgd, adam = SGD(model.parameters(), 1e-3, momentum=0.9), Adam(model.parameters(), 0.01)
        rng = rnd.np_rng(cfg.train.seed, "defense_ft")
        return {"FT-reg SAM epoch": lambda: run_reg_epoch(model, sgd, val, bs, rng, 0.05, 0.7),
                "TSBD stage-D fine-tune epoch": lambda: run_train_epoch(model, adam, val, bs, rng)}

    results: dict = {}
    for fused in (True, False, False, True):
        for kind, fn in epochs(fused).items():
            fn()  # warm-up: cuDNN algorithm choice, allocator, kernel binding
            torch.cuda.synchronize()
            counts = (op.BWD_PARAMS_KERNEL.launches, op.BWD_PARAMS_EVAL_KERNEL.launches)
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 10
            launches = (op.BWD_PARAMS_KERNEL.launches - counts[0], op.BWD_PARAMS_EVAL_KERNEL.launches - counts[1])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            if not kernels:
                print("torch.profiler recorded no device kernels", file=sys.stderr)
                return 1
            busy = busy_us(kernels) / 3 / 1e3
            b_ms = sum(e.time_range.end - e.time_range.start for e in kernels if "bwd_params_" in e.name) / 3 / 1e3
            label = "block 1 on kernel B" if fused else "block 1 on cuDNN autograd"
            results.setdefault((kind, label), []).append((wall * 1e3, busy))
            print(f"  {kind}, {label}: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms (kernel B {b_ms:.3f} ms); "
                  f"kernel B launches an epoch: train mode {launches[0] // 10}, eval mode {launches[1] // 10}")
    print("means of the two turns (wall ms, device busy ms):")
    for (kind, label), runs in results.items():
        print(f"  {kind}, {label}: {np.mean([r[0] for r in runs]):.3f}, {np.mean([r[1] for r in runs]):.3f}")
    return 0


def flowmur_search_epoch(cfg, clean, device):
    """(epoch function, hosts, description) for an epoch of the trigger search."""
    import numpy as np
    import torch

    from audiobd_tpu_torch.data.speech_commands import mfcc_params
    from audiobd_tpu_torch.poison import flowmur
    from audiobd_tpu_torch.train.state import Adam
    from audiobd_tpu_torch.utils import random as rnd

    surrogate = flowmur.build_surrogate(cfg, 0, device).eval()
    for p in surrogate.parameters():
        p.requires_grad_(False)
    hosts = flowmur.select_trigger_hosts(cfg, clean)
    wavs = torch.from_numpy(np.ascontiguousarray(hosts[:, 0])).to(device)
    n, t = wavs.shape
    length = int(cfg.trigger_duration * cfg.dsp.sample_rate)
    bs = min(cfg.train.batch_size, n)
    trigger = torch.full((length,), 0.1, device=device, requires_grad=True)
    opt = Adam([trigger], cfg.flowmur_opt_lr)
    np_rng = rnd.np_rng(cfg.train.seed, "flowmur_trigger_shuffle")
    gen = rnd.torch_generator(cfg.train.seed, "flowmur_positions", device)
    params = mfcc_params(cfg)

    def epoch():
        batches = torch.from_numpy(flowmur.trigger_batches(np_rng, n, bs)).to(device)
        for i in range(batches.shape[0]):
            positions = torch.randint(0, t - length + 1, (bs,), generator=gen, device=device)
            flowmur.trigger_step(surrogate, opt, wavs[batches[i]], positions, params, cfg)

    return epoch, n, (f"FlowMur trigger search, {n} hosts, batch {bs}, {n // bs} steps an epoch, "
                      f"n_fft {params.n_fft}, surrogate block 1 fused {surrogate.fused_block1}")


if __name__ == "__main__":
    sys.exit(main())
