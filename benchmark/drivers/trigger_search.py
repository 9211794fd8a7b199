"""Driver ``trigger_search``: FlowMur's trigger search on one card,
``poison/flowmur.py::optimize_trigger`` called again and again, as the
attack calls it with ``verbose`` and snapshots off.

Set-up: the hosts made on the card from the seed and copied to the host, as
the attack holds them; the surrogate from ``build_surrogate`` with weights
made from the seed (its BatchNorm statistics those of the first batch of
hosts); the first steps, one call over one batch of hosts for
``check_steps`` epochs (restart 0), which also warm every shape up. A unit:
one call, a fresh restart (its own trigger, optimizer and streams,
``restart`` = 1, 2, ...) over every host for the configuration's epochs, at
the configuration's batch; each call copies its hosts to the card, as the
program's interface has it.

Compared with the reference: each of the first steps' losses, the norm of
the trigger's change after them, and the first epoch's summed loss of the
window's first call. The first gradient's norm is not: the call returns the
trigger alone, and Adam's first step moves each sample by the learning rate
whatever its gradient's size. Later epochs are not: a sample whose gradient
lies within rounding of 0 takes Adam's step of ±lr either way, and two
computations of the search drift apart within a few hundred steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, inputs, trace
from benchmark.harness import sync_device
from benchmark.reference import smallcnn, steps
from benchmark.reference.mfcc import mfcc_rows

TRIGGER_START = 0.1  # the search's first trigger, every sample


def program_config(cell, seed: int, device):
    from audiobd_tpu_torch.configs import make_config

    c = cell.config
    keys = ("num_classes", "target_label", "trigger_duration", "snr_db", "flowmur_opt_lr", "flowmur_clamp",
            "flowmur_update", "flowmur_opt_epochs", "fused_conv_block", "batch_size")
    return make_config("flowmur", seed=int(seed), device=str(device), **{k: c[k] for k in keys}, **c["dsp"])


def surrogate_weights(cell, seed: int, hosts: torch.Tensor) -> dict:
    """SmallCNN weights from the seed; each BatchNorm's running statistics
    set to its batch statistics on the first batch of hosts' MFCCs, so the
    frozen surrogate normalises as a trained one would."""
    c = cell.config
    weights = inputs.make_weights(seed, smallcnn.spec(c["num_classes"], c["linear_features"]), hosts.device,
                                  name="surrogate")
    stats: dict = {}
    with torch.no_grad():
        smallcnn.forward(weights, mfcc_rows(hosts[: c["batch_size"]], c["dsp"]), True,
                         inputs.torch_stream(seed, "surrogate_dropout", hosts.device), stats)
    for bn, (mean, var) in stats.items():
        weights[f"{bn}.running_mean"], weights[f"{bn}.running_var"] = mean.clone(), var.clone()
    return weights


def setup(ctx) -> None:
    from audiobd_tpu_torch.poison import flowmur

    cell, dev, seed = ctx.cell, ctx.device, ctx.seed
    c, tr = cell.config, cell.traffic
    pcfg = program_config(cell, seed, dev)
    batch = c["batch_size"]
    phase = ctx.phases

    t0 = time.perf_counter()
    hosts, _ = inputs.make_clips(seed, c["num_classes"], c["hosts"] // c["num_classes"], c["dsp"]["sample_rate"],
                                 dev, name="hosts")
    hosts_np = hosts.cpu().numpy()[:, None, :]
    weights = surrogate_weights(cell, seed, hosts)
    sync_device(dev)
    phase["inputs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    surrogate = flowmur.build_surrogate(pcfg, 0, dev)
    surrogate.load_state_dict(weights)
    sync_device(dev)
    phase["build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    history: list = []
    trig = flowmur.optimize_trigger(pcfg, surrogate, hosts_np[:batch], epochs=tr["check_steps"], verbose=False,
                                    save_snapshots=False, loss_history=history, restart=0)
    sync_device(dev)
    phase["first_steps"] = time.perf_counter() - t0
    ctx.program = {"history": history, "trigger": torch.from_numpy(trig[0]).to(dev), "window_history": []}
    ctx.prep_s = None

    def unit(i: int) -> None:
        history: list = []
        with ctx.marks("search"):
            flowmur.optimize_trigger(pcfg, surrogate, hosts_np, verbose=False, save_snapshots=False,
                                     loss_history=history, restart=i + 1)
        ctx.histories.append(history)
        if i == 0:
            ctx.program["window_history"] = history

    ctx.histories = []
    ctx.unit = unit
    ctx.inputs = {"hosts": hosts, "weights": weights}
    n = hosts.shape[0]
    ctx.steps_per_unit = c["flowmur_opt_epochs"] * max(n // min(batch, n), 1)
    ctx.clips_per_step = min(batch, n)
    ctx.shards = 1


def reference_outputs(ctx, tf32: bool) -> dict:
    """The reference's searches over the same hosts, weights and streams as
    the program's first steps (restart 0, one batch of hosts) and the first
    epoch of its window's first call (restart 1); ``tf32`` makes it the
    control."""
    c, seed, dev = ctx.cell.config, ctx.seed, ctx.device
    batch = c["batch_size"]

    def search(restart: int, hosts: torch.Tensor, epochs: int) -> dict:
        suffix = "" if restart == 0 else f"_r{restart}"
        return steps.search_call(ctx.inputs["weights"], hosts, c, epochs, batch,
                                 inputs.np_stream(seed, "flowmur_trigger_shuffle" + suffix),
                                 inputs.torch_stream(seed, "flowmur_positions" + suffix, dev))

    with steps.precision(tf32):
        first = search(0, ctx.inputs["hosts"][:batch], ctx.cell.traffic["check_steps"])
        first["window_history"] = search(1, ctx.inputs["hosts"], 1)["history"]
    return first


def numbers(ctx, got: dict, ref: dict) -> dict:
    g, r = got["trigger"].double(), ref["trigger"].double()
    rn = float((r - TRIGGER_START).norm())
    return {
        "loss_gap": compare.max_rel(got["history"], ref["history"]),
        "window_loss_gap": compare.max_rel(got["window_history"][:1], ref["window_history"][:1]),
        "change_gap": (abs(float((g - TRIGGER_START).norm()) - rn) / max(rn, 1e-30) if g.shape == r.shape
                       else float("inf")),
    }


def check(ctx) -> dict:
    return numbers(ctx, ctx.program, reference_outputs(ctx, tf32=False))


def end_to_end(ctx, units: int, seconds: float) -> dict:
    """Hosts driven through search steps, every step of every whole call,
    over the window."""
    return {ctx.cell.traffic["rate_metric"]: units * ctx.steps_per_unit * ctx.clips_per_step / seconds}


def readings(ctx, units: int, reduced: dict) -> dict:
    from benchmark import harness
    from benchmark.roofline.peaks import PEAK_F32_FLOPS

    work = harness.load_module("roofline", ctx.cell.config_name, ctx.bench).counts_for(ctx.cell.config,
                                                                                        ctx.cell.traffic)
    n_steps = units * ctx.steps_per_unit
    return {
        "cell": ctx.cell.name, "trace": reduced, "counts": work, "cards": 1, "units": units,
        "train_steps": 0, "search_steps": n_steps, "prep_s": None, "flops": n_steps * work["search_step_flops"],
        "peak_flops": PEAK_F32_FLOPS, "trace_mod": trace,
    }


def failed_units(ctx) -> int:
    return sum(1 for h in ctx.histories if not np.all(np.isfinite(h)))
