"""Driver ``train_epochs``: a BadNets attack's training on one card, as
``train/trainer.py::train_attack`` runs it.

Set-up: the clips made on the card from the seed; the port's prep (kernel A's
MFCC by ``batched_mfcc_device``, the 80/20 split, ``poison/badnets.py``); the
model from ``build_attack_model`` with weights made from the seed and the
optimizer from ``make_optimizer``; the first steps, each a one-batch
``run_train_epoch`` on rows of its own, then both eval passes over the whole
test splits; warm-up units. A unit: ``run_train_epoch`` over the training
split, then ``run_eval_epoch`` on the clean and on the backdoored test
split, at the configuration's batch. ``train_epochs_dp`` runs the same on a
group of ranks (``ctx.mesh``), the batch split evenly over them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, inputs, trace
from benchmark.harness import sync_device
from benchmark.reference import smallcnn, steps
from benchmark.reference.mfcc import badnets_patch, mfcc_rows

CHECK_ROWS = "check_rows"


def program_config(cell, seed: int, device):
    from audiobd_tpu_torch.configs import make_config

    c = cell.config
    return make_config(
        "badnets", model=c["model"], num_classes=c["num_classes"], seed=int(seed),
        batch_size=c["batch_size"],
        learning_rate=c["learning_rate"], poisoning_rate=c["poisoning_rate"], trigger_size=c["trigger_size"],
        target_label=c["target_label"], fused_conv_block=c["fused_conv_block"], device=str(device),
        **c["dsp"],
    )


def setup(ctx) -> None:
    """Everything before the window; ``ctx`` gains the program's objects,
    the inputs, the first steps' outputs and the set-up's parts."""
    from audiobd_tpu_torch.data.speech_commands import CleanData, batched_mfcc_device, mfcc_params, split_indices
    from audiobd_tpu_torch.parallel.mesh import shard_replicated
    from audiobd_tpu_torch.poison import badnets
    from audiobd_tpu_torch.train.loop import ArraySet
    from audiobd_tpu_torch.train.scan_epoch import (
        DeviceDataset, ShardedDeviceDataset, run_eval_epoch, run_eval_sharded, run_train_epoch,
        run_train_epoch_sharded)
    from audiobd_tpu_torch.train.trainer import build_attack_model, make_optimizer

    cell, dev, seed, mesh = ctx.cell, ctx.device, ctx.seed, ctx.mesh
    c, tr = cell.config, cell.traffic
    shards = mesh.shape["data"] if mesh is not None else 1
    rank = mesh.data_index if mesh is not None else 0
    batch = c["batch_size"]  # the global batch: batch // shards rows a rank
    if batch % shards:
        raise ValueError(f"batch {batch} does not split over {shards} ranks")
    pcfg = program_config(cell, seed, dev)
    phase = ctx.phases

    t0 = time.perf_counter()
    clips, labels = inputs.make_clips(seed, c["num_classes"], c["clips_per_class"], c["dsp"]["sample_rate"], dev)
    weights = inputs.make_weights(seed, smallcnn.spec(c["num_classes"], c["linear_features"]), dev)
    sync_device(dev)
    phase["inputs"] = time.perf_counter() - t0

    # The program's prep, timed whole: kernel A, the split, the patch.
    t0 = time.perf_counter()
    feats = batched_mfcc_device(clips, mfcc_params(pcfg), dev)
    idx_train, idx_test = split_indices(len(labels))
    train_dev = feats[torch.from_numpy(idx_train).to(dev)]
    test_dev = feats[torch.from_numpy(idx_test).to(dev)]
    del feats
    clean = CleanData(None, None, train_dev, test_dev, labels[idx_train], labels[idx_test],
                      train_mfcc_dev=train_dev, test_mfcc_dev=test_dev)
    poisoned = badnets.poison(pcfg, clean, save=False)
    sync_device(dev)
    phase["prep"] = ctx.prep_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = build_attack_model(pcfg, dev)
    model.load_state_dict(weights)
    model.dropout_generator = inputs.torch_stream(seed, f"dropout_{rank}", dev)
    if mesh is not None:
        model.sync_batchnorm(mesh.data_group)
    opt = make_optimizer(pcfg, model.parameters())
    if mesh is not None:
        shard_replicated([*model.state_dict().values(), *opt.mu, *opt.nu])
        make_set = lambda s: ShardedDeviceDataset(s, mesh, dev)  # noqa: E731
        train_epoch, eval_epoch = run_train_epoch_sharded, run_eval_sharded
    else:
        make_set = lambda s: DeviceDataset(s, dev)  # noqa: E731
        train_epoch, eval_epoch = run_train_epoch, run_eval_epoch
    sets = [make_set(s) for s in (poisoned.bd_train, poisoned.clean_test, poisoned.bd_test)]
    sync_device(dev)
    phase["build"] = time.perf_counter() - t0

    # The first steps, through the window's own call and feed: a one-batch
    # epoch each, on rows that all differ.
    t0 = time.perf_counter()
    n_check = tr["check_steps"]
    rows = inputs.np_stream(seed, CHECK_ROWS).permutation(len(idx_train))[: n_check * batch]
    bd = poisoned.bd_train
    losses, grad1 = [], None
    for k in range(n_check):
        r = rows[k * batch:(k + 1) * batch]
        sub = ArraySet(bd.feats[torch.from_numpy(r).to(dev)], np.asarray(bd.labels)[r],
                       np.asarray(bd.indicators)[r])
        out = train_epoch(model, opt, make_set(sub), batch, inputs.np_stream(seed, f"check_{k}"))
        losses.append(out["loss"])
        if grad1 is None:
            grad1 = [m.detach() / (1.0 - opt.b1) for m in opt.mu]
    params = [p.detach().clone() for p in model.parameters()]
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    evals = [eval_epoch(model, s, batch) for s in sets[1:]]
    sync_device(dev)
    phase["first_steps"] = time.perf_counter() - t0
    ctx.program = {
        "prep": {"bd_train": bd.feats, "clean_test": poisoned.clean_test.feats, "bd_test": poisoned.bd_test.feats,
                 "labels": [np.asarray(a) for a in (bd.labels, bd.indicators, poisoned.bd_test.labels,
                                                     poisoned.bd_test.indicators)]},
        "losses": losses, "grad1": grad1, "params": params, "state": state,
        "eval": [(e["loss"], [int(v) for v in e["sums"]]) for e in evals],
    }
    ctx.inputs = {"clips": clips, "labels": labels, "weights": weights, "check_rows": rows}
    ctx.train_rng = inputs.np_stream(seed, "shuffle")

    def unit(_i: int) -> None:
        with ctx.marks("train"):
            out = train_epoch(model, opt, sets[0], batch, ctx.train_rng)
        with ctx.marks("eval"):
            ev = [eval_epoch(model, s, batch)["loss"] for s in sets[1:]]
        ctx.losses.append([out["loss"], *ev])

    ctx.losses = []
    ctx.unit = unit
    ctx.batch, ctx.shards = batch, shards
    ctx.train_clips, ctx.eval_clips = len(idx_train), 2 * len(idx_test)
    ctx.steps_per_unit = sets[0].n_batches(batch)
    t0 = time.perf_counter()
    for i in range(tr["warmup_units"]):
        unit(i)
    sync_device(dev)
    ctx.losses.clear()
    phase["warm_up"] = time.perf_counter() - t0
    ctx.free = lambda: (sets.clear(), poisoned.__dict__.clear())


def reference_outputs(ctx, tf32: bool) -> dict:
    """The reference's outputs from the run's inputs, in the program's
    format; ``tf32`` makes it the control. Each stage is judged by itself
    (PERF.md): the prep is worked out again from the clips; the steps start
    from the program's prepared features (from the reference's own, the
    features' last digits, amplified by block 1's batch statistics, would
    swamp the steps' agreement); the eval passes run on the program's
    features and its state after the steps (from the reference's state they
    would re-measure the steps' drift)."""
    c, tr, dev, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    inp, prog = ctx.inputs, ctx.program["prep"]
    target = c["target_label"]
    with steps.precision(tf32):
        feats = mfcc_rows(inp["clips"], c["dsp"])
        idx_train, idx_test = inputs.split_indices(len(inp["labels"]))
        tr_feats, te_feats = feats[torch.from_numpy(idx_train).to(dev)], feats[torch.from_numpy(idx_test).to(dev)]
        del feats
        tr_labels, te_labels = inp["labels"][idx_train], inp["labels"][idx_test]
        n_train = len(idx_train)
        chosen = inputs.np_stream(seed, "badnets_poison").choice(n_train, size=int(n_train * c["poisoning_rate"]),
                                                                 replace=False)
        ind_train = np.zeros(n_train, np.int64)
        ind_train[chosen] = 1
        bd_labels = np.where(ind_train == 1, target, tr_labels)
        ind_test = (te_labels != target).astype(np.int64)
        bd_train = badnets_patch(tr_feats, torch.from_numpy(ind_train == 1).to(dev), c["trigger_size"])
        bd_test = badnets_patch(te_feats, torch.from_numpy(ind_test == 1).to(dev), c["trigger_size"])
        del tr_feats
        prep = {"bd_train": bd_train, "clean_test": te_feats, "bd_test": bd_test,
                "labels": [bd_labels, ind_train, np.full(len(te_labels), target), ind_test]}

        batch, shards = ctx.batch, ctx.shards
        local = batch // shards
        rows = inp["check_rows"]
        batches = []
        for k in range(tr["check_steps"]):
            r = rows[k * batch:(k + 1) * batch]
            rng = inputs.np_stream(seed, f"check_{k}")
            order = r[np.concatenate([d * local + rng.permutation(local) for d in range(shards)])]
            batches.append((prog["bd_train"][torch.from_numpy(order).to(dev)],
                            torch.from_numpy(bd_labels[order]).to(dev)))
        gens = [inputs.torch_stream(seed, f"dropout_{d}", dev) for d in range(shards)]
        masks = [steps.Masks([(g, local) for g in gens])] * tr["check_steps"]
        run = steps.train_steps(inp["weights"], batches, c["learning_rate"], masks)
        keys = smallcnn.param_keys(run["state"])
        te_y = torch.from_numpy(te_labels).to(dev)
        after = ctx.program["state"]
        evals = [steps.eval_pass(after, prog["clean_test"], te_y, torch.zeros_like(te_y), batch, shards),
                 steps.eval_pass(after, prog["bd_test"], torch.full_like(te_y, target),
                                 torch.from_numpy(ind_test).to(dev), batch, shards)]
    return {"prep": prep, "losses": run["losses"], "grad1": run["grad1"], "params": [run["state"][k] for k in keys],
            "eval": [(e["loss"], e["sums"]) for e in evals], "near_ties": [e["near_ties"] for e in evals]}


def numbers(ctx, got: dict, ref: dict) -> dict:
    """The compared numbers of ``got`` (the program's or the control's
    outputs) against the reference's."""
    weights = ctx.inputs["weights"]
    labels_equal = all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(got["prep"]["labels"], ref["prep"]["labels"]))
    prep = max(compare.rel_max_abs(got["prep"][k], ref["prep"][k]) for k in ("bd_train", "clean_test", "bd_test"))
    keys = smallcnn.param_keys(weights)
    keep = compare.kept_leaves(ref["grad1"])
    start = [weights[k] for k in keys]
    change = [p - s for p, s in zip(got["params"], start)]
    ref_change = [p - s for p, s in zip(ref["params"], start)]
    return {
        "prep_gap": prep if labels_equal else float("inf"),
        "loss_gap": compare.max_rel(got["losses"], ref["losses"]),
        "grad1_gap": compare.leaf_gap(got["grad1"], ref["grad1"], keep),
        "change_gap": compare.leaf_gap(change, ref_change, keep),
        "change_median_gap": compare.median_leaf_gap(change, ref_change, keep),
        "eval_loss_gap": compare.max_rel([e[0] for e in got["eval"]], [e[0] for e in ref["eval"]]),
        "eval_sums_gap": compare.sums_gap([e[1] for e in got["eval"]], [e[1] for e in ref["eval"]],
                                          ref["near_ties"]),
    }


def leaf_detail(ctx, got: dict, ref: dict) -> dict:
    """The three worst leaves of the first gradient and of the change, for
    ``calibrate.py``'s look at seeds that read high."""
    keys = smallcnn.param_keys(ctx.inputs["weights"])
    keep = compare.kept_leaves(ref["grad1"])
    start = [ctx.inputs["weights"][k] for k in keys]
    out = {}
    for name, a, b in (("grad1", got["grad1"], ref["grad1"]),
                       ("change", [p - s for p, s in zip(got["params"], start)],
                        [p - s for p, s in zip(ref["params"], start)])):
        gaps = {k: compare.leaf_gap([x], [y], [True]) for k, x, y, kk in zip(keys, a, b, keep) if kk}
        out[name] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    return out


def check(ctx) -> dict:
    """The program's numbers against the reference, once the window has
    closed; frees the program's window state first."""
    ctx.free()
    ref = reference_outputs(ctx, tf32=False)
    return numbers(ctx, ctx.program, ref)


def end_to_end(ctx, units: int, seconds: float) -> dict:
    """The training split's clips of every whole unit over the window, under
    the traffic's ``rate_metric`` (one card and four are metrics of their
    own: their runs spread 1.5% and 9%)."""
    return {ctx.cell.traffic["rate_metric"]: units * ctx.train_clips / seconds}


def readings(ctx, units: int, reduced: dict) -> dict:
    """What the per-layer readers read: the trace, the counts, the work."""
    from benchmark import harness
    from benchmark.roofline.peaks import PEAK_F32_FLOPS

    work = harness.load_module("roofline", ctx.cell.config_name, ctx.bench).counts_for(ctx.cell.config,
                                                                                        ctx.cell.traffic)
    return {
        "cell": ctx.cell.name, "trace": reduced, "counts": work, "cards": ctx.shards, "units": units,
        "train_steps": units * ctx.steps_per_unit, "search_steps": 0, "prep_s": ctx.prep_s,
        "flops": units * (ctx.train_clips * work["train_clip_flops"] + ctx.eval_clips * work["eval_clip_flops"]),
        "peak_flops": PEAK_F32_FLOPS, "trace_mod": trace,
    }


def failed_units(ctx) -> int:
    return sum(1 for losses in ctx.losses if not np.all(np.isfinite(losses)))
