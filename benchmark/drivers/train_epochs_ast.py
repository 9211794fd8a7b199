"""Driver ``train_epochs_ast``: BadNets training of AST on one card, as
``train/trainer.py::train_attack`` runs it: ``train_epochs``' unit on AST's
log-mel path.

Set-up: the clips made on the card from the seed; the port's prep (kernel A's
log-mel mode by ``batched_mfcc_device``, the 80/20 split,
``normalize_features``, ``poison/badnets.py``); the model from
``build_attack_model`` at ``zoo.AST_WIDTHS``, which must be the
configuration's widths, with weights made from the seed
(``reference/ast.py::spec``) and the optimizer from ``make_optimizer``; the
first steps, each a one-batch ``run_train_epoch`` on rows of its own, then
both eval passes over the whole test splits; warm-up units. A unit:
``run_train_epoch`` over the training split, then ``run_eval_epoch`` on the
clean and on the backdoored test split, at the configuration's batch. The
window's rate and the per-layer readings are ``train_epochs``'.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, inputs
from benchmark.drivers.train_epochs import CHECK_ROWS, end_to_end, failed_units, readings  # noqa: F401
from benchmark.harness import sync_device
from benchmark.reference import ast as ast_ref
from benchmark.reference.mfcc import badnets_patch

LOGMEL_CHUNK = 512  # clips the reference's log-mel takes at once


def program_config(cell, seed: int, device):
    from audiobd_tpu_torch.configs import make_config

    c = cell.config
    return make_config(
        "badnets", model=c["model"], num_classes=c["num_classes"], seed=int(seed), batch_size=c["batch_size"],
        learning_rate=c["learning_rate"], poisoning_rate=c["poisoning_rate"], trigger_size=c["trigger_size"],
        target_label=c["target_label"], compute_dtype=c["compute_dtype"], device=str(device), **c["dsp"],
    )


def setup(ctx) -> None:
    """Everything before the window; ``ctx`` gains the program's objects,
    the inputs, the first steps' outputs and the set-up's parts."""
    from audiobd_tpu_torch.data.speech_commands import (
        CleanData, batched_mfcc_device, mfcc_params, normalize_features, split_indices)
    from audiobd_tpu_torch.models import zoo
    from audiobd_tpu_torch.poison import badnets
    from audiobd_tpu_torch.train.loop import ArraySet
    from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_eval_epoch, run_train_epoch
    from audiobd_tpu_torch.train.trainer import build_attack_model, make_optimizer

    cell, dev, seed = ctx.cell, ctx.device, ctx.seed
    c, tr = cell.config, cell.traffic
    w = c["widths"]
    if {k: w[k] for k in zoo.AST_WIDTHS} != zoo.AST_WIDTHS:
        raise ValueError(f"the configuration's widths {w} are not the program's AST_WIDTHS {zoo.AST_WIDTHS}")
    batch = c["batch_size"]
    pcfg = program_config(cell, seed, dev)
    if pcfg.features != c["features"]:
        raise ValueError(f"the program's {c['model']} takes {pcfg.features} features, the configuration states "
                         f"{c['features']}")
    phase = ctx.phases

    t0 = time.perf_counter()
    clips, labels = inputs.make_clips(seed, c["num_classes"], c["clips_per_class"], c["dsp"]["sample_rate"], dev)
    weights = inputs.make_weights(seed, ast_ref.spec(c["num_classes"], c["dsp"]["n_mels"], w), dev)
    sync_device(dev)
    phase["inputs"] = time.perf_counter() - t0

    # The program's prep, timed whole: kernel A's log-mel, the split, the
    # normalisation, the patch.
    t0 = time.perf_counter()
    feats = batched_mfcc_device(clips, mfcc_params(pcfg), dev)
    idx_train, idx_test = split_indices(len(labels))
    train_dev, test_dev = normalize_features(pcfg, feats[torch.from_numpy(idx_train).to(dev)],
                                             feats[torch.from_numpy(idx_test).to(dev)])
    del feats
    clean = CleanData(None, None, train_dev, test_dev, labels[idx_train], labels[idx_test],
                      train_mfcc_dev=train_dev, test_mfcc_dev=test_dev)
    poisoned = badnets.poison(pcfg, clean, save=False)
    sync_device(dev)
    phase["prep"] = ctx.prep_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = build_attack_model(pcfg, dev)
    model.load_state_dict(weights)
    opt = make_optimizer(pcfg, model.parameters())
    sets = [DeviceDataset(s, dev) for s in (poisoned.bd_train, poisoned.clean_test, poisoned.bd_test)]
    sync_device(dev)
    phase["build"] = time.perf_counter() - t0

    # The first steps, through the window's own call and feed: a one-batch
    # epoch each, on rows that all differ.
    t0 = time.perf_counter()
    rows = inputs.np_stream(seed, CHECK_ROWS).permutation(len(idx_train))[: tr["check_steps"] * batch]
    bd = poisoned.bd_train
    losses, grad1 = [], None
    for k in range(tr["check_steps"]):
        r = rows[k * batch:(k + 1) * batch]
        sub = ArraySet(bd.feats[torch.from_numpy(r).to(dev)], np.asarray(bd.labels)[r],
                       np.asarray(bd.indicators)[r])
        out = run_train_epoch(model, opt, DeviceDataset(sub, dev), batch, inputs.np_stream(seed, f"check_{k}"))
        losses.append(out["loss"])
        if grad1 is None:
            grad1 = [m.detach() / (1.0 - opt.b1) for m in opt.mu]
    params = [p.detach().clone() for p in model.parameters()]
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    evals = [run_eval_epoch(model, s, batch) for s in sets[1:]]
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
            out = run_train_epoch(model, opt, sets[0], batch, ctx.train_rng)
        with ctx.marks("eval"):
            ev = [run_eval_epoch(model, s, batch)["loss"] for s in sets[1:]]
        ctx.losses.append([out["loss"], *ev])

    ctx.losses = []
    ctx.unit = unit
    ctx.batch, ctx.shards = batch, 1
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
    format; ``tf32`` makes it the control. Each stage is judged by itself,
    as ``train_epochs`` judges SmallCNN's: the prep is worked out again from
    the clips; the steps start from the program's prepared features; the
    eval passes run on the program's features and its state after the
    steps."""
    c, tr, dev, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    inp, prog, w, dsp = ctx.inputs, ctx.program["prep"], c["widths"], c["dsp"]
    target, batch = c["target_label"], ctx.batch
    with ast_ref.precision(tf32):
        clips = inp["clips"]
        feats = torch.cat([ast_ref.logmel(clips[s:s + LOGMEL_CHUNK], dsp["sample_rate"], dsp["n_fft"],
                                          dsp["hop_length"], dsp["n_mels"])
                           for s in range(0, clips.shape[0], LOGMEL_CHUNK)])[:, None]
        idx_train, idx_test = inputs.split_indices(len(inp["labels"]))
        tr_feats, te_feats = ast_ref.normalize(feats[torch.from_numpy(idx_train).to(dev)],
                                               feats[torch.from_numpy(idx_test).to(dev)])
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

        rows = inp["check_rows"]
        batches = []
        for k in range(tr["check_steps"]):
            order = rows[k * batch:(k + 1) * batch][inputs.np_stream(seed, f"check_{k}").permutation(batch)]
            batches.append((prog["bd_train"][torch.from_numpy(order).to(dev)],
                            torch.from_numpy(bd_labels[order]).to(dev)))
        run = ast_ref.train_steps(inp["weights"], batches, c["learning_rate"], w)
        keys = ast_ref.param_keys(run["state"])
        te_y = torch.from_numpy(te_labels).to(dev)
        after = ctx.program["state"]
        evals = [ast_ref.eval_pass(after, prog["clean_test"], te_y, torch.zeros_like(te_y), batch, w),
                 ast_ref.eval_pass(after, prog["bd_test"], torch.full_like(te_y, target),
                                   torch.from_numpy(ind_test).to(dev), batch, w)]
    return {"prep": prep, "losses": run["losses"], "grad1": run["grad1"], "params": [run["state"][k] for k in keys],
            "eval": [(e["loss"], e["sums"]) for e in evals], "near_ties": [e["near_ties"] for e in evals]}


def _changes(ctx, got: dict, ref: dict) -> tuple[list, list, list]:
    start = [ctx.inputs["weights"][k] for k in ast_ref.param_keys(ctx.inputs["weights"])]
    return ([p - s for p, s in zip(got["params"], start)], [p - s for p, s in zip(ref["params"], start)],
            compare.kept_leaves(ref["grad1"]))


def numbers(ctx, got: dict, ref: dict) -> dict:
    """The compared numbers of ``got`` (the program's or the control's
    outputs) against the reference's."""
    labels_equal = all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(got["prep"]["labels"], ref["prep"]["labels"]))
    prep = max(compare.rel_max_abs(got["prep"][k], ref["prep"][k]) for k in ("bd_train", "clean_test", "bd_test"))
    change, ref_change, keep = _changes(ctx, got, ref)
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
    keys = ast_ref.param_keys(ctx.inputs["weights"])
    change, ref_change, keep = _changes(ctx, got, ref)
    out = {}
    for name, a, b in (("grad1", got["grad1"], ref["grad1"]), ("change", change, ref_change)):
        gaps = {k: compare.leaf_gap([x], [y], [True]) for k, x, y, kk in zip(keys, a, b, keep) if kk}
        out[name] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    return out


def check(ctx) -> dict:
    """The program's numbers against the reference, once the window has
    closed; frees the program's window state first."""
    ctx.free()
    return numbers(ctx, ctx.program, reference_outputs(ctx, tf32=False))
