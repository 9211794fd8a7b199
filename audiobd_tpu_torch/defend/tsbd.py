"""TSBD defense: unlearn → neuron-weight-change reinit → fine-tune (port of
audiobd_tpu/defend/tsbd.py; reference tsbd.py:43-404).

Stages:
  A. ``only_finetune`` (the reference's default branch, tsbd.py:268-290):
     one epoch of SGD-momentum fine-tuning on the 5% clean-val split, test,
     finetuning_data.csv, return.
  B. Unlearning: gradient *ascent* (maximize CE) of the eval-mode model with
     Adam ``lr_un`` until the monitored metric floors (val acc ≤ 0.10 /
     test acc ≤ 0.10 / ASR ≤ 0.05 by ``data_type``), recording per-neuron
     |grad| sums of ``record_layer``; on the card a fused block 1's
     gradients are kernel B's eval mode. With ``first_batch_only`` (the
     reference's loop body returns after the first batch, tsbd.py:133-138)
     an epoch is one step on the first batch of ``iter_batches(np_rng(seed,
     "tsbd_unlearn"), shuffle=True)``, the stream of the JAX package's
     multi-batch host loop; its device loop draws the batch by
     ``jax.random.permutation``, which has no torch twin. The floor test
     reads the three evals on the host: one sync an epoch, inherent to a
     loop whose length the data decides.
  C. NWC: per-neuron summed |Δw| vs the original model → ucn.txt,
     n2w_dict.json, the unlearned model (``unlearned_model.pt``, a
     state_dict) and the grad avg/var CSVs.
  D. ``zero_reinit_weight`` per ratio: zero the globally top-``wratio``
     largest-changed weights within the top-changed neurons of the
     *original* model, then fine-tune ``ft_epochs + 1`` epochs (Adam
     ``lr_ft``), testing every 10 epochs; both CSVs. The ratios run one
     after another whatever ``vectorized_ft`` says: the JAX package stacks
     them only for XLA's compile cost (audiobd_tpu/defend/tsbd.py:214-230).
"""

from __future__ import annotations

import functools
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.parallel.distributed import main_rank_only
from audiobd_tpu_torch.defend.common import (
    DefenseData,
    State,
    eval_loss_grads,
    finetune_epochs,
    flax_layout,
    from_flax_layout,
    layer_kernels,
    load_bd_model,
    load_defense_data,
    make_full_tester,
    make_tester,
    neuron_weight_changes,
    on_device,
    snapshot,
)
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset
from audiobd_tpu_torch.train.state import SGD, Adam
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.logging import append_csv_row, prepend_csv_header, remove_file, write_csv

REINIT_RATIOS = [0.01, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.4, 0.5, 0.7, 0.9]


def default_record_layer(state: State) -> str:
    """Last conv kernel in the reference's order: ``conv3.weight`` on
    SmallCNN, the reference's default record_layer."""
    return layer_kernels(state, "conv")[-1][0]


def unlearn_step(model, opt: Adam, x, y, mask, record_layer: str):
    """One gradient-ascent step (make_unlearn_step, tsbd.py:57-79): returns
    (CE loss, batch train accuracy, per-neuron |grad| sums of
    ``record_layer``), each a 0-d or 1-d tensor on the device."""
    names = [n for n, _ in model.named_parameters()]
    loss_neg, logits, grads = eval_loss_grads(model, x, y, mask, sign=-1.0)
    fm = mask.to(torch.float32)
    hits = (logits.argmax(dim=-1) == y).to(torch.float32)
    train_acc = (hits * fm).sum() / torch.clamp(fm.sum(), min=1.0)
    g = grads[names.index(record_layer)]
    grad_norm = g.abs().flatten(1).sum(dim=1)
    opt.step(grads)
    return -loss_neg, train_acc, grad_norm


def unlearn(model, opt: Adam, loader: DeviceDataset, data: DefenseData, data_type: str, bs: int, seed: int,
            record_layer: str, unlearn_epochs: int, first_batch_only: bool, tester, verbose: bool):
    """Stage B. Returns the (avg, var) grad rows: [epoch, loss, train acc,
    test acc, ASR, val acc] + the per-neuron |grad| sums, averaged (and
    their variance) over the epoch's steps."""
    np_rng = rnd.np_rng(seed, "tsbd_unlearn")
    rows_avg, rows_var = [], []
    for epoch in range(unlearn_epochs):
        perm, mask = loader.plan(min(bs, len(loader)), np_rng)
        if first_batch_only:
            perm, mask = perm[:1], mask[:1]
        steps = [unlearn_step(model, opt, loader.feats[idx], loader.labels[idx], bmask, record_layer)
                 for idx, bmask in zip(perm, mask)]
        losses, accs, gns = (torch.stack(v).cpu().numpy() for v in zip(*steps))
        state = snapshot(model)
        _, val_acc = tester(state, data.clean_val)
        _, test_acc = tester(state, data.clean_test)
        _, test_asr = tester(state, data.bd_test)
        # float64 means of the steps' losses and accuracies, f32 of the rows.
        head = [epoch, float(np.mean(losses.tolist())), float(np.mean(accs.tolist())), test_acc, test_asr, val_acc]
        rows_avg.append(head + gns.mean(axis=0).tolist())
        rows_var.append(head + gns.var(axis=0).tolist())
        if verbose:
            print(f"unlearn {epoch}: acc {100*test_acc:.2f} asr {100*test_asr:.2f} val {100*val_acc:.2f}")
        if (
            (data_type == "clean_val" and val_acc <= 0.10)
            or (data_type == "clean_test" and test_acc <= 0.10)
            or (data_type == "poison_test" and test_asr <= 0.05)
        ):
            break
    return rows_avg, rows_var


def zero_reinit_weight(state_o: State, top_neurons: list, n2w: dict, wratio: float) -> State:
    """Zero the top-``wratio`` largest-|Δw| weights across the selected
    neurons (reference zero_reinit_weight, tsbd.py:49-63): the threshold is
    the smallest of the kept values, every weight of a selected neuron with
    |Δw| ≥ it is zeroed. ``n2w``'s lists are in flax's element order, so the
    selection is made on the flax-layout kernel and mapped back."""
    merged = []
    for layer, idx, _ in top_neurons:
        merged += n2w[f"{layer}.{idx}"]
    if not merged:
        return state_o
    reinit = sorted(merged, reverse=True)[: int(len(merged) * wratio)]
    if not reinit:
        return state_o
    threshold = min(reinit)
    flats: dict[str, np.ndarray] = {}
    for layer, idx, _ in top_neurons:
        sel = np.flatnonzero(np.asarray(n2w[f"{layer}.{idx}"]) >= threshold)
        if sel.size == 0:
            continue
        flat = flats.setdefault(layer, flax_layout(state_o[layer]))
        flat[sel, idx] = 0.0
    return {**state_o, **{layer: from_flax_layout(flat, state_o[layer]) for layer, flat in flats.items()}}


@dataclass
class TSBDResult:
    stage: str
    test_acc: float = 0.0
    test_asr: float = 0.0
    per_ratio: list = field(default_factory=list)
    unlearn_epochs: int = 0


@main_rank_only
def _write_stage_c(checkpoint_dir: str, nwc: list, n2w: dict, params: State) -> None:
    """Stage C's files: the ranked NWC scores, the neuron-to-weight map and
    the unlearned model."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "ucn.txt"), "w") as f:
        f.write("No \t Layer_Name \t Neuron_Idx \t Score \n")
        for count, (layer, idx, value) in enumerate(nwc):
            f.write(f"{count} \t {layer} \t {idx} \t {value:.4f} \n")
    with open(os.path.join(checkpoint_dir, "n2w_dict.json"), "w") as f:
        json.dump(n2w, f)
    torch.save({k: v.cpu() for k, v in params.items()}, os.path.join(checkpoint_dir, "unlearned_model.pt"))


def mitigation(
    cfg: AttackConfig,
    only_finetune: bool = True,
    data_type: str = "clean_val",
    val_ratio: float = 0.05,
    lr_un: float = 1e-4,
    unlearn_epochs: int = 1000,
    reinit_weight_ratio: float = 0.7,
    lr_ft: float = 0.01,
    ft_epochs: int = 51,
    record_layer: str | None = None,
    first_batch_only: bool = True,
    reinit_ratios: list | None = None,
    data: DefenseData | None = None,
    vectorized_ft: bool = True,
    verbose: bool = True,
) -> TSBDResult:
    t0 = time.perf_counter()

    def stage(msg):
        if verbose:
            print(f"[tsbd +{time.perf_counter() - t0:.1f}s] {msg}", flush=True)

    save_dir = os.path.join(cfg.record_dir, "defense", "tsbd")
    model, state_o, _spec = load_bd_model(cfg)
    data = on_device(data or load_defense_data(cfg, val_ratio), next(model.parameters()).device)
    stage("data + model loaded")
    bs = cfg.train.batch_size
    tester = make_tester(model, bs)
    full_tester = make_full_tester(model, bs)

    # ---------------- stage A: plain fine-tune (default branch)
    if only_finetune:
        ft_csv = os.path.join(save_dir, "finetuning_data.csv")
        remove_file(ft_csv)
        ft_state, _ = finetune_epochs(
            model, state_o, data.clean_val, functools.partial(SGD, lr=lr_ft, momentum=0.9), epochs=1,
            batch_size=bs, seed=cfg.train.seed,
        )
        acc, asr, closs, bloss = full_tester(ft_state, data.clean_test, data.bd_test_complete)
        append_csv_row(ft_csv, [0, closs, bloss, acc, asr])
        prepend_csv_header(ft_csv, ["epoch", "clean_test_loss", "bd_test_loss", "test_clean_acc", "test_asr"])
        if verbose:
            print(f"finetune-only: acc {acc:.2f} asr {asr:.2f}")
        return TSBDResult("finetune", acc, asr)

    # ---------------- stage B: unlearning
    record_layer = record_layer or default_record_layer(state_o)
    checkpoint_dir = os.path.join(save_dir, "checkpoint")
    loader = {"clean_val": data.clean_val, "clean_test": data.clean_test, "poison_test": data.bd_test}[data_type]
    n_neurons = state_o[record_layer].shape[0]
    model.load_state_dict(state_o)
    opt = Adam(model.parameters(), lr_un)
    grad_rows_avg, grad_rows_var = unlearn(model, opt, loader, data, data_type, bs, cfg.train.seed, record_layer,
                                           unlearn_epochs, first_batch_only, tester, verbose)
    params = snapshot(model)
    stage(f"stage B unlearning done ({len(grad_rows_avg)} epochs)")
    header = ["Epoch", "train_loss", "train_acc", "test_acc", "test_asr", "val_acc"] + [
        f"neuron_{i}" for i in range(n_neurons)
    ]
    write_csv(os.path.join(checkpoint_dir, f"grad_avg_{record_layer}.csv"), header, grad_rows_avg)
    write_csv(os.path.join(checkpoint_dir, f"grad_var_{record_layer}.csv"), header, grad_rows_var)

    # ---------------- stage C: NWC
    nwc, n2w = neuron_weight_changes(params, state_o, "conv")
    _write_stage_c(checkpoint_dir, nwc, n2w, params)
    stage("stage C NWC done")

    # ---------------- stage D: reinit + fine-tune per ratio
    ranked = sorted(nwc, key=lambda rec: rec[2], reverse=True)
    prune_csv = os.path.join(save_dir, "pruning_data.csv")
    ft_csv = os.path.join(save_dir, "finetuning_data.csv")
    for path in (prune_csv, ft_csv):
        remove_file(path)
    per_ratio = []
    for ratio in reinit_ratios or REINIT_RATIOS:
        reinit_state = zero_reinit_weight(state_o, ranked[: int(len(ranked) * ratio)], n2w, reinit_weight_ratio)
        acc, asr, closs, bloss = full_tester(reinit_state, data.clean_test, data.bd_test_complete)
        append_csv_row(prune_csv, [ratio, closs, bloss, acc, asr])
        if verbose:
            print(f"reinit ratio {ratio}: acc {acc:.2f} asr {asr:.2f}")
        last = {}

        def test_every_10(epoch, m, _ratio=ratio, _last=last):
            if epoch % 10 == 0:
                acc, asr, closs, bloss = full_tester(m.state_dict(), data.clean_test, data.bd_test_complete)
                append_csv_row(ft_csv, [_ratio, epoch, closs, bloss, acc, asr])
                _last["acc"], _last["asr"] = acc, asr

        # One Adam instance + one shuffle stream across all ft_epochs+1
        # epochs, matching the reference's single optimizer (tsbd.py:382-404).
        finetune_epochs(model, reinit_state, data.clean_val, functools.partial(Adam, lr=lr_ft),
                        epochs=ft_epochs + 1, batch_size=bs, seed=cfg.train.seed, on_epoch=test_every_10)
        per_ratio.append((ratio, last["acc"], last["asr"]))
    stage("stage D fine-tunes done")
    prepend_csv_header(prune_csv, ["ratio", "clean_test_loss", "bd_test_loss", "test_clean_acc", "test_asr"])
    prepend_csv_header(ft_csv, ["ratio", "epoch", "clean_test_loss", "bd_test_loss", "test_clean_acc", "test_asr"])
    return TSBDResult("full", per_ratio[-1][1], per_ratio[-1][2], per_ratio, len(grad_rows_avg))
