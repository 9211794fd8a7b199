"""Shared defense infrastructure (port of audiobd_tpu/defend/common.py).

Every defense starts the same way: load the cached clean/bd npys, carve a 5%
validation split out of clean-train, and rebuild the attacked model from the
port's checkpoint, ``record/<result>/torch_checkpoint/``. Block 1 is built by
the trainer's rule (``resolve_fused_conv``), so on the card its backward is
kernel B: train mode in the fine-tunes, eval mode in FT-reg's SAM steps and
the unlearning ascents, which take parameter gradients of the eval-mode
model. The reference builds its defense models unfused only for XLA's
compile time (audiobd_tpu/defend/common.py:63-70); the port compiles nothing.

A model's weights travel as a state_dict (name → tensor, BN buffers
included): a defense snapshots one, edits a copy, and loads it into the
model to test or fine-tune it.

Neurons: a "neuron" is an output channel, dim 0 of a conv weight (out, in,
kh, kw) or of an ``nn.Linear`` weight (out, in); the reference's is the last
axis of the flax kernel (kh, kw, in, out) or (in, out). Layers are named by
the port's state_dict keys (``conv3.weight``, the PyTorch reference's own
``record_layer`` name) and listed in the reference's order: the restored
Orbax tree's, sorted by flax path (``models/convert.py::flax_kernel_path``),
which is not the build order for ResNet. Per-weight work (norms, |Δw| lists,
the reinit selection) runs on the kernel in the flax layout
(``flax_layout``), so sums and lists follow the reference's element order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.models import build_model
from audiobd_tpu_torch.models.zoo import model_features
from audiobd_tpu_torch.models.convert import flax_kernel_path
from audiobd_tpu_torch.train.checkpoint import load_checkpoint
from audiobd_tpu_torch.train.loop import ArraySet, cross_entropy, masked_mean
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_eval_epoch, run_train_epoch
from audiobd_tpu_torch.train.trainer import resolve_fused_conv, snapshot
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.device import resolve_device

State = dict[str, torch.Tensor]


@dataclass
class DefenseData:
    """The defenses' splits: host ArraySets from ``load_defense_data``, or
    DeviceDatasets from ``on_device``."""

    clean_val: ArraySet | DeviceDataset
    clean_test: ArraySet | DeviceDataset
    bd_test: ArraySet | DeviceDataset           # labels all target; the raw "asr-as-acc"
    bd_test_complete: ArraySet | DeviceDataset  # with poison indicators (the true ASR)


def load_defense_data(cfg: AttackConfig, val_ratio: float = 0.05) -> DefenseData:
    clean_path = os.path.join(cfg.record_dir, cfg.dataset, "clean")
    bd_path = os.path.join(cfg.record_dir, cfg.dataset, "bd")
    c_tr_m = np.load(os.path.join(clean_path, "clean_train_mfcc.npy"))
    c_tr_y = np.load(os.path.join(clean_path, "clean_train_label.npy"))
    c_te_m = np.load(os.path.join(clean_path, "clean_test_mfcc.npy"))
    c_te_y = np.load(os.path.join(clean_path, "clean_test_label.npy"))
    b_te_m = np.load(os.path.join(bd_path, "bd_test_mfcc.npy"))
    b_te_y = np.load(os.path.join(bd_path, "bd_test_label.npy"))
    b_te_i = np.load(os.path.join(bd_path, "poison_index_test.npy"))

    rng = rnd.np_rng(cfg.train.seed, "defense_val")
    val_idx = rng.choice(len(c_tr_m), size=int(len(c_tr_m) * val_ratio), replace=False)
    return DefenseData(
        clean_val=ArraySet(c_tr_m[val_idx], c_tr_y[val_idx]),
        clean_test=ArraySet(c_te_m, c_te_y),
        bd_test=ArraySet(b_te_m, b_te_y),
        bd_test_complete=ArraySet(b_te_m, b_te_y, b_te_i),
    )


def on_device(data: DefenseData, device: torch.device) -> DefenseData:
    """The splits on ``device``; the two bd splits share one feature tensor."""
    complete = DeviceDataset(data.bd_test_complete, device)
    return DefenseData(
        clean_val=DeviceDataset(data.clean_val, device),
        clean_test=DeviceDataset(data.clean_test, device),
        bd_test=DeviceDataset(ArraySet(complete.feats, data.bd_test.labels), device),
        bd_test_complete=complete,
    )


def load_bd_model(cfg: AttackConfig):
    """(model on ``cfg.device``, the checkpoint's state on that device,
    model_spec): the attacked model rebuilt from the port's checkpoint, f32,
    block 1 fused by ``resolve_fused_conv``. The defenses and ``infer`` read
    MFCC features, and refuse a model that takes others (AST's log-mel;
    ROADMAP.md queue 6)."""
    device = resolve_device(cfg.device)
    state_dict, spec = load_checkpoint(cfg.record_dir)
    for model in (cfg.model, spec["model"]):
        if model_features(str(model)) != "mfcc":
            raise ValueError(f"the defenses and infer read MFCC features; {model} takes "
                             f"{model_features(str(model))} (ROADMAP.md queue 6)")
    model = build_model(spec["model"], spec["num_classes"], spec["feature_size"], device, cfg.train.seed,
                        n_mfcc=spec.get("n_mfcc"), fused=resolve_fused_conv(cfg, device))
    model.load_state_dict(state_dict)
    return model, snapshot(model), spec


# ---------------------------------------------------------------------------
# Neuron surgery on state_dicts


def layer_kernels(state: State, kind: str = "conv") -> list[tuple[str, torch.Tensor]]:
    """Named conv (ndim 4) or dense (``nn.Linear``, ndim 2) weights, in the
    reference's order (sorted by flax path). LSTM weights are not kernels
    there (``w_ih``) nor here (``weight_ih_l0``)."""
    want_ndim = 4 if kind == "conv" else 2
    named = [(k, v) for k, v in state.items() if k.endswith(".weight") and v.ndim == want_ndim]
    return sorted(named, key=lambda kv: tuple(flax_kernel_path(kv[0], want_ndim).split("/")))


def flax_layout(kernel: torch.Tensor) -> np.ndarray:
    """The kernel as the reference's (fan-in, neurons) matrix, C-contiguous
    f32 numpy: conv (out, in, kh, kw) → (kh·kw·in, out), dense (out, in) →
    (in, out). Column ``idx`` lists neuron idx's weights in flax's order."""
    arr = kernel.detach().cpu().numpy()
    perm = (2, 3, 1, 0) if arr.ndim == 4 else (1, 0)
    return np.ascontiguousarray(np.transpose(arr, perm)).reshape(-1, arr.shape[0])


def from_flax_layout(flat: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Inverse of ``flax_layout``: a tensor shaped and placed as ``like``."""
    if like.ndim == 4:
        out, cin, kh, kw = like.shape
        arr = np.transpose(flat.reshape(kh, kw, cin, out), (3, 2, 0, 1))
    else:
        arr = flat.T
    return torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)


def zero_neurons(state: State, neuron_list: list[tuple[str, int]]) -> State:
    """A copy of ``state`` with the listed output channels' weights zeroed
    (the reference's state_dict[layer][idx] = 0)."""
    by_layer: dict[str, list[int]] = {}
    for layer, idx in neuron_list:
        by_layer.setdefault(layer, []).append(idx)
    out = dict(state)
    for layer, idxs in by_layer.items():
        kernel = state[layer].clone()
        kernel[torch.as_tensor(idxs, device=kernel.device)] = 0.0
        out[layer] = kernel
    return out


def neuron_names(state: State, kind: str = "conv") -> list[tuple[str, int]]:
    return [(name, idx) for name, kernel in layer_kernels(state, kind) for idx in range(kernel.shape[0])]


def neuron_weight_norms(state: State, kind: str = "conv") -> tuple[list[float], list[tuple[str, int]]]:
    """L2 norm of each output channel's weights (reference
    get_neuron_weight_norm, ft_reg.py:144-161)."""
    norms, names = [], []
    for name, kernel in layer_kernels(state, kind):
        k = flax_layout(kernel)
        for idx in range(k.shape[1]):
            names.append((name, idx))
            norms.append(float(np.linalg.norm(k[:, idx])))
    return norms, names


def neuron_weight_changes(state_new: State, state_old: State, kind: str = "conv"):
    """Per-neuron summed |Δw| and per-weight |Δw| lists (TSBD's NWC,
    tsbd.py:345-358), the lists in flax's element order. Returns
    (list[(layer, idx, nwc)], {"layer.idx" → |Δw| list})."""
    nwc, n2w = [], {}
    for name, kernel in layer_kernels(state_new, kind):
        flat = np.abs(flax_layout(kernel) - flax_layout(state_old[name]))
        for idx in range(flat.shape[1]):
            nwc.append((name, idx, float(flat[:, idx].sum())))
            n2w[f"{name}.{idx}"] = flat[:, idx].tolist()
    return nwc, n2w


# ---------------------------------------------------------------------------
# Testing, fine-tuning and eval-mode gradients


def make_tester(model, batch_size: int = 256):
    """(state, data) → (loss, acc fraction): the reference's temp_test
    (fp.py:36-50)."""

    def tester(state: State, data: DeviceDataset):
        model.load_state_dict(state)
        out = run_eval_epoch(model, data, min(batch_size, len(data)))
        return out["loss"], out["acc"] / 100.0

    return tester


def make_full_tester(model, batch_size: int = 256):
    """(state, clean_test, bd_test_complete) → (clean acc %, ASR %, clean
    loss, bd loss): the reference's test()."""

    def tester(state: State, clean_test: DeviceDataset, bd_complete: DeviceDataset):
        model.load_state_dict(state)
        clean = run_eval_epoch(model, clean_test, min(batch_size, len(clean_test)))
        bd = run_eval_epoch(model, bd_complete, min(batch_size, len(bd_complete)))
        return clean["acc"], bd["asr"], clean["loss"], bd["loss"]

    return tester


def finetune_epochs(
    model,
    state: State,
    data: DeviceDataset,
    make_opt: Callable,
    epochs: int,
    batch_size: int,
    seed: int,
    project: Callable[[torch.nn.Module], None] | None = None,
    on_epoch: Callable[[int, torch.nn.Module], None] | None = None,
):
    """Supervised fine-tuning of ``state`` for ``epochs`` train-mode epochs
    (BN running statistics at flax's momentum) with one optimizer,
    ``make_opt(params)``, and one shuffle stream, ``np_rng(seed,
    "defense_ft")``; dropout from ``torch_generator(seed,
    "defense_ft_dropout")``. After each epoch ``project(model)`` (e.g. a
    prune mask re-applied in place), then ``on_epoch(epoch, model)``.
    Returns (the fine-tuned state, the last epoch's metrics)."""
    model.load_state_dict(state)
    opt = make_opt(model.parameters())
    np_rng = rnd.np_rng(seed, "defense_ft")
    model.dropout_generator = rnd.torch_generator(seed, "defense_ft_dropout", data.device)
    metrics = None
    for epoch in range(epochs):
        metrics = run_train_epoch(model, opt, data, min(batch_size, len(data)), np_rng)
        if project is not None:
            project(model)
        if on_epoch is not None:
            on_epoch(epoch, model)
    return snapshot(model), metrics


def eval_loss_grads(model, x, y, mask, params: list[torch.Tensor] | None = None, sign: float = 1.0):
    """``sign`` × the masked-mean cross-entropy of the eval-mode model and
    its gradient with respect to every parameter, at ``params`` (in
    ``model.parameters()`` order) when given, else at the model's own. Eval
    mode: BN normalizes by, and never updates, its running statistics; on
    the card a fused block 1 takes these gradients by kernel B's eval mode.
    Returns (loss, logits, grads), the first two detached."""
    model.eval()
    if params is None:
        params = list(model.parameters())
        logits = model(x)
    else:
        names = [n for n, _ in model.named_parameters()]
        logits = torch.func.functional_call(model, dict(zip(names, params)), (x,))
    loss = sign * masked_mean(cross_entropy(logits, y), mask)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), logits.detach(), list(grads)
