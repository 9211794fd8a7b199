"""The epoch engine on one rank (train/scan_epoch.py) against the
single-device loop written out here, bit for bit.

The engine runs one loop on one rank and on many; on one rank it must give
what the single-device loop gives: the reference's plan (``pad_plan``,
``make_perm`` on the same ``np_rng`` stream), ``masked_mean``'s loss,
``metric_sums``, and the epoch's loss the mean of the batch losses on the
host. SmallCNN in train mode with dropout, 20 rows at 8 a batch: the tail
batch is wrap-padded by 4 rows. Compared with ``torch.equal`` and
``np.array_equal``: each batch loss, each step's gradients, the parameters
and buffers after the epoch, and the returned dict. tests/
test_torch_port_kernels_cuda.py runs the same comparison on the card,
where a loss divided by a Python scalar would round otherwise.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.train import scan_epoch
from audiobd_tpu_torch.train.loop import ArraySet, cross_entropy, masked_mean, metric_sums
from audiobd_tpu_torch.train.trainer import build_attack_model, make_optimizer

CPU = torch.device("cpu")
N, BATCH, SEED = 20, 8, 35


def _data(seed: int, n: int) -> ArraySet:
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((n, 1, 101, 40)) * 8.0).astype(np.float32)
    ind = (rng.random(n) < 0.4).astype(np.int64)
    return ArraySet(feats, np.where(ind == 1, 2, rng.integers(0, 10, n)), ind)


def _recording(opt, grads: list):
    """``opt`` keeping a copy of the gradients of each step."""
    step = opt.step
    opt.step = lambda g: grads.append([t.detach().clone() for t in g]) or step(g)
    return opt


def _plain(kind: str, model, opt, data: ArraySet, device: torch.device) -> tuple:
    """The single-device epoch, written out."""
    n = len(data.labels)
    n_batches, mask = scan_epoch.pad_plan(n, BATCH)
    perm = scan_epoch.make_perm(np.random.default_rng(SEED) if kind == "train" else None, n, n_batches, BATCH)
    feats = torch.from_numpy(data.feats).to(device)
    labels = torch.from_numpy(data.labels).to(device)
    ind = torch.from_numpy(data.indicators).to(device)
    model.train(kind == "train")
    losses, sums = [], torch.zeros(4, dtype=torch.int64, device=device)
    for idx, bmask in zip(torch.from_numpy(perm.astype(np.int64)).to(device), torch.from_numpy(mask).to(device)):
        with torch.set_grad_enabled(kind == "train"):
            logits = model(feats[idx])
            loss = masked_mean(cross_entropy(logits, labels[idx]), bmask)
        if kind == "train":
            opt.step(torch.autograd.grad(loss, opt.params))
        losses.append(loss.detach())
        sums += metric_sums(logits.detach(), labels[idx], ind[idx], bmask)
    losses, s = torch.stack(losses).cpu().numpy(), sums.cpu().numpy()
    acc = "mix_acc" if kind == "train" else "acc"
    out = {"loss": float(losses.mean()), acc: 100.0 * s[0] / max(s[1], 1), "asr": 100.0 * s[2] / max(s[3], 1)}
    return (out if kind == "train" else {**out, "sums": s}), losses


def _engine(kind: str, model, opt, data: ArraySet, device: torch.device) -> tuple:
    """The engine's epoch on one rank, and its batch losses as its summary
    read them."""
    seen = []
    summary = scan_epoch._summary
    with mock.patch.object(scan_epoch, "_summary", lambda *a: seen.append(summary(*a)) or seen[-1]):
        dset = scan_epoch.DeviceDataset(data, device)
        if kind == "train":
            out = scan_epoch.run_train_epoch(model, opt, dset, BATCH, np.random.default_rng(SEED))
        else:
            out = scan_epoch.run_eval_epoch(model, dset, BATCH)
    return out, seen[0][0]


def one_rank_epochs(kind: str, device: torch.device) -> list[tuple]:
    """For the engine and for the plain loop, each from a fresh model alike
    (weights and dropout stream): (the epoch's dict, its batch losses, each
    step's gradients, the state after)."""
    data = _data(9 if kind == "train" else 11, N)
    cfg = make_config("badnets", device=device.type, batch_size=BATCH)
    runs = []
    for run in (_engine, _plain):
        model = build_attack_model(cfg, device)
        assert min(model.dropout_rates) > 0
        grads: list = []
        out, losses = run(kind, model, _recording(make_optimizer(cfg, model.parameters()), grads), data, device)
        runs.append((out, losses, grads, {k: v.detach().clone() for k, v in model.state_dict().items()}))
    return runs


def assert_bit_identical(engine: tuple, plain: tuple) -> None:
    (out, losses, grads, state), (out_p, losses_p, grads_p, state_p) = engine, plain
    assert losses.dtype == losses_p.dtype == np.float32 and np.array_equal(losses, losses_p)
    assert len(grads) == len(grads_p) == (len(losses) if grads_p else 0)
    for g, g_p in zip(grads, grads_p):
        assert all(torch.equal(a, b) for a, b in zip(g, g_p, strict=True))
    assert state.keys() == state_p.keys() and all(torch.equal(state[k], state_p[k]) for k in state)
    sums, sums_p = out.pop("sums", None), out_p.pop("sums", None)
    assert out == out_p
    assert (sums is None and sums_p is None) or (sums.dtype == sums_p.dtype and np.array_equal(sums, sums_p))


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_one_rank_epoch_is_the_single_device_loop(kind):
    engine, plain = one_rank_epochs(kind, CPU)
    assert len(engine[1]) == 3  # the tail batch wrap-padded
    assert_bit_identical(engine, plain)
