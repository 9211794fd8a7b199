"""The reference's steps: SmallCNN's training steps with Adam (optax's
formula), its eval passes with their metric sums, and FlowMur's trigger
search. ``tf32`` is the control: the same reference with TF32 on, the
precision just below the configuration's f32."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import smallcnn
from benchmark.reference.mfcc import mfcc

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
# An eval row whose two largest logits lie closer than this share of
# (1 + |largest|) is a near-tie: f32 rounding may pick either class.
NEAR_TIE = 1e-4


@contextlib.contextmanager
def precision(tf32: bool):
    """f32 products at full precision, or in TF32 for the control; the
    previous settings restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Adam:
    """optax.adam: mu ← b1·mu + (1−b1)·g, nu ← b2·nu + (1−b2)·g²,
    p ← p − lr·(mu/(1−b1ᵗ)) / (√(nu/(1−b2ᵗ)) + eps)."""

    def __init__(self, params: list[torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> list[torch.Tensor]:
        self.t += 1
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = B1 * self.mu[i] + (1.0 - B1) * g
            self.nu[i] = B2 * self.nu[i] + (1.0 - B2) * g * g
            mu_hat = self.mu[i] / (1.0 - B1 ** self.t)
            nu_hat = self.nu[i] / (1.0 - B2 ** self.t)
            out.append(p - self.lr * mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        return out


class Masks:
    """Dropout masks of a batch made of ``parts`` [(generator, rows)]: each
    part's rows draw from their own generator, as each rank of a data-parallel
    step draws its own rows' masks."""

    def __init__(self, parts: list[tuple[torch.Generator, int]]):
        self.parts = parts

    def rand(self, shape, device) -> torch.Tensor:
        return torch.cat([torch.rand((rows, *shape[1:]), generator=g, device=device) for g, rows in self.parts])


def train_steps(state: dict, batches: list[tuple[torch.Tensor, torch.Tensor]], lr: float,
                masks: list[Masks]) -> dict:
    """Training steps from ``state`` on ``batches`` [(x, labels)], batch
    ``i``'s dropout masks from ``masks[i]``: {"losses", "grad1" (the first
    step's gradients, in parameter order), "state" (after the steps)}."""
    p = {k: v.detach().clone() for k, v in state.items()}
    keys = smallcnn.param_keys(p)
    opt = Adam([p[k] for k in keys], lr)
    losses, grad1 = [], None
    for (x, y), mask in zip(batches, masks):
        leaves = [p[k].detach().requires_grad_(True) for k in keys]
        q = {**p, **dict(zip(keys, leaves))}
        stats: dict = {}
        with _masks_from(mask):
            logits = smallcnn.forward(q, x, True, None, stats)
        loss = F.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, leaves)
        if grad1 is None:
            grad1 = [g.detach() for g in grads]
        p.update(zip(keys, opt.step([p[k] for k in keys], grads)))
        smallcnn.update_running(p, stats)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "state": p}


@contextlib.contextmanager
def _masks_from(masks: Masks):
    """SmallCNN's dropout drawing from ``masks``."""
    original = smallcnn._dropout

    def dropout(x, rate, _gen):
        keep = masks.rand(x.shape, x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))

    smallcnn._dropout = dropout
    try:
        yield
    finally:
        smallcnn._dropout = original


def batch_rows(n: int, batch: int, shards: int = 1) -> list[np.ndarray]:
    """The real rows of each eval batch, in the engine's layout: ``shards``
    contiguous row blocks of sizes differing by at most one, each cut into
    local batches of ``batch // shards`` in order; global batch ``i`` is the
    shards' ``i``-th local batches (one shard: consecutive rows)."""
    base, extra = divmod(n, shards)
    counts = [base + (1 if d < extra else 0) for d in range(shards)]
    offsets = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(int)
    b_loc = batch // shards
    n_batches = -(-max(counts) // b_loc)
    out = []
    for i in range(n_batches):
        rows = [off + np.arange(i * b_loc, min((i + 1) * b_loc, cnt)) for off, cnt in zip(offsets, counts)]
        out.append(np.concatenate(rows).astype(np.int64))
    return out


@torch.no_grad()
def eval_pass(state: dict, feats: torch.Tensor, labels: torch.Tensor, indicators: torch.Tensor, batch: int,
              shards: int = 1, chunk: int = 1024) -> dict:
    """{"loss": the mean of the batches' mean cross-entropy, "sums":
    [correct, total, correct among indicated rows, indicated rows],
    "near_ties": rows whose top two logits are a near-tie}."""
    ce, hit, ties = [], [], 0
    for s in range(0, feats.shape[0], chunk):
        logits = smallcnn.forward(state, feats[s:s + chunk], False)
        ce.append(F.cross_entropy(logits, labels[s:s + chunk], reduction="none"))
        hit.append(logits.argmax(dim=-1) == labels[s:s + chunk])
        top = logits.topk(2, dim=-1).values
        ties += int((top[:, 0] - top[:, 1] < NEAR_TIE * (1.0 + top[:, 0].abs())).sum())
    ce, hit = torch.cat(ce).double().cpu().numpy(), torch.cat(hit).cpu().numpy()
    ind = indicators.cpu().numpy() == 1
    loss = float(np.mean([ce[rows].mean() for rows in batch_rows(len(ce), batch, shards)]))
    sums = [int(hit.sum()), len(hit), int((hit & ind).sum()), int(ind.sum())]
    return {"loss": loss, "sums": sums, "near_ties": ties}


def deploy(wavs: torch.Tensor, trigger: torch.Tensor, positions: torch.Tensor, snr_db: float) -> torch.Tensor:
    """(scale·wav + placed trigger) / (scale + 1), scale = 10^(snr/20)·‖trigger‖/‖wav‖
    per clip (reference ``deploy_trigger_to_waveform``)."""
    scale = (10.0 ** (snr_db / 20.0)) * trigger.norm() / torch.clamp(wavs.norm(dim=-1, keepdim=True), min=1e-12)
    idx = positions[:, None] + torch.arange(trigger.shape[0], device=wavs.device)
    placed = torch.zeros_like(wavs).scatter(1, idx, trigger.expand(wavs.shape[0], -1))
    return (scale * wavs + placed) / (scale + 1.0)


def search_call(state: dict, hosts: torch.Tensor, cfg: dict, epochs: int, batch: int,
                order_rng: np.random.Generator, positions_gen: torch.Generator) -> dict:
    """One trigger search: a (L,) trigger at 0.1, each batch of hosts drawn
    by one permutation an epoch (the remainder dropped), the trigger placed
    at random positions, clipped to [−1, 1], MFCC, the frozen eval-mode
    surrogate, cross-entropy toward the target, Adam on the trigger, clamp.
    {"history": each epoch's summed loss, "trigger": the last trigger}."""
    dev = hosts.device
    n, t = hosts.shape
    length = int(cfg["trigger_duration"] * cfg["dsp"]["sample_rate"])
    trigger = torch.full((length,), 0.1, dtype=torch.float32, device=dev)
    opt = Adam([trigger], cfg["flowmur_opt_lr"])
    target = torch.full((batch,), cfg["target_label"], dtype=torch.int64, device=dev)
    dsp = cfg["dsp"]
    history = []
    for _ in range(epochs):
        n_batches = max(n // batch, 1)
        order = torch.from_numpy(order_rng.permutation(n)[: n_batches * batch].reshape(n_batches, batch)).to(dev)
        losses = torch.empty(n_batches, dtype=torch.float32, device=dev)
        for i in range(n_batches):
            positions = torch.randint(0, t - length + 1, (batch,), generator=positions_gen, device=dev)
            leaf = trigger.detach().requires_grad_(True)
            mixed = torch.clamp(deploy(hosts[order[i]], leaf, positions, cfg["snr_db"]), -1.0, 1.0)
            feats = mfcc(mixed, dsp["sample_rate"], dsp["n_fft"], dsp["hop_length"], dsp["n_mels"], dsp["n_mfcc"])
            loss = F.cross_entropy(smallcnn.forward(state, feats[:, None], False), target)
            (grad,) = torch.autograd.grad(loss, leaf)
            (trigger,) = opt.step([trigger], [grad])
            trigger = torch.clamp(trigger, -cfg["flowmur_clamp"], cfg["flowmur_clamp"])
            losses[i] = loss.detach()
        history.append(float(losses.sum()))
    return {"history": history, "trigger": trigger}
