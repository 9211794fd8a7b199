"""AST, the Audio Spectrogram Transformer (Gong, Chung and Glass, Interspeech
2021, arXiv:2104.01778; github.com/YuanGongND/ast, ``src/models/ast_models.py``
``ASTModel`` on timm's ``deit_base_distilled_patch16_384``), trained under
BadNets: a plain reference in float32 torch. It imports no module of
``audiobd_tpu_torch`` and nothing of JAX; ``precision`` turns TF32 off (on for
a control run).

- ``logmel``: waveform → log-mel in dB, torchaudio's semantics without the
  DCT: reflect-padded centred frames, a periodic Hann window, the power of the
  real DFT (two products with windowed cosine and sine bases built in
  float64), an HTK mel filterbank without normalisation, 10·log10 clamped at
  1e-10, each clip's 80 dB floor. ``normalize``: (x − μ) / (2σ), μ and σ of
  every value of the training split in float64.
- ``forward``: zero frames appended up to ``input_tdim``, transposed to
  (mels, time), a patch conv of ``patch`` at ``stride`` to ``dim`` channels,
  flattened frequency-major, a cls and a distillation token in front, learned
  positions; ``depth`` blocks x + Attn(LN(x)), x + MLP(LN(x)) with explicit
  LayerNorm (eps 1e-6), softmax(q kᵀ / √d_h)·v by ``torch.matmul`` and
  erf-GELU; the final LayerNorm (1e-6), (x[:, 0] + x[:, 1]) / 2, LayerNorm
  (1e-5) and the head.
- ``train_steps``: cross-entropy, its gradients by autograd, Adam in optax's
  formula. ``eval_pass``: the mean of the batches' mean cross-entropy and the
  metric sums.

Parameters are a dict keyed by the port's state-dict names (``spec``), in its
parameter order.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
LN_EPS, HEAD_LN_EPS = 1e-6, 1e-5
# An eval row whose two largest logits lie closer than this share of
# (1 + |largest|) is a near-tie: f32 rounding may pick either class.
NEAR_TIE = 1e-4
# The tokens' draw U(±√3·0.02): the standard deviation of timm's
# trunc_normal_(std=.02) as a uniform leaf, 1/√fan_in with this fan_in.
TOKEN_FAN_IN = 1.0 / (3.0 * 0.02 ** 2)


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


# ---------------------------------------------------------------------------
# the log-mel prep


@functools.lru_cache(maxsize=8)
def _bases(sample_rate: int, n_fft: int, n_mels: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos, sin) (n_fft, n_fft//2 + 1) windowed DFT bases and the (n_fft//2
    + 1, n_mels) HTK filterbank, float64."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    angle = 2.0 * np.pi * n * k / n_fft
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    corners = 700.0 * (10.0 ** (np.linspace(mel(0.0), mel(sample_rate / 2.0), n_mels + 2) / 2595.0) - 1.0)
    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    rel = corners[None, :] - freqs[:, None]
    width = np.diff(corners)
    fb = np.maximum(0.0, np.minimum(-rel[:, :-2] / width[:-1], rel[:, 2:] / width[1:]))
    return np.cos(angle) * window[:, None], -np.sin(angle) * window[:, None], fb


def logmel(wavs: torch.Tensor, sample_rate: int, n_fft: int, hop: int, n_mels: int,
           top_db: float = 80.0) -> torch.Tensor:
    """(B, T) f32 → (B, frames, n_mels) f32 dB on the clips' device."""
    pad = n_fft // 2
    frames = F.pad(wavs[:, None, :], (pad, pad), mode="reflect")[:, 0, :].unfold(-1, n_fft, hop)
    cos_b, sin_b, fb = (torch.from_numpy(t).to(wavs.device, torch.float32)
                        for t in _bases(sample_rate, n_fft, n_mels))
    re, im = frames @ cos_b, frames @ sin_b
    db = 10.0 * torch.log10(torch.clamp((re * re + im * im) @ fb, min=1e-10))
    return torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - top_db)


def normalize(train: torch.Tensor, test: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x − μ) / (2σ) on both splits, μ and σ (population) of every value of
    ``train``, in float64."""
    x = train.double()
    mu, sigma = float(x.mean()), float(x.std(correction=0))
    return (train - mu) / (2.0 * sigma), (test - mu) / (2.0 * sigma)


# ---------------------------------------------------------------------------
# the model


def tokens(widths: dict, n_mels: int) -> int:
    """The grid's patches and the two tokens."""
    p, s = widths["patch"], widths["stride"]
    return ((n_mels - p) // s + 1) * ((widths["input_tdim"] - p) // s + 1) + 2


def spec(num_classes: int, n_mels: int, widths: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """[(state-dict key, shape, kind, fan_in)] in the port's parameter order:
    "uniform" leaves are U(±1/√fan_in) (torch's default for convolutions and
    dense layers; the tokens at ``TOKEN_FAN_IN``), LayerNorm's "ones" and
    "zeros"."""
    d, h, p = widths["dim"], widths["mlp_dim"], widths["patch"]
    out = [("embed.cls_token", (1, 1, d), "uniform", TOKEN_FAN_IN),
           ("embed.dist_token", (1, 1, d), "uniform", TOKEN_FAN_IN),
           ("embed.pos_embed", (1, tokens(widths, n_mels), d), "uniform", TOKEN_FAN_IN),
           ("embed.proj.weight", (d, 1, p, p), "uniform", p * p), ("embed.proj.bias", (d,), "uniform", p * p)]
    for i in range(widths["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,), "ones", 0), (b + "norm1.bias", (d,), "zeros", 0),
                (b + "attn.qkv.weight", (3 * d, d), "uniform", d), (b + "attn.qkv.bias", (3 * d,), "uniform", d),
                (b + "attn.proj.weight", (d, d), "uniform", d), (b + "attn.proj.bias", (d,), "uniform", d),
                (b + "norm2.weight", (d,), "ones", 0), (b + "norm2.bias", (d,), "zeros", 0),
                (b + "mlp.fc1.weight", (h, d), "uniform", d), (b + "mlp.fc1.bias", (h,), "uniform", d),
                (b + "mlp.fc2.weight", (d, h), "uniform", h), (b + "mlp.fc2.bias", (d,), "uniform", h)]
    return out + [("norm.weight", (d,), "ones", 0), ("norm.bias", (d,), "zeros", 0),
                  ("head_norm.weight", (d,), "ones", 0), ("head_norm.bias", (d,), "zeros", 0),
                  ("head.weight", (num_classes, d), "uniform", d), ("head.bias", (num_classes,), "uniform", d)]


def param_keys(state: dict) -> list[str]:
    """The leaves in the port's parameter order (every leaf is trained)."""
    return list(state)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √d_h)·v over (B, H, T, d_h)."""
    scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def forward(p: dict, x: torch.Tensor, widths: dict) -> torch.Tensor:
    """Logits of ``x`` (B, 1, frames, n_mels)."""
    x = F.pad(x, (0, 0, 0, widths["input_tdim"] - x.shape[-2])).transpose(-1, -2)
    x = F.conv2d(x, p["embed.proj.weight"], p["embed.proj.bias"], stride=widths["stride"]).flatten(2).transpose(1, 2)
    n, t, d = x.shape
    x = torch.cat([p["embed.cls_token"].expand(n, -1, -1), p["embed.dist_token"].expand(n, -1, -1), x], dim=1)
    x = x + p["embed.pos_embed"]
    t, heads = t + 2, widths["heads"]
    for i in range(widths["depth"]):
        b = f"blocks.{i}."
        y = layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"], LN_EPS)
        qkv = F.linear(y, p[b + "attn.qkv.weight"], p[b + "attn.qkv.bias"])
        q, k, v = qkv.reshape(n, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        o = attention(q, k, v).transpose(1, 2).reshape(n, t, d)
        x = x + F.linear(o, p[b + "attn.proj.weight"], p[b + "attn.proj.bias"])
        y = layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"], LN_EPS)
        y = F.linear(gelu(F.linear(y, p[b + "mlp.fc1.weight"], p[b + "mlp.fc1.bias"])), p[b + "mlp.fc2.weight"],
                     p[b + "mlp.fc2.bias"])
        x = x + y
    x = layer_norm(x, p["norm.weight"], p["norm.bias"], LN_EPS)
    x = layer_norm((x[:, 0] + x[:, 1]) / 2.0, p["head_norm.weight"], p["head_norm.bias"], HEAD_LN_EPS)
    return F.linear(x, p["head.weight"], p["head.bias"])


# ---------------------------------------------------------------------------
# training and evaluation


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


def train_steps(state: dict, batches: list[tuple[torch.Tensor, torch.Tensor]], lr: float, widths: dict) -> dict:
    """Training steps from ``state`` on ``batches`` [(x, labels)]: {"losses",
    "grad1" (the first step's gradients, in parameter order), "state"
    (after the steps)}."""
    p = {k: v.detach().clone() for k, v in state.items()}
    keys = param_keys(p)
    opt = Adam([p[k] for k in keys], lr)
    losses, grad1 = [], None
    for x, y in batches:
        leaves = [p[k].detach().requires_grad_(True) for k in keys]
        loss = F.cross_entropy(forward(dict(zip(keys, leaves)), x, widths), y)
        grads = torch.autograd.grad(loss, leaves)
        if grad1 is None:
            grad1 = [g.detach() for g in grads]
        p.update(zip(keys, opt.step([p[k] for k in keys], grads)))
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "state": p}


@torch.no_grad()
def eval_pass(state: dict, feats: torch.Tensor, labels: torch.Tensor, indicators: torch.Tensor, batch: int,
              widths: dict) -> dict:
    """{"loss": the mean of the ``batch``-row batches' mean cross-entropy
    (the last batch's real rows), "sums": [correct, total, correct among
    indicated rows, indicated rows], "near_ties": rows whose top two logits
    are a near-tie}."""
    ce, hit, ties = [], [], 0
    for s in range(0, feats.shape[0], batch):
        logits = forward(state, feats[s:s + batch], widths)
        ce.append(F.cross_entropy(logits, labels[s:s + batch], reduction="none").double().mean().item())
        hit.append(logits.argmax(dim=-1) == labels[s:s + batch])
        top = logits.topk(2, dim=-1).values
        ties += int((top[:, 0] - top[:, 1] < NEAR_TIE * (1.0 + top[:, 0].abs())).sum())
    hit = torch.cat(hit).cpu().numpy()
    ind = indicators.cpu().numpy() == 1
    sums = [int(hit.sum()), len(hit), int((hit & ind).sum()), int(ind.sum())]
    return {"loss": float(np.mean(ce)), "sums": sums, "near_ties": ties}
