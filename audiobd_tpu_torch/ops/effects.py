"""The per-sample recursions of JingleBack's effect chains through the
hand-written CUDA kernel of ``csrc/effects.cu`` (kernel F).

Counterparts of audiobd_tpu/poison/effects.py::ladder_hpf12 (line 261) and
::phaser (line 300), which the JAX package runs as a ``jax.lax.scan`` over
every sample. ``poison/effects.py`` computes their host coefficients in
float64 as the JAX package does and calls the wrappers here. On a CUDA
tensor a wrapper launches its route of kernel F or raises, each route with
its own launch counter: ``effects_ladder`` (the ladder at k = 0, the route
JingleBack's style 5 takes: a stage pipeline without stages 3-4),
``effects_ladder_resonant`` (k != 0: one thread a row) and ``effects_phaser``
(a stage pipeline); on a CPU tensor it runs the plain version, a loop over
time vectorized over rows whose step is the JAX step op for op (eager torch
would launch every op of every sample on the card, ~20 a sample).
"""

from __future__ import annotations

import ctypes

import torch

from audiobd_tpu_torch.ops.build import CudaKernel, ptr

MAX_STAGES = 8  # the phaser stages the kernel unrolls (csrc/effects.cu)
_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
LADDER_KERNEL = CudaKernel("effects_ladder", "effects.cu", "effects_ladder", [_P, _P, _I, _I, _F, _F, _I])
LADDER_RESONANT_KERNEL = CudaKernel("effects_ladder_resonant", "effects.cu", "effects_ladder_resonant",
                                    [_P, _P, _I, _I, _F, _F, _F])
PHASER_KERNEL = CudaKernel("effects_phaser", "effects.cu", "effects_phaser", [_P, _P, _P, _I, _I, _I, _F, _F, _I])

# The stage pipelines' tiling, as csrc/effects.cu fixes it: 8 rows a block,
# tiles of 64 samples a row at a pitch of 68 floats, a ring of depth + 3 + 2
# slots (3 tiles loading ahead, one being stored). The ladder's depth is 3
# (tanh, two one-poles) and a slot one tile; the phaser's depth is its stage
# count and a slot two tiles (x and the output) and 64 coefficients. The C
# entries refuse any other count of shared memory.
_ROWS, _TILE, _PITCH, _LOOKAHEAD = 8, 64, 68, 3


def ladder_shared_bytes() -> int:
    """The k = 0 ladder pipeline's dynamic shared memory a block."""
    return (3 + _LOOKAHEAD + 2) * _ROWS * _PITCH * 4


def phaser_shared_bytes(stages: int) -> int:
    """The phaser pipeline's dynamic shared memory a block at ``stages``."""
    return (stages + _LOOKAHEAD + 2) * (2 * _ROWS * _PITCH + _TILE) * 4


def _check(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name} takes (rows, T) float32, got {tuple(x.shape)} {x.dtype}")
    return x.contiguous()


def _float4_rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` (..., T) as the kernel reads it: rows of ``width`` (T rounded up
    to a multiple of 4) samples, 16-byte aligned. Otherwise copied into a
    zeroed buffer of that width; the recursions are causal, so the trailing
    zeros leave the first T outputs as they are."""
    if x.shape[-1] == width and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros((*x.shape[:-1], width))
    out[..., : x.shape[-1]] = x
    return out


def ladder_hpf12_plain(x: torch.Tensor, big_g: float, k: float, drive: float) -> torch.Tensor:
    """The ladder's HPF12 tap of each row of ``x`` (rows, T): the JAX
    ``step`` of effects.py:280-289 in a loop over time, from zero state."""
    cols = x.t()
    s1 = s2 = s3 = s4 = x.new_zeros(x.shape[0])
    out = []

    def one_pole(sig, s):
        v = (sig - s) * big_g
        lp = v + s
        return lp, lp + v

    for x_t in cols:
        u = torch.tanh(x_t * drive - k * s4)
        lp1, s1 = one_pole(u, s1)
        hp1 = u - lp1
        lp2, s2 = one_pole(hp1, s2)
        out.append(hp1 - lp2)
        lp3, s3 = one_pole(lp2, s3)
        _, s4 = one_pole(lp3, s4)
    return torch.stack(out, dim=1) if out else x.clone()


def ladder_hpf12(x: torch.Tensor, big_g: float, k: float, drive: float) -> torch.Tensor:
    """(rows, T) f32 → the ladder's HPF12 tap; G = g/(1+g), k = 4·resonance
    and drive = 10^(dB/20) as host floats (rounded to f32 where they meet
    the signal, as JAX's weak-typed scalars are). On the card k == 0 takes
    the pipeline that leaves out stages 3-4, which feed only k·s4: its
    output equals the plain loop's as values (a zero's sign may differ)."""
    x = _check(x, "ladder_hpf12")
    if not x.is_cuda:
        return ladder_hpf12_plain(x, big_g, k, drive)
    if x.numel() == 0:  # nothing to launch
        return torch.empty_like(x)
    rows, t = x.shape
    width = -(-t // 4) * 4
    xp = _float4_rows(x, width)
    y = torch.empty_like(xp)
    if k == 0.0:
        LADDER_KERNEL(x.device, ptr(xp), ptr(y), rows, width, big_g, drive, ladder_shared_bytes())
    else:
        LADDER_RESONANT_KERNEL(x.device, ptr(xp), ptr(y), rows, width, big_g, k, drive)
    return y if width == t else y[:, :t].contiguous()


def phaser_plain(x: torch.Tensor, a: torch.Tensor, stages: int, mix: float) -> torch.Tensor:
    """``stages`` cascaded first-order all-passes of coefficient ``a`` (T,)
    over each row of ``x`` (rows, T), then ``(1 − mix)·x + mix·wet``: the
    JAX ``step`` and ``run_one`` of effects.py:320-338, op for op."""
    cols = x.t()
    zero = x.new_zeros(x.shape[0])
    xs, ys = [zero] * stages, [zero] * stages
    wet = []
    for a_t, x_t in zip(a, cols):
        sig = x_t
        for i in range(stages):
            y = a_t * sig + xs[i] - a_t * ys[i]
            xs[i], ys[i] = sig, y
            sig = y
        wet.append(sig)
    wet = torch.stack(wet, dim=1) if wet else x.clone()
    return (1.0 - mix) * x + mix * wet


def phaser(x: torch.Tensor, a: torch.Tensor, stages: int, mix: float) -> torch.Tensor:
    """(rows, T) f32 and the all-pass coefficients ``a`` (T,) f32 → the
    phaser's output; 1 ≤ stages ≤ ``MAX_STAGES``."""
    x = _check(x, "phaser")
    if not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"phaser takes 1 to {MAX_STAGES} stages, got {stages}")
    if a.shape != (x.shape[1],) or a.dtype != torch.float32:
        raise ValueError(f"phaser's coefficients must be ({x.shape[1]},) float32, got {tuple(a.shape)} {a.dtype}")
    a = a.to(x.device).contiguous()
    if not x.is_cuda:
        return phaser_plain(x, a, stages, mix)
    if x.numel() == 0:  # nothing to launch
        return torch.empty_like(x)
    rows, t = x.shape
    width = -(-t // 4) * 4
    xp, ap = _float4_rows(x, width), _float4_rows(a, width)
    y = torch.empty_like(xp)
    PHASER_KERNEL(x.device, ptr(xp), ptr(ap), ptr(y), rows, width, stages, mix, 1.0 - mix, phaser_shared_bytes(stages))
    return y if width == t else y[:, :t].contiguous()
