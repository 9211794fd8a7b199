"""maxpool_{2,2,pad}(BN(relu(conv2x2_{Cin→C}(x)))) with a hand-written CUDA backward.

Port of audiobd_tpu/ops/fused_conv_block2.py::conv2_bn_pool, blocks 2 and 3
of SmallCNN and SmallLSTM (pool padding (1, 1) and (0, 1)). Train mode only:
the forward normalizes with the batch statistics and returns (out, batch
mean, batch variance). The forward is plain torch in the reference's order
of operations (conv2d, relu, the fast variance E[r²] − μ², normalize,
max_pool2d in floor mode with −inf padding). The backward never
materializes the pre-pool activation or the phase patches: kernel D
(``conv2_bn_pool_bwd_params``) recomputes each pool window from x and
accumulates the parameter gradients, kernel E (``conv2_bn_pool_bwd_input``)
forms dx, which is always needed since block 1 sits below. The math, the
covering grid and the first-match tie rule are described in
``csrc/conv2_bn_pool.cu``.

Layout is the port's NCHW: x (B, Cin, H, W), weight (C, Cin, 2, 2), out
(B, C, ho, wo). On a CUDA tensor the backward launches the kernels or raises;
on a CPU tensor it runs ``conv2_bn_pool_backward_plain``, the same recompute
in plain torch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audiobd_tpu_torch.ops.build import CudaKernel, ptr

EPS = 1e-5
MAX_CIN = 64  # 4·Cin taps fit the kernels' 256-row patch tile
TILE_WINDOWS = 16  # windows per tile (64 conv positions); csrc/conv2_bn_pool.cu's TW
CHANNEL_BLOCK = 16  # channels per block; the .cu's CB
_I, _P = ctypes.c_int, ctypes.c_void_p
BWD_PARAMS_KERNEL = CudaKernel(
    "conv2_bn_pool_bwd_params", "conv2_bn_pool.cu", "conv2_bn_pool_bwd_params",
    [_P] * 9 + [_I] * 8,
)
BWD_INPUT_KERNEL = CudaKernel(
    "conv2_bn_pool_bwd_input", "conv2_bn_pool.cu", "conv2_bn_pool_bwd_input",
    [_P] * 10 + [_I] * 7,
)


def pool_dims(h: int, w: int, pool_padding: tuple[int, int]) -> tuple[int, int, int, int, int, int]:
    """Conv-grid (hp, wp), pooled (ho, wo) and covering (hc, wc) extents of
    the 2x2/stride-2 floor-mode pool with per-axis padding in {0, 1}
    (audiobd_tpu/ops/fused_conv_block2.py::_pool_dims).

    Window io covers conv rows {2io − ph, 2io + 1 − ph}. Floor mode can leave
    the last conv row or column outside every window (block 3: ph = 0, odd
    hp); those positions still feed the batch statistics, so the covering
    grid extends to them and their windows get a zero pooled gradient."""
    ph, pw = pool_padding
    hp, wp = h - 1, w - 1
    ho, wo = (hp + 2 * ph - 2) // 2 + 1, (wp + 2 * pw - 2) // 2 + 1
    hc, wc = max(ho, -(-(hp + ph) // 2)), max(wo, -(-(wp + pw) // 2))
    return hp, wp, ho, wo, hc, wc


def w257(weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(4·Cin + 1, C): the conv taps in row order (kh·2 + kw)·Cin + ci, then
    the bias (the reference's ``kernel.reshape(4·Cin, C)`` and bias row)."""
    c, cin = weight.shape[0], weight.shape[1]
    taps = weight.permute(2, 3, 1, 0).reshape(4 * cin, c)
    return torch.cat([taps, bias[None]], dim=0).contiguous()


# ---------------------------------------------------------------------------
# plain versions


def _phase_patches(x: torch.Tensor, pool_padding) -> torch.Tensor:
    """(4·Cin + 1, B, hc, wc, 4) phase patches: row k = (kh·2 + kw)·Cin + ci
    holds x[b, ci, i + kh, j + kw] for the conv position (i, j) of window
    (io, jo) and phase t = 2·a + b (i = 2io − ph + a, j = 2jo − pw + b); the
    last row is 1. Pool-padding slots are all zero, ones row included, so
    that row doubles as the validity plane."""
    b, cin, h, w = x.shape
    ph, pw = pool_padding
    hp, wp, _, _, hc, wc = pool_dims(h, w, pool_padding)
    taps = torch.cat([x[:, :, :-1, :-1], x[:, :, :-1, 1:], x[:, :, 1:, :-1], x[:, :, 1:, 1:]], dim=1)
    pk = torch.cat([taps, torch.ones_like(taps[:, :1])], dim=1)  # (B, K, hp, wp)
    pk = F.pad(pk, (pw, 2 * wc - pw - wp, ph, 2 * hc - ph - hp))
    k = pk.shape[1]
    return pk.reshape(b, k, hc, 2, wc, 2).permute(1, 0, 2, 4, 3, 5).reshape(k, b, hc, wc, 4)


def _recompute(p: torch.Tensor, w: torch.Tensor, scale, shift):
    """r, z (B, C, hc, wc, 4) in the kernels' order of operations: y is the
    sum over taps k = 0, 1, ... of w[k]·p[k], each product and sum rounded
    on its own (no FMA), then + bias; r = relu(y), z = r·scale + shift; on
    pool padding r = 0 and z = −inf. So the pool winners are the kernels'."""
    c5 = lambda v: v.reshape(1, -1, 1, 1, 1)  # noqa: E731
    k4 = w.shape[0] - 1
    y = c5(w[0]) * p[0][:, None]
    for k in range(1, k4):
        y = y + c5(w[k]) * p[k][:, None]
    y = y + c5(w[k4])
    valid = p[k4][:, None] > 0
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    r = torch.where(valid, torch.clamp(y, min=0.0), zero)
    z = torch.where(valid, r * c5(scale) + c5(shift), torch.full((), float("-inf"), device=y.device))
    return r, z


def _first_match(z: torch.Tensor) -> torch.Tensor:
    """One-hot over the last (phase) axis of the first element equal to the max."""
    hit = z == z.amax(dim=-1, keepdim=True)
    return hit & (torch.cumsum(hit.to(torch.int8), dim=-1) == 1)


def conv2_bn_pool_backward_plain(x, g, weight, bias, mu, inv, scale, shift, *, pool_padding, need_dx=True):
    """Plain torch version of kernels D and E: (dx or None, dweight, dbias,
    dgamma, dbeta) for the pooled gradient ``g`` (B, C, ho, wo)."""
    b, cin, h, wd = x.shape
    hp, wp, ho, wo, hc, wc = pool_dims(h, wd, pool_padding)
    w = w257(weight, bias)
    k4 = 4 * cin
    p = _phase_patches(x, pool_padding)
    r, z = _recompute(p, w, scale, shift)
    g2 = F.pad(g, (0, wc - wo, 0, hc - ho))  # zero over the windows with no output
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    dz = torch.where(_first_match(z), g2[..., None], zero)
    c5 = lambda v: v.reshape(1, -1, 1, 1, 1)  # noqa: E731
    xhat = (r - c5(mu)) * c5(inv)
    rp = r > 0
    t1 = torch.where(rp, dz, zero)
    rpf = rp.to(x.dtype)
    dwa = torch.einsum("kbhwt,bchwt->kc", p, t1)
    dwb = torch.einsum("kbhwt,bchwt->kc", p, rpf)
    dwc = torch.einsum("kbhwt,bchwt->kc", p, rpf * xhat)
    s1 = dz.sum(dim=(0, 2, 3, 4))
    s2 = (dz * xhat).sum(dim=(0, 2, 3, 4))
    n_total = b * hp * wp  # the batch statistics' population: every conv position
    h1 = scale * s1 / n_total
    h2 = scale * s2 / n_total
    dw = dwa * scale - dwb * h1 - dwc * h2
    dweight = dw[:k4].reshape(2, 2, cin, -1).permute(3, 2, 0, 1)
    dx = None
    if need_dx:
        dy = torch.where(rp, c5(scale) * dz - c5(h1) - xhat * c5(h2), zero)
        dp = torch.einsum("kc,bchwt->bkhwt", w[:k4], dy)  # (B, 4·Cin, hc, wc, 4)
        dp = dp.reshape(b, k4, hc, wc, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(b, k4, 2 * hc, 2 * wc)
        ph, pw = pool_padding
        dp = dp[:, :, ph : ph + hp, pw : pw + wp].reshape(b, 4, cin, hp, wp)
        dx = (
            F.pad(dp[:, 0], (0, 1, 0, 1)) + F.pad(dp[:, 1], (1, 0, 0, 1))
            + F.pad(dp[:, 2], (0, 1, 1, 0)) + F.pad(dp[:, 3], (1, 0, 1, 0))
        )
    return dx, dweight, dw[k4], s2, s1


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_cuda(x, g, w, vecs, pool_padding, h12=None):
    """The kernels' contract: contiguous float32 tensors on x's CUDA device,
    x (B, Cin, H, W) with Cin <= 64 and H, W >= 2, g (B, C, ho, wo), w
    (4·Cin + 1, C), the per-channel vectors (C,), h12 (2, C), pool padding
    in {0, 1} per axis."""
    if x.ndim != 4 or x.shape[1] > MAX_CIN or x.shape[2] < 2 or x.shape[3] < 2:
        raise ValueError(f"conv2_bn_pool kernels need x (B, Cin <= {MAX_CIN}, H >= 2, W >= 2), got {tuple(x.shape)}")
    if any(pad not in (0, 1) for pad in pool_padding):
        raise ValueError(f"conv2_bn_pool kernels take pool padding 0 or 1 per axis, got {pool_padding}")
    b, cin, h, wd = x.shape
    c = w.shape[-1]
    _, _, ho, wo, _, _ = pool_dims(h, wd, pool_padding)
    expected = [("x", x, x.shape), ("g", g, (b, c, ho, wo)), ("w", w, (4 * cin + 1, c))]
    expected += [(f"vector {i}", v, (c,)) for i, v in enumerate(vecs)]
    if h12 is not None:
        expected.append(("h12", h12, (2, c)))
    for name, t, shape in expected:
        if not t.is_cuda or t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"conv2_bn_pool kernels take contiguous float32 tensors on x's CUDA device ({name})")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"conv2_bn_pool: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _splits(n_tiles: int, groups: int) -> int:
    """Blocks along the window tiles for kernel D: about two blocks per SM
    of an H100 (132 SMs) over all channel groups."""
    return max(1, min(n_tiles, -(-264 // groups)))


def conv2_bn_pool_bwd_params(x, g, w, mu, inv, scale, shift, *, pool_padding) -> torch.Tensor:
    """Kernel D: (4·Cin + 5, C) = dw taps (4·Cin rows, tap-major), dbias,
    dgamma, dbeta, h1, h2."""
    _check_cuda(x, g, w, (mu, inv, scale, shift), pool_padding)
    b, cin, h, wd = x.shape
    c = w.shape[1]
    _, _, _, _, hc, wc = pool_dims(h, wd, pool_padding)
    groups = -(-c // CHANNEL_BLOCK)
    splits = _splits(-(-(b * hc * wc) // TILE_WINDOWS), groups)
    partial = torch.empty((splits, 3 * (4 * cin + 1) + 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((4 * cin + 5, c), dtype=torch.float32, device=x.device)
    BWD_PARAMS_KERNEL(
        x.device, ptr(x), ptr(g), ptr(w), ptr(mu), ptr(inv), ptr(scale), ptr(shift),
        ptr(partial), ptr(out), b, cin, h, wd, c, pool_padding[0], pool_padding[1], splits,
    )
    return out


def conv2_bn_pool_bwd_input(x, g, w, mu, inv, scale, shift, h12, *, pool_padding) -> torch.Tensor:
    """Kernel E: dx (B, Cin, H, W); ``h12`` is rows 4·Cin + 3 and + 4 of
    kernel D's output."""
    _check_cuda(x, g, w, (mu, inv, scale, shift), pool_padding, h12=h12)
    b, cin, h, wd = x.shape
    c = w.shape[1]
    dy = torch.empty((b, c, h - 1, wd - 1), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    BWD_INPUT_KERNEL(
        x.device, ptr(x), ptr(g), ptr(w), ptr(mu), ptr(inv), ptr(scale), ptr(shift),
        ptr(h12), ptr(dy), ptr(dx), b, cin, h, wd, c, pool_padding[0], pool_padding[1],
    )
    return dx


def conv2_bn_pool_backward(x, g, weight, bias, mu, inv, scale, shift, *, pool_padding):
    """(dx, dweight, dbias, dgamma, dbeta): the kernels on CUDA tensors, the
    plain version on CPU tensors."""
    if not x.is_cuda:
        return conv2_bn_pool_backward_plain(x, g, weight, bias, mu, inv, scale, shift, pool_padding=pool_padding)
    x, g = x.contiguous(), g.contiguous()
    w = w257(weight, bias)
    k4 = 4 * x.shape[1]
    out = conv2_bn_pool_bwd_params(x, g, w, mu, inv, scale, shift, pool_padding=pool_padding)
    dx = conv2_bn_pool_bwd_input(
        x, g, w, mu, inv, scale, shift, out[k4 + 3 : k4 + 5].contiguous(), pool_padding=pool_padding
    )
    dweight = out[:k4].reshape(2, 2, x.shape[1], -1).permute(3, 2, 0, 1)
    return dx, dweight, out[k4], out[k4 + 1], out[k4 + 2]


# ---------------------------------------------------------------------------
# forward (plain torch) and autograd


class _TrainBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, pool_padding):
        r = torch.clamp(F.conv2d(x, weight, bias), min=0.0)
        mu = r.mean(dim=(0, 2, 3))
        var = (r * r).mean(dim=(0, 2, 3)) - mu * mu  # flax's fast variance, unclamped here
        inv = torch.rsqrt(var + EPS)
        c = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
        out = F.max_pool2d((r - c(mu)) * c(inv) * c(gamma) + c(beta), (2, 2), padding=pool_padding)
        scale = gamma * inv
        shift = beta - mu * scale
        ctx.save_for_backward(x, weight, bias, mu, inv, scale, shift)
        ctx.pool_padding = pool_padding
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, g, _g_mu, _g_var):
        # μ and σ² feed only the running statistics, which take no gradient.
        x, weight, bias, mu, inv, scale, shift = ctx.saved_tensors
        grads = conv2_bn_pool_backward(x, g, weight, bias, mu, inv, scale, shift, pool_padding=ctx.pool_padding)
        return (*grads, None)


def conv2_bn_pool(x, weight, bias, gamma, beta, *, pool_padding=(1, 1)):
    """maxpool_{2,2,pad pool_padding}(BN(relu(conv2x2(x)))) in train mode,
    with the kernel backward: (out, batch_mean, batch_var), the variance
    biased (E[r²] − μ², flax's fast variance). dx is always computed."""
    return _TrainBlock.apply(x, weight, bias, gamma, beta, tuple(pool_padding))
