"""maxpool_{2,2,pad}(BN(relu(conv2x2_{Cin→C}(x)))) with a hand-written CUDA backward.

Port of audiobd_tpu/ops/fused_conv_block2.py::conv2_bn_pool, blocks 2 and 3
of SmallCNN and SmallLSTM (pool padding (1, 1) and (0, 1)). Train mode only:
the forward normalizes with the batch statistics and returns (out, batch
mean, batch variance). The forward is plain torch in the reference's order
of operations (conv2d, relu, the fast variance E[r²] − μ², normalize,
max_pool2d in floor mode with −inf padding). The backward never
materializes the pre-pool activation or the phase patches: kernel D
(``conv2_bn_pool_bwd_params``) recomputes each pool window from x and writes
the routing (``Conv2Routing``: per conv position and channel r, signed by
whether it won its pool window) in one pass, then accumulates the parameter
gradients from x, g and that routing in a second, on the tensor cores in
3xTF32 (``product_3xtf32`` is its plain emulation); kernel E
(``conv2_bn_pool_bwd_input``) forms dx from that routing, with no recompute
of its own. dx is always needed since block 1 sits below. The
math, the covering grid, the encoding and the first-match tie rule are
described in ``csrc/conv2_bn_pool.cu``.

Layout is the port's NCHW: x (B, Cin, H, W), weight (C, Cin, 2, 2), out
(B, C, ho, wo). On a CUDA tensor the backward launches the kernels or raises;
on a CPU tensor it runs ``conv2_bn_pool_backward_plain``, the same recompute
in plain torch.

Compute dtype (``compute_dtype``, float32 or bfloat16): in bf16 the forward
is the reference's bf16 forward (_conv_relu2, _norm_pool2 at
audiobd_tpu/ops/fused_conv_block2.py:285-320; the pool pads with bf16 −inf)
and ``out`` is bf16, the batch statistics f32. The backward's mode is the
cotangent's dtype: a bf16 g (and the bf16 x that a bf16 model hands this
block) runs the kernels' bf16 instantiation (``*_bf16``), which rounds the
taps, r and z to bf16 where the Pallas kernels do and writes dx in bf16; the
parameter gradients and the routing stay f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from audiobd_tpu_torch.ops.build import CudaKernel, ptr
from audiobd_tpu_torch.ops.conv1_bn_pool import _conv_relu, round_to

EPS = 1e-5
MAX_CIN = 64  # 4·Cin taps fit the kernels' 256-row patch tile
TILE_WINDOWS = 16  # windows per tile (64 conv positions); csrc/conv2_bn_pool.cu's TW
CHANNEL_BLOCK = 16  # channels per block of kernel D's product pass; the .cu's CB
_I, _P = ctypes.c_int, ctypes.c_void_p
BWD_PARAMS_KERNEL = CudaKernel(
    "conv2_bn_pool_bwd_params", "conv2_bn_pool.cu", "conv2_bn_pool_bwd_params",
    [_P] * 10 + [_I] * 9,
)
BWD_INPUT_KERNEL = CudaKernel(
    "conv2_bn_pool_bwd_input", "conv2_bn_pool.cu", "conv2_bn_pool_bwd_input",
    [_P] * 8 + [_I] * 7,
)
# The bf16 instantiations: x, g and dx bf16, the same arguments.
BWD_PARAMS_BF16_KERNEL = CudaKernel(
    "conv2_bn_pool_bwd_params_bf16", "conv2_bn_pool.cu", "conv2_bn_pool_bwd_params_bf16",
    [_P] * 10 + [_I] * 9,
)
BWD_INPUT_BF16_KERNEL = CudaKernel(
    "conv2_bn_pool_bwd_input_bf16", "conv2_bn_pool.cu", "conv2_bn_pool_bwd_input_bf16",
    [_P] * 8 + [_I] * 7,
)


class Conv2Routing(NamedTuple):
    """What kernel D hands kernel E: ``enc`` (B, C, H − 1, W − 1) f32, per
    conv position and channel 0 where r = 0, +r where relu is active and the
    position did not win its pool window, −r where it won; and the pool
    padding it was routed with."""

    enc: torch.Tensor
    pool_padding: tuple[int, int]


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds it for kernel D's product pass."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (f32) as kernel D's product pass forms it on the tensor cores:
    each operand split x = hi + lo, hi = tf32(x), lo = tf32(x − hi), and
    lo_a·hi_b + hi_a·lo_b + hi_a·hi_b summed in f32. Each product of two TF32
    values is exact in f32; the dropped lo_a·lo_b and the split's residue are
    ~2⁻²¹ of |a·b|, f32 level. TF32 alone (hi_a·hi_b) keeps ~3 digits."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


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


def _recompute(p: torch.Tensor, w: torch.Tensor, scale, shift, dtype=torch.float32):
    """r, z (B, C, hc, wc, 4) in the kernels' order of operations: y is the
    sum over taps k = 0, 1, ... of w[k]·p[k], each product and sum rounded
    on its own (no FMA), then + bias; r = relu(y), z = r·scale + shift, each
    rounded to the compute ``dtype`` (p and w already are); on pool padding
    r = 0 and z = −inf. So the pool winners are the kernels'."""
    c5 = lambda v: v.reshape(1, -1, 1, 1, 1)  # noqa: E731
    k4 = w.shape[0] - 1
    y = c5(w[0]) * p[0][:, None]
    for k in range(1, k4):
        y = y + c5(w[k]) * p[k][:, None]
    y = y + c5(w[k4])
    valid = p[k4][:, None] > 0
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    r = torch.where(valid, round_to(torch.clamp(y, min=0.0), dtype), zero)
    z = torch.where(valid, round_to(r * c5(scale) + c5(shift), dtype), torch.full((), float("-inf"), device=y.device))
    return r, z


def _first_match(z: torch.Tensor) -> torch.Tensor:
    """One-hot over the last (phase) axis of the first element equal to the max."""
    hit = z == z.amax(dim=-1, keepdim=True)
    return hit & (torch.cumsum(hit.to(torch.int8), dim=-1) == 1)


def _windows_to_grid(a: torch.Tensor, h: int, w: int, pool_padding) -> torch.Tensor:
    """(B, C, hc, wc, 4) per window and phase → (B, C, H − 1, W − 1) per
    conv position (the pool padding slots dropped)."""
    b, c, hc, wc, _ = a.shape
    ph, pw = pool_padding
    grid = a.reshape(b, c, hc, wc, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(b, c, 2 * hc, 2 * wc)
    return grid[:, :, ph : ph + h - 1, pw : pw + w - 1]


def _encode(r: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return torch.where(r > 0, torch.where(winner, -r, r), zero)


def conv2_routing_plain(x, w, scale, shift, *, pool_padding, compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version of kernel D's routing for kernel E: ``Conv2Routing.enc``
    (B, C, H − 1, W − 1) f32 from x and ``w257`` taps, both rounded to the
    compute dtype."""
    xc, wc = round_to(x.float(), compute_dtype), round_to(w, compute_dtype)
    r, z = _recompute(_phase_patches(xc, pool_padding), wc, scale, shift, compute_dtype)
    return _windows_to_grid(_encode(r, _first_match(z)), x.shape[2], x.shape[3], pool_padding)


def conv2_input_from_routing_plain(enc, g, weight, mu, inv, scale, h1, h2, *, pool_padding) -> torch.Tensor:
    """Plain version of kernel E: dx (B, Cin, H, W) from the routing ``enc``,
    the pooled gradient ``g`` and kernel D's h1, h2. dy = relu'·(scale·dz −
    h1 − x̂·h2), dz = g of the window where the position won, then the
    transposed 2x2 conv of dy. In bf16 (g's dtype) the weight is rounded to
    bf16, each tap's product (the Pallas dp) is rounded to bf16, and dx is
    the f32 sum of the four rounded taps in tap order, rounded once (bf16)."""
    cd = g.dtype
    g = g.float()
    b, c, hp, wp = enc.shape
    _, _, ho, wo, hc, wc = pool_dims(hp + 1, wp + 1, pool_padding)
    ph, pw = pool_padding
    g2 = F.pad(g, (0, wc - wo, 0, hc - ho))  # zero over the windows with no output
    g_grid = g2.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)[:, :, ph : ph + hp, pw : pw + wp]
    c4 = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
    zero = torch.zeros((), dtype=enc.dtype, device=enc.device)
    dz = torch.where(enc < 0, g_grid, zero)
    xhat = (enc.abs() - c4(mu)) * c4(inv)
    dy = torch.where(enc != 0, c4(scale) * dz - c4(h1) - xhat * c4(h2), zero)
    if cd == torch.float32:
        return F.conv_transpose2d(dy, weight)
    wc = round_to(weight, cd)
    taps = [round_to(torch.einsum("bchw,ci->bihw", dy, wc[:, :, kh, kw]), cd) for kh in (0, 1) for kw in (0, 1)]
    dx = (F.pad(taps[0], (0, 1, 0, 1)) + F.pad(taps[1], (1, 0, 0, 1))
          + F.pad(taps[2], (0, 1, 1, 0)) + F.pad(taps[3], (1, 0, 1, 0)))
    return dx.to(cd)


def conv2_bn_pool_backward_plain(x, g, weight, bias, mu, inv, scale, shift, *, pool_padding, need_dx=True):
    """Plain torch version of kernels D and E: (dx or None, dweight, dbias,
    dgamma, dbeta) for the pooled gradient ``g`` (B, C, ho, wo). g's dtype
    is the compute dtype: in bf16 x and the taps are rounded to it, r and z
    too, the sums multiply the rounded x, and dx is formed as kernel E's
    plain version does and cast to x's dtype; the parameter gradients are
    f32."""
    cd = g.dtype
    b, cin, h, wd = x.shape
    hp, wp, ho, wo, hc, wc = pool_dims(h, wd, pool_padding)
    w = round_to(w257(weight, bias), cd)
    k4 = 4 * cin
    p = _phase_patches(round_to(x.float(), cd), pool_padding)
    r, z = _recompute(p, w, scale, shift, cd)
    winner = _first_match(z)
    g2 = F.pad(g.float(), (0, wc - wo, 0, hc - ho))  # zero over the windows with no output
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    dz = torch.where(winner, g2[..., None], zero)
    c5 = lambda v: v.reshape(1, -1, 1, 1, 1)  # noqa: E731
    xhat = (r - c5(mu)) * c5(inv)
    rp = r > 0
    t1 = torch.where(rp, dz, zero)
    rpf = rp.to(torch.float32)
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
        enc = _windows_to_grid(_encode(r, winner), h, wd, pool_padding)
        dx = conv2_input_from_routing_plain(enc, g, weight, mu, inv, scale, h1, h2,
                                            pool_padding=pool_padding).to(x.dtype)
    return dx, dweight, dw[k4], s2, s1


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_cuda(device, dims, g, w, vecs, pool_padding, extra=()) -> bool:
    """The kernels' contract: contiguous tensors on ``device`` (a CUDA
    device) for the block input of shape ``dims`` = (B, Cin, H, W) with Cin
    <= 64 and H, W >= 2: g (B, C, ho, wo) in the compute dtype, float32 or
    bfloat16; w (4·Cin + 1, C) and the per-channel vectors (C,) float32; each
    (name, tensor, shape, dtype) of ``extra`` (x in the compute dtype, the
    routing f32); pool padding in {0, 1} per axis. Raises naming the tensor
    that breaks it; returns whether the compute dtype is bf16."""
    b, cin, h, wd = dims
    if cin > MAX_CIN or h < 2 or wd < 2:
        raise ValueError(f"conv2_bn_pool kernels need x (B, Cin <= {MAX_CIN}, H >= 2, W >= 2), got {tuple(dims)}")
    if any(pad not in (0, 1) for pad in pool_padding):
        raise ValueError(f"conv2_bn_pool kernels take pool padding 0 or 1 per axis, got {pool_padding}")
    c = w.shape[-1]
    _, _, ho, wo, _, _ = pool_dims(h, wd, pool_padding)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv2_bn_pool kernels take g in float32 or bfloat16 (the compute dtype), got {g.dtype}")
    expected = [("g", g, (b, c, ho, wo), g.dtype), ("w", w, (4 * cin + 1, c), torch.float32)]
    expected += [(f"vector {i}", v, (c,), torch.float32) for i, v in enumerate(vecs)]
    for name, t, shape, dtype in [*expected, *extra]:
        if not t.is_cuda or t.device != device or not t.is_contiguous():
            raise ValueError(f"conv2_bn_pool kernels take contiguous tensors on one CUDA device ({name})")
        if t.dtype != dtype:
            raise ValueError(f"conv2_bn_pool kernels take {name} in {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"conv2_bn_pool: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return g.dtype == torch.bfloat16


def _splits(n_tiles: int, groups: int) -> int:
    """Blocks along the window tiles for a pass of kernel D: about two
    blocks per SM of an H100 (132 SMs) over all channel groups."""
    return max(1, min(n_tiles, -(-264 // groups)))


def _route_block(c: int) -> tuple[int, int]:
    """(channels a block, windows a tile) of kernel D's routing pass: 32 and
    64 for C <= 32, else 64 and 32 (the .cu's RouteShape)."""
    return (32, 64) if c <= 32 else (64, 32)


def conv2_bn_pool_bwd_params(x, g, w, mu, inv, scale, shift, *, pool_padding) -> tuple[torch.Tensor, Conv2Routing]:
    """Kernel D: (4·Cin + 5, C) = dw taps (4·Cin rows, tap-major), dbias,
    dgamma, dbeta, h1, h2; and the routing for kernel E. x and g in the
    compute dtype: bf16 ones launch the bf16 mode."""
    if x.ndim != 4:
        raise ValueError(f"conv2_bn_pool kernels need x (B, Cin, H, W), got {tuple(x.shape)}")
    bf16 = _check_cuda(x.device, x.shape, g, w, (mu, inv, scale, shift), pool_padding,
                       extra=[("x", x, x.shape, g.dtype)])
    b, cin, h, wd = x.shape
    c = w.shape[1]
    _, _, _, _, hc, wc = pool_dims(h, wd, pool_padding)
    splits = _splits(-(-(b * hc * wc) // TILE_WINDOWS), -(-c // CHANNEL_BLOCK))
    route_channels, route_windows = _route_block(c)
    partial = torch.empty((splits, 3 * (4 * cin + 1) + 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((4 * cin + 5, c), dtype=torch.float32, device=x.device)
    route = torch.empty((b, c, h - 1, wd - 1), dtype=torch.float32, device=x.device)
    (BWD_PARAMS_BF16_KERNEL if bf16 else BWD_PARAMS_KERNEL)(
        x.device, ptr(x), ptr(g), ptr(w), ptr(mu), ptr(inv), ptr(scale), ptr(shift),
        ptr(partial), ptr(out), ptr(route), b, cin, h, wd, c, pool_padding[0], pool_padding[1], splits,
        _splits(-(-(b * hc * wc) // route_windows), -(-c // route_channels)),
    )
    return out, Conv2Routing(route, tuple(pool_padding))


def conv2_bn_pool_bwd_input(routing, g, w, mu, inv, scale, h12, *, pool_padding) -> torch.Tensor:
    """Kernel E: dx (B, Cin, H, W) in g's dtype (the compute dtype, x's)
    from kernel D's ``routing`` and its ``h12``, rows 4·Cin + 3 and + 4 of
    D's output. Raises without D's routing."""
    if not isinstance(routing, Conv2Routing):
        raise TypeError(f"kernel E needs the Conv2Routing that kernel D wrote, got {type(routing).__name__}")
    if tuple(routing.pool_padding) != tuple(pool_padding):
        raise ValueError(f"routing was written for pool padding {routing.pool_padding}, not {tuple(pool_padding)}")
    enc = routing.enc
    if enc.ndim != 4 or (w.shape[0] - 1) % 4:
        raise ValueError(f"kernel E needs a (B, C, hp, wp) routing and (4·Cin + 1, C) taps, got "
                         f"{tuple(enc.shape)} and {tuple(w.shape)}")
    b, c, hp, wp = enc.shape
    dims = (b, (w.shape[0] - 1) // 4, hp + 1, wp + 1)
    bf16 = _check_cuda(enc.device, dims, g, w, (mu, inv, scale), pool_padding,
                       extra=[("routing", enc, (b, w.shape[1], hp, wp), torch.float32),
                              ("h12", h12, (2, w.shape[1]), torch.float32)])
    dx = torch.empty(dims, dtype=g.dtype, device=enc.device)
    (BWD_INPUT_BF16_KERNEL if bf16 else BWD_INPUT_KERNEL)(
        enc.device, ptr(enc), ptr(g), ptr(w), ptr(mu), ptr(inv), ptr(scale), ptr(h12), ptr(dx),
        *dims, c, pool_padding[0], pool_padding[1],
    )
    return dx


def conv2_bn_pool_backward(x, g, weight, bias, mu, inv, scale, shift, *, pool_padding):
    """(dx, dweight, dbias, dgamma, dbeta): the kernels on CUDA tensors, D
    then E on D's routing; the plain version on CPU tensors."""
    if not x.is_cuda:
        return conv2_bn_pool_backward_plain(x, g, weight, bias, mu, inv, scale, shift, pool_padding=pool_padding)
    x, g = x.contiguous(), g.contiguous()
    w = w257(weight, bias)
    k4 = 4 * x.shape[1]
    out, routing = conv2_bn_pool_bwd_params(x, g, w, mu, inv, scale, shift, pool_padding=pool_padding)
    dx = conv2_bn_pool_bwd_input(
        routing, g, w, mu, inv, scale, out[k4 + 3 : k4 + 5].contiguous(), pool_padding=pool_padding
    )
    dweight = out[:k4].reshape(2, 2, x.shape[1], -1).permute(3, 2, 0, 1)
    return dx, dweight, out[k4], out[k4 + 1], out[k4 + 2]


# ---------------------------------------------------------------------------
# forward (plain torch) and autograd


class _TrainBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, pool_padding, dtype):
        r = _conv_relu(x, weight, bias, dtype)  # JAX's _conv_relu2, the same as block 1's
        mu = r.mean(dim=(0, 2, 3))
        var = (r * r).mean(dim=(0, 2, 3)) - mu * mu  # flax's fast variance, unclamped here
        inv = torch.rsqrt(var + EPS)
        c = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
        z = ((r - c(mu)) * c(inv) * c(gamma) + c(beta)).to(dtype)  # pooled in the compute dtype (−inf padding)
        out = F.max_pool2d(z, (2, 2), padding=pool_padding)
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
        return (*grads, None, None)


def conv2_bn_pool(x, weight, bias, gamma, beta, *, pool_padding=(1, 1), compute_dtype=torch.float32):
    """maxpool_{2,2,pad pool_padding}(BN(relu(conv2x2(x)))) in train mode,
    with the kernel backward: (out, batch_mean, batch_var), the variance
    biased (E[r²] − μ², flax's fast variance). dx is always computed. ``out``
    is in ``compute_dtype`` (float32 or bfloat16); the statistics are f32."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv2_bn_pool computes in float32 or bfloat16, got {compute_dtype}")
    return _TrainBlock.apply(x, weight, bias, gamma, beta, tuple(pool_padding), compute_dtype)
