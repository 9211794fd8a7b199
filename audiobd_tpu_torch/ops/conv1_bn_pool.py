"""maxpool_{1,3}(BN(relu(conv2x2_{1→C}(x)))) with hand-written CUDA kernels (G forward, B and C backward).

Port of audiobd_tpu/ops/fused_conv_block.py::conv1_bn_pool, the first
SmallCNN block. The reference's forward is stock XLA (conv, relu, batch
statistics with the fast variance E[r²] − μ², normalize, max-pool). On a
CPU tensor, and in bf16, the port's forward is the plain chain
(``_conv_relu``, the statistics, ``_norm_pool``). On a CUDA tensor in f32
kernel G takes the chain's passes over the pre-pool activation r, with the
plain chain's numbers bit for bit: it forms r from x as cuDNN's conv and
torch's bias add form it. In train mode its first pass writes r and r·r
(``conv1_bn_pool_fwd_relu``) for torch's means, which stay the batch
statistics; its pool pass normalises r and takes the (1, 3) max from x,
r never stored, with the batch statistics in train mode
(``conv1_bn_pool_fwd``) and the running ones in eval mode
(``conv1_bn_pool_fwd_eval``). The backward never
materializes the pre-pool activation either: kernel B
(``conv1_bn_pool_bwd_params``) recomputes each pool window from x and
accumulates the parameter gradients when some parameter needs one; kernel
C (``conv1_bn_pool_bwd_input``) forms dx when x requires a gradient
(FlowMur's trigger search through a frozen eval-mode surrogate runs C
alone). The math and the first-match tie rule are described in
``csrc/conv1_bn_pool.cu``.

Layout is the port's NCHW: x (B, 1, H, W), weight (C, 1, 2, 2), out
(B, C, H-1, (W-1)//3). On a CUDA tensor the backward launches the kernels or
raises; on a CPU tensor it runs ``conv1_bn_pool_backward_plain``, the same
recompute in plain torch.

Compute dtype (``compute_dtype``, float32 or bfloat16; JAX's ``dt_name``):
in bf16 the forward is the reference's bf16 forward (_conv_relu, _norm_pool
at audiobd_tpu/ops/fused_conv_block.py:292-318) and ``out`` is bf16; the
batch statistics stay f32. The backward's mode is the cotangent's dtype: a
bf16 g runs the kernels' bf16 instantiation (``*_bf16``), which rounds x,
the taps, r and z to bf16 where the Pallas kernels do and writes dx rounded
to bf16; the parameter gradients stay f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audiobd_tpu_torch.ops.build import CudaKernel, ptr

EPS = 1e-5
_I, _P = ctypes.c_int, ctypes.c_void_p
BWD_PARAMS_KERNEL = CudaKernel(
    "conv1_bn_pool_bwd_params", "conv1_bn_pool.cu", "conv1_bn_pool_bwd_params",
    [_P] * 9 + [_I] * 6,
)
# Kernel B's eval mode (train_bn false: the parameter gradients of a block
# normalized by its running statistics, the defenses' SAM and unlearning
# steps) is the same entry point, counted apart.
BWD_PARAMS_EVAL_KERNEL = CudaKernel(
    "conv1_bn_pool_bwd_params_eval", "conv1_bn_pool.cu", "conv1_bn_pool_bwd_params",
    [_P] * 9 + [_I] * 6,
)
# Kernel B stages a span of at most this many of a clip's pooled positions in
# shared memory (32 bytes each: 96 KB, two blocks an SM); longer clips are cut
# into equal spans whose partial sums the finish adds.
PARAMS_SPAN = 3072
BWD_INPUT_KERNEL = CudaKernel(
    "conv1_bn_pool_bwd_input", "conv1_bn_pool.cu", "conv1_bn_pool_bwd_input",
    [_P] * 9 + [_I] * 8,
)
# The bf16 instantiations (a bf16 g; x f32 or bf16, told by the last int).
BWD_PARAMS_BF16_KERNEL = CudaKernel(
    "conv1_bn_pool_bwd_params_bf16", "conv1_bn_pool.cu", "conv1_bn_pool_bwd_params_bf16",
    [_P] * 9 + [_I] * 7,
)
BWD_INPUT_BF16_KERNEL = CudaKernel(
    "conv1_bn_pool_bwd_input_bf16", "conv1_bn_pool.cu", "conv1_bn_pool_bwd_input_bf16",
    [_P] * 9 + [_I] * 9,
)
# Kernel G, the forward in f32: train mode's first pass (r and r·r from x),
# and the pool pass from x, one entry point whose train mode (the batch
# statistics) and eval mode (the running ones) count apart.
FWD_RELU_KERNEL = CudaKernel(
    "conv1_bn_pool_fwd_relu", "conv1_bn_pool.cu", "conv1_bn_pool_fwd_relu", [_P] * 5 + [_I] * 4,
)
FWD_KERNEL = CudaKernel("conv1_bn_pool_fwd", "conv1_bn_pool.cu", "conv1_bn_pool_fwd", [_P] * 8 + [_I] * 5)
FWD_EVAL_KERNEL = CudaKernel("conv1_bn_pool_fwd_eval", "conv1_bn_pool.cu", "conv1_bn_pool_fwd", [_P] * 8 + [_I] * 5)
# Kernel C keeps a span's dp tile (4 taps x conv rows x (W-1) floats, the
# halo row included) in shared memory; a clip whose tile is larger is cut
# into equal spans of conv rows. The main path's clip (62,400 B) is one span.
INPUT_TILE_BYTES = 64 * 1024
INPUT_WARPS = 8  # a kernel-C block's warps, shared out among channel groups


def input_spans(h: int, w: int) -> tuple[int, int]:
    """(spans, rows): kernel C cuts a clip's h-1 conv rows into ``spans``
    spans of ``rows`` (the last may be shorter, none is empty), so that a
    span's tile with its halo row fits ``INPUT_TILE_BYTES``."""
    hp, row_bytes = h - 1, 16 * (w - 1)
    if hp * row_bytes <= INPUT_TILE_BYTES:
        return 1, hp
    max_rows = INPUT_TILE_BYTES // row_bytes - 1  # a row for the halo
    if max_rows < 1:
        raise ValueError(f"conv1_bn_pool: rows of {w} samples are too wide for kernel C's tile")
    rows = -(-hp // -(-hp // max_rows))
    return -(-hp // rows), rows


def input_groups(positions: int) -> int:
    """Kernel C's channel groups for a span of ``positions`` pooled
    positions: the most (1, 2, 4 or 8) that keep every warp on positions,
    so a short clip (FlowMur's 124 positions, 4 warps' worth) still fills
    the block's 8 warps."""
    runs, groups = -(-positions // 32), 1
    while groups < INPUT_WARPS and 2 * groups * runs <= INPUT_WARPS:
        groups *= 2
    return groups


def supports(x: torch.Tensor) -> bool:
    """The fused block's shape guard (audiobd_tpu/models/layers.py:309):
    one input channel, at least two rows, and (W-1) divisible by the pool."""
    return x.ndim == 4 and x.shape[1] == 1 and x.shape[2] >= 2 and (x.shape[3] - 1) % 3 == 0


def _w5(weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(C, 5): the four 2x2 taps in row-major order, then the bias."""
    return torch.cat([weight.reshape(weight.shape[0], 4), bias[:, None]], dim=1).contiguous()


def round_to(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 ``v`` rounded to ``dtype`` and held in f32: the identity for
    float32, round to nearest even for bfloat16 (the kernels'
    ``round_to_compute``, JAX's ``.astype(bfloat16).astype(float32)``)."""
    return v if dtype == torch.float32 else v.to(dtype).to(torch.float32)


# ---------------------------------------------------------------------------
# plain versions


def _windows(x, w5, scale, shift, dtype=torch.float32):
    """Taps p (5, B, H', Wp, 3) and the recomputed r, z (B, C, H', Wp, 3), in
    the kernel's order of operations (no FMA), so ties route identically; r
    and z rounded to the compute ``dtype`` (x and w5 already are)."""
    b, _, h, w = x.shape
    hp, wp = h - 1, (w - 1) // 3
    x2 = x[:, 0]
    taps = [x2[:, :-1, :-1], x2[:, :-1, 1:], x2[:, 1:, :-1], x2[:, 1:, 1:]]
    taps = [t.reshape(b, hp, wp, 3) for t in taps]
    cw = [w5[:, k].reshape(1, -1, 1, 1, 1) for k in range(5)]
    y = cw[0] * taps[0][:, None]
    for k in range(1, 4):
        y = y + cw[k] * taps[k][:, None]
    y = y + cw[4]
    r = round_to(torch.clamp(y, min=0.0), dtype)
    z = round_to(r * scale.reshape(1, -1, 1, 1, 1) + shift.reshape(1, -1, 1, 1, 1), dtype)
    p = torch.stack(taps + [torch.ones_like(taps[0])])
    return p, r, z


def _first_match(z: torch.Tensor) -> torch.Tensor:
    """One-hot over the last (phase) axis of the first element equal to the max."""
    hit = z == z.amax(dim=-1, keepdim=True)
    return hit & (torch.cumsum(hit.to(torch.int8), dim=-1) == 1)


def conv1_bn_pool_backward_plain(x, g, weight, bias, mu, inv, scale, shift, *, train_bn, need_dx,
                                 need_params=True):
    """Plain torch version of kernels B and C: (dx or None, dweight, dbias,
    dgamma, dbeta) for upstream gradient ``g`` (B, C, H', Wp); the last four
    are None unless ``need_params``.

    g's dtype is the compute dtype. In bf16 (the Pallas kernels' bf16 mode):
    x and the taps are rounded to bf16, y = sum of taps times x with the bias
    folded in is rounded once at r, z is rounded too; the sums multiply the
    rounded x; each tap's dp is rounded to bf16, and dx is their f32 sum in
    the un-patch order, rounded once to bf16 and cast to x's dtype. The
    parameter gradients are f32."""
    cd = g.dtype
    w5 = round_to(_w5(weight, bias), cd)
    c = w5.shape[0]
    xc, g = round_to(x.float(), cd), g.float()
    p, r, z = _windows(xc, w5, scale, shift, cd)
    m_valid = g.numel() // c
    dz = torch.where(_first_match(z), g[..., None], torch.zeros((), dtype=g.dtype, device=g.device))
    c5 = lambda v: v.reshape(1, -1, 1, 1, 1)  # noqa: E731
    xhat = (r - c5(mu)) * c5(inv)
    rp = r > 0
    s1 = dz.sum(dim=(0, 2, 3, 4))
    s2 = (dz * xhat).sum(dim=(0, 2, 3, 4))
    if need_params:
        t1 = torch.where(rp, dz, torch.zeros_like(dz))
        dw = torch.einsum("kbhwt,bchwt->kc", p, t1) * scale
    if train_bn:
        n_total = 3 * m_valid
        h1 = scale * s1 / n_total
        h2 = scale * s2 / n_total
        if need_params:
            rpf = rp.to(torch.float32)
            dwb = torch.einsum("kbhwt,bchwt->kc", p, rpf)
            dwc = torch.einsum("kbhwt,bchwt->kc", p, rpf * xhat)
            dw = dw - dwb * h1 - dwc * h2
    else:
        h1 = h2 = torch.zeros_like(s1)
    dx = None
    if need_dx:
        dr = c5(scale) * dz - c5(h1) - xhat * c5(h2)
        dy = torch.where(rp, dr, torch.zeros_like(dr))
        dp = round_to(torch.einsum("ck,bchwt->kbhwt", w5[:, :4], dy), cd)
        b, _, h, w = x.shape
        dp = dp.reshape(4, b, h - 1, w - 1)
        dx = (
            F.pad(dp[0], (0, 1, 0, 1)) + F.pad(dp[1], (1, 0, 0, 1))
            + F.pad(dp[2], (0, 1, 1, 0)) + F.pad(dp[3], (1, 0, 1, 0))
        )[:, None]
        dx = round_to(dx, cd).to(x.dtype)
    if not need_params:
        return dx, None, None, None, None
    return dx, dw[:4].t().reshape(weight.shape), dw[4], s2, s1


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_cuda(x, g, w5, *vecs, h12=None) -> bool:
    """The kernels' contract, contiguous tensors on x's CUDA device: g (B, C,
    H-1, (W-1)//3) in the compute dtype, float32 or bfloat16; x (B, 1, H, W)
    with (W-1) % 3 == 0, float32, or bfloat16 when g is; w5 (C, 5), the
    per-channel vectors (C,) and h12 (2, C) float32. Raises naming the
    tensor that breaks it; returns whether the compute dtype is bf16."""
    if not supports(x):
        raise ValueError(f"conv1_bn_pool needs x (B, 1, H, W) with (W-1) % 3 == 0, got {tuple(x.shape)}")
    b, _, h, w = x.shape
    c = w5.shape[0]
    f32, bf16 = (torch.float32,), (torch.float32, torch.bfloat16)
    expected = [("g", g, (b, c, h - 1, (w - 1) // 3), bf16),
                ("x", x, x.shape, bf16 if g.dtype == torch.bfloat16 else f32), ("w5", w5, (c, 5), f32)]
    expected += [(f"vector {i}", v, (c,), f32) for i, v in enumerate(vecs)]
    if h12 is not None:
        expected.append(("h12", h12, (2, c), f32))
    for name, t, shape, dtypes in expected:
        if not t.is_cuda or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"conv1_bn_pool kernels take contiguous tensors on x's CUDA device ({name})")
        if t.dtype not in dtypes:
            raise ValueError(f"conv1_bn_pool kernels take {name} in {' or '.join(map(str, dtypes))}"
                             f"{' (bfloat16 only with a bfloat16 g)' if name == 'x' else ''}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"conv1_bn_pool: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return g.dtype == torch.bfloat16


def conv1_bn_pool_bwd_params(x, g, w5, mu, inv, scale, shift, *, train_bn: bool) -> torch.Tensor:
    """Kernel B: (9, C) = dw taps (4 rows), dbias, dgamma, dbeta, h1, h2.
    A block takes one span of at most ``PARAMS_SPAN`` of a clip's pooled
    positions, so any clip length fits. A bf16 g launches the bf16 mode (one
    counter for both BN modes); in f32 train and eval mode count apart."""
    bf16 = _check_cuda(x, g, w5, mu, inv, scale, shift)
    b, _, h, w = x.shape
    c = w5.shape[0]
    chunks = -(-(h - 1) * ((w - 1) // 3) // PARAMS_SPAN)
    partial = torch.empty((17, c, b * chunks), dtype=torch.float32, device=x.device)
    out = torch.empty((9, c), dtype=torch.float32, device=x.device)
    args = [ptr(x), ptr(g), ptr(w5), ptr(mu), ptr(inv), ptr(scale), ptr(shift), ptr(partial), ptr(out),
            b, h, w, c, chunks, int(train_bn)]
    if bf16:
        BWD_PARAMS_BF16_KERNEL(x.device, *args, int(x.dtype == torch.bfloat16))
    else:
        (BWD_PARAMS_KERNEL if train_bn else BWD_PARAMS_EVAL_KERNEL)(x.device, *args)
    return out


def conv1_bn_pool_bwd_input(x, g, w5, mu, inv, scale, shift, h12=None, *, train_bn: bool) -> torch.Tensor:
    """Kernel C: dx (B, 1, H, W) in x's dtype, in one launch. Train mode
    takes ``h12``, rows 7-8 of kernel B's output; eval mode takes none (h1 =
    h2 = 0). A bf16 g launches the bf16 mode."""
    if train_bn != (h12 is not None):
        raise ValueError("kernel C takes h12 (kernel B's rows 7-8) in train mode, and only there")
    bf16 = _check_cuda(x, g, w5, mu, inv, scale, shift, h12=h12)
    b, _, h, w = x.shape
    c = w5.shape[0]
    spans, rows = input_spans(h, w)
    groups = input_groups((rows + (spans > 1)) * ((w - 1) // 3))
    dx = torch.empty_like(x)
    args = [ptr(x), ptr(g), ptr(w5), ptr(mu), ptr(inv), ptr(scale), ptr(shift),
            None if h12 is None else ptr(h12), ptr(dx), b, h, w, c, spans, rows, groups, int(train_bn)]
    if bf16:
        BWD_INPUT_BF16_KERNEL(x.device, *args, int(x.dtype == torch.bfloat16))
    else:
        BWD_INPUT_KERNEL(x.device, *args)
    return dx


def _check_forward(x, weight, bias, **vecs) -> None:
    """Kernel G's contract: x (B, 1, H, W) with (W-1) % 3 == 0, weight (C,
    1, 2, 2), bias and each of ``vecs`` (C,), all float32, contiguous and on
    x's CUDA device. Raises naming the first tensor that breaks it, checked
    in that order (shape, dtype, layout, device)."""
    if not supports(x):
        raise ValueError(f"conv1_bn_pool_fwd needs x (B, 1, H, W) with (W-1) % 3 == 0, got {tuple(x.shape)}")
    c = weight.shape[0]
    named = [("x", x, tuple(x.shape)), ("weight", weight, (c, 1, 2, 2)), ("bias", bias, (c,))]
    named += [(name, v, (c,)) for name, v in vecs.items()]
    for name, t, shape in named:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"conv1_bn_pool_fwd: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    for name, t, _ in named:
        if t.dtype != torch.float32:
            raise ValueError(f"conv1_bn_pool_fwd takes float32 tensors, got {name} in {t.dtype}")
    for name, t, _ in named:
        if not t.is_contiguous():
            raise ValueError(f"conv1_bn_pool_fwd takes contiguous tensors ({name})")
    for name, t, _ in named:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"conv1_bn_pool_fwd takes tensors on x's CUDA device ({name} on {t.device})")


def conv1_bn_pool_fwd_relu(x, weight, bias) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's train-mode first pass, one launch: (r, r·r), r (B, C, H-1,
    W-1) = relu(conv2x2(x) + bias) as cuDNN's convolution, torch's bias add
    and clamp form it, for torch's means."""
    _check_forward(x, weight, bias)
    b, _, h, w = x.shape
    c = weight.shape[0]
    r = torch.empty((b, c, h - 1, w - 1), dtype=torch.float32, device=x.device)
    r2 = torch.empty_like(r)
    FWD_RELU_KERNEL(x.device, ptr(x), ptr(weight), ptr(bias), ptr(r), ptr(r2), b, h, w, c)
    return r, r2


def conv1_bn_pool_fwd(x, weight, bias, gamma, beta, mu, inv, *, train_bn: bool) -> torch.Tensor:
    """Kernel G's pool pass, one launch: out (B, C, H-1, (W-1)//3) of the
    whole block from x, r formed as the first pass forms it and never
    stored, normalised by ``mu`` and ``inv`` (train mode: the batch
    statistics; eval mode: the running mean and rsqrt(running variance +
    eps)) with each step rounded as ``_norm_pool``'s torch ops round it. The
    two modes count apart."""
    _check_forward(x, weight, bias, gamma=gamma, beta=beta, mu=mu, inv=inv)
    b, _, h, w = x.shape
    c = weight.shape[0]
    chunks = -(-(h - 1) * ((w - 1) // 3) // PARAMS_SPAN)
    out = torch.empty((b, c, h - 1, (w - 1) // 3), dtype=torch.float32, device=x.device)
    (FWD_KERNEL if train_bn else FWD_EVAL_KERNEL)(
        x.device, ptr(x), ptr(weight), ptr(bias), ptr(gamma), ptr(beta), ptr(mu), ptr(inv), ptr(out),
        b, h, w, c, chunks)
    return out


def uses_forward_kernel(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether the block's forward runs kernel G: f32 compute on a CUDA
    tensor. CPU tensors and the bf16 compute dtype take the plain chain."""
    return x.is_cuda and dtype == torch.float32


def conv1_bn_pool_backward(x, g, weight, bias, mu, inv, scale, shift, *, train_bn, need_dx, need_params=True):
    """(dx or None, dweight, dbias, dgamma, dbeta), the last four None
    unless ``need_params``: the kernels on CUDA tensors, the plain version
    on CPU tensors. Kernel B runs when the parameters need a gradient, and
    in train mode whenever dx is needed too, since C reads B's h1 and h2;
    eval-mode dx of a frozen block is kernel C alone."""
    if not x.is_cuda:
        return conv1_bn_pool_backward_plain(
            x, g, weight, bias, mu, inv, scale, shift, train_bn=train_bn, need_dx=need_dx,
            need_params=need_params,
        )
    x, g = x.contiguous(), g.contiguous()
    w5 = _w5(weight, bias)
    out = None
    if need_params or (train_bn and need_dx):
        out = conv1_bn_pool_bwd_params(x, g, w5, mu, inv, scale, shift, train_bn=train_bn)
    dx = None
    if need_dx:
        h12 = out[7:9].contiguous() if train_bn else None
        dx = conv1_bn_pool_bwd_input(x, g, w5, mu, inv, scale, shift, h12, train_bn=train_bn)
    if not need_params:
        return dx, None, None, None, None
    return dx, out[:4].t().reshape(weight.shape), out[4], out[5], out[6]


# ---------------------------------------------------------------------------
# plain forward and autograd


def _conv_relu(x, weight, bias, dtype=torch.float32):
    """relu(conv2x2(x)) in f32. In bf16 (JAX's _conv_relu): x and the weight
    rounded to bf16, the convolution rounded to bf16, plus the bf16 bias (a
    second rounding), relu; r is then held in f32."""
    if dtype == torch.float32:
        return torch.clamp(F.conv2d(x, weight, bias), min=0.0)
    y = F.conv2d(x.to(dtype), weight.to(dtype)) + bias.to(dtype).reshape(1, -1, 1, 1)
    return torch.clamp(y, min=0.0).to(torch.float32)


def _norm_pool(r, gamma, beta, mu, inv, dtype=torch.float32):
    """maxpool_{1,3} of z = (r − μ)·inv·γ + β, z formed in f32 and pooled in
    the compute dtype (JAX's _norm_pool)."""
    c = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
    z = ((r - c(mu)) * c(inv) * c(gamma) + c(beta)).to(dtype)
    return F.max_pool2d(z, (1, 3))


class _TrainBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, dtype):
        kernel = uses_forward_kernel(x, dtype)
        if kernel:
            r, r2 = conv1_bn_pool_fwd_relu(x.contiguous(), weight, bias)
        else:
            r = _conv_relu(x, weight, bias, dtype)
            r2 = r * r
        mu = r.mean(dim=(0, 2, 3))
        var = r2.mean(dim=(0, 2, 3)) - mu * mu
        inv = torch.rsqrt(var + EPS)
        if kernel:
            del r, r2
            out = conv1_bn_pool_fwd(x.contiguous(), weight, bias, gamma, beta, mu, inv, train_bn=True)
        else:
            out = _norm_pool(r, gamma, beta, mu, inv, dtype)
        scale = gamma * inv
        shift = beta - mu * scale
        ctx.save_for_backward(x, weight, bias, mu, inv, scale, shift)
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, g, _g_mu, _g_var):
        # μ and σ² feed only the running statistics, which take no gradient.
        x, weight, bias, mu, inv, scale, shift = ctx.saved_tensors
        grads = conv1_bn_pool_backward(
            x, g, weight, bias, mu, inv, scale, shift,
            train_bn=True, need_dx=ctx.needs_input_grad[0], need_params=any(ctx.needs_input_grad[1:5]),
        )
        return (*grads, None)


class _EvalBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, running_mean, running_var, dtype):
        inv = torch.rsqrt(running_var + EPS)
        if uses_forward_kernel(x, dtype):
            out = conv1_bn_pool_fwd(x.contiguous(), weight, bias, gamma, beta, running_mean, inv, train_bn=False)
        else:
            out = _norm_pool(_conv_relu(x, weight, bias, dtype), gamma, beta, running_mean, inv, dtype)
        scale = gamma * inv
        shift = beta - running_mean * scale
        ctx.save_for_backward(x, weight, bias, running_mean, inv, scale, shift)
        return out

    @staticmethod
    def backward(ctx, g):
        # A frozen block (FlowMur's surrogate) needs dx alone: kernel C only.
        x, weight, bias, mu, inv, scale, shift = ctx.saved_tensors
        grads = conv1_bn_pool_backward(
            x, g, weight, bias, mu, inv, scale, shift,
            train_bn=False, need_dx=ctx.needs_input_grad[0], need_params=any(ctx.needs_input_grad[1:5]),
        )
        return (*grads, None, None, None)


def conv1_bn_pool(x, weight, bias, gamma, beta, *, train: bool, running_mean=None, running_var=None,
                  compute_dtype: torch.dtype = torch.float32):
    """maxpool_{1,3}(BN(relu(conv2x2(x)))) with the kernel backward (and, on CUDA
    in f32, kernel G's forward).

    Training mode normalizes with the batch statistics and returns
    (out, batch_mean, batch_var), the variance biased (E[r²] − μ², flax's
    fast variance). Eval mode normalizes with the running statistics and
    returns out. dx is computed whenever x requires a gradient (the
    reference needed a ``need_input_grad`` flag for that; autograd knows).
    ``out`` is in ``compute_dtype`` (float32 or bfloat16); the statistics
    are f32.
    """
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv1_bn_pool computes in float32 or bfloat16, got {compute_dtype}")
    if train:
        return _TrainBlock.apply(x, weight, bias, gamma, beta, compute_dtype)
    if running_mean is None or running_var is None:
        raise ValueError("eval mode needs running_mean and running_var")
    return _EvalBlock.apply(x, weight, bias, gamma, beta, running_mean, running_var, compute_dtype)
