"""The port's conv1_bn_pool against the JAX package's Pallas op.

On the CPU the port's backward runs its plain version, the same recompute
and first-match tie rule as the CUDA kernels; the JAX op runs its Pallas
kernels in interpret mode. Layouts differ (the port is NCHW with OIHW
weights, the reference NHWC with HWIO), so inputs are transposed here.

Tolerance f32 atol 1e-5, rtol 1e-5: both sides compute in f32 and route
every pool tie the same way, so only the order of the sums differs (the
conv taps, the batch statistics and the gradient accumulations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.ops.fused_conv_block import conv1_bn_pool as jax_conv1_bn_pool
from audiobd_tpu_torch.ops import conv1_bn_pool as port

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, W, C = 4, 9, 13, 8


def _inputs(case: str, shape=(B, H, W, C)):
    B, H, W, C = shape  # noqa: N806
    rng = np.random.default_rng({"random": 0, "ties": 1}[case])
    x = rng.normal(size=(B, H, W, 1)).astype(np.float32)
    kernel = (rng.normal(size=(2, 2, 1, C)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    if case == "ties":
        # Mostly negative pre-activations: relu zeros fill whole pool
        # windows, so z ties exactly and the first-match rule decides.
        bias -= 1.0
    gamma = (1.0 + 0.3 * rng.normal(size=(C,))).astype(np.float32)
    gamma[0] = -abs(gamma[0])  # a negative scale: the zeros win the pool
    beta = (0.1 * rng.normal(size=(C,))).astype(np.float32)
    wts = rng.normal(size=(B, H - 1, (W - 1) // 3, C)).astype(np.float32)
    return x, kernel, bias, gamma, beta, wts


def _to_port(x, kernel, bias, gamma, beta, wts):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)  # noqa: E731
    return (
        t(x.transpose(0, 3, 1, 2)), t(kernel.transpose(3, 2, 0, 1)), t(bias), t(gamma), t(beta),
        torch.from_numpy(np.ascontiguousarray(wts.transpose(0, 3, 1, 2))),
    )


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _close(port_t, ref, name):
    np.testing.assert_allclose(port_t.detach().numpy(), np.asarray(ref), err_msg=name, **TOL)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_train_mode_matches_pallas(case):
    x, kernel, bias, gamma, beta, wts = _inputs(case)

    def loss(args):
        out, _, _ = jax_conv1_bn_pool(*args, train=True, interpret=True, need_input_grad=True)
        return jnp.sum(jnp.tanh(out) * wts)

    args = tuple(jnp.asarray(a) for a in (x, kernel, bias, gamma, beta))
    out_j, mu_j, var_j = jax_conv1_bn_pool(*args, train=True, interpret=True)
    g_x, g_k, g_b, g_g, g_be = jax.grad(loss)(args)

    xt, kt, bt, gt, bet, wt = _to_port(x, kernel, bias, gamma, beta, wts)
    out, mu, var = port.conv1_bn_pool(xt, kt, bt, gt, bet, train=True)
    torch.sum(torch.tanh(out) * wt).backward()

    if case == "ties":
        assert (np.asarray(out_j) == np.asarray(out_j).min(axis=2, keepdims=True)).mean() > 0.2
    _close(out, _nchw(out_j), "out")
    _close(mu, mu_j, "mean")
    _close(var, var_j, "var")
    _close(kt.grad, np.asarray(g_k).transpose(3, 2, 0, 1), "dkernel")
    _close(bt.grad, g_b, "dbias")
    _close(gt.grad, g_g, "dgamma")
    _close(bet.grad, g_be, "dbeta")
    _close(xt.grad, _nchw(g_x), "dx")


@pytest.mark.parametrize("case", ["random", "ties"])
def test_eval_mode_matches_pallas(case):
    x, kernel, bias, gamma, beta, wts = _inputs(case)
    rng = np.random.default_rng(5)
    rmean = (0.3 + 0.1 * rng.normal(size=(C,))).astype(np.float32)
    rvar = (0.5 + np.abs(rng.normal(size=(C,)))).astype(np.float32)
    stats = dict(running_mean=jnp.asarray(rmean), running_var=jnp.asarray(rvar))

    def loss(args):
        return jnp.sum(jnp.sin(jax_conv1_bn_pool(*args, train=False, interpret=True, **stats)) * wts)

    args = tuple(jnp.asarray(a) for a in (x, kernel, bias, gamma, beta))
    out_j = jax_conv1_bn_pool(*args, train=False, interpret=True, **stats)
    g_x, g_k, g_b, g_g, g_be = jax.grad(loss)(args)

    xt, kt, bt, gt, bet, wt = _to_port(x, kernel, bias, gamma, beta, wts)
    out = port.conv1_bn_pool(
        xt, kt, bt, gt, bet, train=False,
        running_mean=torch.from_numpy(rmean), running_var=torch.from_numpy(rvar),
    )
    torch.sum(torch.sin(out) * wt).backward()

    _close(out, _nchw(out_j), "out")
    _close(kt.grad, np.asarray(g_k).transpose(3, 2, 0, 1), "dkernel")
    _close(bt.grad, g_b, "dbias")
    _close(gt.grad, g_g, "dgamma")
    _close(bet.grad, g_be, "dbeta")
    _close(xt.grad, _nchw(g_x), "dx")


@pytest.mark.parametrize("case", ["random", "ties"])
def test_eval_mode_input_grad_at_flowmur_shape(case):
    """FlowMur's trigger search: dx of a frozen eval-mode block at its MFCC
    shape (B, 1, 32, 13), C 64, with only x requiring a gradient. The port
    then computes no parameter sums (kernel C alone on the card)."""
    shape = (2, 32, 13, 64)
    x, kernel, bias, gamma, beta, wts = _inputs(case, shape)
    rng = np.random.default_rng(6)
    rmean = (0.3 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    rvar = (0.5 + np.abs(rng.normal(size=(64,)))).astype(np.float32)
    params = [jnp.asarray(a) for a in (kernel, bias, gamma, beta)]

    def loss(xj):
        out = jax_conv1_bn_pool(xj, *params, train=False, interpret=True,
                                running_mean=jnp.asarray(rmean), running_var=jnp.asarray(rvar))
        return jnp.sum(jnp.sin(out) * wts)

    g_x = jax.grad(loss)(jnp.asarray(x))
    xt, kt, bt, gt, bet, wt = _to_port(x, kernel, bias, gamma, beta, wts)
    for t in (kt, bt, gt, bet):
        t.requires_grad_(False)
    out = port.conv1_bn_pool(xt, kt, bt, gt, bet, train=False,
                             running_mean=torch.from_numpy(rmean), running_var=torch.from_numpy(rvar))
    torch.sum(torch.sin(out) * wt).backward()
    assert all(t.grad is None for t in (kt, bt, gt, bet))
    _close(xt.grad, _nchw(g_x), "dx")


@pytest.mark.parametrize("train_bn", [True, False])
def test_backward_without_parameter_gradients(train_bn):
    """need_params=False gives the same dx and no parameter gradients."""
    x, kernel, bias, gamma, beta, wts = _inputs("ties")
    xt, kt, bt, gt, bet, wt = (t.detach() for t in _to_port(x, kernel, bias, gamma, beta, wts))
    mu = 0.2 + 0.1 * torch.arange(C, dtype=torch.float32) / C
    inv = torch.full((C,), 1.3)
    args = (xt, wt, kt, bt, mu, inv, gt * inv, bet - mu * gt * inv)
    full = port.conv1_bn_pool_backward(*args, train_bn=train_bn, need_dx=True)
    dx_only = port.conv1_bn_pool_backward(*args, train_bn=train_bn, need_dx=True, need_params=False)
    assert dx_only[1:] == (None, None, None, None)
    assert torch.equal(dx_only[0], full[0])


@pytest.mark.parametrize("h,w", [(101, 40), (32, 13), (801, 40), (400, 130), (3, 1027)])
def test_kernel_c_spans_and_halo_rebuild_dx(h, w):
    """Kernel C's decomposition in plain torch: each span of conv rows (with
    the halo row above it after the first) gives the dx rows it owns, and
    the spans' rows put together are the whole dx; every span's tile fits."""
    spans, rows = port.input_spans(h, w)
    hp = h - 1
    assert (spans - 1) * rows < hp <= spans * rows
    assert (rows + (spans > 1)) * 16 * (w - 1) <= port.INPUT_TILE_BYTES
    assert (spans == 1) == (hp * 16 * (w - 1) <= port.INPUT_TILE_BYTES)
    rng = np.random.default_rng(h + w)
    c = 4
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.normal(size=(1, 1, h, w)))
    g = t(rng.normal(size=(1, c, hp, (w - 1) // 3)))
    weight, bias = t(rng.normal(size=(c, 1, 2, 2)) * 0.5), t(rng.normal(size=(c,)) * 0.1 - 0.3)
    scale, shift = t(1.0 + 0.2 * rng.normal(size=(c,))), t(0.1 * rng.normal(size=(c,)))
    vecs = (torch.zeros(c), torch.ones(c), scale, shift)
    full = port.conv1_bn_pool_backward_plain(x, g, weight, bias, *vecs, train_bn=False, need_dx=True,
                                             need_params=False)[0]
    parts = []
    for s in range(spans):
        r0, r1 = s * rows, min(hp, (s + 1) * rows)
        first = max(r0 - 1, 0)
        sub = port.conv1_bn_pool_backward_plain(x[:, :, first : r1 + 1], g[:, :, first:r1], weight, bias, *vecs,
                                                train_bn=False, need_dx=True, need_params=False)[0]
        last = h if r1 == hp else r1
        parts.append(sub[:, :, r0 - first : last - first])
    torch.testing.assert_close(torch.cat(parts, dim=2), full, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("positions,groups", [(124, 2), (1300, 1), (32, 8), (33, 4), (256, 1), (100, 2)])
def test_kernel_c_channel_groups(positions, groups):
    """Warps left idle by a short span go to channel groups: FlowMur's 124
    positions a clip fill 4 warps, so two groups of channels fill 8."""
    assert port.input_groups(positions) == groups
    assert groups * -(-positions // 32) <= port.INPUT_WARPS or groups == 1


def test_no_input_grad_when_x_is_constant():
    x, kernel, bias, gamma, beta, _ = _inputs("random")
    xt, kt, bt, gt, bet, _ = _to_port(x, kernel, bias, gamma, beta, x[:1])
    xt.requires_grad_(False)
    out, _, _ = port.conv1_bn_pool(xt, kt, bt, gt, bet, train=True)
    out.sum().backward()
    assert xt.grad is None and kt.grad is not None


def test_shape_guard():
    assert port.supports(torch.zeros(2, 1, 101, 40))
    assert not port.supports(torch.zeros(2, 1, 101, 41))
    assert not port.supports(torch.zeros(2, 2, 101, 40))

