"""The port's conv2_bn_pool against the JAX package's Pallas op.

On the CPU the port's backward runs its plain version, the same recompute
and first-match tie rule as CUDA kernels D and E; the JAX op runs its Pallas
kernels in interpret mode. Layouts differ (the port is NCHW with OIHW
weights, the reference NHWC with HWIO), so inputs are transposed here.

Tolerances: out, μ and σ² rtol 1e-5, atol 1e-5 (both f32; the conv and the
batch statistics sum in another order). The five gradients 1e-4 of the
largest entry of each: they are sums of 257-term products over every conv
position in another order (the JAX package's own bound for this op,
tests/test_fused_conv_block2.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.ops.fused_conv_block2 import _pool_dims as jax_pool_dims
from audiobd_tpu.ops.fused_conv_block2 import conv2_bn_pool as jax_conv2_bn_pool
from audiobd_tpu_torch.ops import conv2_bn_pool as port

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4

# (B, H, W, Cin, C) and pool padding: odd and even conv grids for both
# overhang cases of the floor-mode pool; (8, 100, 13, 64, 64) is block 2's
# width and (8, 50, 7, 64, 32) block 3's, where pool padding (0, 1) drops
# the last conv row from every window.
CASES = [
    ((3, 12, 13, 8, 16), (1, 1)),
    ((3, 12, 13, 8, 16), (0, 1)),
    ((3, 12, 13, 8, 16), (0, 0)),
    ((2, 13, 12, 8, 8), (1, 1)),
    ((8, 100, 13, 64, 64), (1, 1)),
    ((8, 50, 7, 64, 32), (0, 1)),
]

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once
    (pytest-xdist), and torch's thread pool on these small tensors then
    costs more in synchronisation than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _inputs(shape, pool_padding, case):
    b, h, w, cin, c = shape
    rng = np.random.default_rng([*shape, *pool_padding, case == "ties"])
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    kernel = (rng.normal(size=(2, 2, cin, c)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    if case == "ties":
        # Mostly negative pre-activations: relu zeros fill whole pool
        # windows, so z ties exactly and the first-match rule decides.
        bias -= 1.0
    gamma = (1.0 + 0.2 * rng.normal(size=(c,))).astype(np.float32)
    gamma[0] = -abs(gamma[0])  # a negative scale: the zeros win the pool
    beta = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    _, _, ho, wo, _, _ = port.pool_dims(h, w, pool_padding)
    wts = rng.normal(size=(b, ho, wo, c)).astype(np.float32)
    return x, kernel, bias, gamma, beta, wts


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))), 1e-12)


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("shape,pool_padding", CASES)
def test_train_block_matches_pallas(shape, pool_padding, case):
    x, kernel, bias, gamma, beta, wts = _inputs(shape, pool_padding, case)

    def loss(args):
        out, mu, var = jax_conv2_bn_pool(*args, pool_padding=pool_padding, interpret=True)
        return jnp.sum(jnp.tanh(out) * wts), (out, mu, var)

    args = tuple(jnp.asarray(a) for a in (x, kernel, bias, gamma, beta))
    (_, (out_j, mu_j, var_j)), grads_j = jax.value_and_grad(loss, has_aux=True)(args)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)  # noqa: E731
    leaves = [t(_nchw(x)), t(kernel.transpose(3, 2, 0, 1)), t(bias), t(gamma), t(beta)]
    out, mu, var = port.conv2_bn_pool(*leaves, pool_padding=pool_padding)
    torch.sum(torch.tanh(out) * torch.from_numpy(np.ascontiguousarray(_nchw(wts)))).backward()

    if case == "ties":  # whole windows of relu zeros: the pooled value is the zeros' z
        out_np = np.asarray(out_j)
        assert (out_np == out_np.min(axis=(0, 1, 2), keepdims=True)).mean() > 0.1
    np.testing.assert_allclose(out.detach().numpy(), _nchw(out_j), err_msg="out", **TOL)
    np.testing.assert_allclose(mu.numpy(), mu_j, err_msg="mean", **TOL)
    np.testing.assert_allclose(var.numpy(), var_j, err_msg="var", **TOL)
    refs = (_nchw(grads_j[0]), np.asarray(grads_j[1]).transpose(3, 2, 0, 1), *grads_j[2:])
    for name, leaf, ref in zip(("dx", "dkernel", "dbias", "dgamma", "dbeta"), leaves, refs):
        assert _rel(leaf.grad.numpy(), ref) < GRAD_REL, name


@pytest.mark.parametrize("h,w", [(100, 13), (50, 7), (12, 13), (13, 12), (2, 2), (3, 5)])
@pytest.mark.parametrize("pool_padding", [(1, 1), (0, 1), (1, 0), (0, 0)])
def test_pool_dims_match_reference(h, w, pool_padding):
    assert port.pool_dims(h, w, pool_padding) == jax_pool_dims(h, w, pool_padding)


def test_w257_row_order_is_the_reference_reshape():
    """Row (kh·2 + kw)·Cin + ci of the port's taps is HWIO kernel.reshape(4·Cin, C)."""
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(2, 2, 3, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    got = port.w257(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), np.concatenate([kernel.reshape(12, 5), bias[None]]))
