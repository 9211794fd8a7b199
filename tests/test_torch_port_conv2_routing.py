"""Kernel D's routing by-product and kernel E from it, as plain torch,
against the JAX package's Pallas conv2_bn_pool.

On the card kernel D writes, per conv position and channel, the encoded r
(0 where r = 0, +r where relu is active and the position lost its pool
window, −r where it won) and kernel E forms dx from it with no recompute.
``conv2_routing_plain`` and ``conv2_input_from_routing_plain`` are those two
steps in plain torch; composed with the plain parameter pass (for h1, h2)
they must give the JAX op's VJP dx (Pallas in interpret mode). Inputs are
tie-heavy (mostly negative pre-activations: whole windows of relu zeros)
at block 2's and block 3's pool paddings.

Tolerance: dx within 1e-4 of its largest entry, as tests/test_torch_port_conv2.py
(sums over every conv position in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiobd_tpu.ops.fused_conv_block2 import conv2_bn_pool as jax_conv2_bn_pool
from audiobd_tpu_torch.ops import conv2_bn_pool as port

GRAD_REL = 1e-4

# (B, H, W, Cin, C), pool padding: block 2's (1, 1) and block 3's (0, 1),
# where floor mode drops the last conv row from every window, on odd and
# even conv grids.
CASES = [
    ((2, 12, 13, 8, 16), (1, 1)),
    ((2, 13, 8, 8, 16), (1, 1)),
    ((3, 11, 7, 16, 8), (0, 1)),
    ((2, 12, 9, 8, 16), (0, 1)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, pool_padding, ties):
    b, h, w, cin, c = shape
    rng = np.random.default_rng([*shape, *pool_padding, ties])
    x = rng.normal(size=(b, cin, h, w)).astype(np.float32)
    weight = (rng.normal(size=(c, cin, 2, 2)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1 - (1.0 if ties else 0.0)).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.normal(size=(c,))).astype(np.float32)
    gamma[0] = -abs(gamma[0])  # a negative scale: the zeros win the pool
    beta = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    _, _, ho, wo, _, _ = port.pool_dims(h, w, pool_padding)
    g = rng.normal(size=(b, c, ho, wo)).astype(np.float32)
    return x, weight, bias, gamma, beta, g


def _stats(x, weight, bias, gamma, beta):
    """The forward's mu, inv, scale, shift, as _TrainBlock.forward forms them."""
    r = torch.clamp(F.conv2d(x, weight, bias), min=0.0)
    mu = r.mean(dim=(0, 2, 3))
    inv = torch.rsqrt((r * r).mean(dim=(0, 2, 3)) - mu * mu + port.EPS)
    scale = gamma * inv
    return mu, inv, scale, beta - mu * scale


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("shape,pool_padding", CASES)
def test_dx_from_routing_matches_pallas(shape, pool_padding, ties):
    x, weight, bias, gamma, beta, g = _inputs(shape, pool_padding, ties)

    def loss(xj):
        out, _, _ = jax_conv2_bn_pool(xj, jnp.asarray(weight.transpose(2, 3, 1, 0)), jnp.asarray(bias),
                                      jnp.asarray(gamma), jnp.asarray(beta), pool_padding=pool_padding,
                                      interpret=True)
        return jnp.sum(out * jnp.asarray(g.transpose(0, 2, 3, 1)))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)

    t = [torch.from_numpy(a) for a in (x, weight, bias, gamma, beta, g)]
    xt, wt, bt, gt, bet, g_t = t
    mu, inv, scale, shift = _stats(xt, wt, bt, gt, bet)
    _, _, _, dgamma, dbeta = port.conv2_bn_pool_backward_plain(
        xt, g_t, wt, bt, mu, inv, scale, shift, pool_padding=pool_padding, need_dx=False)
    n_total = xt.shape[0] * (xt.shape[2] - 1) * (xt.shape[3] - 1)
    h1, h2 = scale * dbeta / n_total, scale * dgamma / n_total
    enc = port.conv2_routing_plain(xt, port.w257(wt, bt), scale, shift, pool_padding=pool_padding)
    dx = port.conv2_input_from_routing_plain(enc, g_t, wt, mu, inv, scale, h1, h2, pool_padding=pool_padding)

    assert dx.shape == xt.shape
    err = float(np.abs(dx.numpy().astype(np.float64) - ref).max())
    assert err <= GRAD_REL * float(np.abs(ref).max()), err


@pytest.mark.parametrize("shape,pool_padding", CASES)
def test_routing_encodes_r_and_one_winner_per_window(shape, pool_padding):
    x, weight, bias, gamma, beta, _ = _inputs(shape, pool_padding, ties=True)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, weight, bias))
    _, _, scale, shift = _stats(xt, wt, bt, torch.from_numpy(gamma), torch.from_numpy(beta))
    enc = port.conv2_routing_plain(xt, port.w257(wt, bt), scale, shift, pool_padding=pool_padding)
    r = torch.clamp(F.conv2d(xt, wt, bt), min=0.0)
    assert enc.shape == r.shape
    torch.testing.assert_close(enc.abs(), r, rtol=1e-5, atol=1e-5)
    assert bool(((enc == 0) == (r == 0)).all())
    # At most one winner (a negative entry) per pool window.
    _, _, _, _, hc, wc = port.pool_dims(x.shape[2], x.shape[3], pool_padding)
    ph, pw = pool_padding
    won = F.pad((enc < 0).float(), (pw, 2 * wc - pw - enc.shape[3], ph, 2 * hc - ph - enc.shape[2]))
    per_window = won.reshape(*won.shape[:2], hc, 2, wc, 2).sum(dim=(3, 5))
    assert per_window.max() <= 1 and (enc < 0).any() and (enc > 0).any()


def test_kernel_e_refuses_a_missing_routing():
    x, weight, bias, _, _, g = _inputs(CASES[0][0], (1, 1), ties=False)
    w = port.w257(torch.from_numpy(weight), torch.from_numpy(bias))
    c = w.shape[1]
    vecs = [torch.ones(c) for _ in range(3)]
    with pytest.raises(TypeError, match="Conv2Routing"):
        port.conv2_bn_pool_bwd_input(torch.zeros(2, c, 11, 12), torch.from_numpy(g), w, *vecs,
                                     torch.zeros(2, c), pool_padding=(1, 1))
    with pytest.raises(TypeError, match="Conv2Routing"):
        port.conv2_bn_pool_bwd_input(None, torch.from_numpy(g), w, *vecs, torch.zeros(2, c), pool_padding=(1, 1))
    routing = port.Conv2Routing(torch.zeros(2, c, 11, 12), (0, 1))
    with pytest.raises(ValueError, match="pool padding"):
        port.conv2_bn_pool_bwd_input(routing, torch.from_numpy(g), w, *vecs, torch.zeros(2, c), pool_padding=(1, 1))
