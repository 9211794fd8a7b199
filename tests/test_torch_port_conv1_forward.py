"""Block 1's forward on the CPU: which path it takes, and what kernel G's
wrapper refuses.

On the card, in f32, ``ops/conv1_bn_pool.py``'s forward is kernel G
(``tests/test_torch_port_kernels_cuda.py`` holds it against the plain
chain there). A CPU tensor, and the bf16 compute dtype, keep the plain
chain: here its output, batch statistics included, is held bit for bit to
the chain as the port ran it before G (``_chain`` below, written out), and
G's counters stay where they were. G's wrapper checks its inputs before it
launches anything, in the order shape, dtype, layout, device, so each
refusal but the device's shows on CPU tensors too.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiobd_tpu_torch.ops import conv1_bn_pool as op

COUNTERS = (op.FWD_RELU_KERNEL, op.FWD_KERNEL, op.FWD_EVAL_KERNEL)
# (B, H, W, C): a BadNets clip's plane, FlowMur's, a short tail batch of odd sizes.
SHAPES = [(3, 101, 40, 64), (8, 32, 13, 64), (5, 9, 13, 7)]


def _inputs(shape, seed=0):
    b, h, w, c = shape
    rng = np.random.default_rng(seed + sum(shape))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    gamma = 1.0 + 0.3 * rng.normal(size=c)
    gamma[0] = -abs(gamma[0])
    return (t(rng.normal(size=(b, 1, h, w))), t(rng.normal(size=(c, 1, 2, 2)) * 0.5), t(rng.normal(size=c) * 0.3 - 0.2),
            t(gamma), t(0.1 * rng.normal(size=c)), t(rng.random(c) * 0.3), t(0.5 + rng.random(c)))


def _chain(x, weight, bias, gamma, beta, rmean, rvar, dtype, train):
    """The block's forward before kernel G: relu(conv) (in bf16 the
    reference's roundings), the batch statistics by torch's means, the
    normalisation and the (1, 3) max-pool."""
    if dtype == torch.float32:
        r = torch.clamp(F.conv2d(x, weight, bias), min=0.0)
    else:
        y = F.conv2d(x.to(dtype), weight.to(dtype)) + bias.to(dtype).reshape(1, -1, 1, 1)
        r = torch.clamp(y, min=0.0).to(torch.float32)
    c = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
    if train:
        mu = r.mean(dim=(0, 2, 3))
        var = (r * r).mean(dim=(0, 2, 3)) - mu * mu
    else:
        mu, var = rmean, rvar
    out = F.max_pool2d(((r - c(mu)) * c(torch.rsqrt(var + 1e-5)) * c(gamma) + c(beta)).to(dtype), (1, 3))
    return (out, mu, var) if train else out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
def test_cpu_forward_is_the_plain_chain(shape, dtype, train):
    x, weight, bias, gamma, beta, rmean, rvar = _inputs(shape)
    before = [k.launches for k in COUNTERS]
    running = {} if train else dict(running_mean=rmean, running_var=rvar)
    got = op.conv1_bn_pool(x, weight, bias, gamma, beta, train=train, compute_dtype=dtype, **running)
    want = _chain(x, weight, bias, gamma, beta, rmean, rvar, dtype, train)
    assert [k.launches for k in COUNTERS] == before
    for a, e in zip(got, want) if train else [(got, want)]:
        assert a.dtype == e.dtype and torch.equal(a, e)


@pytest.mark.parametrize("is_cuda", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_runs_on_cuda_in_f32_only(is_cuda, dtype):
    assert op.uses_forward_kernel(SimpleNamespace(is_cuda=is_cuda), dtype) == (is_cuda and dtype == torch.float32)


def _refusals():
    """{mode: {message: arguments}}: each breaks one rule of G's wrapper
    (the first pass's, or the pool pass's in train or eval mode)."""
    x, weight, bias, gamma, beta, rmean, rvar = _inputs((2, 101, 40, 64))
    vecs = (gamma, beta, rmean, torch.rsqrt(rvar + op.EPS))
    pool = {
        "\\(W-1\\) % 3": (x[..., :-1].contiguous(), weight, bias, *vecs),
        "inv has shape": (x, weight, bias, *vecs[:3], vecs[3][:5]),
        "float32": (x, weight, bias.double(), *vecs),
        "contiguous": (torch.empty(2, 1, 40, 101).transpose(2, 3), weight, bias, *vecs),
        "CUDA device": (x, weight, bias, *vecs),
    }
    return {
        "relu": {
            "\\(B, 1, H, W\\)": (x[0], weight, bias),
            "weight has shape": (x, weight[:, :, :1].contiguous(), bias),
            "float32": (x.double(), weight, bias),
            "contiguous": (x, weight.transpose(2, 3), bias),
            "CUDA device": (x, weight, bias),
        },
        "train": pool,
        "eval": pool,
    }


@pytest.mark.parametrize("mode,match", [(mode, match) for mode, cases in _refusals().items() for match in cases])
def test_forward_kernel_wrapper_refuses_before_launching(mode, match):
    args = _refusals()[mode][match]
    before = [k.launches for k in COUNTERS]
    with pytest.raises(ValueError, match=match):
        if mode == "relu":
            op.conv1_bn_pool_fwd_relu(*args)
        else:
            op.conv1_bn_pool_fwd(*args, train_bn=mode == "train")
    assert [k.launches for k in COUNTERS] == before
