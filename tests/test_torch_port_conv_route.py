"""The row-slice route of models/layers.py::conv2d on the CPU.

``_RowSlicedConv2d`` hands cuDNN a convolution's input gradient or its
weight gradient in row slices; its forward is the whole-batch call. Called
directly at small shapes, ragged last slices included, it equals the
whole-batch ``F.conv2d`` and its autograd backward: the output exactly, dx
exactly where it is computed whole, and dx, dW and the bias gradient within
f32 rounding (1e-5 relative) where sums are added in another order (the
CPU's backend sums the bias gradient its own way; cuDNN's leaves it to the
same ``sum`` the route calls). ``row_slices`` decides from the input's
shape, dtype and device alone: of the 2x2 planes SmallCNN's blocks see at
the five attacks' features, those ``ROW_SLICES`` holds engage on CUDA in
f32 with a gradient, from their least rows (512 or more) up; the others,
256 rows and everything else keep today's call. Off CUDA ``conv2d`` is
``conv(x)`` itself, and a tensor-parallel conv takes ``tp.conv2d`` before
the rule is asked.
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from audiobd_tpu_torch.models import layers
from audiobd_tpu_torch.utils import profiling

RTOL = 1e-5


def _conv(c_in: int, c_out: int, bias: bool = True, kernel_size: int = 2, **kw) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, kernel_size, bias=bias, **kw)
    layers.init_uniform_(conv, torch.Generator().manual_seed(3))
    return conv


def _close(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool((a - b).abs().max() <= RTOL * b.abs().max() + 1e-7)


I, W = layers.INPUT_GRAD, layers.WEIGHT_GRAD


@pytest.mark.parametrize("route,n,bias,grads", [
    ((W, 3), 10, True, "both"),  # dW in slices of 3, 3, 3, 1
    ((I, 4), 10, True, "both"),  # dx in slices of 4, 4, 2
    ((I, 3), 10, False, "both"),  # dx in slices, no bias
    ((W, 16), 7, True, "both"),  # one slice: the whole-batch backward
    ((I, 4), 9, True, "x"),  # a frozen weight (FlowMur's surrogate): dx alone
    ((W, 4), 9, True, "weight"),  # an input that needs no gradient: dW and db alone
])
def test_sliced_conv_matches_whole_batch(route, n, bias, grads):
    conv = _conv(3, 4, bias)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((n, 3, 6, 5), generator=gen).requires_grad_(grads != "weight")
    conv.weight.requires_grad_(grads != "x")
    if conv.bias is not None:
        conv.bias.requires_grad_(grads != "x")
    g = torch.randn((n, 4, 5, 4), generator=gen)
    wanted = [t for t, on in ((x, grads != "weight"), (conv.weight, grads != "x"), (conv.bias, grads != "x"))
              if on and t is not None]

    y = layers._RowSlicedConv2d.apply(x, conv.weight, conv.bias, *route)
    got = torch.autograd.grad(y, wanted, g)
    y_ref = F.conv2d(x, conv.weight, conv.bias)
    ref = torch.autograd.grad(y_ref, wanted, g)

    assert torch.equal(y, y_ref)
    for t, a, b in zip(wanted, got, ref, strict=True):
        assert a.shape == b.shape
        if t is x and route[0] == W:
            assert torch.equal(a, b)  # computed whole, as autograd does
        else:
            assert _close(a, b)


# (case, input channels, output channels, x shape, device, compute dtype,
# gradient taken, what row_slices gives): each attack's block 2 and 3 planes
# at 1,024 rows, the least rows around, and what never engages
RULE = [
    ("BadNets block 2", 64, 64, (1024, 64, 100, 13), "cuda", torch.float32, True, (W, 256)),
    ("BadNets block 3", 64, 32, (1024, 64, 50, 7), "cuda", torch.float32, True, (I, 128)),
    ("Ultrasonic block 2", 64, 64, (1024, 64, 99, 13), "cuda", torch.float32, True, (W, 256)),
    ("DABA block 2", 64, 64, (1024, 64, 31, 13), "cuda", torch.float32, True, None),
    ("DABA block 3", 64, 32, (1024, 64, 16, 7), "cuda", torch.float32, True, (I, 512)),
    ("FlowMur block 2", 64, 64, (1024, 64, 31, 4), "cuda", torch.float32, True, (I, 512)),
    ("FlowMur block 3", 64, 32, (1024, 64, 16, 2), "cuda", torch.float32, True, None),
    ("block 1 unfused", 1, 64, (1024, 1, 101, 40), "cuda", torch.float32, True, None),
    ("block 2 at 2,048 rows", 64, 64, (2048, 64, 100, 13), "cuda", torch.float32, True, (W, 256)),
    ("block 2 at its least rows", 64, 64, (512, 64, 100, 13), "cuda", torch.float32, True, (W, 256)),
    ("block 2 under its least rows", 64, 64, (511, 64, 100, 13), "cuda", torch.float32, True, None),
    ("block 2 at 256 rows", 64, 64, (256, 64, 100, 13), "cuda", torch.float32, True, None),
    ("block 3 at its least rows", 64, 32, (512, 64, 50, 7), "cuda", torch.float32, True, (I, 128)),
    ("block 3 at 256 rows", 64, 32, (256, 64, 50, 7), "cuda", torch.float32, True, None),
    ("FlowMur block 2 at 768 rows", 64, 64, (768, 64, 31, 4), "cuda", torch.float32, True, None),
    ("DABA block 3 at 768 rows", 64, 32, (768, 64, 16, 7), "cuda", torch.float32, True, None),
    ("block 2 on the CPU", 64, 64, (1024, 64, 100, 13), "cpu", torch.float32, True, None),
    ("block 2 in bf16", 64, 64, (1024, 64, 100, 13), "cuda", torch.bfloat16, True, None),
    ("block 2 without a gradient", 64, 64, (1024, 64, 100, 13), "cuda", torch.float32, False, None),
    ("other channels", 64, 32, (1024, 64, 100, 13), "cuda", torch.float32, True, None),
]


@pytest.mark.parametrize("case,c_in,c_out,x_shape,device,dtype,needs_grad,expected", RULE, ids=[r[0] for r in RULE])
def test_shape_rule(case, c_in, c_out, x_shape, device, dtype, needs_grad, expected):
    assert layers.row_slices(_conv(c_in, c_out), x_shape, device, dtype, needs_grad) == expected


@pytest.mark.parametrize("kw", [dict(padding=1), dict(stride=2), dict(dilation=2), dict(groups=2),
                                dict(kernel_size=3)])
def test_shape_rule_keeps_other_geometries(kw):
    assert layers.row_slices(_conv(64, 64, **kw), (1024, 64, 100, 13), "cuda", torch.float32, True) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_off_cuda_is_todays_call(dtype):
    conv = _conv(64, 64)
    x = torch.randn((4, 64, 100, 13), generator=torch.Generator().manual_seed(1), requires_grad=True)
    before = profiling.counts()["sliced_convs"]
    y = layers.conv2d(conv, x, dtype)
    assert profiling.counts()["sliced_convs"] == before
    assert y.grad_fn.name() == ("ConvolutionBackward0" if dtype == torch.float32 else "AddBackward0")
    if dtype == torch.float32:
        assert torch.equal(y, conv(x))


def _rule_on_the_cpu(monkeypatch):
    """The rule told the CPU is CUDA, block 2's weight gradient sliced at 2
    rows from 4."""
    real = layers.row_slices
    monkeypatch.setattr(layers, "row_slices", lambda conv, shape, device, dtype, needs: real(conv, shape, "cuda",
                                                                                             dtype, needs))
    monkeypatch.setattr(layers, "ROW_SLICES", {(64, 100, 13, 64): (W, 2, 4)})


def test_conv2d_counts_each_routed_call(monkeypatch):
    """Each routed call counts once and equals the whole-batch call."""
    _rule_on_the_cpu(monkeypatch)
    conv = _conv(64, 64)
    x = torch.randn((5, 64, 100, 13), generator=torch.Generator().manual_seed(2), requires_grad=True)
    before = profiling.counts()["sliced_convs"]
    y = layers.conv2d(conv, x, torch.float32)
    y2 = layers.conv2d(conv, x, torch.float32)
    with torch.no_grad():
        layers.conv2d(conv, x, torch.float32)  # no gradient: today's call
    assert profiling.counts()["sliced_convs"] - before == 2
    assert y.grad_fn.name() == "_RowSlicedConv2dBackward"
    assert torch.equal(y, conv(x)) and torch.equal(y2, y)


def test_tensor_parallel_conv_keeps_its_branch(monkeypatch):
    _rule_on_the_cpu(monkeypatch)
    calls = []
    monkeypatch.setattr(layers.tp, "shard_of", lambda module: "shard")
    monkeypatch.setattr(layers.tp, "conv2d", lambda conv, shard, x, dtype: calls.append(shard) or conv(x))
    conv = _conv(64, 64)
    x = torch.randn((5, 64, 100, 13), generator=torch.Generator().manual_seed(2), requires_grad=True)
    before = profiling.counts()["sliced_convs"]
    layers.conv2d(conv, x, torch.float32)
    assert calls == ["shard"] and profiling.counts()["sliced_convs"] == before
