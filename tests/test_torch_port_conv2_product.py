"""The arithmetic of kernel D's product pass, emulated in plain torch.

Kernel D's product pass (csrc/conv2_bn_pool.cu::conv2_params_partial) forms
the three 257-row parameter products on the tensor cores in 3xTF32: each f32
operand split into a TF32 high part and a TF32 low part, three TF32 products
summed in f32. ``ops/conv2_bn_pool.py::product_3xtf32`` does the same in
torch; here it is held against a float64 product at block 2's widths (257
patch rows: 4·Cin taps and the ones row, Cin 64; 192 coefficient columns:
relu'·dz, relu', relu'·x̂ of 64 channels), and single-pass TF32 is shown to
be three orders of magnitude worse.

Tolerances: 3xTF32 within 1e-6 of the largest |entry| (f32 level: the split
leaves ~2⁻²¹ of each product, and the f32 sums over 4,096 positions add
~1e-7); ``tf32_round`` exact against a bit-level numpy rounding.
"""

import numpy as np
import pytest
import torch

from audiobd_tpu_torch.ops import conv2_bn_pool as op2


def test_tf32_round_matches_bit_rounding():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(10_000) * 10.0 ** rng.integers(-8, 8, 10_000),
                        [0.0, -0.0, 1.0, -1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11)]]).astype(np.float32)
    bits = x.view(np.uint32)
    mag = (bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)
    want = ((bits & np.uint32(0x80000000)) | (mag & np.uint32(0x7FFFE000))).view(np.float32)
    got = op2.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-3] == np.float32(1.0 + 2.0**-10) and got[-2] == 1.0 and got[-1] == -got[-3]  # ties away from 0
    assert (np.abs(got - x) <= 2.0**-11 * np.abs(x)).all()


@pytest.mark.parametrize("positions", [4096])
def test_product_3xtf32_matches_float64_at_block2_widths(positions):
    rng = np.random.default_rng(1)
    cin, c = 64, 64
    patches = np.maximum(rng.standard_normal((4 * cin + 1, positions)), 0.0).astype(np.float32)
    patches[-1] = 1.0  # the ones row of the bias
    r = np.maximum(rng.standard_normal((positions, c)) - 0.3, 0.0)
    won = rng.random((positions, c)) < 0.25
    coef = np.concatenate([np.where(won & (r > 0), rng.standard_normal((positions, c)) * 1e-3, 0.0),
                           (r > 0).astype(np.float64), np.where(r > 0, (r - 0.4) * 1.3, 0.0)], axis=1)
    a, b = torch.from_numpy(patches), torch.from_numpy(coef.astype(np.float32))
    truth = a.double() @ b.double()
    scale = float(truth.abs().max())
    err_3x = float((op2.product_3xtf32(a, b).double() - truth).abs().max())
    err_tf32 = float((op2.tf32_round(a) @ op2.tf32_round(b)).double().sub(truth).abs().max())
    assert err_3x <= 1e-6 * scale, (err_3x, scale)
    assert err_tf32 >= 100 * err_3x  # why one TF32 pass is never used
