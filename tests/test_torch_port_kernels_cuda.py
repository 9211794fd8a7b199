"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and skips
without a CUDA device. The file imports no JAX, so it runs on a GPU machine
without it (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_port_kernels_cuda.py -q -m cuda

Tolerances: MFCC rtol 1e-4, atol 1e-3 on every route of kernel A, in its
log-mel mode too (the FFT
path for n_fft of 2, 3, 5 and 7, radix 7 included; the Bluestein path for
the rest; buffers in shared memory, in one block's shared memory with the
tables read through the cache, over a thread-block cluster's shared memory
past one block's, or in device memory past a cluster of 8;
tests/test_pallas_mfcc.py's tolerance: f32 sums in another order, the FFT's
rounding grows like log n). Where plain dsp.mfcc's DFT bases would not fit
the card (n_fft 65537 and 131072: 17 and 69 GB), against a float64 MFCC
within atol 1e-3. Block-1 backward rtol 1e-4, atol 1e-5: the kernels
and the plain version recompute y and z bit-identically and route every
pool tie the same way, so only the order of the f32 sums differs.
Block-1 forward (kernel G) against the plain chain (cuDNN's conv and bias
add, torch's means, ``_norm_pool``'s torch ops) on the card: equal
(torch.equal). Both of G's passes form r from x as cuDNN's convolution
accumulates it (fused multiply-adds in tap order) and the bias as torch
adds it; train mode's first pass writes r and r·r for torch's means, and
the pool pass normalises with the given statistics, each step rounded as
the torch ops round it. Block-2/3 backward
(kernels D, E): max abs error <= 1e-4 * max|ref| + 1e-6 per output,
the same reasoning over sums of up to ~10^4 terms per entry (D's parameter
sums in 3xTF32 on the tensor cores, each product exact, f32 accumulation). D's routing: the
same zero/sign pattern as the plain routing (both form y in one fixed order)
and magnitudes within 1e-6 relative; E from it: 1e-3 * max|ref| + 1e-6.

bf16 modes (a bf16 g; x f32 or bf16 for B and C, bf16 for D and E): the
kernels and the plain version round x, the taps, r and z alike and route
every tie the same way, so only the order of the f32 sums differs: the
parameter gradients within 1e-5 * max|ref| + 1e-6 per output for B (a
small dw entry is a cancelling sum of ~1e4-1e5 terms, which the elementwise
bound above does not allow for: at (2, 801, 40, 64) in eval mode the plain
version alone is 0.83 of it against float64), and D's f32 tolerance above.
dx is a bf16 sum of bf16-rounded taps, each tap an f32 sum over the
channels in another order than the plain version's, so a tap can round the
other way: dx within 2 bf16 ulps of max|dx| (2**-6 * max|dx|).

The row-slice route of models/layers.py::conv2d at each plane of its table
(1,024 rows): the forward is the
whole-batch cuDNN call itself (torch.equal); the gradients within
1e-4 * max|ref| + 1e-6 of the unsliced cuDNN call and of a float64 one, the
bound kernels D and E are held to (sums of ~10^6 terms in another order).

AST's attention (models/layers.py::scaled_attention, SDPA's math backend)
at AST's tokens and heads, forward and backward, against float64 with TF32
off, as the program runs: o, dq, dk and dv within 1e-5 of their largest
entry, f32's reach (measured 5.7e-7 to 9.4e-7 on an H100; TF32's products
err by ~1e-3).

The epoch engine on one rank (train/scan_epoch.py) against the
single-device loop of tests/test_torch_port_scan_epoch.py on the card, with
cuDNN's deterministic algorithms: bit for bit (torch.equal), each batch
loss, each step's gradients, the state after the epoch and the returned
dict; a loss divided by a Python scalar (a product with its reciprocal on
CUDA) would show here.

Kernel F (the effects' recursions) against its plain loop on the card:
exactly equal (torch.equal). Every route forms every product and sum in the
JAX step's order without FMA and calls the same tanhf; the k = 0 ladder
leaves out stages 3-4, which can change only the sign of a zero, and
torch.equal compares values.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiobd_tpu_torch.dsp import MFCCParams, mfcc_features
from audiobd_tpu_torch.models import layers
from audiobd_tpu_torch.ops import conv1_bn_pool as op
from audiobd_tpu_torch.ops import conv2_bn_pool as op2
from audiobd_tpu_torch.ops import effects as op_fx
from audiobd_tpu_torch.ops import mfcc as op_mfcc
from audiobd_tpu_torch.ops.mfcc import fused_mfcc
from audiobd_tpu_torch.poison.device_prep import dequantize_pcm
from audiobd_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
F_KERNELS = (op_fx.LADDER_KERNEL, op_fx.LADDER_RESONANT_KERNEL, op_fx.PHASER_KERNEL)

SETTINGS = {
    "torchaudio": dict(sample_rate=16000, n_mfcc=40, n_fft=400, hop_length=160, parity="torchaudio"),
    "librosa": dict(sample_rate=16000, n_mfcc=40, n_fft=2048, hop_length=512, parity="librosa"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_mfcc_kernel_matches_plain(cuda, setting, dtype):
    x = (np.random.default_rng(11).standard_normal((5, 16000)) * 0.1).astype(np.float32)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    params = MFCCParams(**SETTINGS[setting])
    wavs = torch.from_numpy(x).to(cuda)
    out = _run_counted(wavs, params, "mfcc_fft")
    ref = mfcc_features(dequantize_pcm(wavs), params)[:, 0]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kw, route", [
    (dict(sample_rate=16000, n_fft=400, hop_length=160), "mfcc_fft"),  # AST's input: the main path's route
    (dict(sample_rate=44100, n_fft=1103, hop_length=441), "mfcc_bluestein"),
    (dict(sample_rate=44100, n_fft=2205, hop_length=441), "mfcc_fft_large"),
    (dict(sample_rate=44100, n_fft=16384, hop_length=441), "mfcc_fft_cluster"),
])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_mfcc_kernel_logmel_mode_matches_plain(cuda, kw, route, dtype):
    """The log-mel mode (no DCT table: the floored dB tile out) on each route
    that keeps its dB tile apart: shared memory, device memory, a cluster."""
    x = (np.random.default_rng(13).standard_normal((3, kw["sample_rate"])) * 0.1).astype(np.float32)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    params = MFCCParams(n_mels=128, features="logmel", **kw)
    wavs = torch.from_numpy(x).to(cuda)
    out = _run_counted(wavs, params, route)
    ref = mfcc_features(dequantize_pcm(wavs), params)[:, 0]
    assert out.shape == ref.shape and out.shape[-1] == 128
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-3)


ROUTES = (op_mfcc.MFCC_FFT_KERNEL, op_mfcc.MFCC_BLUESTEIN_KERNEL, op_mfcc.MFCC_LARGE_KERNEL,
          op_mfcc.MFCC_DEVICE_KERNEL, op_mfcc.MFCC_CLUSTER_KERNEL)


def _run_counted(wavs, params, route):
    """fused_mfcc, checking that it launched kernel A once, on ``route``."""
    before = {k.name: k.launches for k in ROUTES}
    out = fused_mfcc(wavs, params)
    torch.cuda.synchronize()
    assert {k.name: k.launches - before[k.name] for k in ROUTES} == {k.name: int(k.name == route) for k in ROUTES}
    return out


def _wavs44(cuda, dtype, seed, n=3):
    x = (np.random.default_rng(seed).standard_normal((n, 44100)) * 0.1).astype(np.float32)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return torch.from_numpy(x).to(cuda)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_mfcc_bluestein_path_matches_plain(cuda, dtype):
    """n_fft 1103 (prime; Ultrasonic's 44.1 kHz setting) takes the Bluestein
    path (the FFT kernel's chirp mode at L = 2240 = 8·8·5·7)."""
    wavs = _wavs44(cuda, dtype, seed=12)
    params = MFCCParams(sample_rate=44100, n_mfcc=40, n_fft=1103, hop_length=441)
    out = _run_counted(wavs, params, "mfcc_bluestein")
    ref = mfcc_features(dequantize_pcm(wavs), params)[:, 0]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kw,route", [
    (dict(n_fft=874, hop_length=441, top_db=None), "mfcc_bluestein"),  # 2 · 19 · 23, L = 1792
    (dict(n_fft=97, hop_length=441, n_mels=40, n_mfcc=13), "mfcc_bluestein"),  # L = 196: 8 thread groups
    (dict(n_fft=2039, hop_length=512), "mfcc_bluestein"),  # prime, L = 4096
    (dict(n_fft=3001, hop_length=441), "mfcc_fft_large"),  # prime, L = 6125 = 5³ · 7²: buffers alone in shared
])
def test_mfcc_bluestein_path_other_sizes(cuda, kw, route):
    wavs = _wavs44(cuda, "float32", seed=14, n=2)
    params = MFCCParams(sample_rate=44100, **kw)
    out = _run_counted(wavs, params, route)
    torch.testing.assert_close(out, mfcc_features(wavs, params)[:, 0], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("n_fft,route,path", [
    (2205, "mfcc_fft_large", "fft"),  # 3² · 5 · 7²: radix-7 stages, two groups, buffers alone in shared memory
    (4097, "mfcc_fft_large", "bluestein"),  # 17 · 241: L = 8232, 149,400 B of one block's shared memory
    (16384, "mfcc_fft_cluster", "fft"),  # 8⁴ · 4 over a cluster of 2 CTAs
])
def test_mfcc_dft_path_matches_plain(cuda, dtype, n_fft, route, path):
    """The routes that replaced the matrix DFT: n_fft 2205 as a direct
    radix-7 FFT, and transforms past the two-blocks layout in one block's
    shared memory or over a cluster's, each checked for the kernel and mode
    it launched."""
    wavs = _wavs44(cuda, dtype, seed=12)
    params = MFCCParams(sample_rate=44100, n_mfcc=40, n_fft=n_fft, hop_length=441)
    assert op_mfcc.mfcc_path(n_fft) == path
    out = _run_counted(wavs, params, route)
    ref = mfcc_features(dequantize_pcm(wavs), params)[:, 0]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-3)


def _mfcc64(wavs, params):
    """dsp.mfcc's function in float64 with torch.fft."""
    from audiobd_tpu_torch.dsp.mel import amplitude_to_db
    from audiobd_tpu_torch.dsp.stft import frame_signal, hann_window

    frames = frame_signal(dequantize_pcm(wavs).double(), params.n_fft, params.hop_length, pad_mode=params.pad_mode)
    window = torch.from_numpy(hann_window(params.n_fft)).to(wavs.device)
    spec = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    mel = spec @ torch.from_numpy(params.mel_fb()).to(wavs.device).double()
    return amplitude_to_db(mel, top_db=params.top_db) @ torch.from_numpy(params.dct()).to(wavs.device).double()


@pytest.mark.parametrize("n_fft,path", [(65537, "bluestein"), (131072, "fft")])
def test_mfcc_device_route_loops_over_clips(cuda, n_fft, path):
    """The device-memory route, now only past a cluster of 8 CTAs (n_fft
    65537's L = 134,456 and 131072): its grid holds two blocks an SM and each
    block loops over clips: with 37 clips more than that, blocks reuse their
    scratch, the dB tile's slot and the reduction buffer on a second clip.
    Held against a float64 MFCC (plain dsp.mfcc's bases would take 17 and
    69 GB)."""
    grid = 2 * torch.cuda.get_device_properties(cuda).multi_processor_count
    x = (np.random.default_rng(15).standard_normal((grid + 37, 70000)) * 0.1).astype(np.float32)
    wavs = torch.from_numpy(x).to(cuda)
    params = MFCCParams(sample_rate=44100, n_fft=n_fft, hop_length=32768)
    assert op_mfcc.mfcc_path(n_fft) == path
    out = _run_counted(wavs, params, "mfcc_fft_device")
    assert out.shape == (grid + 37, 3, 40)
    assert float((out.double() - _mfcc64(wavs, params)).abs().max()) <= 1e-3


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("n_fft,path,ctas", [(8193, "bluestein", 2), (16384, "fft", 2)])
def test_mfcc_cluster_route_matches_plain(cuda, dtype, n_fft, path, ctas):
    """The cluster route at n_fft 8193 (L = 16464 = 2⁴·3·7³) and 16384, each on
    2 CTAs, at (3, 44100), and at 37 clips more than the resident clusters,
    each of which then loops over clips; held to plain dsp.mfcc and to a
    float64 MFCC."""
    params = MFCCParams(sample_rate=44100, n_mfcc=40, n_fft=n_fft, hop_length=441)
    assert op_mfcc.mfcc_path(n_fft) == path
    route, clusters = op_mfcc.cluster_occupancy(params, 44100, cuda)
    assert route.cluster.ctas == ctas and clusters >= 1
    for wavs in (_wavs44(cuda, dtype, seed=16), _wavs44(cuda, dtype, seed=17, n=clusters + 37)[:, :9000]):
        out = _run_counted(wavs, params, "mfcc_fft_cluster")
        torch.testing.assert_close(out, mfcc_features(dequantize_pcm(wavs), params)[:, 0], rtol=1e-4, atol=1e-3)
        assert float((out.double() - _mfcc64(wavs, params)).abs().max()) <= 1e-3


@pytest.mark.parametrize("kw,route", [
    (dict(n_fft=480, hop_length=160), "mfcc_fft"),  # radices 8, 4, 3, 5
    (dict(n_fft=400, hop_length=160, top_db=None), "mfcc_fft"),
    (dict(n_fft=2048, hop_length=512, n_mfcc=13), "mfcc_fft"),  # FlowMur's setting
    (dict(n_fft=882, hop_length=160), "mfcc_fft"),  # 2 · 3² · 7²
    (dict(n_fft=343, hop_length=160, n_mels=40), "mfcc_fft"),  # 7³
    (dict(n_fft=8192, hop_length=512), "mfcc_fft_large"),  # one group, 128 KB of buffers
])
def test_mfcc_fft_path_other_plans(cuda, kw, route):
    x = (np.random.default_rng(13).standard_normal((3, 16000)) * 0.1).astype(np.float32)
    params = MFCCParams(**kw)
    wavs = torch.from_numpy(x).to(cuda)
    out = _run_counted(wavs, params, route)
    torch.testing.assert_close(out, mfcc_features(wavs, params)[:, 0], rtol=1e-4, atol=1e-3)


def test_mfcc_kernel_rejects_other_dtypes(cuda):
    with pytest.raises(ValueError, match="float32 or int16"):
        fused_mfcc(torch.zeros(2, 16000, dtype=torch.float64, device=cuda), MFCCParams())


def _block_inputs(shape, seed):
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.normal(size=(b, 1, h, w)))
    weight = t(rng.normal(size=(c, 1, 2, 2)) * 0.5)
    bias = t(rng.normal(size=(c,)) * 0.1 - 0.8)  # many relu zeros: exact pool ties
    gamma = t(1.0 + 0.3 * rng.normal(size=(c,)))
    gamma[0] = -gamma[0].abs()
    beta = t(0.1 * rng.normal(size=(c,)))
    g = t(rng.normal(size=(b, c, h - 1, (w - 1) // 3)))
    mu = t(0.3 * rng.random(c))
    inv = torch.rsqrt(t(rng.random(c)) + 0.5)
    return x, g, weight, bias, mu, inv, gamma * inv, beta - mu * gamma * inv


@pytest.mark.parametrize("shape", [
    (4, 9, 13, 8), (16, 101, 40, 64),
    # Kernel B: one clip; planes of 21 and 55 positions (not multiples of 4
    # or of a warp; 1,300 above runs full 128-position passes and a tail);
    # C 5 and 33, not multiples of a block's 8-channel slice; 801 frames of
    # 40 (hop 20 at 16 kHz): 10,400 positions a clip, four spans of 2,600.
    (1, 9, 13, 8), (3, 8, 10, 5), (2, 12, 16, 33), (2, 801, 40, 64),
    # FlowMur's surrogates and victim: 124 positions a clip, one span.
    (256, 32, 13, 64),
])
@pytest.mark.parametrize("train_bn", [True, False])
def test_block1_backward_kernels_match_plain(cuda, shape, train_bn):
    args = _block_inputs(shape, seed=sum(shape))
    ref = op.conv1_bn_pool_backward_plain(*args, train_bn=train_bn, need_dx=True)
    got = op.conv1_bn_pool_backward(*(a.to(cuda) for a in args), train_bn=train_bn, need_dx=True)
    for name, a, e in zip(("dx", "dweight", "dbias", "dgamma", "dbeta"), got, ref):
        torch.testing.assert_close(a.cpu(), e, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("shape", [
    # FlowMur's trigger search: one span of 124 positions, two channel groups.
    (256, 32, 13, 64), (1, 32, 13, 64), (3, 32, 13, 5), (2, 32, 13, 33),
    # The main path's clip: one span, a 62 KB tile, one channel group.
    (16, 101, 40, 64),
    # Spans with a halo row: 801 frames of 40 (8 spans of 100 conv rows), rows
    # of 130 samples (14 spans of 29), and a 4-row clip of 1027 samples.
    (2, 801, 40, 64), (2, 400, 130, 8), (3, 5, 1027, 16),
])
@pytest.mark.parametrize("train_bn", [True, False])
def test_block1_input_kernel_matches_plain(cuda, shape, train_bn):
    """Kernel C alone, one launch: eval mode takes no h12; train mode takes
    kernel B's h1, h2 (the plain version forms its own: same sums, another
    order)."""
    args = _block_inputs(shape, seed=sum(shape) + 7)
    ref = op.conv1_bn_pool_backward_plain(*args, train_bn=train_bn, need_dx=True, need_params=False)[0]
    x, g, weight, bias, *vecs = (a.to(cuda) for a in args)
    w5 = op._w5(weight, bias)
    h12 = op.conv1_bn_pool_bwd_params(x, g, w5, *vecs, train_bn=True)[7:9].contiguous() if train_bn else None
    before = op.BWD_INPUT_KERNEL.launches
    dx = op.conv1_bn_pool_bwd_input(x, g, w5, *vecs, h12, train_bn=train_bn)
    torch.cuda.synchronize()
    assert op.BWD_INPUT_KERNEL.launches == before + 1
    torch.testing.assert_close(dx.cpu(), ref, rtol=1e-4, atol=1e-5)


def test_frozen_eval_block_launches_kernel_c_alone(cuda):
    """A frozen eval-mode block (FlowMur's surrogate) launches C once and B
    never; with its parameters requiring gradients, B (its eval-mode counter,
    never the train-mode one) and C once each. dx agrees with the CPU either
    way."""
    x, _, weight, bias, _, _, _, _ = _block_inputs((8, 32, 13, 64), seed=9)
    gamma, beta = torch.linspace(-1.05, 1.45, 64), torch.linspace(-0.2, 0.3, 64)
    rmean, rvar = torch.linspace(0.1, 0.4, 64), torch.linspace(0.6, 1.4, 64)
    wts = torch.randn(8, 64, 31, 4, generator=torch.Generator().manual_seed(1))

    def run(device, params_grad):
        params = [t.to(device).requires_grad_(params_grad) for t in (weight, bias, gamma, beta)]
        xd = x.to(device).detach().requires_grad_(True)
        out = op.conv1_bn_pool(xd, *params, train=False, running_mean=rmean.to(device),
                               running_var=rvar.to(device))
        (out * wts.to(device) + 0.5 * out * out).sum().backward()
        return xd.grad

    for params_grad, launched in ((False, (0, 1)), (True, (1, 1))):
        counters = (op.BWD_PARAMS_EVAL_KERNEL, op.BWD_INPUT_KERNEL, op.BWD_PARAMS_KERNEL)
        before = [k.launches for k in counters]
        dx = run(cuda, params_grad)
        torch.cuda.synchronize()
        after = [k.launches for k in counters]
        assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (*launched, 0)
        torch.testing.assert_close(dx.cpu(), run(torch.device("cpu"), params_grad), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["ties", "tanh"])
def test_block1_eval_params_kernel_at_defense_shape(cuda, case):
    """Kernel B's eval mode (running statistics, parameter gradients only, no
    dx) at the shape the defenses' SAM and unlearning steps give it: x (256,
    1, 101, 40), C 64. ``ties``: _block_inputs's parameters, whose relu zeros
    tie pool windows exactly, and a random g. ``tanh``: g = d/d out of
    sum(tanh(out) * wts), out the eval block's output, formed on the CPU on
    one thread (ROADMAP §3); both sides take that g. It launches the
    eval-mode counter once and the train-mode one never.

    Tolerance: per output within 1e-5 · max|ref| + 1e-6, the bf16 tests'
    rule (``_params_close``): each entry is a sum of 332,800 terms, and a
    small one cancels (on the H100: one dweight entry of 256, -1.1016 in a
    gradient whose largest is 1,491, lies 1.1e-4 from the plain version;
    against a float64 sum over the same routing the kernel's largest error
    is 1.7e-4, the plain version's 3.8e-4: scripts/block1_eval_precision.py)."""
    x, g, weight, bias, *_ = _block_inputs((256, 101, 40, 64), seed=11)
    gamma, beta = torch.linspace(-1.05, 1.45, 64), torch.linspace(-0.2, 0.3, 64)
    rmean, rvar = torch.linspace(0.1, 0.4, 64), torch.linspace(0.6, 1.4, 64)
    if case == "tanh":
        weight, bias = weight * 0.6, bias + 0.8  # fewer relu zeros, so tanh' varies
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out = op.conv1_bn_pool(x, weight, bias, gamma, beta, train=False, running_mean=rmean, running_var=rvar)
            wts = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
            g = ((1.0 - torch.tanh(out) ** 2) * wts).contiguous()
        finally:
            torch.set_num_threads(threads)
    inv = torch.rsqrt(rvar + op.EPS)
    vecs = (rmean, inv, gamma * inv, beta - rmean * gamma * inv)
    ref = op.conv1_bn_pool_backward_plain(x, g, weight, bias, *vecs, train_bn=False, need_dx=False)
    before = op.BWD_PARAMS_EVAL_KERNEL.launches, op.BWD_PARAMS_KERNEL.launches
    got = op.conv1_bn_pool_backward(*(a.to(cuda) for a in (x, g, weight, bias, *vecs)), train_bn=False,
                                    need_dx=False)
    torch.cuda.synchronize()
    assert (op.BWD_PARAMS_EVAL_KERNEL.launches, op.BWD_PARAMS_KERNEL.launches) == (before[0] + 1, before[1])
    assert got[0] is None and ref[0] is None
    _params_close(got[1:], ref[1:])


def test_block1_input_kernel_takes_h12_in_train_mode_only(cuda):
    x, g, weight, bias, *vecs = (a.to(cuda) for a in _block_inputs((2, 9, 13, 8), seed=1))
    w5 = op._w5(weight, bias)
    with pytest.raises(ValueError, match="h12"):
        op.conv1_bn_pool_bwd_input(x, g, w5, *vecs, None, train_bn=True)
    with pytest.raises(ValueError, match="h12"):
        op.conv1_bn_pool_bwd_input(x, g, w5, *vecs, torch.zeros(2, 8, device=cuda), train_bn=False)


@pytest.mark.parametrize("loss", ["polynomial", "tanh"])
def test_block1_autograd_on_card_matches_cpu(cuda, loss):
    """The block through autograd on the card against the CPU. The
    polynomial loss gives g = wts + out. The tanh loss, the test's earlier
    form, failed in 3 of 20 processes while the CPU reference ran on torch's
    default threads (ROADMAP §3), so its CPU side runs on one thread."""
    x, _, weight, bias, _, _, _, _ = _block_inputs((8, 21, 31, 16), seed=3)
    gamma = torch.linspace(-1.05, 1.45, 16)  # no gamma near 0: there z ties at rounding level
    beta = torch.linspace(-0.2, 0.3, 16)
    wts = torch.randn(8, 16, 20, 10, generator=torch.Generator().manual_seed(0))

    def run(device):
        leaves = [t.to(device).requires_grad_(True) for t in (x, weight, bias, gamma, beta)]
        out, mu, var = op.conv1_bn_pool(*leaves, train=True)
        if loss == "tanh":
            (torch.tanh(out) * wts.to(device)).sum().backward()
        else:
            (out * wts.to(device) + 0.5 * out * out).sum().backward()
        return [out, mu, var] + [t.grad for t in leaves]

    before = op.BWD_PARAMS_KERNEL.launches, op.BWD_INPUT_KERNEL.launches
    got = run(cuda)
    assert (op.BWD_PARAMS_KERNEL.launches, op.BWD_INPUT_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    threads = torch.get_num_threads()
    if loss == "tanh":
        torch.set_num_threads(1)
    try:
        want = run(torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    for a, e in zip(got, want):
        torch.testing.assert_close(a.cpu(), e, rtol=1e-4, atol=1e-5)


def test_block1_kernels_on_card_statistics_match_plain(cuda):
    """Kernels B and C given the card's own forward statistics (mu, inv,
    scale, shift) against the plain version on the CPU with the same
    statistics, on the autograd test's inputs: with the forward's rounding
    out of the comparison the routing agrees element for element."""
    x, _, weight, bias, _, _, _, _ = _block_inputs((8, 21, 31, 16), seed=3)
    gamma = torch.linspace(-1.05, 1.45, 16)
    beta = torch.linspace(-0.2, 0.3, 16)
    wts = torch.randn(8, 16, 20, 10, generator=torch.Generator().manual_seed(0))
    xd, wd, bd, gd, betad = (t.to(cuda) for t in (x, weight, bias, gamma, beta))
    r = op._conv_relu(xd, wd, bd)
    mu = r.mean(dim=(0, 2, 3))
    inv = torch.rsqrt((r * r).mean(dim=(0, 2, 3)) - mu * mu + op.EPS)
    scale = gd * inv
    shift = betad - mu * scale
    out = op._norm_pool(r, gd, betad, mu, inv)
    g = (wts.to(cuda) + out).contiguous()  # the autograd test's g: d/d out of sum(out * wts + out² / 2)
    stats = (mu, inv, scale, shift)
    got = op.conv1_bn_pool_backward(xd, g, wd, bd, *stats, train_bn=True, need_dx=True)
    ref = op.conv1_bn_pool_backward_plain(x, g.cpu(), weight, bias, *(s.cpu() for s in stats),
                                          train_bn=True, need_dx=True)
    for name, a, e in zip(("dx", "dweight", "dbias", "dgamma", "dbeta"), got, ref):
        torch.testing.assert_close(a.cpu(), e, rtol=1e-4, atol=1e-5, msg=name)


# Kernel G at the planes block 1 sees: BadNets and JingleBack (101, 40),
# Ultrasonic (100, 40), FlowMur (32, 13), DABA (32, 40); the attacks'
# published batch of 256, the cells' 1,024 and a tail batch.
FORWARD_PLANES = {"badnets": (101, 40), "ultrasonic": (100, 40), "flowmur": (32, 13), "daba": (32, 40)}
FORWARD_ROWS = (256, 1024, 37)
FORWARD_COUNTERS = (op.FWD_RELU_KERNEL, op.FWD_KERNEL, op.FWD_EVAL_KERNEL)


def _forward_inputs(rows, plane, seed, device):
    """x like MFCC features (tens of dB); C = 64 channels whose biases leave
    some relu zeros (exact pool ties), γ[0] < 0."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    gamma = 1.0 + 0.3 * rng.normal(size=64)
    gamma[0] = -abs(gamma[0])
    return (t(rng.normal(size=(rows, 1, *plane)) * 25.0 - 8.0), t(rng.uniform(-0.5, 0.5, size=(64, 1, 2, 2))),
            t(rng.uniform(-0.5, 0.5, size=64)), t(gamma), t(0.1 * rng.normal(size=64)))


def _counted_forward(fn, *args):
    """fn(*args) and the launches it added to G's counters (train mode's two
    passes, eval mode)."""
    before = [k.launches for k in FORWARD_COUNTERS]
    out = fn(*args)
    torch.cuda.synchronize()
    return out, tuple(k.launches - b for k, b in zip(FORWARD_COUNTERS, before))


@pytest.mark.parametrize("rows", FORWARD_ROWS)
@pytest.mark.parametrize("plane", sorted(FORWARD_PLANES))
def test_forward_kernel_train_mode_equals_plain_chain(cuda, plane, rows):
    x, weight, bias, gamma, beta = _forward_inputs(rows, FORWARD_PLANES[plane], rows + len(plane), cuda)
    (r, r2), launched = _counted_forward(op.conv1_bn_pool_fwd_relu, x, weight, bias)
    assert launched == (1, 0, 0)
    assert torch.equal(r, op._conv_relu(x, weight, bias)) and torch.equal(r2, r * r)
    mu = r.mean(dim=(0, 2, 3))
    inv = torch.rsqrt(r2.mean(dim=(0, 2, 3)) - mu * mu + op.EPS)
    out, launched = _counted_forward(
        lambda: op.conv1_bn_pool_fwd(x, weight, bias, gamma, beta, mu, inv, train_bn=True))
    assert launched == (0, 1, 0)
    assert torch.equal(out, op._norm_pool(r, gamma, beta, mu, inv))


@pytest.mark.parametrize("rows", FORWARD_ROWS)
@pytest.mark.parametrize("plane", sorted(FORWARD_PLANES))
def test_forward_kernel_eval_mode_equals_plain_chain(cuda, plane, rows):
    x, weight, bias, gamma, beta = _forward_inputs(rows, FORWARD_PLANES[plane], rows + len(plane) + 1, cuda)
    rmean = torch.linspace(0.5, 4.0, 64, device=cuda)
    inv = torch.rsqrt(torch.linspace(2.0, 60.0, 64, device=cuda) + op.EPS)
    out, launched = _counted_forward(
        lambda: op.conv1_bn_pool_fwd(x, weight, bias, gamma, beta, rmean, inv, train_bn=False))
    assert launched == (0, 0, 1)
    assert torch.equal(out, op._norm_pool(op._conv_relu(x, weight, bias), gamma, beta, rmean, inv))


@pytest.mark.parametrize("plane", sorted(FORWARD_PLANES))
def test_forward_kernel_eval_mode_r_is_cudnns(cuda, plane):
    """With μ 0, inv 1, β 0 and γ ±1, z is ±r exactly, so the pooled output
    is each window's largest and smallest r: both equal to the r of cuDNN's
    convolution and torch's bias add."""
    x, weight, bias, _, _ = _forward_inputs(256, FORWARD_PLANES[plane], 5, cuda)
    r = op._conv_relu(x, weight, bias)
    windows = r.reshape(*r.shape[:3], r.shape[3] // 3, 3)
    zeros, ones = torch.zeros(64, device=cuda), torch.ones(64, device=cuda)
    top = op.conv1_bn_pool_fwd(x, weight, bias, ones, zeros, zeros, ones, train_bn=False)
    bottom = op.conv1_bn_pool_fwd(x, weight, bias, -ones, zeros, zeros, ones, train_bn=False)
    assert torch.equal(top, windows.amax(dim=-1)) and torch.equal(-bottom, windows.amin(dim=-1))


def test_forward_kernel_refuses_what_it_cannot_take(cuda):
    x, weight, bias, gamma, beta = _forward_inputs(4, (101, 40), 1, cuda)
    vecs = (gamma, beta, gamma.abs(), gamma.abs())
    pool = {
        "\\(W-1\\) % 3": (x[..., :-1].contiguous(), weight, bias, *vecs),
        "float32": (x.double(), weight, bias, *vecs),
        "contiguous": (torch.empty(4, 1, 40, 101, device=cuda).transpose(2, 3), weight, bias, *vecs),
        "device": (x, weight.cpu(), bias, *vecs),
        "inv has shape": (x, weight, bias, gamma, beta, gamma, gamma[:5]),
    }
    refusals = {
        op.conv1_bn_pool_fwd_relu: {
            "\\(B, 1, H, W\\)": (x[0], weight, bias),
            "float32": (x, weight, bias.double()),
            "contiguous": (x, weight.transpose(2, 3), bias),
            "device": (x, weight, bias.cpu()),
            "bias has shape": (x, weight, bias[:5]),
        },
        lambda *a: op.conv1_bn_pool_fwd(*a, train_bn=True): pool,
        lambda *a: op.conv1_bn_pool_fwd(*a, train_bn=False): pool,
    }
    before = [k.launches for k in FORWARD_COUNTERS]
    for fn, cases in refusals.items():
        for match, args in cases.items():
            with pytest.raises(ValueError, match=match):
                fn(*args)
    assert [k.launches for k in FORWARD_COUNTERS] == before


@pytest.mark.parametrize("train", [True, False])
def test_block1_forward_on_card_takes_kernel_g_in_f32_only(cuda, train):
    """The op on the card: f32 launches G once a call (its train or eval
    counter) and gives the plain chain's output, statistics included, bit
    for bit; the bf16 compute dtype launches no G."""
    x, weight, bias, gamma, beta = _forward_inputs(16, (101, 40), 7, cuda)
    rmean, rvar = torch.linspace(0.5, 4.0, 64, device=cuda), torch.linspace(2.0, 60.0, 64, device=cuda)
    stats = {} if train else dict(running_mean=rmean, running_var=rvar)

    def call(dtype):
        got = op.conv1_bn_pool(x, weight, bias, gamma, beta, train=train, compute_dtype=dtype, **stats)
        return got if train else (got,)

    for dtype, g_launches in ((torch.float32, (1, 1, 0) if train else (0, 0, 1)), (torch.bfloat16, (0, 0, 0))):
        got, launched = _counted_forward(call, dtype)
        assert launched == g_launches
        r = op._conv_relu(x, weight, bias, dtype)
        if train:
            mu = r.mean(dim=(0, 2, 3))
            var = (r * r).mean(dim=(0, 2, 3)) - mu * mu
            want = (op._norm_pool(r, gamma, beta, mu, torch.rsqrt(var + op.EPS), dtype), mu, var)
        else:
            want = (op._norm_pool(r, gamma, beta, rmean, torch.rsqrt(rvar + op.EPS), dtype),)
        assert all(torch.equal(a, e) for a, e in zip(got, want, strict=True))


def _block2_inputs(shape, pool_padding, seed):
    """x (B, Cin, H, W), g over the pooled grid, parameters with many relu
    zeros (exact pool ties) and one negative gamma, and forward statistics."""
    b, cin, h, w, c = shape
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.normal(size=(b, cin, h, w)))
    weight = t(rng.normal(size=(c, cin, 2, 2)) * 0.3)
    bias = t(rng.normal(size=(c,)) * 0.1 - 0.5)
    _, _, ho, wo, _, _ = op2.pool_dims(h, w, pool_padding)
    g = t(rng.normal(size=(b, c, ho, wo)))
    mu = t(0.3 * rng.random(c))
    inv = torch.rsqrt(t(rng.random(c)) + 0.5)
    gamma = t(1.0 + 0.3 * rng.normal(size=(c,)))
    gamma[0] = -gamma[0].abs()
    beta = t(0.1 * rng.normal(size=(c,)))
    return x, g, weight, bias, mu, inv, gamma * inv, beta - mu * gamma * inv


@pytest.mark.parametrize("shape,pool_padding", [
    ((3, 8, 12, 13, 16), (1, 1)), ((3, 8, 12, 13, 16), (0, 1)), ((2, 8, 13, 12, 8), (0, 0)),
    ((4, 64, 20, 13, 64), (1, 1)), ((4, 64, 11, 7, 32), (0, 1)), ((2, 24, 9, 21, 40), (1, 0)),
    # Kernel D's routing pass takes 32 channels a block in pairs, its product
    # pass 16: C 48 and 40 leave a partial group of each, C 3 an odd pair.
    ((3, 16, 12, 13, 32), (1, 1)), ((2, 16, 11, 7, 48), (0, 1)), ((2, 64, 9, 13, 48), (1, 1)),
    ((3, 16, 10, 9, 64), (1, 1)), ((2, 4, 5, 6, 3), (1, 1)),
])
def test_block2_backward_kernels_match_plain(cuda, shape, pool_padding):
    args = _block2_inputs(shape, pool_padding, seed=sum(shape))
    ref = op2.conv2_bn_pool_backward_plain(*args, pool_padding=pool_padding)
    before = op2.BWD_PARAMS_KERNEL.launches, op2.BWD_INPUT_KERNEL.launches
    got = op2.conv2_bn_pool_backward(*(a.to(cuda) for a in args), pool_padding=pool_padding)
    torch.cuda.synchronize()
    assert (op2.BWD_PARAMS_KERNEL.launches, op2.BWD_INPUT_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    for name, a, e in zip(("dx", "dweight", "dbias", "dgamma", "dbeta"), got, ref):
        err = float((a.cpu().double() - e.double()).abs().max())
        assert err <= 1e-4 * float(e.abs().max()) + 1e-6, (name, err)


def test_block2_autograd_on_card_matches_cpu(cuda):
    x, _, weight, bias, _, _, _, _ = _block2_inputs((4, 16, 14, 9, 16), (1, 1), seed=4)
    gamma = torch.linspace(-1.05, 1.45, 16)  # no gamma near 0: there z ties at rounding level
    beta = torch.linspace(-0.2, 0.3, 16)
    wts = torch.randn(4, 16, 7, 5, generator=torch.Generator().manual_seed(0))

    def run(device):
        leaves = [t.to(device).requires_grad_(True) for t in (x, weight, bias, gamma, beta)]
        out, mu, var = op2.conv2_bn_pool(*leaves, pool_padding=(1, 1))
        (torch.tanh(out) * wts.to(device)).sum().backward()
        return [out, mu, var] + [t.grad for t in leaves]

    for a, e in zip(run(cuda), run(torch.device("cpu"))):
        torch.testing.assert_close(a.cpu(), e, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("x_shape,c_out,frozen,route", [
    ((1024, 64, 100, 13), 64, False, (layers.WEIGHT_GRAD, 256)),  # the train cell's block 2
    ((1024, 64, 50, 7), 32, False, (layers.INPUT_GRAD, 128)),  # its block 3
    ((1024, 64, 31, 4), 64, True, (layers.INPUT_GRAD, 512)),  # the search cell's frozen surrogate, block 2
    ((1024, 64, 99, 13), 64, False, (layers.WEIGHT_GRAD, 256)),  # Ultrasonic's block 2
    ((1024, 64, 16, 7), 32, False, (layers.INPUT_GRAD, 512)),  # DABA's block 3
])
def test_row_slice_route_matches_whole_batch_cudnn(cuda, x_shape, c_out, frozen, route):
    gen = torch.Generator().manual_seed(x_shape[2])
    conv = torch.nn.Conv2d(x_shape[1], c_out, 2)
    layers.init_uniform_(conv, gen)
    conv = conv.to(cuda).requires_grad_(not frozen)
    x = torch.randn(x_shape, generator=gen).to(cuda).requires_grad_()
    g = torch.randn((x_shape[0], c_out, x_shape[2] - 1, x_shape[3] - 1), generator=gen).to(cuda)
    leaves = [x] if frozen else [x, conv.weight, conv.bias]
    assert layers.row_slices(conv, x_shape, "cuda", torch.float32, True) == route

    before = profiling.counts()["sliced_convs"]
    y = layers.conv2d(conv, x, torch.float32)
    assert profiling.counts()["sliced_convs"] == before + 1
    assert y.grad_fn.name() == "_RowSlicedConv2dBackward"
    got = torch.autograd.grad(y, leaves, g)
    y_ref = torch.nn.functional.conv2d(x, conv.weight, conv.bias)
    ref = torch.autograd.grad(y_ref, leaves, g)
    x64, w64, b64 = (t.detach().double().requires_grad_() for t in (x, conv.weight, conv.bias))
    ref64 = torch.autograd.grad(torch.nn.functional.conv2d(x64, w64, b64), [x64, w64, b64][:len(leaves)], g.double())
    torch.cuda.synchronize()
    assert torch.equal(y, y_ref)
    for name, a, e, e64 in zip(("dx", "dweight", "dbias"), got, ref, ref64):
        for against in (e.double(), e64):
            err = float((a.double() - against).abs().max())
            assert err <= 1e-4 * float(against.abs().max()) + 1e-6, (name, err)


@pytest.mark.parametrize("shape,pool_padding", [
    ((3, 8, 12, 13, 16), (1, 1)), ((4, 64, 20, 13, 64), (1, 1)), ((4, 64, 11, 7, 32), (0, 1)),
    ((2, 16, 11, 7, 48), (0, 1)), ((3, 16, 10, 9, 64), (1, 1)),
])
def test_block2_routing_and_input_from_it_match_plain(cuda, shape, pool_padding):
    x, g, weight, bias, mu, inv, scale, shift = _block2_inputs(shape, pool_padding, seed=sum(shape) + 1)
    w = op2.w257(weight, bias)
    dev = [t.to(cuda) for t in (x, g, w, mu, inv, scale, shift)]
    out, routing = op2.conv2_bn_pool_bwd_params(*dev, pool_padding=pool_padding)
    torch.cuda.synchronize()
    enc_ref = op2.conv2_routing_plain(x, w, scale, shift, pool_padding=pool_padding)
    enc = routing.enc.cpu()
    assert torch.equal(torch.sign(enc), torch.sign(enc_ref))
    assert float((enc - enc_ref).abs().max()) <= 1e-6 * float(enc_ref.abs().max())

    k4 = 4 * x.shape[1]
    before = op2.BWD_INPUT_KERNEL.launches
    dx = op2.conv2_bn_pool_bwd_input(routing, dev[1], dev[2], *dev[3:6], out[k4 + 3 : k4 + 5].contiguous(),
                                     pool_padding=pool_padding)
    torch.cuda.synchronize()
    assert op2.BWD_INPUT_KERNEL.launches == before + 1
    ref = op2.conv2_bn_pool_backward_plain(x, g, weight, bias, mu, inv, scale, shift, pool_padding=pool_padding)[0]
    err = float((dx.cpu().double() - ref.double()).abs().max())
    assert err <= 1e-3 * float(ref.abs().max()) + 1e-6, err


def test_block2_kernels_reject_other_dtypes(cuda):
    args = [a.to(cuda) for a in _block2_inputs((2, 8, 6, 5, 16), (1, 1), seed=0)]
    w = op2.w257(args[2], args[3])
    with pytest.raises(ValueError, match="float32"):
        op2.conv2_bn_pool_bwd_params(args[0].double(), args[1], w, *args[4:], pool_padding=(1, 1))
    _, routing = op2.conv2_bn_pool_bwd_params(args[0], args[1], w, *args[4:], pool_padding=(1, 1))
    with pytest.raises(ValueError, match="float32"):
        op2.conv2_bn_pool_bwd_input(routing._replace(enc=routing.enc.half()), args[1], w, *args[4:7],
                                    torch.zeros(2, 16, device=cuda), pool_padding=(1, 1))
    with pytest.raises(TypeError, match="Conv2Routing"):
        op2.conv2_bn_pool_bwd_input(routing.enc, args[1], w, *args[4:7], torch.zeros(2, 16, device=cuda),
                                    pool_padding=(1, 1))


# ---------------------------------------------------------------------------
# bf16 modes


def _dx_within_bf16_ulps(got, ref, ulps: int = 2) -> None:
    err = float((got.cpu().double() - ref.double()).abs().max())
    assert err <= ulps * 2.0 ** -7 * float(ref.abs().max()), err


def _params_close(got, ref) -> None:
    for name, a, e in zip(("dweight", "dbias", "dgamma", "dbeta"), got, ref):
        err = float((a.cpu().double() - e.double()).abs().max())
        assert err <= 1e-5 * float(e.abs().max()) + 1e-6, (name, err)


@pytest.mark.parametrize("shape", [
    (4, 9, 13, 8), (16, 101, 40, 64), (3, 8, 10, 5), (2, 12, 16, 33),
    # kernel B's spans (801 frames) and C's halo rows (rows of 130 samples); FlowMur's shape.
    (2, 801, 40, 64), (2, 400, 130, 8), (256, 32, 13, 64),
])
@pytest.mark.parametrize("train_bn", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_block1_bf16_kernels_match_plain(cuda, shape, train_bn, x_dtype):
    x, g, *rest = _block_inputs(shape, seed=sum(shape) + 11)
    args = (x.to(x_dtype), g.to(torch.bfloat16), *rest)
    ref = op.conv1_bn_pool_backward_plain(*args, train_bn=train_bn, need_dx=True)
    before = op.BWD_PARAMS_BF16_KERNEL.launches, op.BWD_INPUT_BF16_KERNEL.launches, op.BWD_PARAMS_KERNEL.launches
    got = op.conv1_bn_pool_backward(*(a.to(cuda) for a in args), train_bn=train_bn, need_dx=True)
    torch.cuda.synchronize()
    after = op.BWD_PARAMS_BF16_KERNEL.launches, op.BWD_INPUT_BF16_KERNEL.launches, op.BWD_PARAMS_KERNEL.launches
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0)
    assert got[0].dtype == x_dtype and all(t.dtype == torch.float32 for t in got[1:])
    _dx_within_bf16_ulps(got[0].float(), ref[0].float())
    _params_close(got[1:], ref[1:])


def test_block1_bf16_kernels_on_card_statistics_match_plain(cuda):
    """The bf16 block through autograd on the card launches the bf16 kernels,
    and B and C given the card's own forward statistics match the plain
    version given the same statistics."""
    x, _, weight, bias, _, _, _, _ = _block_inputs((8, 21, 31, 16), seed=3)
    gamma, beta = torch.linspace(-1.05, 1.45, 16), torch.linspace(-0.2, 0.3, 16)
    wts = torch.randn(8, 16, 20, 10, generator=torch.Generator().manual_seed(0))
    leaves = [t.to(cuda).requires_grad_(True) for t in (x, weight, bias, gamma, beta)]
    before = op.BWD_PARAMS_BF16_KERNEL.launches, op.BWD_INPUT_BF16_KERNEL.launches
    out, mu, var = op.conv1_bn_pool(*leaves, train=True, compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and mu.dtype == var.dtype == torch.float32
    (out.float() * wts.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (op.BWD_PARAMS_BF16_KERNEL.launches, op.BWD_INPUT_BF16_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert all(t.grad.dtype == torch.float32 and bool(torch.isfinite(t.grad).all()) for t in leaves)
    inv = torch.rsqrt(var.detach() + op.EPS)
    scale = leaves[3].detach() * inv
    stats = (mu.detach(), inv, scale, leaves[4].detach() - mu.detach() * scale)
    g = wts.to(cuda).to(torch.bfloat16)
    got = op.conv1_bn_pool_backward(leaves[0].detach(), g, leaves[1].detach(), leaves[2].detach(), *stats,
                                    train_bn=True, need_dx=True)
    ref = op.conv1_bn_pool_backward_plain(x, g.cpu(), weight, bias, *(s.cpu() for s in stats), train_bn=True,
                                          need_dx=True)
    _dx_within_bf16_ulps(got[0], ref[0])
    _params_close(got[1:], ref[1:])


@pytest.mark.parametrize("shape,pool_padding", [
    ((3, 8, 12, 13, 16), (1, 1)), ((3, 8, 12, 13, 16), (0, 1)), ((4, 64, 20, 13, 64), (1, 1)),
    ((4, 64, 11, 7, 32), (0, 1)), ((2, 16, 11, 7, 48), (0, 1)), ((2, 4, 5, 6, 3), (1, 1)),
])
def test_block2_bf16_kernels_match_plain(cuda, shape, pool_padding):
    x, g, *rest = _block2_inputs(shape, pool_padding, seed=sum(shape) + 3)
    args = (x.to(torch.bfloat16), g.to(torch.bfloat16), *rest)
    ref = op2.conv2_bn_pool_backward_plain(*args, pool_padding=pool_padding)
    before = op2.BWD_PARAMS_BF16_KERNEL.launches, op2.BWD_INPUT_BF16_KERNEL.launches
    got = op2.conv2_bn_pool_backward(*(a.to(cuda) for a in args), pool_padding=pool_padding)
    torch.cuda.synchronize()
    assert (op2.BWD_PARAMS_BF16_KERNEL.launches, op2.BWD_INPUT_BF16_KERNEL.launches) == (before[0] + 1,
                                                                                         before[1] + 1)
    assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:])
    _dx_within_bf16_ulps(got[0].float(), ref[0].float())
    for name, a, e in zip(("dweight", "dbias", "dgamma", "dbeta"), got[1:], ref[1:]):
        err = float((a.cpu().double() - e.double()).abs().max())
        assert err <= 1e-4 * float(e.abs().max()) + 1e-6, (name, err)
    w = op2.w257(args[2], args[3])
    dev = [t.to(cuda) for t in (args[0], args[1], w, *args[4:])]
    _, routing = op2.conv2_bn_pool_bwd_params(*dev, pool_padding=pool_padding)
    enc_ref = op2.conv2_routing_plain(args[0], w, args[6], args[7], pool_padding=pool_padding,
                                      compute_dtype=torch.bfloat16)
    assert torch.equal(routing.enc.cpu(), enc_ref)


def test_bf16_kernels_reject_mixed_dtypes(cuda):
    x, g, weight, bias, *vecs = (a.to(cuda) for a in _block_inputs((2, 9, 13, 8), seed=1))
    w5 = op._w5(weight, bias)
    with pytest.raises(ValueError, match="x in torch.float32 .bfloat16 only with a bfloat16 g"):
        op.conv1_bn_pool_bwd_params(x.to(torch.bfloat16), g, w5, *vecs, train_bn=True)
    with pytest.raises(ValueError, match="g in torch.float32 or torch.bfloat16"):
        op.conv1_bn_pool_bwd_input(x, g.half(), w5, *vecs, train_bn=False)
    args = [a.to(cuda) for a in _block2_inputs((2, 8, 6, 5, 16), (1, 1), seed=0)]
    w = op2.w257(args[2], args[3])
    with pytest.raises(ValueError, match="x in torch.bfloat16"):
        op2.conv2_bn_pool_bwd_params(args[0], args[1].to(torch.bfloat16), w, *args[4:], pool_padding=(1, 1))
    with pytest.raises(ValueError, match="w in torch.float32"):
        op2.conv2_bn_pool_bwd_params(args[0].to(torch.bfloat16), args[1].to(torch.bfloat16), w.to(torch.bfloat16),
                                     *args[4:], pool_padding=(1, 1))


@pytest.mark.parametrize("mode,rows,t", [
    ("ladder", 64, 16000), ("ladder resonant, driven", 64, 16000), ("ladder", 64, 1999),
    ("phaser", 64, 16000), ("phaser 4 stages", 64, 16000), ("phaser", 64, 1999),
    ("ladder", 1, 16000), ("phaser", 1, 4001), ("ladder", 37, 4001), ("ladder resonant, driven", 37, 4001),
    ("phaser 4 stages", 37, 4001), ("ladder", 300, 1999), ("phaser", 300, 1999),
])
def test_effects_kernel_matches_plain(cuda, mode, rows, t):
    """Every route of kernel F at (rows, T): T = 16000 as the kernels read
    it, T = 1999 and 4001 through the wrapper's zero padding to a multiple of
    4 and a ragged last tile; 1, 37 and 300 rows leave rows of the
    pipelines' last 8-row block idle. The ladder at k = 0 counts on
    ``effects_ladder``, at k != 0 on ``effects_ladder_resonant``."""
    from audiobd_tpu_torch.poison import effects as fx

    rng = np.random.default_rng(21)
    x = torch.from_numpy((rng.standard_normal((rows, t)) * 0.3).astype(np.float32)).to(cuda)
    if mode.startswith("ladder"):
        g = float(np.tan(np.pi * 1000.0 / 16000))
        args = (g / (1 + g), 1.2, 10 ** (6 / 20)) if "resonant" in mode else (g / (1 + g), 0.0, 10 ** (12 / 20))
        kernel = op_fx.LADDER_RESONANT_KERNEL if "resonant" in mode else op_fx.LADDER_KERNEL
        plain = lambda: op_fx.ladder_hpf12_plain(x, *args)  # noqa: E731
        run = lambda: op_fx.ladder_hpf12(x, *args)  # noqa: E731
    else:
        stages = 4 if "4 stages" in mode else 6
        a = torch.from_numpy(fx.phaser_coefficients(t, 16000)).to(cuda)
        kernel, plain = op_fx.PHASER_KERNEL, lambda: op_fx.phaser_plain(x, a, stages, 0.5)
        run = lambda: op_fx.phaser(x, a, stages, 0.5)  # noqa: E731
    before = {k.name: k.launches for k in F_KERNELS}
    got = run()
    torch.cuda.synchronize()
    assert {k.name: k.launches - before[k.name] for k in F_KERNELS} == {k.name: int(k is kernel) for k in F_KERNELS}
    ref = plain()
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert torch.equal(got, ref), f"max abs err {float((got - ref).abs().max()):.3e}"


def test_effects_kernel_empty_input_launches_nothing(cuda):
    """An empty batch returns an empty result without a launch, so every
    count of kernel F is a launch that ran."""
    x = torch.empty((0, 16000), device=cuda)
    a = torch.zeros(16000, device=cuda)
    before = [k.launches for k in F_KERNELS]
    assert op_fx.ladder_hpf12(x, 0.5, 0.0, 1.0).shape == (0, 16000)
    assert op_fx.ladder_hpf12(x, 0.5, 1.2, 1.0).shape == (0, 16000)
    assert op_fx.phaser(x, a, 6, 0.5).shape == (0, 16000)
    assert [k.launches for k in F_KERNELS] == before


def test_effects_pipeline_refuses_a_launch_it_cannot_run(cuda):
    """A pipeline launch whose shared memory is not the pipeline's, or whose
    T is not a multiple of 4, is refused in the C entry, and the wrapper's
    kernel raises without counting it."""
    x = torch.zeros((2, 64), device=cuda)
    y, a = torch.empty_like(x), torch.zeros(64, device=cuda)
    before = [k.launches for k in F_KERNELS]
    with pytest.raises(RuntimeError, match="effects_ladder failed"):
        op_fx.LADDER_KERNEL(cuda, op_fx.ptr(x), op_fx.ptr(y), 2, 64, 0.1, 1.0, op_fx.ladder_shared_bytes() + 16)
    with pytest.raises(RuntimeError, match="effects_phaser failed"):
        op_fx.PHASER_KERNEL(cuda, op_fx.ptr(x), op_fx.ptr(a), op_fx.ptr(y), 2, 62, 6, 0.5, 0.5,
                            op_fx.phaser_shared_bytes(6))
    assert [k.launches for k in F_KERNELS] == before


def test_attention_is_f32_on_the_card(cuda):
    """The pinned backend computes at f32's accuracy with TF32 off."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(8, 12, 146, 64, device=cuda, generator=g) for _ in range(4))
    qd, kd, vd = (t.double().requires_grad_(True) for t in (q, k, v))
    o64 = torch.softmax(qd @ kd.transpose(-1, -2) / 8.0, -1) @ vd
    want = (o64.detach(), *torch.autograd.grad(o64, (qd, kd, vd), do.double()))
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = layers.scaled_attention(qq, kk, vv)
    got = (o.detach(), *torch.autograd.grad(o, (qq, kk, vv), do))
    for a, b in zip(got, want):
        assert float((a.double() - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_one_rank_epoch_is_the_single_device_loop_on_the_card(cuda, kind, monkeypatch):
    from test_torch_port_scan_epoch import assert_bit_identical, one_rank_epochs

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    assert_bit_identical(*one_rank_epochs(kind, cuda))
