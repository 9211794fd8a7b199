"""The port's polyphase resampler (dsp/resample.py) against the JAX
package's (audiobd_tpu/dsp/resample.py), and the ingest's batching of
clips of unequal lengths (data/speech_commands.py::resample_rows) against
the clips one at a time. The pitch shift's pairs (1000, 561) and (1000,
1335) are checked at its stretched lengths (28,160 and 11,776 samples).

Both packages build the same float64 kernel bank and cast it to f32; the
convolutions are f32 sums of K = 2·width + orig products in another order
(XLA's against ATen's), so the outputs agree within 1e-6 of the input's
largest magnitude (measured below 2e-7). The batched rows must equal the
rows resampled alone within the same 1e-6: the padding zeros are the ones
each clip gets anyway, and only the convolution's summation order may
change with the batch's shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.dsp.resample import _kernel as jax_kernel
from audiobd_tpu.dsp.resample import resample as jax_resample
from audiobd_tpu_torch.data.speech_commands import resample_rows
from audiobd_tpu_torch.dsp.resample import _kernel, resample, resampled_length

# The last two are the pitch shift's (poison/effects.py): 1000 → round(1000·2^(−s/12))
# at +10 and −5 semitones.
RATES = [(16000, 44100), (22050, 16000), (48000, 44100), (8000, 16000), (16000, 16000), (1000, 561), (1000, 1335)]
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("orig,new", RATES)
def test_resample_matches_jax(orig, new):
    x = np.stack(_clips(orig + new, [3001] * 3))
    got = resample(torch.from_numpy(x), orig, new).numpy()
    ref = np.asarray(jax_resample(jnp.asarray(x), orig, new))
    assert got.shape == ref.shape == (3, resampled_length(3001, orig, new))
    assert np.max(np.abs(got - ref)) <= TOL * np.max(np.abs(x))
    if orig == new:
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("orig,new", RATES[:4])
def test_kernel_bank_is_the_reference_one(orig, new):
    g = np.gcd(orig, new)
    bank, width = _kernel(orig // g, new // g, 6, 0.99)
    ref_bank, ref_width = jax_kernel(orig // g, new // g, 6, 0.99)
    assert width == ref_width
    np.testing.assert_array_equal(bank, ref_bank)


@pytest.mark.parametrize("orig,new", RATES[:4])
def test_batch_of_unequal_lengths_equals_clips_alone(orig, new):
    keep = new // 4
    # The shortest clip is the shortest that still resamples to ``keep`` samples.
    shortest = next(n for n in range(1, orig) if resampled_length(n, orig, new) >= keep)
    clips = _clips(7, [shortest, orig // 4 + 17, orig // 3, shortest + 1])
    got = resample_rows(clips, orig, new, keep, torch.device("cpu"), chunk=3)
    assert got.shape == (4, keep)
    scale = max(float(np.max(np.abs(c))) for c in clips)
    for row, clip in zip(got.numpy(), clips):
        alone = resample(torch.from_numpy(clip), orig, new).numpy()[:keep]
        ref = np.asarray(jax_resample(jnp.asarray(clip[None]), orig, new))[0, :keep]
        assert np.max(np.abs(row - alone)) <= TOL * scale
        assert np.max(np.abs(row - ref)) <= TOL * scale


@pytest.mark.parametrize("n,orig,new,expected", [(16000, 16000, 44100, 44100), (15999, 16000, 44100, 44098),
                                                 (22050, 22050, 44100, 44100), (3, 48000, 44100, 3),
                                                 (28160, 1000, 561, 15798), (11776, 1000, 1335, 15721)])
def test_resampled_length_is_the_reference_one(n, orig, new, expected):
    assert resampled_length(n, orig, new) == expected
    assert np.asarray(jax_resample(jnp.zeros((1, n), jnp.float32), orig, new)).shape[1] == expected
