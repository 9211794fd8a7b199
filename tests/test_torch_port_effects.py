"""The port's JingleBack effects (poison/effects.py, ops/effects.py's plain
loops) against the JAX package's, on the CPU; the JAX functions jitted, as
the JAX package's boards run them.

Tolerances, on clips of peak 0.5 made from a seed with numpy:
* gain and distortion: atol 1e-6 (one f32 multiply; tanh's last ulp).
* chorus: the LFO's sin rounds differently in the two frameworks in the last
  ulp for a few percent of samples, and the read position n − delay, kept
  in f32 as in JAX, then can round to its f32 neighbour (spacing 2⁻¹⁰ at
  16,000). So a sample may differ by mix·max|x[i+1] − x[i]|·2·spacing(T − 1):
  that is the bound (measured up to 3.2e-5 at T = 2,000 and 2.4e-4 at T =
  16,000, against bounds of 7.1e-5 and 5.8e-4), and at least 95% of samples
  agree within 1e-6 (measured: 97.3-99.95%). The depth=5 clamp is exact.
* reverb (block form; the port's damping product against JAX's
  associative_scan): atol 1e-5 (measured ~5e-8).
* ladder_hpf12 and phaser, the plain loops against JAX's lax.scan: atol 1e-5
  (measured ~2e-7); kernel F's k = 0 ladder route, written as a loop without
  stages 3-4, the same against JAX at resonance 0, and equal as values to
  the full plain loop at k = 0.
* pitch_shift: the synthesized phase is a cumulative sum over ~110 frames of
  f32 phase advances up to ~800 rad, kept in f32 (an ulp is ~0.008 rad past
  65,536 rad), so the two frameworks' f32 runs differ by ~5e-4 (measured).
  Exception to a fixed tolerance: each is held against the JAX function in
  float64 (the same f32 tables), and the port's distance may be at most
  twice JAX's own f32 distance (measured: port 6.6e-4 and 2.1e-4, JAX
  3.9e-4 and 2.8e-4, at +10 and −5 semitones).
* the six boards on one-second clips: the same float64 rule for every style
  (measured, port and JAX: style 0 9.1e-4, 1.6e-3; style 3, pitch shift
  then 20 dB of drive, 4.1e-3, 6.5e-3; style 4 1.0e-3 each); styles 1 and 5
  also within 1e-5 of JAX directly (measured 2.4e-7, 3.0e-7).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.poison import effects as jfx
from audiobd_tpu.poison.jingleback import get_boards as jax_boards
from audiobd_tpu_torch.ops import effects as op
from audiobd_tpu_torch.ops.build import MAX_SHARED_BYTES
from audiobd_tpu_torch.poison import effects as fx
from audiobd_tpu_torch.poison.jingleback import get_boards

SR = 16000
CHORUS = {
    "style2": dict(rate_hz=1.0, depth=5.0, centre_delay_ms=10.0, mix=0.5),
    "style3": dict(rate_hz=1.0, depth=5.0, centre_delay_ms=8.0, mix=0.5),
    "style4": dict(centre_delay_ms=15.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clips(n: int, t: int, seed: int = 0) -> np.ndarray:
    """(n, t) f32 tones of 200-3000 Hz with noise, each of peak 0.5."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / SR
    x = 0.5 * np.sin(2 * np.pi * rng.uniform(200, 3000, (n, 1)) * tt) + 0.05 * rng.standard_normal((n, t))
    return (0.5 * x / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)


def run_jax(fn, x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


def run_port(fn, x: np.ndarray) -> np.ndarray:
    return fn(torch.from_numpy(x)).numpy()


def run_jax_f64(fn, x: np.ndarray, monkeypatch) -> np.ndarray:
    """``fn`` of the JAX package in float64, its f32 tables (the resampler's
    kernel bank too) promoted as they are."""
    jres = sys.modules["audiobd_tpu.dsp.resample"]
    kernel = jres._kernel
    monkeypatch.setattr(jres, "_kernel", lambda *a: (kernel(*a)[0].astype(np.float64), kernel(*a)[1]))
    with jax.enable_x64(True):
        out = np.asarray(jax.jit(fn)(jnp.asarray(x.astype(np.float64))))
    assert out.dtype == np.float64
    return out


@pytest.mark.parametrize("name,jf,pf", [
    ("gain 12 dB", lambda v: jfx.gain(v, 12.0), lambda v: fx.gain(v, 12.0)),
    ("distortion 30 dB", lambda v: jfx.distortion(v, 30.0), lambda v: fx.distortion(v, 30.0)),
    ("distortion 20 dB", lambda v: jfx.distortion(v, 20.0), lambda v: fx.distortion(v, 20.0)),
    ("distortion default", jfx.distortion, fx.distortion),
])
def test_feedforward_effects_match_jax(name, jf, pf):
    x = clips(3, 2000)
    got, ref = run_port(pf, x), run_jax(jf, x)
    assert got.shape == ref.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("t", [2000, 16000])
@pytest.mark.parametrize("chain", sorted(CHORUS))
def test_chorus_matches_jax(chain, t):
    kw = CHORUS[chain]
    x = clips(4, t, seed=1)
    got = run_port(lambda v: fx.chorus(v, SR, **kw), x)
    ref = run_jax(lambda v: jfx.chorus(v, SR, **kw), x)
    diff = np.abs(got - ref)
    bound = 1e-6 + kw.get("mix", 0.5) * np.abs(np.diff(x, axis=-1)).max() * 2 * np.spacing(np.float32(t - 1))
    print(f"chorus {chain} T={t}: max abs {diff.max():.3e} (bound {bound:.3e}), "
          f"{100 * (diff <= 1e-6).mean():.2f}% within 1e-6")
    assert diff.max() <= bound
    assert (diff <= 1e-6).mean() >= 0.95
    assert not np.allclose(got, x, atol=1e-3)
    if kw.get("depth", 0.25) > 1.0:  # the reference's depth=5 saturates at 1
        np.testing.assert_array_equal(got, run_port(lambda v: fx.chorus(v, SR, **dict(kw, depth=1.0)), x))


def test_chorus_refuses_feedback():
    with pytest.raises(ValueError, match="feedback 0"):
        fx.chorus(torch.zeros(1, 100), SR, feedback=0.1)


@pytest.mark.parametrize("room", [0.6, None])
def test_reverb_matches_jax(room):
    kw = {} if room is None else {"room_size": room}
    x = clips(3, 2000, seed=2)
    got = run_port(lambda v: fx.reverb(v, SR, **kw), x)
    ref = run_jax(lambda v: jfx.reverb(v, SR, **kw), x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.abs(got[:, 1000:]).max() > 0.05  # a tail, not just the dry path


def test_damping_map_is_the_recursion():
    lower, powers = fx._damping_map(7, 0.2)
    u, s_prev = np.random.default_rng(3).standard_normal((2, 7))
    store, s = [], s_prev[0]
    for v in u:
        s = 0.2 * s + v
        store.append(s)
    np.testing.assert_allclose(u @ lower.T.astype(np.float64) + powers * s_prev[0], store, rtol=1e-6)
    assert lower[0, 1] == 0.0 and lower.dtype == powers.dtype == np.float32


@pytest.mark.parametrize("resonance,drive_db,gain_db", [(0.0, 0.0, 12.0), (0.3, 6.0, 0.0)],
                         ids=["chain", "resonant, driven"])
def test_ladder_plain_loop_matches_jax_scan(resonance, drive_db, gain_db):
    x = clips(3, 2000, seed=4) * np.float32(10 ** (gain_db / 20))
    got = run_port(lambda v: fx.ladder_hpf12(v, SR, 1000.0, resonance, drive_db), x)
    ref = run_jax(lambda v: jfx.ladder_hpf12(v, SR, 1000.0, resonance, drive_db), x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def ladder_k0_route(x: torch.Tensor, big_g: float, drive: float) -> torch.Tensor:
    """Kernel F's ladder route at k = 0 (csrc/effects.cu) as a loop over
    time: u = tanh(x·drive) first, then the two one-pole HP stages (hp1 =
    u − lp1, y = hp1 − lp2); nothing of stages 3-4, which feed only k·s4."""
    u = torch.tanh(x * drive)
    s1 = s2 = x.new_zeros(x.shape[0])
    out = []
    for u_t in u.t():
        v = (u_t - s1) * big_g
        lp1 = v + s1
        s1 = lp1 + v
        hp1 = u_t - lp1
        v = (hp1 - s2) * big_g
        lp2 = v + s2
        s2 = lp2 + v
        out.append(hp1 - lp2)
    return torch.stack(out, dim=1)


def ladder_k0_rows(case: str) -> torch.Tensor:
    """Style 5's rows after its 12 dB gain (peak ~2: tanh saturates), and
    those rows with runs of +0.0 and −0.0 (a whole row of −0.0, a row that
    starts silent, −0.0 after a negative run, where s4 < 0 and the full
    loop's u is +0.0 against the route's −0.0) or with a NaN in the middle
    of a row."""
    x = torch.from_numpy(clips(5, 1200, seed=8)) * 10 ** (12 / 20)
    if case == "signed zeros":
        x[0] = -0.0
        x[1, :300] = 0.0
        x[1, 300:600:2] = -0.0
        x[2, ::7] = -0.0
        x[4, :300] = -1.5
        x[4, 300:] = -0.0
    elif case == "NaN":
        x[2, 500] = float("nan")
    return x


@pytest.mark.parametrize("drive_db", [0.0, 6.0])
@pytest.mark.parametrize("case", ["style 5 after 12 dB", "signed zeros", "NaN"])
def test_ladder_k0_route_equals_the_full_loop(case, drive_db):
    """Leaving out stages 3-4 at k = 0 changes no value: the k = 0 route
    equals ladder_hpf12_plain at k = 0 (torch.equal, which holds −0.0 equal
    to +0.0; NaN where the full loop has NaN, from the NaN on)."""
    x = ladder_k0_rows(case)
    g = np.tan(np.pi * 1000.0 / SR)
    big_g, drive = g / (1 + g), 10 ** (drive_db / 20)
    got, ref = ladder_k0_route(x, big_g, drive), op.ladder_hpf12_plain(x, big_g, 0.0, drive)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    if case == "NaN":
        assert torch.isnan(got[2, 500:]).all() and not torch.isnan(got[2, :500]).any()
        assert not torch.isnan(got[[0, 1, 3, 4]]).any()


@pytest.mark.parametrize("drive_db", [0.0, 6.0])
def test_ladder_k0_route_matches_jax_scan(drive_db):
    """The k = 0 route against JAX's ladder_hpf12 at resonance 0, the
    scan's stages 3-4 included, on style 5's rows after the 12 dB gain."""
    x = ladder_k0_rows("style 5 after 12 dB").numpy()
    g = np.tan(np.pi * 1000.0 / SR)
    got = ladder_k0_route(torch.from_numpy(x), g / (1 + g), 10 ** (drive_db / 20)).numpy()
    ref = run_jax(lambda v: jfx.ladder_hpf12(v, SR, 1000.0, 0.0, drive_db), x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_pipeline_shared_memory_fits_every_stage_count():
    """The pipelines' rings of 8-row tiles fit the card's 227 KB at every
    stage count the phaser takes."""
    assert op.ladder_shared_bytes() == 17_408
    assert [op.phaser_shared_bytes(st) for st in (1, op.MAX_STAGES)] == [27_648, 59_904]
    assert op.phaser_shared_bytes(op.MAX_STAGES) <= MAX_SHARED_BYTES


@pytest.mark.parametrize("stages", [6, 4])
def test_phaser_plain_loop_matches_jax_scan(stages):
    x = clips(3, 2000, seed=5)
    got = run_port(lambda v: fx.phaser(v, SR, stages=stages), x)
    ref = run_jax(lambda v: jfx.phaser(v, SR, stages=stages), x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_recursion_wrappers_check_their_inputs():
    x = torch.zeros(2, 8)
    a = torch.zeros(8)
    with pytest.raises(ValueError, match="1 to 8 stages"):
        op.phaser(x, a, 9, 0.5)
    with pytest.raises(ValueError, match="coefficients"):
        op.phaser(x, torch.zeros(7), 6, 0.5)
    with pytest.raises(ValueError, match="float32"):
        op.ladder_hpf12(x.double(), 0.1, 0.0, 1.0)
    with pytest.raises(ValueError, match="float32"):
        op.ladder_hpf12(x[0], 0.1, 0.0, 1.0)


def test_float4_padding_leaves_the_recursions_unchanged():
    """On the card the wrappers hand kernel F rows padded with zeros to a
    multiple of 4 samples, 16-byte aligned; the recursions are causal, so
    the first T outputs of a padded row are those of the row itself
    (compared exactly, through the plain loops)."""
    x = torch.from_numpy(clips(3, 401, seed=6))
    xp = op._float4_rows(x, 404)
    assert xp.shape == (3, 404) and torch.equal(xp[:, :401], x) and not xp[:, 401:].any()
    assert xp.data_ptr() % 16 == 0
    assert op._float4_rows(xp, 404) is xp
    unaligned = torch.zeros(3 * 404 + 1)[1:].view(3, 404)
    assert unaligned.data_ptr() % 16 and op._float4_rows(unaligned, 404).data_ptr() % 16 == 0
    a = torch.from_numpy(fx.phaser_coefficients(401, SR))
    assert torch.equal(op.ladder_hpf12_plain(xp, 0.2, 1.2, 2.0)[:, :401], op.ladder_hpf12_plain(x, 0.2, 1.2, 2.0))
    assert torch.equal(op.phaser_plain(xp, op._float4_rows(a, 404), 6, 0.5)[:, :401], op.phaser_plain(x, a, 6, 0.5))


@pytest.mark.parametrize("semitones", [10.0, -5.0])
def test_pitch_shift_matches_jax_by_its_float64_distance(semitones, monkeypatch):
    x = clips(3, SR, seed=6)
    got = run_port(lambda v: fx.pitch_shift(v, SR, semitones), x)
    ref = run_jax(lambda v: jfx.pitch_shift(v, SR, semitones), x)
    truth = run_jax_f64(lambda v: jfx.pitch_shift(v, SR, semitones), x, monkeypatch)
    d_port, d_jax = np.abs(got - truth).max(), np.abs(ref - truth).max()
    print(f"pitch shift {semitones:+}: port-f64 {d_port:.3e}, jax-f64 {d_jax:.3e}, "
          f"port-jax {np.abs(got - ref).max():.3e}")
    assert got.shape == x.shape and got.dtype == np.float32
    assert d_port <= 2 * d_jax + 1e-6


@pytest.mark.parametrize("style", range(6))
def test_boards_match_jax(style, monkeypatch):
    x = clips(2, SR, seed=10 + style)
    got = run_port(get_boards(SR)[style], x)
    ref = run_jax(jax_boards(SR)[style], x)
    truth = run_jax_f64(jax_boards(SR)[style], x, monkeypatch)
    d_port, d_jax = np.abs(got - truth).max(), np.abs(ref - truth).max()
    print(f"style {style}: port-f64 {d_port:.3e}, jax-f64 {d_jax:.3e}, port-jax {np.abs(got - ref).max():.3e}")
    assert got.shape == x.shape and np.isfinite(got).all()
    assert not np.allclose(got, x, atol=1e-3)
    assert d_port <= 2 * d_jax + 1e-6
    if style in (1, 5):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
