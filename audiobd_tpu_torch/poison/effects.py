"""Audio effects of the JingleBack style chains (port of
audiobd_tpu/poison/effects.py).

Standard published DSP algorithms with pedalboard's parameter semantics (the
reference applies pedalboard's JUCE effects as black boxes,
utils/styles_trigger.py:8-53): tanh-drive distortion, a modulated-delay
chorus, a phase-vocoder pitch shift, Freeverb, a Moog-style ladder HPF and
a modulated all-pass phaser. Each function takes (..., T) float32 on any
device and computes what the JAX function computes, in f32 with its scalars
rounded to f32 where they meet the signal (JAX's weak types):

* gain, distortion, chorus and the pitch shift are feed-forward tensor ops;
  the pitch shift's STFT and inverse are products with the DFT bases, as in
  JAX, and its resample goes through ``dsp/resample.py``;
* reverb keeps the JAX block form: a comb's writes feed back only at its
  delay D, so blocks of D samples depend block to block, and the damping
  lowpass inside a block is one product with the (D, D) table
  ``damp^(i−j)`` (float64 on the host, cast to f32; JAX runs the same linear
  map as an ``associative_scan``); the all-passes' blocks are vector ops;
* ladder_hpf12 and phaser recur sample by sample: their host coefficients
  are computed here in float64, as in JAX, and the recursion runs in
  ``ops/effects.py`` (kernel F on the card).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from audiobd_tpu_torch.dsp.resample import resample
from audiobd_tpu_torch.dsp.stft import hann_window
from audiobd_tpu_torch.ops import effects as op


def _table(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(device)


# ---------------------------------------------------------------------------
# Memoryless / feed-forward


def gain(x: torch.Tensor, gain_db: float) -> torch.Tensor:
    return x * (10.0 ** (gain_db / 20.0))


def distortion(x: torch.Tensor, drive_db: float = 25.0) -> torch.Tensor:
    """pedalboard.Distortion: tanh waveshaper with pre-gain."""
    return torch.tanh(x * (10.0 ** (drive_db / 20.0)))


def chorus(x: torch.Tensor, sample_rate: int, rate_hz: float = 1.0, depth: float = 0.25,
           centre_delay_ms: float = 7.0, feedback: float = 0.0, mix: float = 0.5) -> torch.Tensor:
    """Sine-LFO modulated fractional delay, wet/dry mix: wet(t) = x(t − d(t))
    by linear interpolation between clamped positions. ``depth`` is clamped
    to [0, 1] (JUCE's range; the reference's depth=5 saturates it). Only
    feedback 0 (every reference chain) is a pure gather."""
    if feedback != 0.0:
        raise ValueError("chorus takes feedback 0 only (every reference chain uses 0)")
    t = x.shape[-1]
    depth = float(np.clip(depth, 0.0, 1.0))
    centre = centre_delay_ms * 1e-3 * sample_rate
    mod_amp = depth * centre
    n = torch.arange(t, dtype=torch.float32, device=x.device)
    # The f32 phase 2π·rate·n/sr as XLA compiles the JAX expression: the
    # division by the constant becomes a product with its f32 reciprocal,
    # folded into the constant, n · (f32(2π·rate) · f32(1/sr)).
    step = np.float32(2.0 * math.pi * rate_hz) * np.float32(1.0 / sample_rate)
    lfo = torch.sin(n * float(step))
    delay = centre + mod_amp * lfo
    pos = torch.clamp(n - delay, 0.0, t - 1.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=t - 1)
    frac = pos - lo
    wet = x[..., lo] * (1.0 - frac) + x[..., hi] * frac
    return (1.0 - mix) * x + mix * wet


# ---------------------------------------------------------------------------
# Phase-vocoder pitch shift


@functools.lru_cache(maxsize=4)
def _dft_tables(n_fft: int) -> tuple[np.ndarray, ...]:
    """f32 (window, forward cos, forward −sin, inverse cos, inverse sin) of
    effects.py:77-109, built in float64."""
    n_bins = n_fft // 2 + 1
    ang = 2 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :] / n_fft
    wk = np.full(n_bins, 2.0)  # one-sided spectrum weights
    wk[0] = 1.0
    if n_fft % 2 == 0:
        wk[-1] = 1.0
    win = hann_window(n_fft).astype(np.float32)
    return (win, np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32),
            (np.cos(ang) * wk / n_fft).astype(np.float32), (np.sin(ang) * wk / n_fft).astype(np.float32))


def _stft_c(x: torch.Tensor, n_fft: int, hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex STFT (..., frames, bins) as (real, imag), by the DFT bases."""
    win, cb, sb, _, _ = _dft_tables(n_fft)
    pad = n_fft // 2
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)
    frames = xp.unfold(-1, n_fft, hop) * _table(win, x.device)
    return frames @ _table(cb, x.device), frames @ _table(sb, x.device)


@functools.lru_cache(maxsize=8)
def _ola_norm(n_fft: int, hop: int, n_frames: int) -> np.ndarray:
    """The win² overlap-add normalization of effects.py:113-117, in f32."""
    out_len = (n_frames - 1) * hop + n_fft
    idx = ((np.arange(n_frames) * hop)[:, None] + np.arange(n_fft)[None, :]).reshape(-1)
    norm = np.zeros(out_len, np.float32)
    np.add.at(norm, idx, np.tile((hann_window(n_fft) ** 2).astype(np.float32), n_frames))
    return np.maximum(norm, 1e-8)


def _istft(re_s: torch.Tensor, im_s: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """iSTFT with win²-normalized overlap-add (COLA holds at hop n_fft/4):
    the real part of the inverse DFT with the forward convention Im = −Σ x
    sin, so the DC and Nyquist bins' imaginary parts drop out."""
    win, _, _, icb, isb = _dft_tables(n_fft)
    n_frames = re_s.shape[-2]
    dev = re_s.device
    frames_t = (re_s @ _table(icb, dev).T - im_s @ _table(isb, dev).T) * _table(win, dev)
    out_len = (n_frames - 1) * hop + n_fft
    lead = frames_t.shape[:-2]
    cols = frames_t.reshape(-1, n_frames, n_fft).transpose(1, 2)  # (B, n_fft, frames)
    out = F.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop)).reshape(*lead, out_len)
    out = out / _table(_ola_norm(n_fft, hop, n_frames), dev)
    return out[..., n_fft // 2 : out_len - n_fft // 2]  # undo the centring pad


def pitch_shift(x: torch.Tensor, sample_rate: int, semitones: float, n_fft: int = 1024) -> torch.Tensor:
    """Phase-vocoder pitch shift (pedalboard.PitchShift: same duration, pitch
    × 2^(s/12)): time-stretch by rate = 2^(−s/12), reading fractional
    analysis frames at a fixed n_fft/4 synthesis hop, then resample by
    1000 → round(1000·rate) and trim or zero-pad to T."""
    hop = n_fft // 4
    rate = 2.0 ** (-semitones / 12.0)
    t_len = x.shape[-1]
    dev = x.device

    re, im = _stft_c(x, n_fft, hop)
    mag = torch.sqrt(re * re + im * im + 1e-20)
    phase = torch.atan2(im, re)
    n_frames = re.shape[-2]
    n_bins = n_fft // 2 + 1
    omega = _table(2.0 * np.pi * np.arange(n_bins) * hop / n_fft, dev)

    # The synthesis frames' count is decided on the host, in float64, as in
    # JAX (a float arange on the device can differ by one).
    steps = np.arange(0.0, n_frames - 1, rate)
    lo = np.floor(steps).astype(np.int64)
    frac = _table(steps - lo, dev)[:, None]
    lo_t = torch.from_numpy(lo).to(dev)
    hi_t = torch.from_numpy(np.minimum(lo + 1, n_frames - 1)).to(dev)

    mag_i = mag[..., lo_t, :] * (1 - frac) + mag[..., hi_t, :] * frac
    dphi = phase[..., hi_t, :] - phase[..., lo_t, :] - omega
    dphi = torch.remainder(dphi + math.pi, 2 * math.pi) - math.pi  # floor-mod, as jnp.mod
    advance = omega + dphi

    synth_phase = phase[..., :1, :] + torch.cat(
        [torch.zeros_like(advance[..., :1, :]), torch.cumsum(advance[..., :-1, :], dim=-2)], dim=-2)
    stretched = _istft(mag_i * torch.cos(synth_phase), mag_i * torch.sin(synth_phase), n_fft, hop)
    # stretched is ~T/rate long; resampling back to ~T scales the pitch by 1/rate.
    orig_f, new_f = 1000, int(round(1000 * rate))
    shifted = resample(stretched, orig_f, new_f) if orig_f != new_f else stretched
    cur = shifted.shape[-1]
    if cur >= t_len:
        return shifted[..., :t_len]
    return F.pad(shifted, (0, t_len - cur))


# ---------------------------------------------------------------------------
# Recursive filters

_FREEVERB_COMBS = np.array([1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617])
_FREEVERB_ALLPASS = np.array([556, 441, 341, 225])
_FREEVERB_SR = 44100


@functools.lru_cache(maxsize=16)
def _damping_map(d_len: int, damp: float) -> tuple[np.ndarray, np.ndarray]:
    """A block's damping recursion store[i] = damp·store[i−1] + u[i] as a
    linear map: store = u @ L.T + p·s_prev with L[i, j] = damp^(i−j) (j ≤ i)
    and p[i] = damp^(i+1); float64, cast to f32."""
    i = np.arange(d_len)
    lags = i[:, None] - i[None, :]
    lower = np.where(lags >= 0, float(damp) ** np.maximum(lags, 0).astype(np.float64), 0.0)
    return lower.astype(np.float32), (float(damp) ** (i + 1.0)).astype(np.float32)


def _blocks(sig: torch.Tensor, d_len: int) -> torch.Tensor:
    """(B, T) → (nb, B, D), zero-padded to whole blocks."""
    nb = -(-sig.shape[-1] // d_len)
    return F.pad(sig, (0, nb * d_len - sig.shape[-1])).reshape(sig.shape[0], nb, d_len).transpose(0, 1)


def _unblocks(outs: list[torch.Tensor], t_len: int) -> torch.Tensor:
    return torch.stack(outs, dim=1).reshape(outs[0].shape[0], -1)[:, :t_len]


def reverb(x: torch.Tensor, sample_rate: int, room_size: float = 0.5, damping: float = 0.5,
           wet_level: float = 0.33, dry_level: float = 0.4, width: float = 1.0) -> torch.Tensor:
    """Freeverb (8 damped combs in parallel, then 4 all-passes in series), the
    algorithm JUCE's Reverb (pedalboard.Reverb) implements, in the JAX
    package's block form (effects.py:185-258)."""
    comb_len = np.maximum((_FREEVERB_COMBS * sample_rate / _FREEVERB_SR).astype(int), 1)
    ap_len = np.maximum((_FREEVERB_ALLPASS * sample_rate / _FREEVERB_SR).astype(int), 1)
    feedback = room_size * 0.28 + 0.7
    damp = damping * 0.4
    wet_gain = wet_level * 3.0 * (width / 2.0 + 0.5)
    dry_gain = dry_level * 2.0
    flat = x.reshape(-1, x.shape[-1])
    t_len = flat.shape[-1]

    def comb_out(inp, d_len):
        """out[n] = w[n−D]; store[n] = d·store[n−1] + (1−d)·out[n];
        w[n] = inp[n] + f·store[n], from zero buffers."""
        lower, powers = (_table(a, x.device) for a in _damping_map(d_len, damp))
        w_prev = flat.new_zeros(flat.shape[0], d_len)
        s_prev = flat.new_zeros(flat.shape[0], 1)
        outs = []
        for x_block in _blocks(inp, d_len):
            out = w_prev  # the writes of one block ago are this block's reads
            store = ((1.0 - damp) * out) @ lower.T + powers * s_prev
            w_prev = x_block + feedback * store
            s_prev = store[:, -1:]
            outs.append(out)
        return _unblocks(outs, t_len)

    def allpass(sig, a_len):
        """out[n] = −sig[n] + buf[n−A]; buf[n] = sig[n] + 0.5·buf[n−A]."""
        buf = flat.new_zeros(flat.shape[0], a_len)
        outs = []
        for x_block in _blocks(sig, a_len):
            outs.append(-x_block + buf)
            buf = x_block + 0.5 * buf
        return _unblocks(outs, t_len)

    inp = flat * 0.015  # Freeverb's input gain
    acc = sum(comb_out(inp, int(d)) for d in comb_len)
    for a in ap_len:
        acc = allpass(acc, int(a))
    return (acc * wet_gain + flat * dry_gain).reshape(x.shape)


def ladder_hpf12(x: torch.Tensor, sample_rate: int, cutoff_hz: float = 1000.0, resonance: float = 0.0,
                 drive_db: float = 0.0) -> torch.Tensor:
    """Moog-style 4-stage ladder, HPF12 tap (JUCE LadderFilter Mode.HPF12):
    zero-delay (TPT) one-poles, two cascaded HP taps, resonance fed back
    from the fourth lowpass. The recursion is kernel F's ladder mode."""
    g = float(np.tan(np.pi * cutoff_hz / sample_rate))
    flat = x.reshape(-1, x.shape[-1])
    return op.ladder_hpf12(flat, g / (1.0 + g), 4.0 * resonance, 10.0 ** (drive_db / 20.0)).reshape(x.shape)


@functools.lru_cache(maxsize=8)
def phaser_coefficients(t: int, sample_rate: int, rate_hz: float = 1.0, depth: float = 0.5,
                        centre_frequency_hz: float = 1300.0) -> np.ndarray:
    """The all-pass coefficient a_t (T,) of a sine-LFO-swept corner
    frequency, float64 on the host, cast to f32 (effects.py:313-318)."""
    lfo = np.sin(2 * np.pi * rate_hz * np.arange(t) / sample_rate)
    fc = np.clip(centre_frequency_hz * (2.0 ** (depth * lfo)), 20.0, sample_rate * 0.45)
    warp = np.tan(np.pi * fc / sample_rate)
    return ((warp - 1.0) / (warp + 1.0)).astype(np.float32)


def phaser(x: torch.Tensor, sample_rate: int, rate_hz: float = 1.0, depth: float = 0.5,
           centre_frequency_hz: float = 1300.0, feedback: float = 0.0, mix: float = 0.5,
           stages: int = 6) -> torch.Tensor:
    """Cascaded first-order all-passes with a sine-LFO-modulated corner
    frequency (JUCE dsp::Phaser's parameters; ``feedback`` is not used, as
    in the JAX package). The recursion is kernel F's phaser mode."""
    a = _table(phaser_coefficients(x.shape[-1], sample_rate, rate_hz, depth, centre_frequency_hz), x.device)
    flat = x.reshape(-1, x.shape[-1])
    return op.phaser(flat, a, stages, mix).reshape(x.shape)
