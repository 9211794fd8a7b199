"""The port's wav ingest against the JAX package's: wav reading and
writing, the native batch decoder, and ``prepare_clean_dataset`` on a wav
tree that mixes rates and lengths, with the npy cache round trip.

Exact (bit-equal): written wav bytes, read samples, the native int16 and
f32 decodes, the labels, the split, and the clips that need no resampling
(PCM16 and PCM8 at the attack's 44.1 kHz). Within tolerance: the resampled
clips (8 kHz, 16 kHz and 22,050 Hz → 44.1 kHz), within 1e-6 of the largest sample
(f32 convolutions summed in another order, tests/test_torch_port_resample.py;
measured bit-equal here), and the MFCCs (the Ultrasonic setting, n_fft 1103,
both packages' plain MFCC): the port's within rtol 1e-4, atol 1e-3 of a
float64 MFCC of the same clips (the repo's MFCC tolerance,
tests/test_pallas_mfcc.py), and within rtol 1e-4, atol 3e-3 of the JAX
package's. A resampled clip has nothing above 4, 8 or 11 kHz, so its top mel
bands lie in the resampler's stopband, 70-80 dB down, where the f32
transform's rounding shows in the dB value: JAX's MFCC lies up to 2.0e-3
from the float64 one there, the port's 2.2e-4 (measured on resampled noise).
"""

import os
import wave

import numpy as np
import pytest
import torch

from audiobd_tpu.configs import make_config as jax_make_config
from audiobd_tpu.data import native as jax_native
from audiobd_tpu.data.speech_commands import load_clean_data as jax_load_clean_data
from audiobd_tpu.data.speech_commands import prepare_clean_dataset as jax_prepare
from audiobd_tpu.data.wavio import read_wav as jax_read_wav
from audiobd_tpu.data.wavio import write_wav as jax_write_wav
from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.data import native
from audiobd_tpu_torch.data.speech_commands import load_clean_data, mfcc_params, prepare_clean_dataset
from audiobd_tpu_torch.data.wavio import read_wav, write_wav
from audiobd_tpu_torch.dsp.mel import amplitude_to_db
from audiobd_tpu_torch.dsp.stft import frame_signal, hann_window

SR = 44100
FIELDS = ("train_wav", "test_wav", "train_mfcc", "test_mfcc", "train_label", "test_label")


def _mfcc_float64(wavs: np.ndarray) -> np.ndarray:
    """The torchaudio-parity MFCC at the Ultrasonic setting in float64 (rfft)."""
    params = mfcc_params(make_config("ultrasonic"))
    frames = frame_signal(torch.from_numpy(wavs[:, 0]).double(), params.n_fft, params.hop_length,
                          pad_mode=params.pad_mode)
    spec = torch.fft.rfft(frames * torch.from_numpy(hann_window(params.n_fft)), dim=-1).abs() ** 2
    mel = spec @ torch.from_numpy(params.mel_fb()).double()
    db = amplitude_to_db(mel, top_db=params.top_db) @ torch.from_numpy(params.dct()).double()
    return db.numpy()[:, None]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw_wav(path, data: np.ndarray, rate: int, width: int, fmt: int = 1) -> None:
    """Write ``data`` (frames, channels) as a RIFF file of sample ``width``
    bytes; fmt 3 is IEEE float (the ``wave`` module writes PCM only)."""
    body = np.ascontiguousarray(data).tobytes()
    ch = data.shape[1]
    fmt_chunk = (fmt.to_bytes(2, "little") + ch.to_bytes(2, "little") + rate.to_bytes(4, "little")
                 + (rate * ch * width).to_bytes(4, "little") + (ch * width).to_bytes(2, "little")
                 + (8 * width).to_bytes(2, "little"))
    riff = b"WAVE" + b"fmt " + len(fmt_chunk).to_bytes(4, "little") + fmt_chunk
    riff += b"data" + len(body).to_bytes(4, "little") + body
    with open(path, "wb") as f:
        f.write(b"RIFF" + len(riff).to_bytes(4, "little") + riff)


def _tone(rng, n, scale=0.3):
    return (rng.standard_normal(n) * scale).clip(-0.99, 0.99).astype(np.float32)


@pytest.fixture(scope="module")
def formats(tmp_path_factory):
    """Files of every sample format the readers take: PCM16 mono and
    stereo, PCM8, PCM24, PCM32 and IEEE float32, plus one shorter and one
    longer than the decode length."""
    d = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(3)
    x = _tone(rng, 1000)
    files = {}
    files["pcm16"] = str(d / "pcm16.wav")
    write_wav(files["pcm16"], x, 16000)
    files["pcm16_stereo"] = str(d / "stereo.wav")
    write_wav(files["pcm16_stereo"], np.stack([x, -x[::-1]]), 16000)
    files["pcm8"] = str(d / "pcm8.wav")
    _raw_wav(files["pcm8"], np.round(x * 127 + 128).astype(np.uint8)[:, None], 22050, 1)
    files["pcm24"] = str(d / "pcm24.wav")
    v = np.round(x * 2 ** 23).astype(np.int32)
    _raw_wav(files["pcm24"], np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], 1).astype(np.uint8), 44100, 3)
    files["pcm32"] = str(d / "pcm32.wav")
    _raw_wav(files["pcm32"], np.round(x * 2 ** 31 * 0.5).astype("<i4")[:, None], 44100, 4)
    files["float32"] = str(d / "float32.wav")
    _raw_wav(files["float32"], x.astype("<f4")[:, None], 44100, 4, fmt=3)
    files["short"] = str(d / "short.wav")
    write_wav(files["short"], x[:300], 44100)
    return files


@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_bytes_equal_jax(tmp_path, channels):
    x = np.stack([_tone(np.random.default_rng(c), 777, 0.6) for c in range(channels)])
    write_wav(str(tmp_path / "port.wav"), x if channels > 1 else x[0], 16000)
    jax_write_wav(str(tmp_path / "jax.wav"), x if channels > 1 else x[0], 16000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("kind", ["pcm16", "pcm16_stereo", "pcm8", "pcm32", "short"])
def test_read_wav_equals_jax(formats, kind):
    got, rate = read_wav(formats[kind])
    ref, ref_rate = jax_read_wav(formats[kind])
    assert rate == ref_rate and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind,error,match", [("pcm24", ValueError, "sample width 3"),
                                              ("float32", wave.Error, "unknown format: 3")])
def test_read_wav_rejects_what_jax_rejects(formats, kind, error, match):
    for reader in (read_wav, jax_read_wav):
        with pytest.raises(error, match=match):
            reader(formats[kind])


def test_native_decodes_equal_jax(formats):
    paths = [formats[k] for k in ("pcm16", "pcm16_stereo", "pcm8", "pcm24", "pcm32", "float32", "short")]
    for max_len in (500, 1200):
        got = native.decode_batch(paths, max_len)
        ref = jax_native.decode_batch(paths, max_len)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        got16 = native.decode_batch_pcm16(paths, max_len)
        ref16 = jax_native.decode_batch_pcm16(paths, max_len)
        for a, b in zip(got16, ref16):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got16[3].tolist() == [True, True, False, False, False, False, True]


def test_native_raises_on_a_bad_file_and_on_a_failed_build(tmp_path, monkeypatch):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX" + bytes(60))
    with pytest.raises(OSError, match="failed to decode"):
        native.decode_batch([str(bad)], 100)
    with pytest.raises(OSError, match="failed to decode"):
        native.decode_batch_pcm16([str(bad)], 100)
    broken = tmp_path / "wav_decoder.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.decode_batch([str(bad)], 100)


def _write_tree(root, labels):
    """Per class: PCM16 at 44.1 kHz (1 s and 1.2 s), PCM8 at 44.1 kHz (1 s,
    the f32 decode), PCM16 at 16 kHz (1 s) and 22,050 Hz (1.1 s), both
    resampled from the native decoder's rows, and three clips the 1-s filter
    drops: 44,099 samples at 44.1 kHz, 15,999 at 16 kHz, 22,049 at 22,050 Hz.
    Two more are resampled from a second, whole read: PCM8 at 22,050 Hz
    (1.1 s, not PCM16) and PCM16 at 8 kHz with 44,101 samples (more than
    the decoder's 44,100). The file names sort the rates into an
    interleaved order."""
    rng = np.random.default_rng(11)
    for label in labels:
        d = os.path.join(root, label)
        os.makedirs(d)
        write_wav(os.path.join(d, "a_44k.wav"), _tone(rng, SR), SR)
        write_wav(os.path.join(d, "b_16k.wav"), _tone(rng, 16000), 16000)
        write_wav(os.path.join(d, "c_44k_long.wav"), _tone(rng, int(1.2 * SR)), SR)
        write_wav(os.path.join(d, "d_22k.wav"), _tone(rng, int(1.1 * 22050)), 22050)
        _raw_wav(os.path.join(d, "e_44k_pcm8.wav"), np.round(_tone(rng, SR) * 127 + 128).astype(np.uint8)[:, None],
                 SR, 1)
        write_wav(os.path.join(d, "f_44k_short.wav"), _tone(rng, SR - 1), SR)
        write_wav(os.path.join(d, "g_16k_short.wav"), _tone(rng, 15999), 16000)
        write_wav(os.path.join(d, "h_22k_short.wav"), _tone(rng, 22049), 22050)
        _raw_wav(os.path.join(d, "i_22k_pcm8.wav"),
                 np.round(_tone(rng, int(1.1 * 22050)) * 127 + 128).astype(np.uint8)[:, None], 22050, 1)
        write_wav(os.path.join(d, "j_8k_long.wav"), _tone(rng, SR + 1), 8000)
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("not a wav\n")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """(port CleanData, JAX CleanData, the run directory) from one tree at
    the dataset's default path, the port's with its cache written."""
    run = tmp_path_factory.mktemp("ingest")
    cfg = make_config("ultrasonic", device="cpu")
    _write_tree(os.path.join(run, cfg.data_path), cfg.labels)
    cwd = os.getcwd()
    os.chdir(run)
    try:
        port = prepare_clean_dataset(cfg)
        ref = jax_prepare(jax_make_config("ultrasonic"), save=False)
    finally:
        os.chdir(cwd)
    return port, ref, run


def test_prepare_keeps_the_reference_clips_and_split(prepared):
    port, ref, _ = prepared
    assert len(port.train_label) + len(port.test_label) == 70  # 7 clips of at least 1 s a class
    for field in ("train_label", "test_label"):
        assert getattr(port, field).dtype == np.int64
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field))
    assert port.train_wav.shape[1:] == (1, SR) and port.train_mfcc.shape[1:] == (1, 100, 40)
    assert port.prep_walls is not None and set(port.prep_walls) == {"decode", "resample", "mfcc"}


@pytest.mark.parametrize("split", ["train", "test"])
def test_prepare_wavs_match(prepared, split):
    """Clips at 44.1 kHz bit-equal; resampled ones within 1e-6."""
    port, ref, _ = prepared
    got, want = getattr(port, f"{split}_wav"), getattr(ref, f"{split}_wav")
    assert got.shape == want.shape and got.dtype == np.float32
    # A resampled clip has nothing above 16 kHz, past its filter's transition band.
    resampled = np.abs(np.fft.rfft(want[:, 0], axis=-1))[:, 16000:].max(axis=-1) < 1.0
    assert 0 < resampled.sum() < len(resampled)  # both kinds of clip are in the split
    np.testing.assert_array_equal(got[~resampled], want[~resampled])
    assert np.max(np.abs(got[resampled] - want[resampled])) <= 1e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("split", ["train", "test"])
def test_prepare_mfcc_matches(prepared, split):
    port, ref, _ = prepared
    got = getattr(port, f"{split}_mfcc")
    np.testing.assert_allclose(got, _mfcc_float64(getattr(port, f"{split}_wav")), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, getattr(ref, f"{split}_mfcc"), rtol=1e-4, atol=3e-3)
    np.testing.assert_array_equal(getattr(port, f"{split}_mfcc"), getattr(port, f"{split}_mfcc_dev").numpy())


def test_cache_round_trip_in_both_packages(prepared, monkeypatch):
    port, _, run = prepared
    monkeypatch.chdir(run)
    loaded = load_clean_data(make_config("ultrasonic", device="cpu"))
    by_jax = jax_load_clean_data(jax_make_config("ultrasonic"))
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(loaded, field), getattr(port, field))
        np.testing.assert_array_equal(getattr(by_jax, field), getattr(port, field))


def test_load_clean_data_rebuilds_from_the_tree(prepared, monkeypatch):
    port, _, run = prepared
    monkeypatch.chdir(run)
    cfg = make_config("ultrasonic", device="cpu", result="rebuilt")
    assert not os.path.exists(os.path.join("record", "rebuilt"))
    for load in (True, False):  # no cache yet, then the cache is ignored
        data = load_clean_data(cfg, load=load)
        assert data.prep_walls is not None
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(data, field), getattr(port, field))
    assert os.path.exists(os.path.join("record", "rebuilt", "SCDv1-10", "clean", "clean_train_mfcc.npy"))


def test_wave_module_reads_what_the_tree_writer_wrote(tmp_path):
    """The PCM8 helper writes a file the stdlib reader accepts."""
    _raw_wav(str(tmp_path / "x.wav"), np.full((10, 1), 128, np.uint8), 8000, 1)
    with wave.open(str(tmp_path / "x.wav")) as w:
        assert (w.getsampwidth(), w.getframerate(), w.getnframes()) == (1, 8000, 10)
