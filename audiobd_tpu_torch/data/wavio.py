"""WAV decode/encode, single files (port of audiobd_tpu/data/wavio.py).

The batch decoder of the ingest path is ``data.native``; this module reads
the off-rate files that are resampled, and writes PCM16 (the Ultrasonic
trigger, test trees).
"""

from __future__ import annotations

import os
import wave

import numpy as np

from audiobd_tpu_torch.parallel.distributed import main_rank_only


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (waveform (channels, T) float32 in [-1, 1], sample_rate).
    PCM8 is unsigned around 128; 16- and 32-bit widths are read as signed
    integers (as the reference does, so an IEEE-float file is misread)."""
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        sw = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"Unsupported sample width {sw} in {path}")
    return data.reshape(-1, n_ch).T.copy(), sr


@main_rank_only
def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write a float waveform (T,) or (channels, T) as PCM16, making its
    directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    pcm = np.clip(np.round(wav * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())
