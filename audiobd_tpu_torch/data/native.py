"""ctypes binding of the native batch WAV decoder (``native/wav_decoder.cpp``).

The decoder is a thread-pooled RIFF parser with a plain C interface. On
first use ``ops.build.build`` compiles it with ``g++`` into
``audiobd_tpu_torch/_build/`` (git-ignored), named by a digest of its source
and flags so an edited source is rebuilt. A failed build raises: the ingest
path has no slower stand-in.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from audiobd_tpu_torch.ops.build import PACKAGE_DIR, build

SOURCE = PACKAGE_DIR.parent / "native" / "wav_decoder.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
STATUS_NOT_PCM16 = 7  # wavdec_batch_i16's per-file status for a file that is not 16-bit PCM

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def get_lib() -> ctypes.CDLL:
    """The decoder library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build([SOURCE], lambda: "g++", CXX_FLAGS)[SOURCE]
        lib = ctypes.CDLL(str(path))
        for name, sample in (("wavdec_batch", ctypes.c_float), ("wavdec_batch_i16", ctypes.c_int16)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(sample), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
            ]
        lib.wavdec_version.restype = ctypes.c_int
        lib.wavdec_version.argtypes = []
        if lib.wavdec_version() < 2:
            raise RuntimeError(f"{path} is an older wav decoder (version {lib.wavdec_version()})")
        _lib = lib
        return lib


def _decode(fn, paths: list[str], max_len: int, dtype):
    """Run one batch entry point, a thread per core: (out (N, max_len)
    zero-padded, lengths (N,) min(frames, max_len), rates (N,), status (N,))."""
    n = len(paths)
    out = np.zeros((n, max_len), dtype)
    lengths, rates, status = (np.zeros(n, np.int32) for _ in range(3))
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    c_int_p = ctypes.POINTER(ctypes.c_int)
    fn(names, n, out.ctypes.data_as(fn.argtypes[2]), max_len, lengths.ctypes.data_as(c_int_p),
       rates.ctypes.data_as(c_int_p), status.ctypes.data_as(c_int_p), 0)
    return out, lengths, rates, status


def decode_batch(paths: list[str], max_len: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode wav files to float32 in [-1, 1) → (waves (N, max_len)
    zero-padded, lengths (N,) min(frames, max_len), sample_rates (N,)).
    Any file that fails to decode raises."""
    out, lengths, rates, status = _decode(get_lib().wavdec_batch, paths, max_len, np.float32)
    bad = np.flatnonzero(status)
    if bad.size:
        raise OSError(f"{bad.size} wav files failed to decode, first: {paths[bad[0]]}")
    return out, lengths, rates


def decode_batch_pcm16(paths: list[str], max_len: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Raw int16 PCM → (pcm (N, max_len) int16 zero-padded, lengths (N,),
    sample_rates (N,), ok (N,) bool). ``ok`` is False for files that are not
    16-bit PCM; the caller decodes those with ``decode_batch``. Any other
    failure raises."""
    out, lengths, rates, status = _decode(get_lib().wavdec_batch_i16, paths, max_len, np.int16)
    hard = np.flatnonzero((status != 0) & (status != STATUS_NOT_PCM16))
    if hard.size:
        raise OSError(f"{hard.size} wav files failed to decode, first: {paths[hard[0]]}")
    return out, lengths, rates, status == 0
