"""Plotting utilities (port of audiobd_tpu/utils/visual.py; reference
utils/visual_tools.py:8-109).

matplotlib is imported inside each function (Agg backend), never when the
module is imported, so the port runs where matplotlib is not installed and
only a plot call raises there.
"""

from __future__ import annotations

import os

import numpy as np

from audiobd_tpu_torch.parallel.distributed import main_rank_only


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_or_show(plt, path: str | None) -> None:
    if path:
        _savefig(plt, path)
        plt.close()
    else:
        plt.show()


@main_rank_only
def _savefig(plt, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, dpi=120, bbox_inches="tight")


def plot_waveform(wav: np.ndarray, sample_rate: int, path: str | None = None) -> None:
    plt = _pyplot()
    wav = np.asarray(wav).reshape(-1)
    t = np.arange(len(wav)) / sample_rate
    plt.figure(figsize=(10, 3))
    plt.plot(t, wav, linewidth=0.5)
    plt.xlabel("time [s]")
    plt.ylabel("amplitude")
    save_or_show(plt, path)


def plot_fft(wav: np.ndarray, sample_rate: int, path: str | None = None) -> None:
    plt = _pyplot()
    wav = np.asarray(wav).reshape(-1)
    spec = np.abs(np.fft.rfft(wav))
    freqs = np.fft.rfftfreq(len(wav), 1.0 / sample_rate)
    plt.figure(figsize=(10, 3))
    plt.plot(freqs, spec, linewidth=0.5)
    plt.xlabel("frequency [Hz]")
    plt.ylabel("|X(f)|")
    save_or_show(plt, path)


def plot_mfccs(mfcc: np.ndarray, path: str | None = None) -> None:
    plt = _pyplot()
    mfcc = np.asarray(mfcc)
    if mfcc.ndim == 3:
        mfcc = mfcc[0]
    plt.figure(figsize=(8, 4))
    plt.imshow(mfcc.T, origin="lower", aspect="auto", cmap="magma")
    plt.colorbar()
    plt.xlabel("frame")
    plt.ylabel("mfcc coeff")
    save_or_show(plt, path)


def plot_mel(melspec: np.ndarray, path: str | None = None) -> None:
    plt = _pyplot()
    melspec = np.asarray(melspec)
    plt.figure(figsize=(8, 4))
    plt.imshow(10 * np.log10(np.maximum(melspec.T, 1e-10)), origin="lower", aspect="auto")
    plt.colorbar()
    save_or_show(plt, path)


def plot_loss(train_loss, clean_loss, bd_loss, path: str | None = None) -> None:
    plt = _pyplot()
    plt.figure(figsize=(8, 5))
    plt.plot(train_loss, label="train loss")
    plt.plot(clean_loss, label="test clean loss")
    plt.plot(bd_loss, label="test bd loss")
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.legend()
    save_or_show(plt, path)


def plot_metrics(train_acc, train_asr, test_acc, test_asr, path: str | None = None) -> None:
    plt = _pyplot()
    plt.figure(figsize=(8, 5))
    plt.plot(train_acc, label="train mix acc")
    plt.plot(train_asr, label="train asr")
    plt.plot(test_acc, label="test clean acc")
    plt.plot(test_asr, label="test asr")
    plt.xlabel("epoch")
    plt.ylabel("%")
    plt.legend()
    save_or_show(plt, path)
