"""DABA: dB-matched music-clip overlay attack with Cer/Inf selection (port of
audiobd_tpu/poison/daba.py).

Reference pipeline (utils/daba_selection_tools.py, utils/daba_injection_tools.py,
daba.py):
  * a pool of 60 one-second music clips; each clip's "certainty" is the
    softmax entropy of an **untrained** victim model (quirk kept,
    utils/daba_injection_tools.py:125-128; SURVEY.md §6b.3) on the clip's
    librosa MFCC, truncated or padded with −200 to 32 frames;
  * the trigger is the minimum-entropy clip; a host's "influence" is the
    binary cross-entropy between softmax(trigger) and softmax(host ⊕ trigger
    at ``po_db`` dBFS); ``poison_num`` hosts are picked (the least
    influential for "Cer&Inf", the most for "Cer") among 3,000 candidates
    outside the target class;
  * injection is pydub's dBFS-matched overlay with int16 saturation, the
    gain cycling over [0, −5, …, −40] dB per host when ``variant``;
  * poisoned hosts are relabelled to the target; every non-target test row
    is overlaid at ``po_db``.

The victim is drawn from ``torch_generator(seed, "daba_victim")``; the JAX
package draws it from threefry, so the two packages pick their triggers and
hosts with different victims on the same seed. Its features come from
kernel A on the card (``ops/mfcc.py::fused_mfcc_features``), the plain
version on the CPU. Overlays run on the device; the overlaid rows' MFCCs are
merged into the device-resident clean features.
"""

from __future__ import annotations

import os
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from audiobd_tpu_torch.configs import AttackConfig, linear_features_for
from audiobd_tpu_torch.data.speech_commands import CleanData, batched_mfcc_device, mfcc_params
from audiobd_tpu_torch.data.wavio import read_wav, write_wav
from audiobd_tpu_torch.parallel.distributed import agreed, main_rank_only
from audiobd_tpu_torch.models import build_model
from audiobd_tpu_torch.ops.mfcc import fused_mfcc_features
from audiobd_tpu_torch.poison.badnets import save_bd_arrays
from audiobd_tpu_torch.poison.device_prep import scatter_rows
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.assets import find_resource
from audiobd_tpu_torch.utils.device import resolve_device

VARIANT_DBS = np.array([0, -5, -10, -15, -20, -25, -30, -35, -40], dtype=np.float32)
VICTIM_FRAMES = 32  # the victim's input length in frames (reference pads or truncates to it)
INF_CHUNK = 512  # hosts scored a batch

# ---------------------------------------------------------------------------
# pydub-semantics overlay


def dbfs(wav: torch.Tensor) -> torch.Tensor:
    """pydub AudioSegment.dBFS: 20·log10(rms / full scale) over the last axis."""
    rms = torch.sqrt(torch.mean(wav**2, dim=-1))
    return 20.0 * torch.log10(torch.clamp(rms, min=1e-12))


def overlay_db(host: torch.Tensor, trigger: torch.Tensor, po_db) -> torch.Tensor:
    """``trigger`` gain-shifted to ``po_db`` dBFS (per clip) and overlaid on
    ``host`` with int16 saturation at both stages (pydub
    single_trigger_injection_db, utils/daba_selection_tools.py:24-39).

    host (..., T); trigger (T,) or broadcastable; po_db a number, a tensor
    of one per clip, or "auto" (the host's dBFS) or "keep" (no gain)."""
    t = host.shape[-1]
    trig = torch.broadcast_to(trigger[..., :t], host.shape)
    if isinstance(po_db, str):
        if po_db == "auto":
            gain_db = dbfs(host) - dbfs(trig)
        elif po_db == "keep":
            gain_db = host.new_zeros(host.shape[:-1])
        else:
            raise ValueError(po_db)
    else:
        gain_db = torch.as_tensor(po_db, device=host.device) - dbfs(trig)
    scaled = trig * (10.0 ** (gain_db[..., None] / 20.0))
    scaled = torch.clamp(scaled, -1.0, 32767.0 / 32768.0)
    return torch.clamp(host + scaled, -1.0, 32767.0 / 32768.0)


# ---------------------------------------------------------------------------
# Trigger pool


def synthesize_trigger_pool(path: str | None, n_songs: int = 20, variants: int = 3, sr: int = 16000,
                            seed: int = 7) -> np.ndarray:
    """60 deterministic one-second music-like clips (chord and melody
    harmonics with vibrato and envelope), standing in for the reference's
    music pool. Returns (60, T) f32; writes ``music{ii}_{v}.wav`` into
    ``path`` if given."""
    rng = np.random.default_rng(seed)
    t = np.arange(sr) / sr
    pool, names = [], []
    for song in range(n_songs):
        root = 110.0 * 2 ** (rng.integers(0, 24) / 12.0)
        chord = [1.0, 1.25 if song % 2 else 1.2, 1.5]
        for var in range(variants):
            wav = np.zeros(sr)
            vib = 1.0 + 0.01 * np.sin(2 * np.pi * (4 + var) * t)
            for ci, ratio in enumerate(chord):
                f = root * ratio * (2.0 ** (var - 1))
                env = 0.5 + 0.5 * np.sin(2 * np.pi * (1 + ci) * t + rng.uniform(0, 6.28))
                wav += env * np.sin(2 * np.pi * f * vib * t + rng.uniform(0, 6.28)) / (ci + 1)
            wav += 0.05 * rng.standard_normal(sr)
            wav *= 0.5 / np.abs(wav).max()
            pool.append(wav.astype(np.float32))
            # Zero-padded, so the sorted load order is the generation order.
            names.append(f"music{song:02d}_{var}.wav")
    pool_arr = np.stack(pool)
    if path:
        for name, wav in zip(names, pool_arr):
            write_wav(os.path.join(path, name), wav, sr)
    return pool_arr


def resolve_trigger_pool_dir(cfg: AttackConfig) -> str:
    """The genuine pool (``resources/DABA/trigger_pool``, 60 music clips)
    where ``utils.assets`` finds it, else the run's own directory, where the
    pool is synthesized."""
    real = find_resource(os.path.join("DABA", "trigger_pool"))
    if real is not None:
        return real
    return os.path.join(cfg.record_dir, "resources", "DABA", "trigger_pool")


def load_trigger_pool(path: str, sr: int = 16000) -> np.ndarray:
    """The wavs of ``path`` in sorted order (as the reference globs), their
    first second each; a pool synthesized into ``path`` if it holds none.
    Every rank decides before rank 0 writes: all read the same files, or
    all take the same synthesized pool."""
    if agreed(os.path.isdir(path) and any(n.endswith(".wav") for n in os.listdir(path)), path):
        clips = []
        for name in sorted(os.listdir(path)):
            if name.endswith(".wav"):
                wav, file_sr = read_wav(os.path.join(path, name))
                if file_sr != sr:
                    raise ValueError(f"{name}: {file_sr} Hz, the pool must be {sr} Hz")
                clips.append(wav[0, :sr])
        return np.stack(clips)
    return synthesize_trigger_pool(path, sr=sr)


# ---------------------------------------------------------------------------
# Cer / Inf scoring


def _entropy(p: torch.Tensor) -> torch.Tensor:
    return -torch.sum(p * torch.log2(torch.clamp(p, min=1e-12)), dim=-1)


def _binary_cross_entropy(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ −y·log a − (1−y)·log(1−a) (reference cross_entropy,
    utils/daba_selection_tools.py:65-66), nan-safe."""
    la = torch.log(torch.clamp(a, min=1e-12))
    l1a = torch.log(torch.clamp(1.0 - a, min=1e-12))
    return torch.sum(-y * la - (1.0 - y) * l1a, dim=-1)


def victim_features(wavs: torch.Tensor, cfg: AttackConfig) -> torch.Tensor:
    """(B, T) → (B, 1, 32, n_mfcc): the MFCC truncated or padded with −200
    to the victim's 32 frames."""
    f = fused_mfcc_features(wavs, mfcc_params(cfg))
    frames = f.shape[-2]
    if frames > VICTIM_FRAMES:
        return f[..., :VICTIM_FRAMES, :]
    return torch.nn.functional.pad(f, (0, 0, 0, VICTIM_FRAMES - frames), value=-200.0)


def make_victim_scorer(cfg: AttackConfig, model: nn.Module | None = None
                       ) -> tuple[nn.Module, Callable[[torch.Tensor], torch.Tensor]]:
    """An untrained victim (``model``, or a fresh one from
    ``torch_generator(seed, "daba_victim")``) in eval mode on ``cfg.device``
    and its softmax of (B, T) waveforms, computed without gradients."""
    device = resolve_device(cfg.device)
    if model is None:
        model = build_model(cfg.model, cfg.num_classes, linear_features_for("daba", cfg.model), device,
                            cfg.train.seed, n_mfcc=cfg.dsp.n_mfcc, init_stream="daba_victim")
    model = model.to(device).eval()

    def softmax_of_wavs(wavs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.softmax(model(victim_features(wavs.to(device), cfg)).float(), dim=-1)

    return model, softmax_of_wavs


def cer_scores(softmax_fn, pool: np.ndarray) -> np.ndarray:
    return _entropy(softmax_fn(torch.from_numpy(np.ascontiguousarray(pool)))).cpu().numpy()


def inf_scores(softmax_fn, trigger: np.ndarray, hosts: np.ndarray, device: torch.device, po_db=-20.0,
               chunk: int = INF_CHUNK) -> np.ndarray:
    trig = torch.from_numpy(np.ascontiguousarray(trigger)).to(device)
    trig_sf = softmax_fn(trig[None, :])[0]
    scores = []
    for start in range(0, len(hosts), chunk):
        block = torch.from_numpy(np.ascontiguousarray(hosts[start : start + chunk])).to(device)
        poison_sf = softmax_fn(overlay_db(block, trig, po_db))
        scores.append(_binary_cross_entropy(trig_sf[None, :], poison_sf).cpu().numpy())
    return np.concatenate(scores)


def select_trigger_and_hosts(cfg: AttackConfig, pool: np.ndarray, host_wavs: np.ndarray, poison_num: int,
                             victim: nn.Module | None = None) -> tuple[int, np.ndarray]:
    """(trigger index into ``pool``, sorted indices into ``host_wavs``)."""
    _, softmax_fn = make_victim_scorer(cfg, victim)
    cer = cer_scores(softmax_fn, pool)
    trig_idx = int(np.argmin(cer))  # the min-entropy trigger (reference tr_num=1)
    inf = inf_scores(softmax_fn, pool[trig_idx], host_wavs, resolve_device(cfg.device), po_db=cfg.po_db)
    order = np.argsort(inf)  # ascending
    if cfg.trigger_selection_mode == "Cer":
        chosen = order[::-1][:poison_num]  # max influence
    else:  # "Cer&Inf"
        chosen = order[:poison_num]        # min influence
    return trig_idx, np.sort(chosen)


def gen_trigger_variants_db(poison_num: int, seed: int = 35) -> np.ndarray:
    """Seeded cyclic assignment of per-host gains (reference
    gen_trigger_variants_db, utils/daba_selection_tools.py:162-167)."""
    rng = np.random.default_rng(seed)
    return VARIANT_DBS[rng.permutation(poison_num) % len(VARIANT_DBS)]


# ---------------------------------------------------------------------------
# Dataset poisoning


@dataclass
class DabaSelection:
    trigger_index: int   # into the pool
    trigger: np.ndarray  # (T,) the pool's clip
    chosen: np.ndarray   # sorted train rows to poison


@dataclass
class DabaPoisoned:
    bd_train: ArraySet
    bd_test: ArraySet
    clean_test: ArraySet
    trigger: np.ndarray
    trigger_index: int


def select(cfg: AttackConfig, clean: CleanData, victim: nn.Module | None = None) -> DabaSelection:
    """The pool, the host candidates from ``np_rng(seed, "daba_hosts")``,
    and the trigger and hosts the victim picks (``poison_num`` of them: the
    rate times the train rows, rounded half to even, or a count above 1)."""
    pool = load_trigger_pool(resolve_trigger_pool_dir(cfg), sr=cfg.dsp.sample_rate)
    n_train = len(clean.train_wav)
    rng = rnd.np_rng(cfg.train.seed, "daba_hosts")
    nontarget_rows = np.flatnonzero(clean.train_label != cfg.target_label)
    candidates = rng.choice(nontarget_rows, size=min(cfg.host_candidates, len(nontarget_rows)), replace=False)
    candidates.sort()
    poison_num = cfg.poisoning_rate
    if poison_num <= 1:
        poison_num = round(poison_num * n_train)
    poison_num = int(min(poison_num, len(candidates)))
    trig_idx, chosen_local = select_trigger_and_hosts(cfg, pool, clean.train_wav[candidates][:, 0, :], poison_num,
                                                      victim)
    return DabaSelection(trig_idx, pool[trig_idx], candidates[chosen_local])


def _overlay_split(clean_wav: np.ndarray, clean_mfcc: np.ndarray, clean_mfcc_dev: torch.Tensor | None,
                   idx: np.ndarray, trigger: torch.Tensor, po_db, cfg: AttackConfig, device: torch.device):
    """One split: the trigger overlaid on the ``idx`` rows on the device,
    their MFCCs computed there and merged into the clean features; the host
    npy views get the same rows. Returns (bd_wav host, bd_mfcc host, bd_mfcc
    on the device)."""
    bd_wav = clean_wav.copy()
    bd_mfcc = clean_mfcc.copy()
    feats = clean_mfcc_dev.to(device) if clean_mfcc_dev is not None else torch.from_numpy(clean_mfcc).to(device)
    if len(idx) == 0:
        return bd_wav, bd_mfcc, feats
    mixed = overlay_db(torch.from_numpy(np.ascontiguousarray(clean_wav[idx][:, 0, :])).to(device), trigger, po_db)
    sub = batched_mfcc_device(mixed, mfcc_params(cfg), device)
    bd_wav[idx] = mixed.cpu().numpy()[:, None, :]
    bd_mfcc[idx] = sub.cpu().numpy()
    return bd_wav, bd_mfcc, scatter_rows(feats, sub, torch.from_numpy(np.asarray(idx, np.int64)).to(device))


def poison(cfg: AttackConfig, clean: CleanData, selection: DabaSelection | None = None, save: bool = True,
           export_wav_tree: bool = False, victim: nn.Module | None = None) -> DabaPoisoned:
    """The poisoned splits on ``cfg.device`` (``selection`` from ``select``,
    or made here with ``victim``); the eight bd npys and ``trigger.wav`` are
    written when ``save``, the reference's wav trees when
    ``export_wav_tree``."""
    device = resolve_device(cfg.device)
    sel = selection if selection is not None else select(cfg, clean, victim)
    chosen, target, trigger = sel.chosen, cfg.target_label, sel.trigger
    trig = torch.from_numpy(np.ascontiguousarray(trigger)).to(device)
    gains = (gen_trigger_variants_db(len(chosen), seed=cfg.train.seed) if cfg.variant
             else np.full(len(chosen), cfg.po_db, np.float32))

    n_train = len(clean.train_wav)
    bd_train_wav, bd_train_mfcc, bd_train_dev = _overlay_split(
        clean.train_wav, clean.train_mfcc, clean.train_mfcc_dev, chosen, trig,
        torch.from_numpy(gains).to(device), cfg, device)
    bd_train_label = clean.train_label.copy()
    bd_train_label[chosen] = target
    ind_train = np.zeros(n_train, dtype=np.int64)
    ind_train[chosen] = 1

    nontarget_test = clean.test_label != target
    bd_test_wav, bd_test_mfcc, bd_test_dev = _overlay_split(
        clean.test_wav, clean.test_mfcc, clean.test_mfcc_dev, np.flatnonzero(nontarget_test), trig, cfg.po_db,
        cfg, device)
    bd_test_label = np.full(len(clean.test_label), target, dtype=np.int64)
    ind_test = nontarget_test.astype(np.int64)

    if save:
        save_bd_arrays(
            cfg,
            bd_train_wav=bd_train_wav, bd_test_wav=bd_test_wav,
            bd_train_mfcc=bd_train_mfcc, bd_test_mfcc=bd_test_mfcc,
            bd_train_label=bd_train_label, bd_test_label=bd_test_label,
            poison_index_train=ind_train, poison_index_test=ind_test,
        )
        write_wav(os.path.join(cfg.record_dir, "trigger.wav"), trigger, cfg.dsp.sample_rate)
    if export_wav_tree:
        _export_wav_tree(cfg, clean, bd_train_wav, bd_test_wav, ind_train, nontarget_test)
    clean_test = clean.test_mfcc_dev if clean.test_mfcc_dev is not None else clean.test_mfcc
    return DabaPoisoned(
        bd_train=ArraySet(bd_train_dev, bd_train_label, ind_train),
        bd_test=ArraySet(bd_test_dev, bd_test_label, ind_test),
        clean_test=ArraySet(clean_test, clean.test_label),
        trigger=trigger,
        trigger_index=sel.trigger_index,
    )


@main_rank_only
def _export_wav_tree(cfg: AttackConfig, clean: CleanData, bd_train_wav: np.ndarray, bd_test_wav: np.ndarray,
                     ind_train: np.ndarray, nontarget_test: np.ndarray) -> None:
    """The reference's poisoned-file trees under ``record/<result>/``:
    ``poison/<split>/<label>/`` with ``poison_<label><i>.wav`` for the
    overlaid rows (filed under the target's label) and ``<split>_<i>.wav``
    for the rest, and the empty ``clean/<split>/<label>/`` directories
    (utils/daba_injection_tools.py:132-211)."""
    sr = cfg.dsp.sample_rate
    labels = cfg.labels
    poison_label = labels[cfg.target_label]
    base = cfg.record_dir
    po_count = 0
    for split, wavs, ys, poisoned_rows in (
        ("train", bd_train_wav, clean.train_label, ind_train.astype(bool)),
        ("test", bd_test_wav, clean.test_label, nontarget_test),
    ):
        for i, (wav, y) in enumerate(zip(wavs, ys)):
            label = labels[int(y)]
            os.makedirs(os.path.join(base, "clean", split, label), exist_ok=True)
            if poisoned_rows[i]:
                poi_dir = os.path.join(base, "poison", split, poison_label)
                os.makedirs(poi_dir, exist_ok=True)
                # Train files count the poisoned rows; test files keep the row's index.
                name = f"poison_{label}{po_count if split == 'train' else i}.wav"
                write_wav(os.path.join(poi_dir, name), wav[0], sr)
                po_count += split == "train"
            else:
                out_dir = os.path.join(base, "poison", split, label)
                os.makedirs(out_dir, exist_ok=True)
                write_wav(os.path.join(out_dir, f"{split}_{i}.wav"), wav[0], sr)
