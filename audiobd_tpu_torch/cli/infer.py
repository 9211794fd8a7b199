"""Serving entry: classify wav clips with a trained checkpoint (port of
audiobd_tpu/cli/infer.py).

    python -m audiobd_tpu_torch infer --result badnets_smallcnn --wav a.wav b.wav
    python -m audiobd_tpu_torch infer --result badnets_smallcnn --wav clips_dir/ --json
    python -m audiobd_tpu_torch infer --result badnets_smallcnn --eval_clean [--device cpu]

``--wav`` entries may be directories (expanded recursively to their .wav
files, sorted); ``--json`` prints one JSON object a clip (or one for the
eval). The model is rebuilt from ``record/<result>/torch_checkpoint/`` and
its spec, whose attack fixes the MFCC preset, so clips are featurized as in
training:
  1. read: each file decoded, channel 0 kept;
  2. resample: clips at another rate resampled on the device, grouped by
     rate, and every clip cut or zero-padded to 1 s at the attack's rate;
  3. mfcc: kernel A through ``batched_mfcc_device``, 2,048 clips a launch
     (its plain version on the CPU);
  4. forward: the eval-mode model in batches of ``--batch_size``, then a
     softmax in f32 and the top k.
The four stages' walls go to stderr as one line, ``infer walls (s): {...}``.
``--eval_clean`` scores the run's cached clean test split instead, its loss
the mean of batch means at the training batch size, as the training log's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig, make_config
from audiobd_tpu_torch.data.speech_commands import (
    batched_mfcc_device,
    clean_dir,
    mfcc_params,
    resample_rows,
    sync_device,
)
from audiobd_tpu_torch.data.wavio import read_wav
from audiobd_tpu_torch.defend.common import load_bd_model
from audiobd_tpu_torch.train.checkpoint import checkpoint_dir
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_eval_epoch


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Classify wav clips with a trained checkpoint (PyTorch/CUDA)")
    parser.add_argument("--result", type=str, required=True, help="record/<result> of the training run")
    parser.add_argument("--wav", type=str, nargs="*", default=None,
                        help="wav files (or directories, expanded recursively) to classify")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output: one JSON object per clip (or per eval)")
    parser.add_argument("--eval_clean", action="store_true",
                        help="score the run's cached clean test split instead")
    parser.add_argument("--top_k", type=int, default=3)
    parser.add_argument("--dataset", type=str, default=None, help="label-name table override")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="batch size (default: the training batch size from the checkpoint spec, "
                             "whose batch-mean loss the training log shows)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: cuda; raises if CUDA is missing)")
    return parser.parse_args(argv)


def load_model(result: str, dataset: str | None = None, device: str | None = None):
    """(cfg, eval-mode model) from ``record/<result>/torch_checkpoint/``: the
    spec's attack preset, with the dataset (the label table and the clean
    cache's place) and batch size it was trained with."""
    spec_path = os.path.join(checkpoint_dir(os.path.join("record", result)), "model_spec.json")
    if not os.path.exists(spec_path):
        raise FileNotFoundError(f"no checkpoint spec at {spec_path}: train a model first")
    with open(spec_path) as f:
        spec = json.load(f)
    cfg = make_config(spec["attack"], result=result, model=spec["model"], num_classes=spec["num_classes"],
                      dataset=dataset or spec.get("dataset"), batch_size=spec.get("batch_size"), device=device)
    model, _, _ = load_bd_model(cfg)
    return cfg, model.eval()


def expand_wavs(entries: list[str]) -> list[str]:
    """--wav entries → files; a directory gives its .wav files, recursively,
    sorted."""
    out: list[str] = []
    for e in entries:
        if os.path.isdir(e):
            hits = []
            for root, _, files in os.walk(e):
                hits.extend(os.path.join(root, f) for f in files if f.lower().endswith(".wav"))
            out.extend(sorted(hits))
        else:
            out.append(e)
    return out


def load_waveforms(cfg: AttackConfig, paths: list[str], device: torch.device
                   ) -> tuple[torch.Tensor, dict[str, float]]:
    """Files → (N, T) f32 on ``device``, T one second at the attack's rate:
    channel 0, resampled where the file's rate differs, then cut or
    zero-padded, as the reference does a file at a time; and the read and
    resample stages' walls, seconds."""
    walls = {}
    sr = cfg.dsp.sample_rate
    t0 = time.perf_counter()
    clips, rates = [], []
    for path in paths:
        wav, file_sr = read_wav(path)
        clips.append(wav[0])
        rates.append(file_sr)
    t1 = time.perf_counter()
    walls["read"] = t1 - t0
    out = torch.zeros((len(paths), sr), dtype=torch.float32, device=device)
    for rate in sorted(set(rates)):
        idx = [i for i, r in enumerate(rates) if r == rate]
        if rate == sr:
            host = np.zeros((len(idx), sr), np.float32)
            for j, i in enumerate(idx):
                n = min(len(clips[i]), sr)
                host[j, :n] = clips[i][:n]
            rows = torch.from_numpy(host).to(device)
        else:
            rows = resample_rows([clips[i] for i in idx], rate, sr, sr, device)
        out[torch.tensor(idx, device=device)] = rows
    sync_device(device)
    walls["resample"] = time.perf_counter() - t1
    return out, walls


@torch.no_grad()
def classify(model, feats: torch.Tensor, batch_size: int) -> np.ndarray:
    """(N, C) f32 softmax probabilities of the eval-mode model, ``batch_size``
    clips a forward."""
    model.eval()
    probs = [torch.softmax(model(feats[s : s + batch_size]).float(), dim=-1)
             for s in range(0, feats.shape[0], batch_size)]
    return torch.cat(probs).cpu().numpy()


def _label(labels: list[str], i: int):
    return labels[i] if i < len(labels) else int(i)


def eval_clean(cfg: AttackConfig, model, batch_size: int, as_json: bool) -> dict:
    """The run's cached clean test split through ``run_eval_epoch``."""
    path = clean_dir(cfg)
    if not os.path.exists(os.path.join(path, "clean_test_mfcc.npy")):
        # A health check must not fall through to a full dataset rebuild.
        raise SystemExit(
            f"--eval_clean needs the clean npy cache at {path} "
            "(run the attack CLI once, or prepare_clean_dataset, to build it)"
        )
    feats = np.load(os.path.join(path, "clean_test_mfcc.npy"))
    labels = np.load(os.path.join(path, "clean_test_label.npy"))
    device = next(model.parameters()).device
    ev = run_eval_epoch(model, DeviceDataset(ArraySet(feats, labels), device), batch_size)
    if as_json:
        print(json.dumps({"clean_test_acc": round(float(ev["acc"]), 4),
                          "clean_test_loss": round(float(ev["loss"]), 6),
                          "n_clips": int(len(labels))}))
    else:
        print(f"clean test: acc {ev['acc']:.2f}  loss {ev['loss']:.4f} ({len(labels)} clips)")
    return ev


def main(argv: list[str] | None = None):
    """Returns the (N, C) probabilities, or with ``--eval_clean`` the eval's
    dict (``acc``, ``loss``)."""
    args = parse_arguments(argv)
    cfg, model = load_model(args.result, args.dataset, args.device)
    batch_size = args.batch_size or cfg.train.batch_size
    if args.eval_clean:
        return eval_clean(cfg, model, batch_size, args.json)
    if not args.wav:
        raise SystemExit("nothing to do: pass --wav files or --eval_clean")
    paths = expand_wavs(args.wav)
    if not paths:
        raise SystemExit(f"no .wav files found under {args.wav}")

    device = next(model.parameters()).device
    wavs, walls = load_waveforms(cfg, paths, device)
    t0 = time.perf_counter()
    feats = batched_mfcc_device(wavs, mfcc_params(cfg), device)
    sync_device(device)
    t1 = time.perf_counter()
    probs = classify(model, feats, batch_size)
    walls.update(mfcc=t1 - t0, forward=time.perf_counter() - t1)
    print(f"infer walls (s): {json.dumps({'clips': len(paths), **walls})}", file=sys.stderr)

    labels = cfg.labels
    k = min(args.top_k, probs.shape[-1])
    for path, row in zip(paths, probs):
        top = np.argsort(row)[::-1][:k]
        if args.json:
            print(json.dumps({
                "path": path,
                "label": _label(labels, top[0]),
                "top": [{"label": _label(labels, i), "prob": round(float(row[i]), 6)} for i in top],
            }))
        else:
            ranked = ", ".join(f"{_label(labels, i)}={row[i]:.3f}" for i in top)
            print(f"{path}: {ranked}")
    return probs


if __name__ == "__main__":
    main()
