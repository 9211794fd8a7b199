"""Shared helpers for the defense entry points (fp, ft_reg, tsbd,
correlation_analysis): a defense reads the attack and model from the attack
run's checkpoint spec, so ``--result`` alone chains stages (port of
audiobd_tpu/cli/common.py, reading the port's checkpoint)."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from audiobd_tpu_torch.ops import launches
from audiobd_tpu_torch.parallel.distributed import world_size
from audiobd_tpu_torch.train.checkpoint import checkpoint_dir
from audiobd_tpu_torch.utils.device import rank_label


def infer_attack(result: str, fallback: str) -> tuple[str, str | None]:
    """(attack, model) from ``record/<result>/torch_checkpoint/model_spec.json``
    when it exists, else (``fallback``, None)."""
    spec_path = os.path.join(checkpoint_dir(os.path.join("record", result)), "model_spec.json")
    if os.path.exists(spec_path):
        with open(spec_path) as f:
            spec = json.load(f)
        return spec.get("attack", fallback), spec.get("model")
    return fallback, None


def add_defense_args(parser, with_model: bool = True) -> None:
    """The flags every defense CLI of the reference has, plus ``--device``."""
    parser.add_argument("--attack", type=str, default="badnets",
                        help="attack preset the checkpoint was produced by")
    parser.add_argument("--dataset", type=str, default="SCDv1-10")
    parser.add_argument("--result", type=str, default="badnets_smallcnn")
    if with_model:
        parser.add_argument("--model", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: cuda; raises if CUDA is missing)")


def report_rank(command: str, result, device) -> None:
    """Under a group of ranks, where each rank runs a defense whole: this
    rank's line, ``rank r/N on <card>: <command> result sha256 ...; kernel
    launches {...}``, a digest of the result's fields in order (arrays by
    their bytes, the rest by repr). Silent on one rank."""
    if world_size() == 1:
        return
    digest = hashlib.sha256()
    for f in dataclasses.fields(result):
        value = getattr(result, f.name)
        digest.update(f.name.encode())
        digest.update(value.tobytes() if isinstance(value, np.ndarray) else repr(value).encode())
    print(f"{rank_label(device)}: {command} result sha256 {digest.hexdigest()}; kernel launches "
          f"{json.dumps(launches())}", flush=True)
