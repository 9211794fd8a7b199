"""The best training state under ``record/<result>/torch_checkpoint/``.

The reference's Orbax checkpoint is the directory ``record/<result>/checkpoint``
holding {params, batch_stats, opt_state, step} and a model spec
(audiobd_tpu/train/checkpoint.py:26-47); the port writes
``record/<result>/torch_checkpoint/`` so the two never collide:
  * ``model.pt``: the model's state_dict, tensors on the CPU;
  * ``model_spec.json``: what a loader needs to rebuild the model (the
    defenses' and ``infer``'s contract);
  * ``train_state.pt``: the optimizer's ``state_dict()`` and the train
    ``step``, what ``badnets --resume`` restarts from.
Each file is written to a temporary name beside it and then renamed over
the old one, so a run killed mid-write leaves the previous file whole.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from audiobd_tpu_torch.parallel.distributed import main_rank_only

_SPEC_FILE = "model_spec.json"
_MODEL_FILE = "model.pt"
_TRAIN_STATE_FILE = "train_state.pt"


def checkpoint_dir(record_dir: str) -> str:
    return os.path.join(record_dir, "torch_checkpoint")


def _on_cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _on_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_on_cpu(v) for v in value]
    return value


def _replace(path: str, write) -> None:
    """``write(tmp)`` then rename ``tmp`` over ``path``."""
    tmp = f"{path}.tmp"
    write(tmp)
    os.replace(tmp, path)


@main_rank_only
def save_checkpoint(record_dir: str, state_dict: dict[str, torch.Tensor], model_spec: dict[str, Any],
                    opt_state: dict | None = None, step: int = 0) -> None:
    """The model (and, given ``opt_state``, the optimizer's state with the
    train ``step``): each file in full beside the old one, then renamed
    over it."""
    path = checkpoint_dir(record_dir)
    os.makedirs(path, exist_ok=True)
    model = _on_cpu(state_dict)
    _replace(os.path.join(path, _MODEL_FILE), lambda tmp: torch.save(model, tmp))
    if opt_state is not None:
        train_state = {"optimizer": _on_cpu(opt_state), "step": int(step)}
        _replace(os.path.join(path, _TRAIN_STATE_FILE), lambda tmp: torch.save(train_state, tmp))

    def write_spec(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(model_spec, f)

    _replace(os.path.join(path, _SPEC_FILE), write_spec)


def load_checkpoint(record_dir: str) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """Returns (state_dict on the CPU, model_spec)."""
    path = checkpoint_dir(record_dir)
    state_dict = torch.load(os.path.join(path, _MODEL_FILE), map_location="cpu", weights_only=True)
    with open(os.path.join(path, _SPEC_FILE)) as f:
        spec = json.load(f)
    return state_dict, spec


def load_train_state(record_dir: str) -> dict:
    """``{"optimizer": the optimizer's state_dict, "step": int}``, tensors on
    the CPU. A checkpoint without the file (one written before the port kept
    optimizer state) raises ``FileNotFoundError`` naming it."""
    path = os.path.join(checkpoint_dir(record_dir), _TRAIN_STATE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: the checkpoint holds no optimizer state to resume from "
            "(train without --resume to start afresh)"
        )
    return torch.load(path, map_location="cpu", weights_only=True)
