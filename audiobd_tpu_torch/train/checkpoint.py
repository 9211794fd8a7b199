"""The best model as a torch state_dict under ``record/<result>/``.

The reference's Orbax checkpoint is the directory ``record/<result>/checkpoint``;
the port writes ``record/<result>/torch_checkpoint/`` so the two never
collide: ``model.pt`` (the model's state_dict, tensors on the CPU) and
``model_spec.json`` (what a loader needs to rebuild the model).
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

_SPEC_FILE = "model_spec.json"
_MODEL_FILE = "model.pt"


def checkpoint_dir(record_dir: str) -> str:
    return os.path.join(record_dir, "torch_checkpoint")


def save_checkpoint(record_dir: str, state_dict: dict[str, torch.Tensor], model_spec: dict[str, Any]) -> None:
    path = checkpoint_dir(record_dir)
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, os.path.join(path, _MODEL_FILE))
    with open(os.path.join(path, _SPEC_FILE), "w") as f:
        json.dump(model_spec, f)


def load_checkpoint(record_dir: str) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """Returns (state_dict on the CPU, model_spec)."""
    path = checkpoint_dir(record_dir)
    state_dict = torch.load(os.path.join(path, _MODEL_FILE), map_location="cpu", weights_only=True)
    with open(os.path.join(path, _SPEC_FILE)) as f:
        spec = json.load(f)
    return state_dict, spec
