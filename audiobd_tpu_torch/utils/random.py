"""Deterministic seeding by name.

``np_rng`` is the reference's (audiobd_tpu/utils/random.py) hashlib +
SeedSequence construction, copied as is, so both packages draw identical
numpy streams for splits, poison indices and shuffles. ``torch_generator``
seeds a ``torch.Generator`` from the same (seed, name) digest for model init
and dropout; torch's bits differ from JAX's threefry bits by nature.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

DEFAULT_SEED = 35


def _name_digest(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little")


def np_rng(seed: int = DEFAULT_SEED, name: str = "data") -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, _name_digest(name)]))


def torch_generator(seed: int, name: str, device: torch.device | str = "cpu") -> torch.Generator:
    state = np.random.SeedSequence([seed, _name_digest(name)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen
