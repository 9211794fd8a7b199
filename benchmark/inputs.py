"""Inputs made on the device from a run's seed, handed alike to the program
and to the reference: the clips, the models' weights, and named random
streams.

``np_stream`` and ``torch_stream`` are the seeding formulas the port uses for
its own named streams (a sha256 of the name and a numpy ``SeedSequence``),
frozen here so the reference can draw what the program draws (shuffles,
trigger positions) without importing the port.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

CLIP_CHUNK = 2048  # clips drawn a call; fixed, since the noise stream depends on it


def _name_digest(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little")


def np_stream(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), _name_digest(name)]))


def torch_stream(seed: int, name: str, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), _name_digest(name)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def split_indices(n: int, test_size: float = 0.2, seed: int = 35) -> tuple[np.ndarray, np.ndarray]:
    """(train, test) rows of sklearn's ``train_test_split(..., random_state=35)``:
    one RandomState permutation, test rows first."""
    n_test = int(np.ceil(test_size * n))
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def make_clips(seed: int, num_classes: int, per_class: int, sample_rate: int, device,
               name: str = "clips") -> tuple[torch.Tensor, np.ndarray]:
    """(clips (N, T) f32 on ``device``, labels (N,)): class c is a tone burst
    at 200 + 160·c Hz (±3%), its octave, a Gaussian envelope centred in
    [0.3, 0.7] s, and white noise, the formula of the port's synthetic
    stand-in for Speech Commands, drawn on the device from ``seed``."""
    gen = torch_stream(seed, name, device)
    n = num_classes * per_class
    labels = torch.arange(num_classes, device=device).repeat_interleave(per_class)
    f0 = (200.0 + 160.0 * labels.to(torch.float32)) * (1.0 + 0.03 * torch.randn(n, generator=gen, device=device))
    phase = torch.rand(n, generator=gen, device=device) * (2.0 * math.pi)
    centre = 0.3 + 0.4 * torch.rand(n, generator=gen, device=device)
    t = torch.arange(sample_rate, device=device, dtype=torch.float32) / sample_rate
    out = torch.empty((n, sample_rate), dtype=torch.float32, device=device)
    for s in range(0, n, CLIP_CHUNK):
        e = min(s + CLIP_CHUNK, n)
        env = torch.exp(-((t - centre[s:e, None]) ** 2) / 0.05)
        w = 2.0 * math.pi * f0[s:e, None]
        out[s:e] = (0.4 * env * torch.sin(w * t + phase[s:e, None]) + 0.3 * env * torch.sin(2.0 * w * t)
                    + 0.02 * torch.randn((e - s, sample_rate), generator=gen, device=device))
    return out, labels.cpu().numpy()


def make_weights(seed: int, spec: list[tuple[str, tuple[int, ...], str, int]], device,
                 name: str = "weights") -> dict[str, torch.Tensor]:
    """A state dict for ``spec`` [(key, shape, kind, fan_in)]: one uniform
    draw on the device for every "uniform" leaf, scaled to U(±1/√fan_in)
    (torch's default for convolutions and dense layers); "ones" and "zeros"
    leaves (BatchNorm's scale, shift and running statistics) as named."""
    gen = torch_stream(seed, name, device)
    sizes = [math.prod(shape) for _, shape, kind, _ in spec if kind == "uniform"]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    parts = iter(flat.split(sizes))
    out = {}
    for key, shape, kind, fan_in in spec:
        if kind == "uniform":
            out[key] = (next(parts) * (1.0 / math.sqrt(fan_in))).reshape(shape).contiguous()
        elif kind == "ones":
            out[key] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[key] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
    return out
