#!/usr/bin/env python3
"""Runs chip_smoke.py's phase 13 (tensor parallel: shard_params_tp and the
column-parallel routes, by 2 and 4 ranks on the card) alone, on random
features in place of phase 2's, so the phase can be iterated on without
the rest of the script.

    python3 scripts/tp_phase.py

Builds the kernels, writes a (300, 1, 101, 40) batch of N(0, 8²) features
with random labels and poison flags (seed 0) where phase 13 reads phase 2's
record, and runs the phase: its checks, walls, bytes and collectives, each
beside the card's name and power limit. Exits non-zero if a check failed;
needs a CUDA device.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    from audiobd_tpu_torch.ops.build import build_all
    from audiobd_tpu_torch.utils.device import resolve_device

    resolve_device(None)  # CUDA, TF32 off; raises without a card
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    build_all()
    workdir = tempfile.mkdtemp(prefix="tp_phase_")
    try:
        bd = os.path.join(workdir, "record", "chip_smoke", "SCDv1-10", "bd")
        os.makedirs(bd)
        rng = np.random.default_rng(0)
        n = 300
        np.save(os.path.join(bd, "bd_train_mfcc.npy"), (rng.standard_normal((n, 1, 101, 40)) * 8).astype(np.float32))
        np.save(os.path.join(bd, "bd_train_label.npy"), rng.integers(0, 10, n))
        np.save(os.path.join(bd, "poison_index_train.npy"), (rng.random(n) < 0.3).astype(np.int64))
        t0 = time.perf_counter()
        chip_smoke.phase_tp(torch, workdir)
        print(f"phase 13 wall {time.perf_counter() - t0:.1f} s; {len(chip_smoke.failures)} check(s) failed", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 1 if chip_smoke.failures else 0


if __name__ == "__main__":
    sys.exit(main())
