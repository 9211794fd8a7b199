#!/usr/bin/env python3
"""Runs chip_smoke.py's phase 14 (data and tensor parallelism across four
cards, one a rank, over NCCL) alone, on random features in place of phase
2's, on a machine of at least four cards.

    python3 scripts/multicard_phase.py

Builds the kernels, writes a (300, 1, 101, 40) batch of N(0, 8²) features
with random labels and poison flags (seed 0) where phase 14 reads phase 2's
record, and runs the phase: 14a, dryrun_multichip(4) on four cards (a 2 x
2 dp x tp SmallCNN step; the sharded epochs of SmallCNN and LargeCNN, then
its phase 3(a), each rank's rows of the poisoning prep; phase 12a's step by
four ranks and the NCCL all-reduce of its gradient buffer); 14b, the badnets
main path through torchrun on four cards at global batches 256 and 1024,
each against the same command on one card; 14c, phase 13's tensor-parallel
cases with a card a rank; 14d, flowmur, ultrasonic, jingleback --style 5
and daba through torchrun on four cards, each against the same command on
one card, then the four defense commands on the DABA record. Every number
is printed beside each card's name and power limit. Raises with fewer than
four cards; exits non-zero if a check failed.

    python3 scripts/multicard_phase.py --rehearse

rehearses the phase on a machine of fewer cards, at a fraction of four
cards' price: told of four cards once CUDA is up, every part runs, its
ranks sharing the cards there are over gloo. The placement checks (cuda:r,
NCCL, distinct cards) fail by design, so the exit code is non-zero; every
other check holds as on four cards.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    import torch

    from audiobd_tpu_torch.ops import KERNELS
    from audiobd_tpu_torch.ops.build import build_all
    from audiobd_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description="chip_smoke.py's phase 14 alone")
    parser.add_argument("--rehearse", action="store_true",
                        help="run every part on fewer than four cards, the ranks sharing them over gloo")
    args = parser.parse_args(argv)
    resolve_device(None)  # CUDA, TF32 off; raises without a card
    n = torch.cuda.device_count()
    if args.rehearse:
        torch.cuda.init()
        torch.backends.cudnn.version()  # cuDNN's first use queries every card the count names: before it changes
        torch.cuda.device_count = lambda: chip_smoke.MULTICARD_RANKS
        print(f"rehearsal on {n} card(s) told of {chip_smoke.MULTICARD_RANKS}: the ranks share them over gloo, "
              f"and the placement checks fail by design", flush=True)
    elif n < chip_smoke.MULTICARD_RANKS:
        raise RuntimeError(f"phase 14 needs {chip_smoke.MULTICARD_RANKS} cards; this machine has {n}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}",
          flush=True)
    t0 = time.perf_counter()
    build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    workdir = tempfile.mkdtemp(prefix="multicard_phase_")
    try:
        chip_smoke.write_random_features(workdir)
        chip_smoke.phase_multicard(torch, KERNELS, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"{len(chip_smoke.failures)} check(s) failed", flush=True)
    for line in chip_smoke.smi_lines():
        print(line)
    return 1 if chip_smoke.failures else 0


if __name__ == "__main__":
    sys.exit(main())
