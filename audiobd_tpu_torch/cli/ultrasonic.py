"""Ultrasonic attack entry point.

    python -m audiobd_tpu_torch ultrasonic [--synthetic] [--device cpu] ...

The reference CLI's flags (audiobd_tpu/cli/ultrasonic.py:18-28) plus
``--device``. Without ``--synthetic`` the clean set is the npy cache, or
the wav tree at the dataset's path (``configs.DATASET_PATHS``) when there
is no cache. Each stage's wall time and kernel launches (prep, poison,
train) are printed and returned.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field

import numpy as np

from audiobd_tpu_torch.cli.stages import Stages
from audiobd_tpu_torch.configs import add_common_args, config_from_args
from audiobd_tpu_torch.data.speech_commands import (
    load_clean_data,
    make_synthetic_clean_data,
    save_clean_data,
)
from audiobd_tpu_torch.poison import ultrasonic
from audiobd_tpu_torch.train.trainer import TrainResult, train_attack
from audiobd_tpu_torch.utils.device import resolve_device


@dataclass
class UltrasonicRun:
    result: TrainResult
    trigger: np.ndarray
    n_clips: int  # clean clips after the 1-s filter, both splits
    prep_walls: dict[str, float] | None  # the wav-tree prep's decode, resample and mfcc walls
    stages: dict[str, dict] = field(default_factory=dict)  # name → {"wall_s", "launches"}


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Ultrasonic audio backdoor attack (PyTorch/CUDA)")
    add_common_args(parser)
    parser.add_argument("--trigger_size", type=int, default=None, help="percent of the 1s trigger kept")
    parser.add_argument("--trigger_pos", type=str, default=None, choices=["start", "mid", "end"])
    parser.add_argument("--trigger_cont", type=lambda s: s.lower() != "false", default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="use the deterministic synthetic dataset (no Speech Commands on disk)")
    parser.add_argument("--synthetic_per_class", type=int, default=50)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> UltrasonicRun:
    args = parse_arguments(argv)
    cfg = config_from_args(
        "ultrasonic", args,
        ultra_trigger_size=args.trigger_size,
        trigger_pos=args.trigger_pos,
        trigger_cont=args.trigger_cont,
    )
    stage = Stages(resolve_device(cfg.device))
    print("----------Ultrasonic attack (audiobd_tpu_torch)----------")
    for key, value in vars(args).items():
        print(f"{key}: {value}")
    with stage("prep"):
        if args.synthetic:
            clean = make_synthetic_clean_data(cfg, n_per_class=args.synthetic_per_class)
            save_clean_data(cfg, clean)  # defenses read the clean npy cache
        else:
            clean = load_clean_data(cfg)
    with stage("poison"):
        poisoned = ultrasonic.poison(cfg, clean)
    with stage("train"):
        result = train_attack(cfg, poisoned.bd_train, poisoned.clean_test, poisoned.bd_test)
    print(
        f"done: epochs={result.epochs_ran} "
        f"clean_acc={result.history['test_clean_acc'][-1]:.2f} "
        f"asr={result.history['test_asr'][-1]:.2f} "
        f"throughput={result.clips_per_sec:.1f} clips/s"
    )
    return UltrasonicRun(result=result, trigger=poisoned.trigger,
                         n_clips=len(clean.train_label) + len(clean.test_label),
                         prep_walls=clean.prep_walls, stages=stage.records)


if __name__ == "__main__":
    main()
