"""JingleBack attack entry point.

    python -m audiobd_tpu_torch jingleback [--style 0-5] [--synthetic] [--device cpu] ...

The reference CLI's flags (audiobd_tpu/cli/jingleback.py:18-24) plus
``--device``. Without ``--synthetic`` the clean set is the npy cache, or the
wav tree at the dataset's path when there is no cache. Each stage's wall
time and kernel launches (prep, poison, train) are printed and returned.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field

from audiobd_tpu_torch.cli.stages import Stages
from audiobd_tpu_torch.configs import add_common_args, config_from_args
from audiobd_tpu_torch.data.speech_commands import (
    load_clean_data,
    make_synthetic_clean_data,
    save_clean_data,
)
from audiobd_tpu_torch.poison import jingleback
from audiobd_tpu_torch.train.trainer import TrainResult, train_attack
from audiobd_tpu_torch.utils.device import resolve_device


@dataclass
class JingleBackRun:
    result: TrainResult
    stages: dict[str, dict] = field(default_factory=dict)  # name → {"wall_s", "launches"}


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="JingleBack audio backdoor attack (PyTorch/CUDA)")
    add_common_args(parser)
    parser.add_argument("--style", type=int, default=None, choices=range(6), help="style chain 0-5")
    parser.add_argument("--synthetic", action="store_true",
                        help="use the deterministic synthetic dataset (no Speech Commands on disk)")
    parser.add_argument("--synthetic_per_class", type=int, default=50)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> JingleBackRun:
    args = parse_arguments(argv)
    cfg = config_from_args("jingleback", args, style=args.style)
    stage = Stages(resolve_device(cfg.device))
    print("----------JingleBack attack (audiobd_tpu_torch)----------")
    for key, value in vars(args).items():
        print(f"{key}: {value}")
    with stage("prep"):
        if args.synthetic:
            clean = make_synthetic_clean_data(cfg, n_per_class=args.synthetic_per_class)
            save_clean_data(cfg, clean)  # defenses read the clean npy cache
        else:
            clean = load_clean_data(cfg)
    with stage("poison"):
        poisoned = jingleback.poison(cfg, clean)
    with stage("train"):
        result = train_attack(cfg, poisoned.bd_train, poisoned.clean_test, poisoned.bd_test)
    print(
        f"done: epochs={result.epochs_ran} "
        f"clean_acc={result.history['test_clean_acc'][-1]:.2f} "
        f"asr={result.history['test_asr'][-1]:.2f} "
        f"throughput={result.clips_per_sec:.1f} clips/s"
    )
    return JingleBackRun(result=result, stages=stage.records)


if __name__ == "__main__":
    main()
