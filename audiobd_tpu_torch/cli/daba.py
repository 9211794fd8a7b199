"""DABA attack entry point.

    python -m audiobd_tpu_torch daba [--trigger_selection_mode Cer|Cer&Inf] [--variant true|false]
        [--po_db X] [--export_wav_tree] [--synthetic] [--device cpu] ...

The reference CLI's flags (audiobd_tpu/cli/daba.py:18-28) plus ``--device``.
Without ``--synthetic`` the clean set is the npy cache, or the wav tree at
the dataset's path when there is no cache. Each stage's wall time and
kernel launches (prep, select, poison, train) are printed and returned.
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
from audiobd_tpu_torch.poison import daba
from audiobd_tpu_torch.train.trainer import TrainResult, train_attack
from audiobd_tpu_torch.utils.device import resolve_device


@dataclass
class DabaRun:
    result: TrainResult
    trigger_index: int
    n_poisoned: int
    stages: dict[str, dict] = field(default_factory=dict)  # name → {"wall_s", "launches"}


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="DABA audio backdoor attack (PyTorch/CUDA)")
    add_common_args(parser)
    parser.add_argument("--trigger_selection_mode", type=str, default=None, choices=["Cer", "Cer&Inf"])
    parser.add_argument("--variant", type=lambda s: s.lower() != "false", default=None)
    parser.add_argument("--po_db", type=float, default=None)
    parser.add_argument("--export_wav_tree", action="store_true",
                        help="also write the reference-style poisoned wav trees")
    parser.add_argument("--synthetic", action="store_true",
                        help="use the deterministic synthetic dataset (no Speech Commands on disk)")
    parser.add_argument("--synthetic_per_class", type=int, default=50)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> DabaRun:
    args = parse_arguments(argv)
    cfg = config_from_args("daba", args, trigger_selection_mode=args.trigger_selection_mode,
                           variant=args.variant, po_db=args.po_db)
    stage = Stages(resolve_device(cfg.device))
    print("----------DABA attack (audiobd_tpu_torch)----------")
    for key, value in vars(args).items():
        print(f"{key}: {value}")
    with stage("prep"):
        if args.synthetic:
            clean = make_synthetic_clean_data(cfg, n_per_class=args.synthetic_per_class)
            save_clean_data(cfg, clean)  # defenses read the clean npy cache
        else:
            clean = load_clean_data(cfg)
    with stage("select"):
        selection = daba.select(cfg, clean)
    with stage("poison"):
        poisoned = daba.poison(cfg, clean, selection, export_wav_tree=args.export_wav_tree)
    n_poisoned = int(poisoned.bd_train.indicators.sum())
    print(f"selected trigger #{poisoned.trigger_index}; {n_poisoned} hosts poisoned")
    with stage("train"):
        result = train_attack(cfg, poisoned.bd_train, poisoned.clean_test, poisoned.bd_test)
    print(
        f"done: epochs={result.epochs_ran} "
        f"clean_acc={result.history['test_clean_acc'][-1]:.2f} "
        f"asr={result.history['test_asr'][-1]:.2f} "
        f"throughput={result.clips_per_sec:.1f} clips/s"
    )
    return DabaRun(result=result, trigger_index=poisoned.trigger_index, n_poisoned=n_poisoned,
                   stages=stage.records)


if __name__ == "__main__":
    main()
