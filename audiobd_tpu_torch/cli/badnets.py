"""BadNets attack entry point.

    python -m audiobd_tpu_torch badnets --synthetic [--device cpu] ...

The reference CLI's flags (audiobd_tpu/cli/badnets.py:23-34), plus
``--device``. ``--resume`` restarts from ``record/<result>/torch_checkpoint/``
(the model, the optimizer's state and the step); ``--profile_dir`` writes a
torch.profiler trace of epochs 1-2 there and the program's spans beside it,
a pair on every rank (utils/profiling.py).
"""

from __future__ import annotations

import argparse

from audiobd_tpu_torch.configs import add_common_args, config_from_args
from audiobd_tpu_torch.data.speech_commands import (
    load_clean_data,
    make_synthetic_clean_data,
    save_clean_data,
)
from audiobd_tpu_torch.poison import badnets
from audiobd_tpu_torch.train.trainer import TrainResult, train_attack


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="BadNets audio backdoor attack (PyTorch/CUDA)")
    add_common_args(parser)
    parser.add_argument("--trigger_size", type=int, default=None, help="square trigger side")
    parser.add_argument(
        "--synthetic", action="store_true",
        help="use the deterministic synthetic dataset (no Speech Commands on disk)",
    )
    parser.add_argument("--synthetic_per_class", type=int, default=50)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of epochs 1-2 and its spans here, a pair a rank")
    parser.add_argument("--resume", action="store_true", help="resume from record/<result>/torch_checkpoint")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> TrainResult:
    args = parse_arguments(argv)
    cfg = config_from_args("badnets", args, trigger_size=args.trigger_size)
    print("----------BadNets attack (audiobd_tpu_torch)----------")
    for key, value in vars(args).items():
        print(f"{key}: {value}")

    if args.synthetic:
        clean = make_synthetic_clean_data(cfg, n_per_class=args.synthetic_per_class)
        save_clean_data(cfg, clean)  # defenses read the clean npy cache
    else:
        clean = load_clean_data(cfg)
    poisoned = badnets.poison(cfg, clean)
    result = train_attack(cfg, poisoned.bd_train, poisoned.clean_test, poisoned.bd_test,
                          profile_dir=args.profile_dir, resume=args.resume)
    print(
        f"done: epochs={result.epochs_ran} "
        f"clean_acc={result.history['test_clean_acc'][-1]:.2f} "
        f"asr={result.history['test_asr'][-1]:.2f} "
        f"throughput={result.clips_per_sec:.1f} clips/s"
    )
    return result


if __name__ == "__main__":
    main()
