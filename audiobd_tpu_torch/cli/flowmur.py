"""FlowMur attack entry point.

    python -m audiobd_tpu_torch flowmur --synthetic [--device cpu] ...

The reference CLI's flags (audiobd_tpu/cli/flowmur.py:27-47) plus
``--device``. Every stage runs: the surrogates, the trigger search (or
``--load_trigger``), the poisoning and the victim's training. Each stage's
wall time and the kernel launches it made are printed and returned.

Under a group of ranks every rank first reads whether the ``--load_trigger``
file exists (ranks that disagree raise), and each rank prints the sha256 of
the trigger it poisons with: rank 0's, broadcast by the search.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field

import numpy as np

from audiobd_tpu_torch.cli.stages import Stages
from audiobd_tpu_torch.configs import add_common_args, config_from_args
from audiobd_tpu_torch.data.speech_commands import (
    load_clean_data,
    make_synthetic_clean_data,
    save_clean_data,
)
from audiobd_tpu_torch.parallel.distributed import agreed, world_size
from audiobd_tpu_torch.poison import flowmur
from audiobd_tpu_torch.train.ensemble import MemberResult
from audiobd_tpu_torch.train.trainer import TrainResult, sha256_hex, train_attack
from audiobd_tpu_torch.utils.device import rank_label, resolve_device


@dataclass
class FlowmurRun:
    victim: TrainResult
    trigger: np.ndarray
    surrogates: list[MemberResult]
    trigger_losses: list[float]  # each search epoch's summed loss (empty with --load_trigger)
    stages: dict[str, dict] = field(default_factory=dict)  # name → {"wall_s", "launches"}


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="FlowMur audio backdoor attack (PyTorch/CUDA)")
    add_common_args(parser)
    parser.add_argument("--trigger_duration", type=float, default=None)
    parser.add_argument("--snr_db", type=int, default=None)
    parser.add_argument("--surrogate_epochs", type=int, default=None)
    parser.add_argument("--opt_epochs", type=int, default=None)
    parser.add_argument("--load_trigger", type=str, default=None, help="path to sp_trigger npy")
    parser.add_argument(
        "--flowmur_update", type=str, default=None, choices=["per_batch", "accumulated"],
        help="trigger-search update rule: independent per-batch Adam steps, or the "
             "reference's per-batch steps on the prefix-summed epoch gradient",
    )
    parser.add_argument(
        "--flowmur_restarts", type=int, default=None,
        help="trigger searches with probe-victim selection (1 = the reference's single search)",
    )
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_per_class", type=int, default=50)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> FlowmurRun:
    args = parse_arguments(argv)
    cfg = config_from_args(
        "flowmur", args,
        trigger_duration=args.trigger_duration,
        snr_db=args.snr_db,
        surrogate_epochs=args.surrogate_epochs,
        flowmur_opt_epochs=args.opt_epochs,
    )
    device = resolve_device(cfg.device)
    # Every rank reads the trigger file's presence before any rank goes on:
    # ranks that split between loading and searching would not pair up in
    # the probe victims' collectives.
    load_trigger = bool(args.load_trigger) and agreed(os.path.exists(args.load_trigger), args.load_trigger)
    print("----------FlowMur attack (audiobd_tpu_torch)----------")
    for key, value in vars(args).items():
        print(f"{key}: {value}")
    stage = Stages(device)
    with stage("prep"):
        if args.synthetic:
            clean = make_synthetic_clean_data(cfg, n_per_class=args.synthetic_per_class)
            save_clean_data(cfg, clean)  # defenses read the clean npy cache
        else:
            clean = load_clean_data(cfg)
    print("Training surrogate models...")
    with stage("surrogates"):
        model, surrogates = flowmur.pretrain_surrogate(cfg, clean)
    trigger_losses: list[float] = []
    with stage("trigger"):
        if load_trigger:
            trigger = np.load(args.load_trigger).astype(np.float32)
            print(f"loaded trigger {args.load_trigger} {trigger.shape}")
        else:
            print("Generating optimal trigger...")
            hosts = flowmur.select_trigger_hosts(cfg, clean)
            trigger = flowmur.select_trigger(cfg, model, hosts, clean, loss_history=trigger_losses)
    if world_size() > 1:
        print(f"{rank_label(device)}: flowmur poisons with trigger sha256 {sha256_hex(trigger)}", flush=True)
    with stage("poison"):
        poisoned = flowmur.poison(cfg, clean, trigger)
    with stage("victim"):
        result = train_attack(cfg, poisoned.bd_train, poisoned.clean_test, poisoned.bd_test)
    print(
        f"done: epochs={result.epochs_ran} "
        f"clean_acc={result.history['test_clean_acc'][-1]:.2f} "
        f"asr={result.history['test_asr'][-1]:.2f} "
        f"throughput={result.clips_per_sec:.1f} clips/s"
    )
    return FlowmurRun(victim=result, trigger=trigger, surrogates=surrogates,
                      trigger_losses=trigger_losses, stages=stage.records)


if __name__ == "__main__":
    main()
