"""Fine-Pruning defense entry point.

    python -m audiobd_tpu_torch fp [--result badnets_smallcnn] [--device cpu] ...

The reference CLI's flags (audiobd_tpu/cli/fp.py) plus ``--device``; reads
``record/<result>/torch_checkpoint/``.
"""

from __future__ import annotations

import argparse

from audiobd_tpu_torch.cli.common import add_defense_args, infer_attack, report_rank
from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.defend import fp
from audiobd_tpu_torch.utils.device import resolve_device


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Fine-Pruning defense (PyTorch/CUDA)")
    add_defense_args(parser)
    parser.add_argument("--val_ratio", type=float, default=0.05)
    parser.add_argument("--lr_ft", type=float, default=0.01)
    parser.add_argument("--acc_ratio", type=float, default=0.1)
    parser.add_argument("--once_prune_ratio", type=float, default=0.01)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> fp.FPResult:
    args = parse_arguments(argv)
    attack, spec_model = infer_attack(args.result, args.attack)
    cfg = make_config(attack, dataset=args.dataset, result=args.result, model=args.model or spec_model,
                      batch_size=args.batch_size, device=args.device)
    result = fp.mitigation(cfg, val_ratio=args.val_ratio, acc_ratio=args.acc_ratio,
                           once_prune_ratio=args.once_prune_ratio, lr_ft=args.lr_ft)
    print(f"fp done: pruned={result.pruned_channels} acc={result.test_acc:.2f} asr={result.test_asr:.2f}")
    report_rank("fp", result, resolve_device(cfg.device))
    return result


if __name__ == "__main__":
    main()
