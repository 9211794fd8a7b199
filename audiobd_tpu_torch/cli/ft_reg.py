"""FT-reg defense entry point.

    python -m audiobd_tpu_torch ft_reg [--ft_epochs 300] [--device cpu] ...

The reference CLI's flags (audiobd_tpu/cli/ft_reg.py) plus ``--device``;
reads ``record/<result>/torch_checkpoint/``.
"""

from __future__ import annotations

import argparse

from audiobd_tpu_torch.cli.common import add_defense_args, infer_attack, report_rank
from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.defend import ft_reg
from audiobd_tpu_torch.utils.device import resolve_device


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="FT-reg defense (PyTorch/CUDA)")
    add_defense_args(parser)
    parser.add_argument("--val_ratio", type=float, default=0.05)
    parser.add_argument("--lr_ft", type=float, default=0.001)
    parser.add_argument("--ft_epochs", type=int, default=300,
                        help="reg fine-tune epochs (reference hardcodes 300, ft_reg.py:263)")
    parser.add_argument("--r", type=float, default=0.05)
    parser.add_argument("--alpha", type=float, default=0.7)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> ft_reg.FTRegResult:
    args = parse_arguments(argv)
    attack, spec_model = infer_attack(args.result, args.attack)
    cfg = make_config(attack, dataset=args.dataset, result=args.result, model=args.model or spec_model,
                      batch_size=args.batch_size, device=args.device)
    result = ft_reg.mitigation(cfg, val_ratio=args.val_ratio, lr_ft=args.lr_ft, reg_epochs=args.ft_epochs,
                               r=args.r, alpha=args.alpha)
    for ratio, acc, asr in result.per_ratio:
        print(f"ratio {ratio}: acc={acc:.2f} asr={asr:.2f}")
    report_rank("ft_reg", result, resolve_device(cfg.device))
    return result


if __name__ == "__main__":
    main()
