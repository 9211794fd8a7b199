"""Unlearning correlation analysis entry point.

    python -m audiobd_tpu_torch correlation_analysis [--unlearn_epochs 10] [--device cpu] ...

The reference CLI's flags (audiobd_tpu/cli/correlation_analysis.py) plus
``--device``; reads ``record/<result>/torch_checkpoint/``.
"""

from __future__ import annotations

import argparse

from audiobd_tpu_torch.cli.common import add_defense_args, infer_attack, report_rank
from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.defend import correlation
from audiobd_tpu_torch.utils.device import resolve_device


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Unlearning NWC correlation analysis (PyTorch/CUDA)")
    add_defense_args(parser, with_model=False)
    parser.add_argument("--lr_un", type=float, default=1e-4)
    parser.add_argument("--unlearn_epochs", type=int, default=10)
    parser.add_argument("--subset", type=int, default=None)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> correlation.CorrelationResult:
    args = parse_arguments(argv)
    attack, model = infer_attack(args.result, args.attack)
    cfg = make_config(attack, dataset=args.dataset, result=args.result, model=model, batch_size=args.batch_size,
                      device=args.device)
    result = correlation.analyze(cfg, lr_un=args.lr_un, unlearn_epochs=args.unlearn_epochs, subset=args.subset)
    print(f"pearson r = {result.pearson_r:.4f}")
    report_rank("correlation_analysis", result, resolve_device(cfg.device))
    return result


if __name__ == "__main__":
    main()
