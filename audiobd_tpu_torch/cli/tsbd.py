"""TSBD defense entry point.

    python -m audiobd_tpu_torch tsbd [--only_finetune false] [--device cpu] ...

The reference CLI's flags (audiobd_tpu/cli/tsbd.py) plus ``--device``;
reads ``record/<result>/torch_checkpoint/``. ``--vectorized_ft`` is
accepted; either value runs stage D's ratios one after another.
"""

from __future__ import annotations

import argparse

from audiobd_tpu_torch.cli.common import add_defense_args, infer_attack, report_rank
from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.defend import tsbd
from audiobd_tpu_torch.utils.device import resolve_device


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="TSBD defense (PyTorch/CUDA)")
    add_defense_args(parser)
    parser.add_argument("--only_finetune", type=lambda s: s.lower() != "false", default=True)
    parser.add_argument("--data_type", choices=["clean_test", "poison_test", "clean_val"], default="clean_val")
    parser.add_argument("--record_layer", type=str, default=None,
                        help="state_dict key of a conv weight (default: the last conv, conv3.weight on SmallCNN)")
    parser.add_argument("--val_ratio", type=float, default=0.05)
    parser.add_argument("--lr_un", type=float, default=1e-4)
    parser.add_argument("--unlearn_epochs", type=int, default=1000)
    parser.add_argument("--reinit_weight_ratio", type=float, default=0.7)
    parser.add_argument("--lr_ft", type=float, default=0.01)
    parser.add_argument("--ft_epochs", type=int, default=51)
    parser.add_argument("--vectorized_ft", type=lambda s: s.lower() != "false", default=True,
                        help="accepted for the reference's CLI; stage D runs its ratios one after another")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> tsbd.TSBDResult:
    args = parse_arguments(argv)
    attack, spec_model = infer_attack(args.result, args.attack)
    cfg = make_config(attack, dataset=args.dataset, result=args.result, model=args.model or spec_model,
                      batch_size=args.batch_size, device=args.device)
    result = tsbd.mitigation(
        cfg, only_finetune=args.only_finetune, data_type=args.data_type, val_ratio=args.val_ratio,
        lr_un=args.lr_un, unlearn_epochs=args.unlearn_epochs, reinit_weight_ratio=args.reinit_weight_ratio,
        lr_ft=args.lr_ft, ft_epochs=args.ft_epochs, record_layer=args.record_layer,
        vectorized_ft=args.vectorized_ft,
    )
    print(f"tsbd done ({result.stage}): acc={result.test_acc:.2f} asr={result.test_asr:.2f}")
    report_rank("tsbd", result, resolve_device(cfg.device))
    return result


if __name__ == "__main__":
    main()
