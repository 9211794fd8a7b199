"""CLI dispatcher: ``python -m audiobd_tpu_torch <command> [flags]``.

The reference's eleven commands (``python -m audiobd_tpu``):
attacks   badnets, jingleback, ultrasonic, daba, flowmur
defenses  fp, ft_reg, tsbd, correlation_analysis (they read an attack's
          ``record/<result>/torch_checkpoint/``)
data      get_dataset
serving   infer (classify wav clips with an attack's checkpoint)

N ranks, data-parallel training (one process a rank):
    python -m torch.distributed.run --standalone --nproc_per_node N -m audiobd_tpu_torch <command> [flags]
"""

from __future__ import annotations

import importlib
import sys

from audiobd_tpu_torch.parallel.distributed import destroy, maybe_initialize_distributed

COMMANDS = {
    "badnets": "audiobd_tpu_torch.cli.badnets",
    "jingleback": "audiobd_tpu_torch.cli.jingleback",
    "ultrasonic": "audiobd_tpu_torch.cli.ultrasonic",
    "daba": "audiobd_tpu_torch.cli.daba",
    "flowmur": "audiobd_tpu_torch.cli.flowmur",
    "fp": "audiobd_tpu_torch.cli.fp",
    "ft_reg": "audiobd_tpu_torch.cli.ft_reg",
    "tsbd": "audiobd_tpu_torch.cli.tsbd",
    "correlation_analysis": "audiobd_tpu_torch.cli.correlation_analysis",
    "get_dataset": "audiobd_tpu_torch.cli.get_dataset",
    "infer": "audiobd_tpu_torch.cli.infer",
}


def main(argv: list[str] | None = None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print(__doc__)
        print("available commands:", ", ".join(COMMANDS))
        raise SystemExit(0 if argv and argv[0] in ("-h", "--help") else 1)
    # A no-op without a multi-rank launcher; under torchrun, join the group
    # before the command touches a device (parallel/distributed.py).
    joined = maybe_initialize_distributed()
    try:
        return importlib.import_module(COMMANDS[argv[0]]).main(argv[1:])
    finally:
        if joined:
            destroy()


if __name__ == "__main__":
    main()
