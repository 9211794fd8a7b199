"""Device selection for the entry points."""

from __future__ import annotations

import torch

from audiobd_tpu_torch.parallel.distributed import live, local_rank


def resolve_device(name: str | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Without CUDA and without an explicit device this raises; it
    never carries on on the CPU unasked.

    Under a live group of ranks, no name or ``cuda`` means this rank's card,
    ``cuda:{LOCAL_RANK % device_count}``; an explicit index wins.

    Also turns TF32 off. The reference computes in f32 at full precision
    (``Precision.HIGHEST`` in audiobd_tpu/dsp/mfcc.py and ops/pallas_mfcc.py),
    and cuDNN runs f32 convolutions in TF32 unless told otherwise.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass --device cpu (or device='cpu') "
                "to run on the CPU"
            )
        name = "cuda"
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    if device.type == "cuda" and device.index is None and live():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device
