"""Device selection for the entry points."""

from __future__ import annotations

import torch

from audiobd_tpu_torch.parallel.distributed import live, local_rank, rank, world_size


def resolve_device(name: str | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Without CUDA and without an explicit device this raises; it
    never carries on on the CPU unasked.

    Under a live group of ranks, no name or ``cuda`` means this rank's card,
    ``cuda:{local_rank() % device_count}``, the card the join set
    (parallel/distributed.py::local_rank); an explicit index wins.

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


def card_label(device: torch.device) -> str:
    """``device`` and, on CUDA, its card's PCI bus id (``cuda:1, PCI
    00000000:19:00.0``; ``unknown`` where this torch's device properties
    lack it), which names the physical card whatever
    ``CUDA_VISIBLE_DEVICES`` renumbers: how ranks show they hold distinct
    cards."""
    if device.type != "cuda":
        return str(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    props = torch.cuda.get_device_properties(index)
    bus = (f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:{props.pci_device_id:02X}.0"
           if hasattr(props, "pci_bus_id") else "unknown")
    return f"cuda:{index}, PCI {bus}"


def rank_label(device: torch.device) -> str:
    """``rank r/N on <card_label>``: how a rank names itself in the lines
    each rank prints of its own run."""
    return f"rank {rank()}/{world_size()} on {card_label(device)}"
