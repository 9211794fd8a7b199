"""PCM handling of the device-resident prep (port of
audiobd_tpu/poison/device_prep.py).

``dequantize_pcm`` and ``scatter_rows`` are kept here. The reference's chunked prep
(``make_block_fn``/``run_prep``: dequantize → MFCC → optional feature
injection, ``lax.map`` over chunks, wrap-padded to quantized XLA shapes) is
a plain loop over chunks in ``data.speech_commands.batched_mfcc_device``:
the CUDA kernel takes any batch size, so no padding is needed, and BadNets
patches the device-resident clean features instead of recomputing them.
"""

from __future__ import annotations

import torch


def dequantize_pcm(w: torch.Tensor) -> torch.Tensor:
    """int16 PCM → f32 in [-1, 1); exact (2⁻¹⁵ is a power of two, matching
    the reference's wav reader and native decoder bit for bit). Other
    integer widths raise: 24/32-bit PCM would come out 2⁹/2¹⁷ too large."""
    if not w.is_floating_point():
        if w.dtype != torch.int16:
            raise ValueError(f"integer wavs must be int16 PCM, got {w.dtype}")
        return w.to(torch.float32) * (1.0 / 32768.0)
    return w


def scatter_rows(base: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``base`` with ``base[idx] ← rows``, out of place: subset-poisoning
    attacks (FlowMur) recompute MFCCs only for the injected rows and merge
    them into the device-resident clean features."""
    return base.index_copy(0, idx, rows)
