"""NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit: f32 outside the
tensor cores, and HBM3. ``bound_s`` is ``chip_smoke.py::bound`` in seconds."""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """(the least seconds, "operations" or "bytes", whichever bounds it)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
