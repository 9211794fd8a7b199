"""AST's attention in the forward, one call a block: softmax(q kᵀ / √d_h)·v
over (B, H, T, d_h), whatever implements it (``models/layers.py::
scaled_attention`` today). Operations: q kᵀ and the probabilities times v,
4·B·H·T²·d_h; the softmax's, under 1% of them, left out. Bytes: q, k and v
read once and o written once, f32. Its least time a call, ``peaks.bound_s``."""

from __future__ import annotations

from benchmark.roofline.peaks import bound_s

SPAN = "attention"  # the program's span around each call (utils/profiling.py)


def call_bound(batch: int, tokens: int, heads: int, head_dim: int) -> tuple[float, str]:
    """(the least seconds a call, "operations" or "bytes")."""
    flops = 4.0 * batch * heads * tokens * tokens * head_dim
    nbytes = 4.0 * 4 * batch * heads * tokens * head_dim
    return bound_s(flops, nbytes)
