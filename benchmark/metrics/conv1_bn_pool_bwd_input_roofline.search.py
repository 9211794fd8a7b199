"""Kernel C's share of its roofline in the traced window: its calls × the
least time a call can take (``roofline/conv1_bn_pool_bwd_input.py``: bytes at
3.35 TB/s) over its kernel's device time (``bwd_input``)."""


def read(r):
    k = r.counts.get("kernels", {}).get("conv1_bn_pool_bwd_input")
    if k is None:
        return None
    calls = r.trace_mod.count(r.trace["kernels"], k["calls"])
    seconds = r.trace_mod.seconds(r.trace["kernels"], tuple(k["time"]))
    return 100.0 * calls * k["bound_s"] / seconds if calls and seconds > 0 else None
