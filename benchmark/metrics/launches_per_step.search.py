"""Device operations that started during the traced window's calls to
``optimize_trigger`` (the host's ``search`` phases, each call's copy of its
hosts included) over their search steps."""


def read(r):
    if not r.search_steps:
        return None
    kernels = r.trace_mod.within(r.trace["kernels"], r.trace["spans"].get("search", []))
    return len(kernels) / r.search_steps if kernels else None
