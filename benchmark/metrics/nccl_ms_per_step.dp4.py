"""Milliseconds of NCCL kernels' device time during the traced window's
training epochs over their training steps, on rank 0: the sync-BN
statistics, the gradient buffer's all-reduce, and each epoch's one reduction
of losses and sums. A collective's kernel runs from its launch until every
rank has joined it, so the time includes the wait for the slowest rank."""


def read(r):
    if r.cards < 2 or not r.train_steps:
        return None
    kernels = r.trace_mod.within(r.trace["kernels"], r.trace["spans"].get("train", []))
    nccl = [k for k in kernels if "nccl" in k[0].lower()]
    return 1e3 * sum(e - s for _, s, e in nccl) / 1e9 / r.train_steps if nccl else None
