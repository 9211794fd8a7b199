"""Device operations that started during the traced window's training epochs
(the host's ``train`` phases: ``run_train_epoch``, or its sharded form, with
the epoch's one reduction and host sync) over their training steps; on
rank 0 where there are ranks. The eval passes' operations are not counted."""


def read(r):
    if not r.train_steps:
        return None
    kernels = r.trace_mod.within(r.trace["kernels"], r.trace["spans"].get("train", []))
    return len(kernels) / r.train_steps if kernels else None
