"""Faults planted in the program, for the tests and for ``calibrate.py``:
each must turn ``correct`` false. Never used by a benchmark run.

- ``unchanged``: an optimizer step that leaves its state unchanged;
- ``half_batch``: half of each batch left out of the loss, the mean taken
  over the rest;
- ``no_exchange``: the gradients' all-reduce between ranks left out;
- ``altered``: an answer altered where it is produced (the eval-mode
  model's logits of a batch's first row rolled by a class, the search's
  frozen surrogate's too; the trigger a search returns with its first
  sample negated).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted (None: as it is)."""
    if fault is None:
        yield
        return
    import torch

    from audiobd_tpu_torch.models import zoo
    from audiobd_tpu_torch.poison import flowmur
    from audiobd_tpu_torch.train import scan_epoch, state

    if fault == "unchanged":
        with patched(state.Adam, "step", lambda self, grads: None):
            yield
    elif fault == "half_batch":
        ce, loss = scan_epoch.cross_entropy, flowmur.trigger_loss

        def half_ce(logits, labels):
            rows = ce(logits, labels)
            keep = torch.zeros_like(rows)
            keep[: rows.shape[0] // 2] = 2.0
            return rows * keep

        def half_loss(surrogate, trigger, wavs, positions, *args):
            half = wavs.shape[0] // 2
            return loss(surrogate, trigger, wavs[:half], positions[:half], *args)

        with patched(scan_epoch, "cross_entropy", half_ce), patched(flowmur, "trigger_loss", half_loss):
            yield
    elif fault == "no_exchange":
        with patched(scan_epoch, "all_reduce_flat", lambda tensors, group: list(tensors)):
            yield
    elif fault == "altered":
        forward, search = zoo.SmallCNN.forward, flowmur.optimize_trigger

        def altered_forward(self, x):
            logits = forward(self, x)
            if self.training:
                return logits
            logits = logits.clone()
            logits[0] = logits[0].roll(1)
            return logits

        def altered_search(*args, **kwargs):
            trig = search(*args, **kwargs).copy()
            trig[0, 0] = -trig[0, 0]
            return trig

        with patched(zoo.SmallCNN, "forward", altered_forward), patched(flowmur, "optimize_trigger", altered_search):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}")
