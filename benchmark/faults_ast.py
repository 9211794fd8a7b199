#!/usr/bin/env python3
"""Faults planted in AST's program (``badnets_ast``), beside those of
``faults.py`` that apply to it (``unchanged``, ``half_batch``): each must turn
``correct`` false. Never used by a benchmark run.

- ``unscaled_attention``: the attention's 1/√d_h scale left out;
- ``altered_ast``: the eval-mode AST's logits of a batch's first row rolled
  by a class (``faults.py``'s ``altered`` patches SmallCNN's forward).

    python3 benchmark/faults_ast.py <calibrate.py's arguments>

runs ``calibrate.py`` with these faults and ``faults.py``'s.
"""

from __future__ import annotations

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import faults  # noqa: E402
from benchmark.faults import patched  # noqa: E402

FAULTS = ("unscaled_attention", "altered_ast")


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted: one of ``FAULTS`` or of
    ``faults.py``'s."""
    if fault not in FAULTS:
        with faults.planted(fault):
            yield
        return
    from audiobd_tpu_torch.models import layers, zoo

    if fault == "unscaled_attention":
        scaled = layers.scaled_attention

        def unscaled(q, k, v):  # q · √d_h takes back the 1/√d_h scale (exact for d_h 64)
            return scaled(q * q.shape[-1] ** 0.5, k, v)

        with patched(layers, "scaled_attention", unscaled):
            yield
    else:
        forward = zoo.AST.forward

        def altered_forward(self, x):
            logits = forward(self, x)
            if self.training:
                return logits
            logits = logits.clone()
            logits[0] = logits[0].roll(1)
            return logits

        with patched(zoo.AST, "forward", altered_forward):
            yield


if __name__ == "__main__":
    from benchmark import calibrate

    calibrate.faults = sys.modules[__name__]
    sys.exit(calibrate.main())
