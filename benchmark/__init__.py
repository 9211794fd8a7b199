"""The benchmark of ``audiobd_tpu_torch``, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix, driver or per-layer metric is
a file of its own, found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the sizes as run, ``reduced`` and ``assumed``;
- ``traffic/<traffic>.json``: a mix's parameters, and the driver that runs it;
- ``drivers/<driver>.py``: set-up, the unit of work the window repeats, and
  the comparison with the reference that decides ``correct``;
- ``limits/<cell>.json``: each compared number's limit;
- ``metrics/<metric>.py``: how a per-layer metric is read from the trace;
- ``roofline/<config>.py``: a configuration's operation counts, beside one
  file a hand-written kernel (its least time a call) and the peaks.

``reference/`` is the plain reference the outputs are judged against; it
imports nothing of the port. ``calibrate.py`` gives the readings the limits
are set from. Nothing here imports JAX or the JAX package ``audiobd_tpu``.
"""
