"""The port's spans and host-sync counter (utils/profiling.py) on the CPU.

Under a ``torch.profiler`` session a training epoch, an eval pass and a
trigger search record the span tree their modules name, each child inside
its parent, with the host syncs each site makes; the spans' host clock is
the profiler's (each ``forward`` span holds the starts of its own aten
operators). With no session nothing is recorded, and the results are
bit-identical with the session on and off. Two gloo ranks record the
sharded epochs' tree. A train step at a shape where models/layers.py's
row-slice route engages (the rule told the CPU is CUDA, its slices cut to
a few rows) records its two routed convolutions (blocks 2 and 3) in
``sliced_convs``; under the least rows, or in an eval step (no gradient),
none. A span records each kernel's launches inside it by name (``kernels``)
and their sum (``launches``), and the change of any counter that ``count``
alone names, which ``spans.json`` writes beside the rest.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.profiler import ProfilerActivity, profile

from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.models import layers
from audiobd_tpu_torch.parallel import distributed as port_dist
from audiobd_tpu_torch.parallel.mesh import make_mesh
from audiobd_tpu_torch.poison import flowmur
from audiobd_tpu_torch.train import scan_epoch
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.train.trainer import build_attack_model, make_optimizer
from audiobd_tpu_torch.utils import profiling

CPU = torch.device("cpu")
TRAIN_N, EVAL_N, BATCH = 20, 9, 8
HOSTS, SEARCH_BATCH, EPOCHS = 8, 4, 2
D = 2
# Steps an epoch: 20 and 9 rows at 8 a batch, the tails wrap-padded; on two
# ranks 10 and 5 rows a rank at 4; 8 hosts at 4.
STEPS = {"train": 3, "eval": 2, "train_sharded": 3, "eval_sharded": 2, "search": 2}
SPAWN_TIMEOUT_S = 240
CLOCK_SLACK_NS = 1_000_000
TRAIN_STEP = ["forward", "loss", "backward", "optimizer", "metrics"]
SEARCH_STEP = ["deploy", "mfcc", "surrogate", "backward", "adam"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed: int, n: int) -> ArraySet:
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((n, 1, 101, 40)) * 8.0).astype(np.float32)
    ind = (rng.random(n) < 0.4).astype(np.int64)
    return ArraySet(feats, np.where(ind == 1, 2, rng.integers(0, 10, n)), ind)


def _run(case: str):
    """One unit of ``case`` from a fresh model: (its outputs, the
    parameters after it)."""
    if case == "search":
        cfg = make_config("flowmur", device="cpu", batch_size=SEARCH_BATCH, flowmur_opt_epochs=EPOCHS)
        surrogate = flowmur.build_surrogate(cfg, 0, CPU)
        hosts = np.random.default_rng(5).uniform(-0.5, 0.5, (HOSTS, 1, 16000)).astype(np.float32)
        history: list = []
        trig = flowmur.optimize_trigger(cfg, surrogate, hosts, verbose=False, save_snapshots=False,
                                        loss_history=history)
        return history, [torch.from_numpy(trig)]
    cfg = make_config("badnets", device="cpu", batch_size=BATCH)
    model = build_attack_model(cfg, CPU)
    if case == "train":
        opt = make_optimizer(cfg, model.parameters())
        out = scan_epoch.run_train_epoch(model, opt, scan_epoch.DeviceDataset(_data(9, TRAIN_N), CPU), BATCH,
                                         np.random.default_rng(35))
    else:
        out = scan_epoch.run_eval_epoch(model, scan_epoch.DeviceDataset(_data(11, EVAL_N), CPU), BATCH)
    return out, [t.detach().clone() for t in model.state_dict().values()]


def _profiled(fn):
    """``fn()`` under a CPU profiler session: (its result, the spans it
    recorded as rows, the profiler's events as (name, start ns))."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()]
    return out, _rows([s for s in profiling.recorded() if s.t0 >= t0]), events


def _rows(spans) -> list[dict]:
    """Spans as picklable rows, each with its parent's row index."""
    index = {id(s): i for i, s in enumerate(spans)}
    return [{"name": s.name, "parent": index.get(id(s.parent)), "t0": s.t0, "t1": s.t1, "host_syncs": s.host_syncs,
             "sliced_convs": s.counts["sliced_convs"], "device_ms": s.device_ms} for s in spans]


def _tree(rows: list[dict], i: int) -> tuple:
    """(name, children's trees in host order) of row ``i``."""
    children = sorted((j for j, r in enumerate(rows) if r["parent"] == i), key=lambda j: rows[j]["t0"])
    return rows[i]["name"], [_tree(rows, j) for j in children]


def _expected(case: str) -> tuple:
    leaf = lambda name: (name, [])  # noqa: E731
    if case == "search":
        step = ("search_step", [leaf(n) for n in SEARCH_STEP])
        epoch = ("search_epoch", [leaf("plan"), *[step] * STEPS[case], leaf("summary")])
        return "search_call", [leaf("upload"), *[epoch] * EPOCHS, leaf("result")]
    if case.startswith("train"):
        step = ("train_step", [leaf(n) for n in TRAIN_STEP])
        return "train_epoch", [leaf("plan"), *[step] * STEPS[case], leaf("summary")]
    step = ("eval_step", [leaf("forward"), leaf("metrics")])
    return "eval_epoch", [leaf("plan"), *[step] * STEPS[case], leaf("summary")]


# Host syncs of a root span: an epoch's plan upload and its summary read
# (after the ranks' all-reduce where there are ranks); a search's upload,
# its result, and each epoch's plan and summary.
HOST_SYNCS = {"train": 2, "eval": 2, "search": 2 * EPOCHS + 2, "train_sharded": 2, "eval_sharded": 2}


def _check_tree(rows: list[dict], case: str) -> None:
    roots = [i for i, r in enumerate(rows) if r["parent"] is None]
    assert len(roots) == 1, [rows[i]["name"] for i in roots]
    assert _tree(rows, roots[0]) == _expected(case)
    for r in rows:
        if r["parent"] is not None:
            p = rows[r["parent"]]
            assert p["t0"] <= r["t0"] <= r["t1"] <= p["t1"], (r["name"], p["name"])
        assert r["device_ms"] is None  # no timing events off CUDA
    assert rows[roots[0]]["host_syncs"] == HOST_SYNCS[case]


# ---------------------------------------------------------------------------
# Two gloo ranks


def _rank_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    assert port_dist.maybe_initialize_distributed(f"file://{tmp}/rendezvous", D, rank)
    mesh = make_mesh()
    cfg = make_config("badnets", device="cpu", batch_size=BATCH)
    model = build_attack_model(cfg, CPU)
    model.sync_batchnorm(mesh.data_group)
    opt = make_optimizer(cfg, model.parameters())
    train = scan_epoch.ShardedDeviceDataset(_data(9, TRAIN_N), mesh, CPU)
    evals = scan_epoch.ShardedDeviceDataset(_data(11, EVAL_N), mesh, CPU)
    out = {}
    _, out["train_sharded"], _ = _profiled(
        lambda: scan_epoch.run_train_epoch_sharded(model, opt, train, BATCH, np.random.default_rng(35)))
    _, out["eval_sharded"], _ = _profiled(lambda: scan_epoch.run_eval_sharded(model, evals, BATCH))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    port_dist.destroy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's span rows of a sharded train epoch and eval pass."""
    tmp = str(tmp_path_factory.mktemp("span_ranks"))
    ctx = mp.start_processes(_rank_main, args=(tmp,), nprocs=D, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {D} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(D)]


# ---------------------------------------------------------------------------
# The tests


def test_nothing_is_recorded_without_a_profiler():
    before, syncs = len(profiling.recorded()), profiling.counts()["host_syncs"]
    assert profiling.span("train_step") is profiling.span("forward")  # one shared no-op
    _run("train")
    assert len(profiling.recorded()) == before
    assert profiling.counts()["host_syncs"] - syncs == HOST_SYNCS["train"]  # the counter counts either way


@pytest.mark.parametrize("case", ["train", "eval", "search"])
def test_span_tree(case):
    _, rows, events = _profiled(lambda: _run(case))
    _check_tree(rows, case)
    if case == "search":
        return
    # The spans' host clock is the profiler's: each forward span holds the
    # starts of its own convolutions, and every convolution (the backward
    # runs convolution_backward) starts in a forward span.
    forwards = [(r["t0"] - CLOCK_SLACK_NS, r["t1"] + CLOCK_SLACK_NS) for r in rows if r["name"] == "forward"]
    convs = [t for name, t in events if name == "aten::conv2d"]
    assert convs and forwards
    assert all(any(a <= t <= b for a, b in forwards) for t in convs)
    assert all(any(a <= t <= b for t in convs) for a, b in forwards)


@pytest.mark.parametrize("case", ["train_sharded", "eval_sharded"])
def test_span_tree_on_two_ranks(ranks, case):
    for out in ranks:
        _check_tree(out[case], case)


@pytest.mark.parametrize("case", ["train", "eval", "search"])
def test_results_are_bit_identical_with_the_profiler_on(case):
    (out_off, params_off), ((out_on, params_on), _, _) = _run(case), _profiled(lambda: _run(case))
    if isinstance(out_off, dict):  # an epoch's losses and metrics; a search's losses
        assert out_off.keys() == out_on.keys()
        out_off, out_on = list(out_off.values()), list(out_on.values())
    assert all(np.array_equal(a, b) for a, b in zip(out_off, out_on, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on, strict=True))


@pytest.mark.parametrize("case,slice_rows,expected", [("train", 2, 2), ("train", BATCH, 0), ("eval", 2, 0)])
def test_step_counts_sliced_convs(monkeypatch, case, slice_rows, expected):
    real = layers.row_slices
    monkeypatch.setattr(layers, "row_slices", lambda conv, shape, device, dtype, needs: real(conv, shape, "cuda",
                                                                                             dtype, needs))
    monkeypatch.setattr(layers, "ROW_SLICES", {(64, 100, 13, 64): (layers.WEIGHT_GRAD, slice_rows, 2 * slice_rows),
                                               (64, 50, 7, 32): (layers.INPUT_GRAD, slice_rows, 2 * slice_rows)})
    cfg = make_config("badnets", device="cpu", batch_size=BATCH)
    model = build_attack_model(cfg, CPU)
    data = scan_epoch.DeviceDataset(_data(9, BATCH), CPU)  # one batch
    if case == "train":
        opt = make_optimizer(cfg, model.parameters())
        _, rows, _ = _profiled(lambda: scan_epoch.run_train_epoch(model, opt, data, BATCH, np.random.default_rng(35)))
    else:
        _, rows, _ = _profiled(lambda: scan_epoch.run_eval_epoch(model, data, BATCH))
    assert [r["sliced_convs"] for r in rows if r["name"] == f"{case}_step"] == [expected]


def test_span_counts_each_kernels_launches():
    """Launch counters moved inside a span (as a wrapper's call moves its
    own) show in its ``kernels`` by name and in ``launches``; a counter
    that did not move is left out."""
    from audiobd_tpu_torch.ops import conv1_bn_pool as op

    def launches():
        with profiling.span("train_step"):
            with profiling.span("forward"):
                profiling.count(op.FWD_KERNEL.counter)
            profiling.count(op.BWD_PARAMS_KERNEL.counter, 2)

    before = op.FWD_KERNEL.launches
    _profiled(launches)
    forward, step = profiling.recorded()[-2:]
    assert (forward.name, forward.kernels, forward.launches) == ("forward", {"conv1_bn_pool_fwd": 1}, 1)
    assert (step.kernels, step.launches) == ({"conv1_bn_pool_fwd": 1, "conv1_bn_pool_bwd_params": 2}, 3)
    assert op.FWD_KERNEL.launches == before + 1


def test_a_counter_made_by_count_alone_is_recorded_and_written(tmp_path):
    """A counter that only ``count`` names, first counted inside a span,
    shows in that span's and its parent's changes and in the args of every
    event of ``spans.json``, zero where it did not move, beside the keys
    every event has."""
    name = "test_registry_counter"

    def run():
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count(name, 3)
            with profiling.span("other"):
                pass

    with profiling.trace(str(tmp_path), CPU):
        run()
    inner, other, outer = profiling.recorded()[-3:]
    assert (inner.counts[name], other.counts[name], outer.counts[name]) == (3, 0, 3)
    [path] = tmp_path.glob("rank0.*.spans.json")
    events = {e["name"]: e["args"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {k: events[k][name] for k in ("inner", "other", "outer")} == {"inner": 3, "other": 0, "outer": 3}
    assert all({"index", "parent", "path", "host_syncs", "sliced_convs", "attention_calls", "launches", "kernels",
                "device_ms"} <= args.keys() for args in events.values())
