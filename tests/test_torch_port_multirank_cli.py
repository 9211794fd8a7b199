"""The attack and defense commands under two ranks, on the CPU.

One module-scoped spawn of 2 gloo ranks (torch.multiprocessing's spawn,
``file://`` rendezvous, as tests/test_torch_port_parallel.py) runs, each
rank in a directory of its own, through ``python -m audiobd_tpu_torch``'s
``main``:
  (a) ``flowmur``, tiny;
  (b) the same run with rank 1's surrogates perturbed (``build_surrogate``
      wrapped on rank 1 to add 1e-3 to one weight), so its own trigger
      search ends elsewhere than rank 0's;
  (c) ``jingleback --style 5``, tiny;
  (d) ``fp``, ``ft_reg``, ``tsbd`` (stages B-D) and ``correlation_analysis``,
      both ranks reading rank 0's JingleBack record;
  (e) ``flowmur --load_trigger`` on a file only rank 0 sees.
While the ranks run, this process runs (a) and (c) as one process, and then
(d) on a copy of rank 0's JingleBack record. torch runs one intra-op thread
in every rank and here, so the three compute alike bit for bit.

Each rank wraps the attacks' ``poison`` to keep a sha256 of the ``bd_train``
it returns (features, labels, indicators), and records with an audit hook
every file it opens for writing, creates, renames or removes under the
ranks' directories. The checks: the ranks hold one trigger, one
``bd_train`` and equal final parameters; ``bd_train`` is bit-equal to one
process's (which tests/test_torch_port_flowmur.py and
tests/test_torch_port_jingleback.py hold against the JAX package); rank 1
writes nothing; rank 0's defense CSVs equal one process's; a trigger file
the ranks see differently raises on both.

A rank imports this module to find its target, so nothing here imports
JAX.
"""

import contextlib
import hashlib
import io
import os
import re
import shutil
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.parallel import distributed as port_dist

D = 2
SPAWN_TIMEOUT_S = 240
PERTURB = 1e-3
FLOWMUR = ["flowmur", "--synthetic", "--synthetic_per_class", "4", "--surrogate_epochs", "2", "--opt_epochs", "2",
           "--num_epochs", "2", "--device", "cpu"]
JINGLEBACK = ["jingleback", "--synthetic", "--synthetic_per_class", "4", "--style", "5", "--num_epochs", "2",
              "--batch_size", "16", "--device", "cpu"]
DEFENSES = {
    "fp": ["fp", "--result", "jingleback_smallcnn", "--device", "cpu"],
    "ft_reg": ["ft_reg", "--ft_epochs", "2", "--result", "jingleback_smallcnn", "--device", "cpu"],
    "tsbd": ["tsbd", "--only_finetune", "false", "--unlearn_epochs", "5", "--ft_epochs", "1", "--result",
             "jingleback_smallcnn", "--device", "cpu"],
    "correlation_analysis": ["correlation_analysis", "--result", "jingleback_smallcnn", "--device", "cpu"],
}
DEFENSE_DIR = os.path.join("record", "jingleback_smallcnn", "defense")
SEARCHED = re.compile(r"rank (\d+)/\d+ on [^:]*: flowmur trigger search sha256 ([0-9a-f]{64}) on this rank, "
                      r"([0-9a-f]{64}) after rank 0's broadcast")


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor) else a).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def _keep_bd_train(module, store: list):
    """``module.poison`` wrapped to append the sha256 of the ``bd_train`` it
    returns to ``store``."""
    poison = module.poison

    def wrapper(*args, **kwargs):
        out = poison(*args, **kwargs)
        store.append(_digest(out.bd_train.feats, out.bd_train.labels, out.bd_train.indicators))
        return out

    module.poison = wrapper
    try:
        yield
    finally:
        module.poison = poison


def _run(argv: list[str], cwd: str, wraps=()) -> dict:
    """``python -m audiobd_tpu_torch <argv>`` in ``cwd``: what it returned,
    printed, and the sha256 of each ``bd_train`` the attacks in ``wraps``
    poisoned."""
    digests: list = []
    printed = io.StringIO()
    with contextlib.ExitStack() as stack:
        for module in wraps:
            stack.enter_context(_keep_bd_train(module, digests))
        stack.enter_context(contextlib.chdir(cwd))
        stack.enter_context(contextlib.redirect_stdout(printed))
        result = port_main(argv)
    return {"result": result, "printed": printed.getvalue(), "bd_train": digests}


def _flowmur_out(run: dict) -> dict:
    return {"trigger": run["result"].trigger, "bd_train": run["bd_train"], "printed": run["printed"],
            "state": {k: v.clone() for k, v in run["result"].victim.model.state_dict().items()}}


# ---------------------------------------------------------------------------
# What each rank runs


def _rank_main(rank: int, tmp: str) -> None:
    from audiobd_tpu_torch.poison import flowmur, jingleback

    torch.set_num_threads(1)
    work = os.path.join(tmp, "work")
    writes: list = []
    case = [None]
    writing = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC

    def audit(event, args):
        if event == "open":
            mode, flags = args[1], args[2]
            if not (any(c in mode for c in "wax+") if isinstance(mode, str) else flags & writing):
                return
        elif event not in ("os.mkdir", "os.rename", "os.remove", "os.rmdir"):
            return
        if isinstance(args[0], (str, bytes, os.PathLike)):
            path = os.path.abspath(os.fsdecode(args[0]))
            if path.startswith(work):
                writes.append((case[0], path))

    sys.addaudithook(audit)
    assert port_dist.maybe_initialize_distributed(f"file://{tmp}/rendezvous", D, rank)
    out = {}

    case[0] = "a"
    out["a"] = _flowmur_out(_run(FLOWMUR, os.path.join(work, f"a{rank}"), (flowmur,)))

    case[0] = "b"
    build = flowmur.build_surrogate
    if rank == 1:
        def perturbed(*args, **kwargs):
            model = build(*args, **kwargs)
            with torch.no_grad():
                next(model.parameters()).view(-1)[0] += PERTURB
            return model

        flowmur.build_surrogate = perturbed
    try:
        out["b"] = _flowmur_out(_run(FLOWMUR, os.path.join(work, f"b{rank}"), (flowmur,)))
    finally:
        flowmur.build_surrogate = build

    case[0] = "c"
    run = _run(JINGLEBACK, os.path.join(work, f"c{rank}"), (jingleback,))
    out["c"] = {"bd_train": run["bd_train"],
                "state": {k: v.clone() for k, v in run["result"].result.model.state_dict().items()}}

    case[0] = "d"
    out["d"] = {}
    for name, argv in DEFENSES.items():
        out["d"][name] = _run(argv, os.path.join(work, "c0"))["printed"]

    case[0] = "e"
    try:
        _run([*FLOWMUR, "--load_trigger", "trigger.npy"], os.path.join(work, f"e{rank}"))
    except RuntimeError as e:
        out["e"] = str(e)

    out["writes"] = writes
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    port_dist.destroy()


# ---------------------------------------------------------------------------
# The fixture: the ranks, and one process beside them


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from audiobd_tpu_torch.poison import flowmur, jingleback

    tmp = str(tmp_path_factory.mktemp("multirank_cli"))
    work = os.path.join(tmp, "work")
    for d in [f"{case}{r}" for case in "abce" for r in range(D)] + ["one_a", "one_c", "one_d"]:
        os.makedirs(os.path.join(work, d))
    np.save(os.path.join(work, "e0", "trigger.npy"), np.full((1, 8000), 0.05, np.float32))
    threads = torch.get_num_threads()
    ctx = mp.start_processes(_rank_main, args=(tmp,), nprocs=D, join=False, start_method="spawn")
    try:
        torch.set_num_threads(1)
        one = {"a": _flowmur_out(_run(FLOWMUR, os.path.join(work, "one_a"), (flowmur,))),
               "c": _run(JINGLEBACK, os.path.join(work, "one_c"), (jingleback,))["bd_train"]}
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the {D} ranks did not finish in {SPAWN_TIMEOUT_S} s")
        # (d) as one process, on rank 0's record as the attack left it.
        record = os.path.join(work, "one_d", "record", "jingleback_smallcnn")
        shutil.copytree(os.path.join(work, "c0", "record", "jingleback_smallcnn"), record,
                        ignore=shutil.ignore_patterns("defense"))
        for argv in DEFENSES.values():
            _run(argv, os.path.join(work, "one_d"))
    finally:
        torch.set_num_threads(threads)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(D)]
    return {"work": work, "one": one, "outs": outs}


def _searched(printed: str) -> tuple[str, str]:
    """(this rank's own search's trigger digest, the one after the broadcast)."""
    (m,) = SEARCHED.finditer(printed)
    return m[2], m[3]


def _equal_states(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key, value in a.items():
        assert torch.equal(value, b[key]), key


def test_flowmur_under_two_ranks(runs):
    """(a): one trigger, one bd_train and equal replicas across the ranks;
    bd_train and the trigger bit-equal to one process's run."""
    out0, out1 = (o["a"] for o in runs["outs"])
    one = runs["one"]["a"]
    np.testing.assert_array_equal(out0["trigger"], out1["trigger"])
    np.testing.assert_array_equal(out0["trigger"], one["trigger"])
    assert out0["bd_train"] == out1["bd_train"] == one["bd_train"] and len(one["bd_train"]) == 1
    _equal_states(out0["state"], out1["state"])
    assert _searched(out0["printed"]) == _searched(out1["printed"])


def test_flowmur_ranks_poison_with_rank_0s_trigger(runs):
    """(b): rank 1's surrogates differ, so its own search ends elsewhere;
    both ranks poison with rank 0's trigger, the one rank 0 wrote."""
    out0, out1 = (o["b"] for o in runs["outs"])
    np.testing.assert_array_equal(out0["trigger"], out1["trigger"])
    assert out0["bd_train"] == out1["bd_train"] and len(out0["bd_train"]) == 1
    _equal_states(out0["state"], out1["state"])
    own0, after0 = _searched(out0["printed"])
    own1, after1 = _searched(out1["printed"])
    assert own1 != own0 == after0 == after1 == _digest(out0["trigger"])
    record = os.path.join(runs["work"], "b0", "record", "flowmur_smallcnn", "SCDv1-10", "bd")
    bd = [np.load(os.path.join(record, f"{n}.npy")) for n in ("bd_train_mfcc", "bd_train_label",
                                                               "poison_index_train")]
    assert _digest(*bd) == out0["bd_train"][0]


def test_jingleback_under_two_ranks(runs):
    """(c): style 5's bd_train equal across the ranks and bit-equal to one
    process's; equal replicas."""
    out0, out1 = (o["c"] for o in runs["outs"])
    assert out0["bd_train"] == out1["bd_train"] == runs["one"]["c"] and len(out0["bd_train"]) == 1
    _equal_states(out0["state"], out1["state"])


@pytest.mark.parametrize("defense", list(DEFENSES))
def test_defense_under_two_ranks(runs, defense):
    """(d): each rank ran the defense whole and printed its result's digest;
    rank 1 wrote nothing, anywhere; rank 0's files equal one process's."""
    work = runs["work"]
    names = {"fp": "fp", "ft_reg": "ft_reg", "tsbd": "tsbd", "correlation_analysis": "correlation"}
    for r, out in enumerate(runs["outs"]):
        assert re.search(rf"rank {r}/{D} on cpu: {defense} result sha256 [0-9a-f]{{64}}", out["d"][defense])
    assert runs["outs"][1]["writes"] == []
    assert os.listdir(os.path.join(work, "c1")) == []
    ranks = os.path.join(work, "c0", DEFENSE_DIR, names[defense])
    one = os.path.join(work, "one_d", DEFENSE_DIR, names[defense])
    files = sorted(os.path.relpath(os.path.join(d, f), ranks) for d, _, fs in os.walk(ranks) for f in fs)
    assert files and files == sorted(os.path.relpath(os.path.join(d, f), one) for d, _, fs in os.walk(one)
                                     for f in fs)
    for f in files:
        if f.endswith((".csv", ".txt", ".json")):
            with open(os.path.join(ranks, f)) as a, open(os.path.join(one, f)) as b:
                assert a.read() == b.read(), f


def test_trigger_file_seen_by_one_rank_raises(runs):
    """(e): ``--load_trigger`` naming a file only rank 0 sees raises on both
    ranks before anything is written."""
    for out in runs["outs"]:
        assert out["e"] == f"1 of {D} ranks see trigger.npy: the ranks must share it"
    assert not [w for w in runs["outs"][0]["writes"] if w[0] == "e"]
