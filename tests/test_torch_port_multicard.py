"""Ranks on a machine of several cards, on the CPU.

(a) Placement: four gloo ranks, started once by torch.multiprocessing's
spawn and meeting at ``file://`` paths, each join a group three times on a
machine patched to have 4 cards, or 1 (``torch.cuda.device_count``,
``is_available``), with ``torch.cuda.set_device`` and the backend
``init_process_group`` is asked for recorded (the group itself is gloo's):
  * an explicit join (coordinator, world, rank; no launcher environment) on
    4 cards: rank r sets card r, and the backend is ``cpu:gloo,cuda:nccl``;
  * torchrun's environment for two nodes of two ranks (``LOCAL_RANK`` r % 2,
    ``LOCAL_WORLD_SIZE`` 2) on 4 cards: ``LOCAL_RANK`` places the rank;
  * an explicit join of 4 ranks on 1 card: ``gloo``, nothing set.
In each, ``resolve_device(None)`` must name the card that was set (cuda:0
where none was), and rank 0's banner each rank's card as that rank set it.

(b) ``dryrun_multichip(4)``'s phase 2 for the port: one spawn of 4 gloo
ranks runs the sharded eval epoch and a train epoch of one global batch of
all rows, for SmallCNN and LargeCNN, on the hook's data (``n_rows`` 16 of
N(0, 1) features at (1, 101, 40), seed 7; eval batch 8), from the flax
weights ``jit_init`` draws at PRNGKey(0), carried by models/convert.py.
They are held against the JAX package's ``make_sharded_eval_epoch_fn`` and
``make_sharded_train_epoch_fn`` on 4 of the conftest's virtual devices, with
the hook's bounds: metric sums equal, the mean eval loss within 1e-5, the
running statistics within 2e-5 (absolute). Dropout is off on both sides
(flax's Dropout intercepted, the port's rates 0), so the train epoch's sums
are held equal too, and its gradients and parameters as
tests/test_torch_port_tp.py holds a step against JAX's: each tensor at most
the port's one-process step's distance from JAX's, plus 1e-4 of its
largest entry for the gradients (read from Adam's first moment, one step
from zero: mu = 0.1·g) and 0.25 lr for the parameters. JAX's sharded
gradient is D times the global batch's (tests/test_torch_port_parallel.py
shows it), undone by ``optax.scale(1 / D)``. On the hook's data the port's
f32 LargeCNN is 1.5e-3 and 8.2e-3 of convs.0's and convs.1's largest
gradient entry from JAX's in one process already (each feeds a max pool
with no relu between, whose near-ties the two route apart); the ranks are
as far, and every other tensor within 1e-5.

(c) ``dryrun_multichip(4)``'s phase 3(a), in the same spawn: the poisoning
prep row-sharded. The hook draws ``n_devices * 8`` clips of N(0, 0.1²) and
indicators at p 0.4 from the same generator after phase 2's data, and holds
``device_prep.make_sharded_prep_fn`` (MFCC, then BadNets' patch on the
indicated rows) on 4 devices against the single-device program within 1e-6.
In the port that prep is ``batched_mfcc_device`` then
``poison/badnets.py::_patch_indicated``, and a rank's rows are
``host_shard``'s. Each rank's rows must equal one process's within the
hook's 1e-6 (they come out bit-equal), and the JAX package's sharded rows
its single-device rows within 1e-6, as the hook runs them. Across the two
packages, whose f32 MFCCs differ in their last digits (up to 7.5e-5 on these
clips, above an elementwise 1e-6), the ranks' rows are held to
JAX's sharded rows at the MFCC tolerance of tests/test_torch_port_mfcc.py
(rtol 1e-4, atol 1e-3). Phase 3(b), a row-sharded TSBD unlearning step, has
no counterpart in the port: no path of either package shards a defense.

A rank imports this module to find its target, so JAX is imported inside
the fixture only.
"""

import contextlib
import io
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from audiobd_tpu_torch.models import LargeCNN, SmallCNN
from audiobd_tpu_torch.parallel import distributed as port_dist
from audiobd_tpu_torch.parallel.mesh import make_mesh
from audiobd_tpu_torch.train import scan_epoch as port_scan
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.train.state import Adam

RANKS = 4
SPAWN_TIMEOUT_S = 240
CPU = torch.device("cpu")
LAUNCHER = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# case: (cards on the machine, torchrun's environment for rank r or None)
PLACEMENT_CASES = {
    "explicit join, 4 cards": (4, None),
    "torchrun, 2 nodes x 2 ranks, 4 cards": (4, lambda r: {"WORLD_SIZE": str(RANKS), "RANK": str(r),
                                                           "LOCAL_RANK": str(r % 2), "LOCAL_WORLD_SIZE": "2"}),
    "explicit join, 1 card": (1, None),
}
N_ROWS, EVAL_BATCH = 4 * RANKS, 2 * RANKS  # dryrun_multichip(n): n_rows = 4n, eval batch 2n
LR = 1e-4
PREP_ROWS, PREP_CHUNK = 8 * RANKS, 8  # dryrun_multichip(n), phase 3: n_devices * 8 clips, chunk 8
PREP_TOL = 1e-6
MFCC_RTOL, MFCC_ATOL = 1e-4, 1e-3
MODELS = {"smallcnn": lambda: SmallCNN(10, 3072, dropout_rates=(0.0, 0.0)),
          "largecnn": lambda: LargeCNN(10, 12288, dropout_rate=0.0)}


def _spawn(fn, tmp: str) -> None:
    ctx = mp.start_processes(fn, args=(tmp,), nprocs=RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {RANKS} ranks did not finish in {SPAWN_TIMEOUT_S} s")


# ---------------------------------------------------------------------------
# (a) placement


def _placement_rank(rank: int, tmp: str) -> None:
    """Rank ``rank``'s three joins; what each set, asked for and printed to
    ``tmp``."""
    from audiobd_tpu_torch.utils.device import resolve_device

    torch.set_num_threads(1)
    real_init, saved = dist.init_process_group, (torch.cuda.device_count, torch.cuda.is_available,
                                                 torch.cuda.set_device)
    out = {}
    for i, (case, (cards, env)) in enumerate(PLACEMENT_CASES.items()):
        for var in LAUNCHER:
            os.environ.pop(var, None)
        os.environ.update(env(rank) if env else {})
        seen = {"set_device": [], "backend": None}

        def init(backend, **kwargs):
            seen["backend"] = backend
            real_init("gloo", **kwargs)

        torch.cuda.device_count, torch.cuda.is_available = (lambda: cards), (lambda: True)
        torch.cuda.set_device = seen["set_device"].append
        dist.init_process_group = init
        try:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                if env:
                    joined = port_dist.maybe_initialize_distributed(f"file://{tmp}/rendezvous{i}")
                else:
                    joined = port_dist.maybe_initialize_distributed(f"file://{tmp}/rendezvous{i}", RANKS, rank)
            seen.update(joined=joined, resolved=str(resolve_device(None)), printed=printed.getvalue())
        finally:
            torch.cuda.device_count, torch.cuda.is_available, torch.cuda.set_device = saved
            dist.init_process_group = real_init
            port_dist.destroy()
        out[case] = seen
    torch.save(out, os.path.join(tmp, f"placement{rank}.pt"))


@pytest.fixture(scope="module")
def placements(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("placement"))
    _spawn(_placement_rank, tmp)
    return [torch.load(os.path.join(tmp, f"placement{r}.pt")) for r in range(RANKS)]


def _set(seen) -> int:
    """The one card a rank set; 0, the current device, where it set none."""
    assert len(seen["set_device"]) <= 1, seen
    return seen["set_device"][0] if seen["set_device"] else 0


@pytest.mark.parametrize("check", ["explicit join: card r, nccl", "torchrun: LOCAL_RANK wins",
                                   "one card: gloo, nothing set", "resolve_device is the card set",
                                   "the banner names what was set"])
def test_rank_takes_its_own_card(placements, check):
    if check == "explicit join: card r, nccl":
        runs = [p["explicit join, 4 cards"] for p in placements]
        assert [s["set_device"] for s in runs] == [[r] for r in range(RANKS)]
        assert {s["backend"] for s in runs} == {"cpu:gloo,cuda:nccl"}
    elif check == "torchrun: LOCAL_RANK wins":
        runs = [p["torchrun, 2 nodes x 2 ranks, 4 cards"] for p in placements]
        assert [s["set_device"] for s in runs] == [[r % 2] for r in range(RANKS)]
        assert {s["backend"] for s in runs} == {"cpu:gloo,cuda:nccl"}
    elif check == "one card: gloo, nothing set":
        runs = [p["explicit join, 1 card"] for p in placements]
        assert [s["set_device"] for s in runs] == [[]] * RANKS
        assert {s["backend"] for s in runs} == {"gloo"}
    elif check == "resolve_device is the card set":
        for case in PLACEMENT_CASES:
            for r, p in enumerate(placements):
                assert p[case]["joined"] is True
                assert p[case]["resolved"] == f"cuda:{_set(p[case])}", (case, r)
    else:
        for case, (cards, _) in PLACEMENT_CASES.items():
            backend = "nccl" if cards == RANKS else "gloo"
            devices = ", ".join(f"rank {r}: cuda:{_set(p[case])}" for r, p in enumerate(placements))
            assert placements[0][case]["printed"] == f"distributed: world {RANKS}, backend {backend} ({devices})\n"
            assert all(p[case]["printed"] == "" for p in placements[1:]), case


# ---------------------------------------------------------------------------
# (b) dryrun_multichip(4)'s phase 2


def _dryrun_rank(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    assert port_dist.maybe_initialize_distributed(f"file://{tmp}/rendezvous", RANKS, rank)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh()
    out = {}
    for name, make in MODELS.items():
        data = ArraySet(*inputs["data"][name])
        model = make()
        model.load_state_dict(inputs["state"][name])
        model.sync_batchnorm(mesh.data_group)
        dset = port_scan.ShardedDeviceDataset(data, mesh, CPU)
        batches = []
        summary = port_scan._summary
        port_scan._summary = lambda *a: batches.append(summary(*a)) or batches[-1]
        try:
            ev = port_scan.run_eval_sharded(model, dset, EVAL_BATCH)
            opt = Adam(model.parameters(), LR)
            tr = port_scan.run_train_epoch_sharded(model, opt, dset, N_ROWS, None)
        finally:
            port_scan._summary = summary
        out[name] = {"eval": ev, "eval_losses": batches[0][0], "train": tr, "train_sums": batches[1][1],
                     "state": {k: v.clone() for k, v in model.state_dict().items()},
                     "mu": dict(zip((n for n, _ in model.named_parameters()), opt.mu))}
    wavs, inds = inputs["prep"]
    rows = port_dist.host_shard(PREP_ROWS).indices()
    out["prep"] = (rows, _badnets_prep(wavs[rows], inds[rows]))
    torch.save(out, os.path.join(tmp, f"dryrun{rank}.pt"))
    port_dist.destroy()


def _badnets_prep(wavs: np.ndarray, inds: np.ndarray) -> np.ndarray:
    """The port's fused poisoning prep of the hook's phase 3: MFCC of the
    clips, BadNets' patch on the indicated rows."""
    from audiobd_tpu_torch.configs import make_config
    from audiobd_tpu_torch.data.speech_commands import batched_mfcc_device, mfcc_params
    from audiobd_tpu_torch.poison.badnets import _patch_indicated, generate_trigger

    cfg = make_config("badnets")
    trigger = torch.from_numpy(generate_trigger(cfg.dsp.n_mfcc, 101, cfg.trigger_size))
    feats = batched_mfcc_device(wavs, mfcc_params(cfg), CPU)
    return _patch_indicated(feats, torch.from_numpy(inds.astype(np.int64)), trigger).numpy()


def _rel(got, want) -> float:
    """The largest difference, relative to ``want``'s largest entry."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _no_dropout(next_fun, args, kwargs, context):
    import flax.linen as nn

    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The hook's data and weights, the JAX package's sharded epochs on 4
    virtual devices, and the 4 ranks' results."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax

    from audiobd_tpu.configs import make_config as jax_make_config
    from audiobd_tpu.models import jit_init
    from audiobd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audiobd_tpu.train import scan_epoch as jax_scan
    from audiobd_tpu.train.loop import ArraySet as JaxArraySet
    from audiobd_tpu.train.state import TrainState
    from audiobd_tpu.train.trainer import build_attack_model
    from audiobd_tpu_torch.models.convert import largecnn_from_flax, opt_state_from_flax, smallcnn_from_flax

    tmp = str(tmp_path_factory.mktemp("dryrun"))
    mesh = jax_make_mesh(n_data=RANKS, n_model=1, devices=jax.devices()[:RANKS])
    rng = np.random.default_rng(7)
    tx = optax.chain(optax.scale(1.0 / RANKS), optax.adam(LR))  # the reference's D x gradient, undone
    inputs, ref = {"state": {}, "data": {}}, {}
    for name, carry in (("smallcnn", smallcnn_from_flax), ("largecnn", largecnn_from_flax)):
        m = build_attack_model(jax_make_config("badnets", model=name, batch_size=N_ROWS))
        data = (rng.normal(size=(N_ROWS, 1, 101, 40)).astype(np.float32), rng.integers(0, 10, N_ROWS),
                (rng.random(N_ROWS) < 0.3).astype(np.int64))
        variables = jax.tree_util.tree_map(np.asarray, jit_init(m, jax.random.PRNGKey(0),
                                                                jnp.zeros((1, 1, 101, 40))))
        inputs["state"][name], inputs["data"][name] = carry(variables), data
        state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
        dset = jax_scan.ShardedDeviceDataset(JaxArraySet(*data), mesh)
        perm, mask, _ = jax_scan.make_sharded_perm(None, N_ROWS, RANKS, EVAL_BATCH)
        losses, sums = jax_scan.make_sharded_eval_epoch_fn(m, mesh)(
            state.params, state.batch_stats, dset.feats, dset.labels, dset.indicators, jnp.asarray(perm),
            jnp.asarray(mask))
        perm, mask, _ = jax_scan.make_sharded_perm(None, N_ROWS, RANKS, N_ROWS)
        with nn.intercept_methods(_no_dropout):
            trained, t_losses, t_sums = jax_scan.make_sharded_train_epoch_fn(m, tx, mesh)(
                state, dset.feats, dset.labels, dset.indicators, jnp.asarray(perm), jnp.asarray(mask),
                jax.random.PRNGKey(2))
        final = carry(jax.tree_util.tree_map(np.asarray, {"params": trained.params,
                                                          "batch_stats": trained.batch_stats}))
        one = MODELS[name]()
        one.load_state_dict(inputs["state"][name])
        opt = Adam(one.parameters(), LR)
        port_scan.run_train_epoch(one, opt, port_scan.DeviceDataset(ArraySet(*data), CPU), N_ROWS, None)
        names = [n for n, _ in one.named_parameters()]
        adam = opt_state_from_flax(name, jax.tree_util.tree_map(np.asarray, trained.opt_state[1]), names)
        ref[name] = {"eval_losses": np.asarray(losses), "eval_sums": np.asarray(sums),
                     "train_losses": np.asarray(t_losses), "train_sums": np.asarray(t_sums), "state": final,
                     "mu": dict(zip(names, adam["mu"])), "one_mu": dict(zip(names, opt.mu)),
                     "one_state": {k: v.clone() for k, v in one.state_dict().items()}}
    # Phase 3(a): the hook's clips and indicators, drawn after phase 2's data.
    from audiobd_tpu.data.speech_commands import mfcc_params as jax_mfcc_params
    from audiobd_tpu.poison import device_prep
    from audiobd_tpu.poison.badnets import generate_trigger as jax_generate_trigger

    wavs = rng.normal(size=(PREP_ROWS, 16000)).astype(np.float32) * 0.1
    inds = (rng.random(PREP_ROWS) < 0.4).astype(np.int32)
    inputs["prep"] = (wavs, inds)
    pcfg = jax_make_config("badnets")
    trig = jnp.asarray(jax_generate_trigger(pcfg.dsp.n_mfcc, 101, pcfg.trigger_size, save_path=None))
    block = device_prep.make_block_fn(jax_mfcc_params(pcfg), feat_fn=lambda f: jnp.where(trig != 0, trig, f))
    ref["prep"] = {
        "single": np.asarray(jax.jit(lambda w, i: device_prep.map_blocks(block, w, i, PREP_CHUNK))(
            jnp.asarray(wavs), jnp.asarray(inds))),
        "sharded": np.asarray(device_prep.make_sharded_prep_fn(block, mesh, chunk=PREP_CHUNK)(
            jnp.asarray(wavs), jnp.asarray(inds))),
        "one": _badnets_prep(wavs, inds),
    }
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    _spawn(_dryrun_rank, tmp)
    outs = [torch.load(os.path.join(tmp, f"dryrun{r}.pt"), weights_only=False) for r in range(RANKS)]
    return ref, outs


@pytest.mark.parametrize("name", list(MODELS))
def test_four_ranks_hold_dryrun_multichip_phase2(dryrun, name):
    ref, outs = dryrun
    ref = ref[name]
    assert int(ref["eval_sums"][1]) == N_ROWS and int(ref["train_sums"][1]) == N_ROWS
    for out in (o[name] for o in outs):
        np.testing.assert_array_equal(out["eval"]["sums"], ref["eval_sums"])
        np.testing.assert_allclose(np.mean(out["eval_losses"]), ref["eval_losses"].mean(), atol=1e-5)
        np.testing.assert_allclose(out["eval"]["loss"], ref["eval_losses"].mean(), atol=1e-5)
        np.testing.assert_array_equal(out["train_sums"], ref["train_sums"])
        np.testing.assert_allclose(out["train"]["loss"], ref["train_losses"].mean(), atol=1e-5)
        stats = [k for k in out["state"] if "running" in k]
        assert len(stats) == (6 if name == "smallcnn" else 0)
        for key in stats:
            np.testing.assert_allclose(out["state"][key].numpy(), ref["state"][key].numpy(), atol=2e-5, rtol=0,
                                       err_msg=key)
        assert out["mu"].keys() == ref["mu"].keys()
        for key, mu in out["mu"].items():
            want = ref["mu"][key]
            assert _rel(mu, want) <= _rel(ref["one_mu"][key], want) + 1e-4, key
            want, one = ref["state"][key], ref["one_state"][key]
            assert (out["state"][key] - want).abs().max() <= (one - want).abs().max() + 0.25 * LR, key
    for out in outs[1:]:
        for key, value in out[name]["state"].items():
            assert torch.equal(value, outs[0][name]["state"][key]), key


def test_four_ranks_hold_dryrun_multichip_phase3a(dryrun):
    """Each rank's ``host_shard`` rows of the poisoned features equal one
    process's within the hook's 1e-6, the JAX package's sharded prep equals
    its single-device prep within 1e-6, and the ranks' rows sit at the MFCC
    tolerance from JAX's sharded rows."""
    ref, outs = dryrun
    ref = ref["prep"]
    assert ref["sharded"].shape == ref["one"].shape == (PREP_ROWS, 1, 101, 40)
    np.testing.assert_allclose(ref["sharded"], ref["single"], atol=PREP_TOL, rtol=PREP_TOL)
    covered = []
    for r, out in enumerate(outs):
        rows, feats = out["prep"]
        assert len(rows) == PREP_ROWS // RANKS, r
        covered.extend(rows)
        np.testing.assert_allclose(feats, ref["one"][rows], atol=PREP_TOL, rtol=PREP_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(feats, ref["sharded"][rows], atol=MFCC_ATOL, rtol=MFCC_RTOL, err_msg=f"rank {r}")
    assert covered == list(range(PREP_ROWS))
