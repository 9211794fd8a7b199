"""Data-parallel training in the port (parallel/, the sharded epoch engine,
sync-BN) against audiobd_tpu's sharded scan epochs, on the CPU.

Two gloo ranks are started once, with torch.multiprocessing's spawn, and
meet through a ``file://`` path in a temporary directory (no port, so
xdist workers never race for one). A rank imports this module to find its
target, so nothing here imports JAX at module level: JAX is imported inside
the tests and the fixture, in the pytest process only. The ranks read their
inputs (weights carried from a flax SmallCNN with models/convert.py, the
data) from a file the fixture writes, and write their results to another.

Dropout is off on both sides, as in tests/test_torch_port_model.py: flax's
Dropout intercepted on the JAX side, rates (0, 0) on the port's.

The reference's sharded engine differentiates ``psum(num) / den`` inside a
``shard_map`` with ``check_vma=False``, where psum's transpose is a psum:
its gradient is D times the global batch's (shown by
``test_reference_sharded_gradient_is_d_times_the_global_one``). The port
sums the ranks' gradients of ``num_rank / den``, the global batch's
gradient. So the JAX side of the epoch comparison steps with
``optax.chain(optax.scale(1 / D), optax.adam(lr))``, and both step on one
gradient.

Tolerances (those of tests/test_torch_port_model.py): losses rtol 1e-5;
gradients and running statistics 1e-4 relative to each tensor's largest
entry; parameters after Adam steps 0.25 lr; metric sums and the plans
exact; the two ranks' parameters bit-equal.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.models import SmallCNN
from audiobd_tpu_torch.parallel import distributed as port_dist
from audiobd_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from audiobd_tpu_torch.train import scan_epoch as port_scan
from audiobd_tpu_torch.train.loop import ArraySet, cross_entropy, masked_mean
from audiobd_tpu_torch.train.state import Adam
from audiobd_tpu_torch.utils.random import np_rng

D = 2
LR = 1e-4
TRAIN_N, TRAIN_BATCH = 20, 8  # 3 batches of 4 rows a rank, the last wrap-padded
EVAL_N, EVAL_BATCH = 9, 4     # ragged shards: 5 and 4 rows
STEP_N = 16                   # one global batch, 8 rows a rank
DABA_SMALL = dict(host_candidates=40, poisoning_rate=0.1)
RANK1_DELAY_S = 1.0
CPU = torch.device("cpu")
SPAWN_TIMEOUT_S = 240


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _port_model(state):
    model = SmallCNN(10, 3072, dropout_rates=(0.0, 0.0))
    model.load_state_dict(state)
    return model


def _spy(fn, store):
    """``fn`` that also appends its result to ``store``."""

    def wrapper(*args):
        out = fn(*args)
        store.append(out)
        return out

    return wrapper


def _record_grads(opt, store):
    """Keep a copy of the gradients of each ``opt.step``."""
    step = opt.step

    def wrapper(grads):
        store.append([g.detach().clone() for g in grads])
        return step(grads)

    opt.step = wrapper


# ---------------------------------------------------------------------------
# What each rank runs


def _rank_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(2)
    assert port_dist.maybe_initialize_distributed(f"file://{tmp}/rendezvous", D, rank)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh()
    out = {"mesh": (mesh.shape, mesh.data_index), "rank": port_dist.rank(), "world": port_dist.world_size()}

    # (b), (c): the sharded eval on the initial weights, then a train epoch.
    batches = []
    port_scan._summary = _spy(port_scan._summary, batches)
    model = _port_model(inputs["state"])
    model.sync_batchnorm(mesh.data_group)
    opt = Adam(model.parameters(), LR)
    ev = port_scan.run_eval_sharded(model, port_scan.ShardedDeviceDataset(ArraySet(*inputs["eval"]), mesh, CPU),
                                    EVAL_BATCH)
    tr = port_scan.run_train_epoch_sharded(
        model, opt, port_scan.ShardedDeviceDataset(ArraySet(*inputs["train"]), mesh, CPU), TRAIN_BATCH,
        np_rng(35, "shuffle"))
    out["eval"], out["train"] = ev, tr
    out["eval_batches"], out["train_batches"] = batches
    out["epoch_state"] = {k: v.clone() for k, v in model.state_dict().items()}

    # (d): one step on one global batch, this rank's half of its rows.
    model = _port_model(inputs["state"])
    model.sync_batchnorm(mesh.data_group)
    opt = Adam(model.parameters(), LR)
    grads = []
    _record_grads(opt, grads)
    x, y, ind = inputs["step"]
    rows = shard_batch(mesh, np.arange(STEP_N))
    out["step_rows"] = rows
    step = port_scan.run_train_epoch_sharded(
        model, opt, port_scan.ShardedDeviceDataset(ArraySet(x, y, ind), mesh, CPU), STEP_N, None)
    out["step"], out["step_grads"] = step, grads[0]
    out["step_state"] = {k: v.clone() for k, v in model.state_dict().items()}

    # (e): the BadNets CLI, this rank in a directory of its own.
    from audiobd_tpu_torch.cli import badnets
    from audiobd_tpu_torch.train.trainer import resolve_fused_block2, resolve_fused_conv

    cfg = make_config("badnets", fused_block2="on")
    out["fused"] = (resolve_fused_conv(cfg, torch.device("cuda")), resolve_fused_block2(cfg))
    os.chdir(os.path.join(tmp, f"cwd{rank}"))
    result = badnets.main(["--synthetic", "--synthetic_per_class", "4", "--num_epochs", "2", "--batch_size", "16",
                           "--device", "cpu"])
    out["cli_history"] = result.history
    out["cli_state"] = {k: v.clone() for k, v in result.model.state_dict().items()}
    out["cli_groups"] = {m.group is not None for m in result.model.modules() if hasattr(m, "group")}
    # --resume where only rank 0's directory holds the checkpoint, as with a
    # record directory local to each node.
    try:
        badnets.main(["--synthetic", "--synthetic_per_class", "4", "--num_epochs", "1", "--batch_size", "16",
                      "--device", "cpu", "--resume"])
    except RuntimeError as e:
        out["resume_error"] = str(e)

    # (h): Ultrasonic and DABA poisoning with both ranks in one directory,
    # twice: the first run writes the trigger files, the second reads them.
    # Rank 1 starts each run late, so rank 0 would write before it looks.
    from audiobd_tpu_torch.data.speech_commands import make_synthetic_clean_data
    from audiobd_tpu_torch.poison import daba, ultrasonic

    os.environ["AUDIOBD_RESOURCES"] = os.path.join(tmp, "no_resources")
    os.chdir(os.path.join(tmp, "shared"))
    out["poisoned"] = {}
    for attack, module, extra in (("ultrasonic", ultrasonic, {}), ("daba", daba, DABA_SMALL)):
        cfg = make_config(attack, device="cpu", **extra)
        clean = make_synthetic_clean_data(cfg, n_per_class=4)
        for run in range(2):
            if rank == 1:
                time.sleep(RANK1_DELAY_S)
            res = module.poison(cfg, clean)
            out["poisoned"][attack, run] = (res.bd_train, res.trigger)

    # (i): a flag the ranks read differently raises on every rank.
    try:
        port_dist.agreed(rank == 0, "a file only rank 0 sees")
    except RuntimeError as e:
        out["disagreed"] = str(e)
    out["agreed"] = port_dist.agreed(True, "a file every rank sees")
    out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "audiobd_tpu"))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    port_dist.destroy()


def _spawn(tmp: str) -> None:
    ctx = mp.start_processes(_rank_main, args=(tmp,), nprocs=D, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {D} ranks did not finish in {SPAWN_TIMEOUT_S} s")


# ---------------------------------------------------------------------------
# The JAX side and the fixture


def _data(seed, n):
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((n, 1, 101, 40)) * 8.0).astype(np.float32)
    labels = rng.integers(0, 10, n)
    ind = (rng.random(n) < 0.4).astype(np.int64)
    labels[ind == 1] = 2  # poisoned rows carry the target label
    return feats, labels, ind


def _no_dropout(next_fun, args, kwargs, context):
    import flax.linen as nn

    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs (a flax SmallCNN's weights carried over, the data) and
    both ranks' results on them."""
    import jax

    from audiobd_tpu.models import build_model as jax_build_model
    from audiobd_tpu.models import jit_init
    from audiobd_tpu_torch.models.convert import smallcnn_from_flax

    tmp = str(tmp_path_factory.mktemp("ranks"))
    for sub in [f"cwd{r}" for r in range(D)] + ["shared", "no_resources"]:
        os.makedirs(os.path.join(tmp, sub))
    train, evals, step = _data(9, TRAIN_N), _data(11, EVAL_N), _data(13, STEP_N)
    jmodel = jax_build_model("smallcnn", 10, 3072)
    variables = jax.tree_util.tree_map(np.asarray, jit_init(jmodel, jax.random.PRNGKey(0), train[0][:1]))
    inputs = {"state": smallcnn_from_flax(variables), "train": train, "eval": evals, "step": step}
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    _spawn(tmp)
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(D)]
    return {"tmp": tmp, "inputs": inputs, "jmodel": jmodel, "variables": variables, "outs": outs}


def _jax_sharded(jmodel, variables, tx, data, batch_size, np_rng_, train: bool):
    """The reference's sharded epoch on a D-device slice of the conftest
    mesh: (per-batch losses, sums, state or None)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from audiobd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audiobd_tpu.train import scan_epoch as jax_scan
    from audiobd_tpu.train.loop import ArraySet as JaxArraySet
    from audiobd_tpu.train.state import TrainState

    mesh = jax_make_mesh(n_data=D, n_model=1, devices=jax.devices()[:D])
    dset = jax_scan.ShardedDeviceDataset(JaxArraySet(*data), mesh)
    perm, mask, _ = jax_scan.make_sharded_perm(np_rng_, dset.n, D, batch_size)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    with nn.intercept_methods(_no_dropout):
        if train:
            fn = jax_scan.make_sharded_train_epoch_fn(jmodel, tx, mesh)
            state, losses, sums = fn(state, dset.feats, dset.labels, dset.indicators, jnp.asarray(perm),
                                     jnp.asarray(mask), jax.random.PRNGKey(0))
        else:
            fn = jax_scan.make_sharded_eval_epoch_fn(jmodel, mesh)
            losses, sums = fn(state.params, state.batch_stats, dset.feats, dset.labels, dset.indicators,
                              jnp.asarray(perm), jnp.asarray(mask))
            state = None
    return np.asarray(losses), np.asarray(sums), state


# ---------------------------------------------------------------------------
# (a) the plans, (f) the launcher's helpers, (g) the config fault: no ranks


@pytest.mark.parametrize("n,d,batch", [(9, 8, 8), (20, 2, 8), (9, 2, 4), (33, 8, 16), (64, 4, 64), (101, 3, 12)])
def test_plans_match_jax(n, d, batch):
    from audiobd_tpu.parallel.distributed import host_shard as jax_host_shard
    from audiobd_tpu.train import scan_epoch as jax_scan
    from audiobd_tpu.utils.random import np_rng as jax_np_rng

    for got, ref in zip(port_scan.shard_layout(n, d), jax_scan.shard_layout(n, d)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(port_scan.pad_rows_index(n, d), jax_scan.pad_rows_index(n, d))
    arr = np.arange(n * 3).reshape(n, 3)
    np.testing.assert_array_equal(port_scan.pad_rows(arr, d), jax_scan.pad_rows(arr, d))
    for rng, jrng in ((np_rng(35, "shuffle"), jax_np_rng(35, "shuffle")), (None, None)):
        got, ref = port_scan.make_sharded_perm(rng, n, d, batch), jax_scan.make_sharded_perm(jrng, n, d, batch)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    for p in range(d):
        assert port_dist.host_shard(n, p, d) == port_dist.HostShard(*tuple(vars(jax_host_shard(n, p, d)).values()))
        np.testing.assert_array_equal(port_dist.host_shard(n, p, d).indices(), jax_host_shard(n, p, d).indices())


def test_launcher_helpers_without_a_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert port_dist.maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert (port_dist.rank(), port_dist.world_size(), port_dist.is_main()) == (0, 1, True)
    assert port_dist.host_shard(10) == port_dist.HostShard(0, 10)
    mesh = make_mesh()
    assert (mesh.shape, mesh.data_index, mesh.data_group) == ({"data": 1, "model": 1}, 0, None)
    for n_data, n_model in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="a world of 1 ranks"):
            make_mesh(n_data, n_model)
    two_shards = Mesh(np.arange(2).reshape(2, 1), 1, None)
    np.testing.assert_array_equal(shard_batch(two_shards, np.arange(6)), [3, 4, 5])
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(two_shards, np.arange(3))


def test_resolve_device_under_a_group(monkeypatch):
    from audiobd_tpu_torch.utils import device as device_mod

    monkeypatch.setattr(device_mod, "live", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert device_mod.resolve_device(None) == torch.device("cuda", 1)
    assert device_mod.resolve_device("cuda") == torch.device("cuda", 1)
    assert device_mod.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert device_mod.resolve_device("cpu") == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device(None)


@pytest.mark.parametrize("yaml_text,overrides", [
    ("mesh:\n  data: 2\n", {}),
    ("mesh:\n  data: 2\n  model: 2\n", {}),
    ("train:\n  batch_size: 64\n", {"data": 4}),
    (None, {"data": 2}),
])
def test_mesh_config_loads_as_in_jax(tmp_path, yaml_text, overrides):
    """The reference resolves a key against AttackConfig first: ``model``
    names the architecture, so ``mesh: {model: 2}`` sets cfg.model to 2 in
    both packages and MeshConfig.model only changes from code."""
    from audiobd_tpu.configs import config_from_yaml as jax_from_yaml
    from audiobd_tpu.configs import make_config as jax_make_config
    from audiobd_tpu_torch.configs import config_from_yaml

    if yaml_text is None:
        cfg, ref = make_config("badnets", **overrides), jax_make_config("badnets", **overrides)
    else:
        path = tmp_path / "cfg.yaml"
        path.write_text(yaml_text)
        cfg = config_from_yaml(str(path), attack="badnets", **overrides)
        ref = jax_from_yaml(str(path), attack="badnets", **overrides)
    assert (cfg.mesh.data, cfg.mesh.model) == (ref.mesh.data, ref.mesh.model)
    assert cfg.model == ref.model and cfg.train.batch_size == ref.train.batch_size


# ---------------------------------------------------------------------------
# The reference's gradient scale


def test_reference_sharded_gradient_is_d_times_the_global_one():
    """One sharded step of audiobd_tpu with optax.sgd(1.0) moves each
    parameter by D times the single-device step on the same global batch
    (a conv-BN-dense net; dropout is no factor)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax

    from audiobd_tpu.models.layers import TorchBatchNorm, TorchConv, TorchDense, nchw_to_nhwc
    from audiobd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audiobd_tpu.train import scan_epoch as jax_scan
    from audiobd_tpu.train.loop import ArraySet as JaxArraySet
    from audiobd_tpu.train.state import TrainState

    class Net(nn.Module):
        bn_axis: str | None = None

        @nn.compact
        def __call__(self, x, train: bool = False):
            x = nn.relu(TorchConv(4, (2, 2))(nchw_to_nhwc(x)))
            x = TorchBatchNorm(axis_name=self.bn_axis)(x, train)
            return TorchDense(10)(x.reshape(x.shape[0], -1))

    n = 8
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, 1, 5, 4)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    ind = np.zeros(n, np.int32)
    model, tx = Net(), optax.sgd(1.0)
    state = TrainState.create(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 5, 4))), tx)
    s1, _, _ = jax_scan.make_train_epoch_fn(model, tx, donate=False)(
        state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(ind), jnp.arange(n, dtype=jnp.int32)[None],
        jnp.ones((1, n), bool), jax.random.PRNGKey(1))
    mesh = jax_make_mesh(n_data=D, n_model=1, devices=jax.devices()[:D])
    dset = jax_scan.ShardedDeviceDataset(JaxArraySet(x, y, ind), mesh)
    perm, mask, _ = jax_scan.make_sharded_perm(None, n, D, n)
    sD, _, _ = jax_scan.make_sharded_train_epoch_fn(model, tx, mesh)(
        state, dset.feats, dset.labels, dset.indicators, jnp.asarray(perm), jnp.asarray(mask), jax.random.PRNGKey(1))
    for p0, p1, pD in zip(*(jax.tree_util.tree_leaves(s.params) for s in (state, s1, sD))):
        step1, stepD = np.asarray(p1) - np.asarray(p0), np.asarray(pD) - np.asarray(p0)
        assert _rel(stepD, D * step1) < 1e-4


# ---------------------------------------------------------------------------
# Two ranks against the reference and against one process


def test_ranks_meet_as_a_mesh(ranks):
    for r, out in enumerate(ranks["outs"]):
        assert out["jax_loaded"] == []
        assert (out["rank"], out["world"]) == (r, D)
        assert out["mesh"] == ({"data": D, "model": 1}, r)
        np.testing.assert_array_equal(out["step_rows"], np.arange(STEP_N).reshape(D, -1)[r])


def test_sharded_eval_matches_jax_with_ragged_shards(ranks):
    import optax

    losses, sums, _ = _jax_sharded(ranks["jmodel"], ranks["variables"], optax.adam(LR), ranks["inputs"]["eval"],
                                   EVAL_BATCH, None, train=False)
    assert int(sums[1]) == EVAL_N
    for out in ranks["outs"]:
        got_losses, got_sums = out["eval_batches"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        np.testing.assert_array_equal(got_sums, sums)
        np.testing.assert_array_equal(out["eval"]["sums"], sums)
        np.testing.assert_allclose(out["eval"]["loss"], float(losses.mean()), rtol=1e-5)


def test_sharded_train_epoch_matches_jax(ranks):
    import jax
    import optax

    from audiobd_tpu.utils.random import np_rng as jax_np_rng
    from audiobd_tpu_torch.models.convert import smallcnn_from_flax

    tx = optax.chain(optax.scale(1.0 / D), optax.adam(LR))  # the reference's D x gradient, undone
    losses, sums, state = _jax_sharded(ranks["jmodel"], ranks["variables"], tx, ranks["inputs"]["train"],
                                       TRAIN_BATCH, jax_np_rng(35, "shuffle"), train=True)
    final = smallcnn_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    out0, out1 = ranks["outs"]
    for out in (out0, out1):
        got_losses, got_sums = out["train_batches"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        np.testing.assert_allclose(out["train"]["loss"], float(losses.mean()), rtol=1e-5)
        np.testing.assert_array_equal(got_sums, sums)
        assert out["train"]["mix_acc"] == 100.0 * sums[0] / sums[1]
        assert out["train"]["asr"] == 100.0 * sums[2] / max(sums[3], 1)
        for name, value in out["epoch_state"].items():
            if "running" in name:
                assert _rel(value.numpy(), final[name].numpy()) < 1e-4, name
            else:
                assert np.max(np.abs(value.numpy() - final[name].numpy())) <= 0.25 * LR, name
    for name, value in out0["epoch_state"].items():
        assert torch.equal(value, out1["epoch_state"][name]), name


def test_two_rank_step_is_the_single_process_step(ranks):
    """As tests/test_sharded_scan.py::test_one_step_matches_single_device
    holds the reference: the same global batch, one rank or two."""
    x, y, ind = ranks["inputs"]["step"]
    model = _port_model(ranks["inputs"]["state"])
    opt = Adam(model.parameters(), LR)
    grads = []
    _record_grads(opt, grads)
    single = port_scan.run_train_epoch(model, opt, port_scan.DeviceDataset(ArraySet(x, y, ind), CPU), STEP_N, None)
    ref = dict(model.state_dict())
    model_ref = _port_model(ranks["inputs"]["state"]).train()
    loss_ref = masked_mean(cross_entropy(model_ref(torch.from_numpy(x)), torch.from_numpy(y).long()),
                           torch.ones(STEP_N, dtype=torch.bool))
    names = [n for n, _ in model_ref.named_parameters()]
    out0, out1 = ranks["outs"]
    for out in (out0, out1):
        np.testing.assert_allclose(out["step"]["loss"], single["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["step"]["loss"], loss_ref.item(), rtol=1e-5)
        assert (out["step"]["mix_acc"], out["step"]["asr"]) == (single["mix_acc"], single["asr"])
        for name, g, g_ref in zip(names, out["step_grads"], grads[0]):
            assert _rel(g.numpy(), g_ref.numpy()) < 1e-4, name
        for name, value in out["step_state"].items():
            if "running" in name:
                assert _rel(value.numpy(), ref[name].numpy()) < 1e-4, name
            else:
                assert np.max(np.abs(value.numpy() - ref[name].numpy())) <= 0.25 * LR, name
    for name, value in out0["step_state"].items():
        assert torch.equal(value, out1["step_state"][name]), name


def test_train_attack_under_two_ranks(ranks):
    """The BadNets CLI on 2 CPU ranks: identical histories and final
    weights, sync-BN on, the fused blocks off; rank 0 alone wrote (each rank
    ran in a directory of its own)."""
    out0, out1 = ranks["outs"]
    assert out0["cli_history"] == out1["cli_history"]
    assert len(out0["cli_history"]["train_loss"]) == 2
    assert all(np.isfinite(v) for v in out0["cli_history"]["train_loss"])
    for name, value in out0["cli_state"].items():
        assert torch.equal(value, out1["cli_state"][name]), name
    assert out0["cli_groups"] == out1["cli_groups"] == {True}
    assert out0["fused"] == out1["fused"] == (False, False)
    cwd0, cwd1 = (os.path.join(ranks["tmp"], f"cwd{r}") for r in range(D))
    record = os.path.join(cwd0, "record", "badnets_smallcnn")
    for name in ("loss_result.csv", "acc_result.csv", "torch_checkpoint/model.pt", "torch_checkpoint/train_state.pt",
                 "SCDv1-10/bd/bd_train_mfcc.npy", "SCDv1-10/clean/clean_train_mfcc.npy"):
        assert os.path.exists(os.path.join(record, name)), name
    with open(os.path.join(record, "loss_result.csv")) as f:
        assert len(f.read().strip().splitlines()) == 3
    assert os.listdir(cwd1) == []


def test_poisoning_in_one_directory_gives_every_rank_the_same_rows(ranks):
    """Ultrasonic and DABA with both ranks in one record directory: every
    rank poisons the same rows with the same trigger, on the run that writes
    the trigger files (a full-precision trigger) and on the run that reads
    them back (PCM16)."""
    out0, out1 = ranks["outs"]
    assert set(out0["poisoned"]) == {(a, run) for a in ("ultrasonic", "daba") for run in range(2)}
    for key, (bd0, trig0) in out0["poisoned"].items():
        bd1, trig1 = out1["poisoned"][key]
        np.testing.assert_array_equal(trig0, trig1, err_msg=str(key))
        for name in ("feats", "labels", "indicators"):
            a, b = getattr(bd0, name), getattr(bd1, name)
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), (key, name)
        pcm = np.asarray(trig0, np.float64) * 32768.0
        assert np.array_equal(pcm, np.round(pcm)) == (key[1] == 1), key
    shared = os.path.join(ranks["tmp"], "shared", "record")
    assert os.path.exists(os.path.join(shared, "ultrasonic_smallcnn", "resources", "Ultrasonic", "trigger.wav"))
    assert len(os.listdir(os.path.join(shared, "daba_smallcnn", "resources", "DABA", "trigger_pool"))) == 60


def test_ranks_that_read_a_shared_file_differently_raise(ranks):
    """A fact of the shared files that the ranks read differently raises on
    every rank: ``agreed`` itself, and --resume where only rank 0's record
    directory holds a checkpoint."""
    checkpoint = os.path.join("record", "badnets_smallcnn", "torch_checkpoint")
    for out in ranks["outs"]:
        assert out["disagreed"] == f"1 of {D} ranks see a file only rank 0 sees: the ranks must share it"
        assert out["agreed"] is True
        assert out["resume_error"] == f"1 of {D} ranks see {checkpoint}: the ranks must share it"
