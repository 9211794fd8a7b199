"""Tensor parallelism in the port (parallel/mesh.py::shard_params_tp, the
column-parallel routes of parallel/tp.py) against the JAX package's
``shard_params_tp`` and its dp × tp train step, on the CPU.

(a) and (f) need no ranks: a ``Mesh`` of 1 × n with this process as rank
(0, m) and no group lays the shards out, and each rank m's shard is held
bit-equal to JAX device (0, m)'s ``addressable_shards`` data, for every
model, at n_model 2 and 3 and min_features 128 and 8.

(b)-(e) run in gloo ranks, started once a mesh (1 × 2: 2 ranks; 2 × 2: 4
ranks) by torch.multiprocessing's spawn, meeting at a ``file://`` path, as
tests/test_torch_port_parallel.py starts its two. A rank imports this
module to find its target, so JAX is imported inside the tests and the
fixture only. Inputs are written by the fixture, results read back.

The models' widths are fixed, so the step runs on a few frames and a batch
of 8, at min_features 8 on both sides, which shards nearly every conv,
dense and LSTM kernel (SmallCNN's convs and its 10-class head too).
Weights are drawn with numpy (U(±1/√fan_in), BatchNorm at its init) in the
flax tree's shapes and carried to the port by models/convert.py. Dropout is
off on both sides (flax's Dropout intercepted, the port's rates 0), but for
the 1 × 2 epoch of (c), where the row's ranks draw the one-process masks.

Tolerances (tests/test_torch_port_parallel.py's): logits and losses 1e-5
relative (logits to their largest entry); gradients and running statistics
1e-4 relative to each tensor's largest entry; parameters after one Adam
step within 0.25 lr; metric sums exact; the ranks of a row bit-equal in
every replicated tensor, and a grid column's in every tensor. Against JAX's
step the gradients are read from Adam's first moment (one step from zero:
mu = 0.1·g). The epoch: loss within 1e-4 and mix_acc, asr equal, as
tests/test_parallel.py::test_tp_training_matches_single_device_metrics
holds JAX's. Against JAX's step each tensor is held within the
one-process step's own distance from it plus those tolerances (see
``test_tp_step_matches_jax_tp_step``). bf16 (d): logits and loss within
1e-2 (of the logits' largest entry, of the loss), gradients within 2e-2 of
each tensor's largest entry, against the port's one-process bf16 step (a
sharded layer's input gradient is the sum of the ranks' bf16 partial
products: one bf16 rounding more; measured up to 1.3e-2, logits and loss
equal).
"""

import copy
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn as nn

from audiobd_tpu_torch.models import RNN, LargeCNN, LSTMWithAttention, SmallCNN, SmallLSTM, build_model
from audiobd_tpu_torch.parallel import distributed as port_dist
from audiobd_tpu_torch.parallel import tp as port_tp
from audiobd_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch, shard_params_tp, unshard_params_tp
from audiobd_tpu_torch.train import scan_epoch as port_scan
from audiobd_tpu_torch.train.loop import ArraySet, cross_entropy, masked_mean, metric_sums
from audiobd_tpu_torch.train.state import Adam
from audiobd_tpu_torch.utils.random import np_rng, torch_generator

CPU = torch.device("cpu")
LR = 1e-4
MIN = 8          # min_features of the steps: the models' widths are fixed
STEP_N = 8       # one global batch; 4 rows a data shard on 2 x 2
N_MODEL = 2
SPAWN_TIMEOUT_S = 240
# name: (input (C, H, W), feature size, the port's model without dropout)
STEP_MODELS = {
    "smallcnn": ((1, 32, 13), 224, lambda: SmallCNN(10, 224, dropout_rates=(0.0, 0.0))),
    "largecnn": ((1, 16, 16), 256, lambda: LargeCNN(10, 256, dropout_rate=0.0)),
    "smalllstm": ((1, 32, 13), 32, lambda: SmallLSTM(10, 32, dropout_rate=0.0)),
    "rnn": ((1, 6, 13), 0, lambda: RNN(10, 13)),
    "lstmwithattention": ((1, 8, 13), 8, lambda: LSTMWithAttention(10, 13, 8, dropout_rate=0.0)),
}
EPOCH_N, EPOCH_BATCH, EPOCH_LR = 64, 32, 1e-3  # tests/test_parallel.py's toy problem


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _step_data(name, seed=13):
    shape = STEP_MODELS[name][0]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((STEP_N, *shape)) * 4.0).astype(np.float32)
    y = rng.integers(0, 10, STEP_N)
    ind = (rng.random(STEP_N) < 0.4).astype(np.int64)
    y[ind == 1] = 2
    return x, y, ind


def _epoch_data():
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((EPOCH_N, 1, 32, 13)).astype(np.float32)
    labels = rng.integers(0, 10, EPOCH_N).astype(np.int64)
    ind = np.zeros(EPOCH_N, np.int64)
    ind[::5] = 1
    labels[ind == 1] = 2
    return feats, labels, ind


class _Recorded:
    """The gradients each ``opt.step`` takes and the logits of each forward."""

    def __init__(self, model, opt):
        self.grads, self.logits = [], []
        step = opt.step

        def recording(grads):
            self.grads.append([g.detach().clone() for g in grads])
            return step(grads)

        opt.step = recording
        model.register_forward_hook(lambda _m, _a, out: self.logits.append(out.detach().clone()))


def _one_step(model, opt, x, y, ind, rows=None, mask=None):
    """One process's step on the rows ``rows`` of (x, y, ind) (all of them
    by default): the body of run_train_epoch, on a given batch."""
    idx = torch.from_numpy(np.arange(len(y)) if rows is None else rows)
    bmask = torch.ones(len(idx), dtype=torch.bool) if mask is None else torch.from_numpy(mask)
    xs, labels = torch.from_numpy(x)[idx], torch.from_numpy(y).long()[idx]
    model.train()
    logits = model(xs)
    loss = masked_mean(cross_entropy(logits, labels), bmask)
    opt.step(torch.autograd.grad(loss, opt.params))
    return loss.item(), metric_sums(logits.detach(), labels, torch.from_numpy(ind).long()[idx], bmask)


# ---------------------------------------------------------------------------
# What each rank runs


def _rank_main(rank: int, tmp: str, world: int) -> None:
    torch.set_num_threads(1)
    assert port_dist.maybe_initialize_distributed(f"file://{tmp}/rendezvous{world}", world, rank)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh(world // N_MODEL, N_MODEL)
    n_data = mesh.shape["data"]
    out = {"mesh": (mesh.shape, mesh.data_index, mesh.model_index),
           "row": torch.distributed.get_process_group_ranks(mesh.model_group),
           "column": torch.distributed.get_process_group_ranks(mesh.data_group)}
    rows = shard_batch(mesh, np.arange(STEP_N))
    out["rows"] = rows
    for dtype in (torch.float32, torch.bfloat16):
        for name, (_, _, make) in STEP_MODELS.items():
            if dtype == torch.bfloat16 and (name != "largecnn" or n_data > 1):
                continue
            model = make()
            model.compute_dtype = dtype
            model.load_state_dict(inputs["state"][name])
            if n_data > 1:
                model.sync_batchnorm(mesh.data_group)
            opt = Adam(model.parameters(), LR)
            shard_params_tp(mesh, model, opt, min_features=MIN)
            rec = _Recorded(model, opt)
            x, y, ind = inputs["step"][name]
            counts = dict(port_tp.COUNTS)
            step = port_scan.run_train_epoch_sharded(
                model, opt, port_scan.ShardedDeviceDataset(ArraySet(x, y, ind), mesh, CPU), STEP_N, None)
            res = {"step": step, "logits": rec.logits[0], "grads": rec.grads[0],
                   "collectives": {k: port_tp.COUNTS[k] - counts[k] for k in counts},
                   "sharded": {k: (s.n, s.index, s.full) for k, s in model.tp_sharded.items()},
                   "local": {k: v.clone() for k, v in model.state_dict().items()},
                   "mu": [m.clone() for m in opt.mu], "nu": [v.clone() for v in opt.nu], "count": opt.count,
                   "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
            res["full"] = unshard_params_tp(mesh, model)
            if dtype == torch.float32:
                # (e) the gathered weights in a model build_model makes.
                model.eval()
                with torch.no_grad():
                    res["eval_logits"] = model(torch.from_numpy(x))
                shape, feature, _ = STEP_MODELS[name]
                fresh = build_model(name, 10, feature or 224, CPU, 0, n_mfcc=shape[-1])
                fresh.load_state_dict(res["full"])
                fresh.eval()
                with torch.no_grad():
                    res["fresh_logits"] = fresh(torch.from_numpy(x))
                res["fresh_state"] = {k: v.clone() for k, v in fresh.state_dict().items()}
            out[name, str(dtype)] = res

    # The fused blocks step aside for a sharded conv (min_features 8 shards
    # SmallCNN's three).
    model = SmallCNN(10, 224, fused_block1=True, fused_block2=True, fused_block3=True, dropout_rates=(0.0, 0.0))
    model.load_state_dict(inputs["state"]["smallcnn"])
    if n_data > 1:
        model.sync_batchnorm(mesh.data_group)
    opt = Adam(model.parameters(), LR)
    shard_params_tp(mesh, model, opt, min_features=MIN)
    rec = _Recorded(model, opt)
    step = port_scan.run_train_epoch_sharded(
        model, opt, port_scan.ShardedDeviceDataset(ArraySet(*inputs["step"]["smallcnn"]), mesh, CPU), STEP_N, None)
    out["smallcnn_fused"] = {"step": step, "logits": rec.logits[0], "grads": rec.grads[0],
                             "sharded": {k: (s.n, s.index, s.full) for k, s in model.tp_sharded.items()}}

    # (c) one epoch of the toy problem; dropout on where the row is the
    # whole batch (1 x 2), the masks drawn after the gather from the stream
    # one process draws.
    model = SmallCNN(10, 224, dropout_rates=(0.4, 0.5) if n_data == 1 else (0.0, 0.0))
    model.load_state_dict(inputs["epoch_state"])
    model.dropout_generator = torch_generator(35, "dropout")
    if n_data > 1:
        model.sync_batchnorm(mesh.data_group)
    opt = Adam(model.parameters(), EPOCH_LR)
    shard_params_tp(mesh, model, opt, min_features=MIN)
    out["epoch"] = port_scan.run_train_epoch_sharded(
        model, opt, port_scan.ShardedDeviceDataset(ArraySet(*inputs["epoch"]), mesh, CPU), EPOCH_BATCH,
        np_rng(35, "shuffle"))
    out["epoch_local"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["epoch_sharded"] = set(model.tp_sharded)

    # The faults: a block of the wrong size, and a layer with no live group.
    shard = model.fc1.tp_shard
    try:
        port_tp.gather(torch.zeros(2, shard.full // shard.n + 1), -1, shard)
    except ValueError as e:
        out["bad_block"] = str(e)
    orphan = nn.Linear(224, shard.full // shard.n)
    orphan.tp_shard = port_tp.TPShard(None, shard.n, shard.index, shard.full)
    try:
        port_tp.linear(orphan, orphan.tp_shard, torch.zeros(2, 224), torch.float32)
    except RuntimeError as e:
        out["no_group"] = str(e)
    torch.save(out, os.path.join(tmp, f"rank{rank}_of_{world}.pt"))
    port_dist.destroy()


def _spawn(tmp: str, world: int) -> None:
    ctx = mp.start_processes(_rank_main, args=(tmp, world), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} ranks did not finish in {SPAWN_TIMEOUT_S} s")


# ---------------------------------------------------------------------------
# The JAX side


def _jax_model(name, feature):
    from audiobd_tpu.models import build_model as jax_build_model

    return jax_build_model(name, 10, feature, n_mfcc=13 if name in ("rnn", "lstmwithattention") else None)


def _jax_variables(jmodel, shape, seed):
    """numpy weights in the flax tree's shapes: U(±1/√fan_in) for kernels,
    U(±1/8) for biases, BatchNorm at its init."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *shape)), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [getattr(k, "key", "") for k in path]
        if keys[-1] in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        if keys[-1] == "mean" or (keys[-1] == "bias" and "BatchNorm_0" in keys):
            return np.zeros(s.shape, np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 0.125
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _no_dropout(next_fun, args, kwargs, context):
    import flax.linen as nn_

    if isinstance(context.module, nn_.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _shard_tree(tree, device):
    """Each leaf's data on ``device`` (its block where the leaf is sharded)."""
    import jax

    return jax.tree_util.tree_map(
        lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == device)), tree)


def _flags(tree):
    """1 where a leaf is sharded over 'model', else 0, in the leaf's shape."""
    import jax

    return jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float("model" in tuple(a.sharding.spec)), np.float32), tree)


def _jax_tp_step(name, variables, data, mesh_shape):
    """JAX's make_train_step on shard_params_tp state (min_features 8),
    dropout off: (loss, metric sums, the new variables and optax state as
    numpy trees)."""
    import flax.linen as nn_
    import jax
    import optax

    from audiobd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audiobd_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from audiobd_tpu.parallel.mesh import shard_params_tp as jax_shard_params_tp
    from audiobd_tpu.train.loop import make_train_step
    from audiobd_tpu.train.state import TrainState

    n_data, n_model = mesh_shape
    mesh = jax_make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[: n_data * n_model])
    jmodel = _jax_model(name, STEP_MODELS[name][1])
    tx = optax.adam(LR)
    state = TrainState.create(jax.tree_util.tree_map(np.array, variables), tx)
    state = TrainState(params=jax_shard_params_tp(mesh, state.params, MIN),
                       batch_stats=jax_shard_params_tp(mesh, state.batch_stats, MIN),
                       opt_state=jax_shard_params_tp(mesh, state.opt_state, MIN), step=state.step)
    x, y, ind = data
    batch = jax_shard_batch(mesh, {"x": x, "y": y.astype(np.int32), "indicator": ind.astype(np.int32),
                                   "mask": np.ones(STEP_N, bool)})
    with nn_.intercept_methods(_no_dropout):
        new, metrics = make_train_step(jmodel, tx)(state, batch, jax.random.PRNGKey(1))
    sums = [int(metrics[k]) for k in ("correct", "total", "asr_correct", "poison_total")]
    return (float(metrics["loss_batchmean"]), sums,
            jax.tree_util.tree_map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats}),
            jax.tree_util.tree_map(np.asarray, new.opt_state))


# ---------------------------------------------------------------------------
# The fixture: the inputs, the one-process steps, both meshes' ranks


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    from audiobd_tpu_torch.models.convert import FROM_FLAX

    tmp = str(tmp_path_factory.mktemp("tp_ranks"))
    variables, state, step = {}, {}, {}
    for i, (name, (shape, feature, _)) in enumerate(STEP_MODELS.items()):
        variables[name] = _jax_variables(_jax_model(name, feature), shape, seed=100 + i)
        state[name] = FROM_FLAX[name](variables[name])
        step[name] = _step_data(name)
    epoch_vars = _jax_variables(_jax_model("smallcnn", 224), (1, 32, 13), seed=99)
    inputs = {"state": state, "step": step, "epoch": _epoch_data(), "epoch_state": FROM_FLAX["smallcnn"](epoch_vars)}
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    outs = {}
    for world in (2, 4):
        _spawn(tmp, world)
        outs[world] = [torch.load(os.path.join(tmp, f"rank{r}_of_{world}.pt"), weights_only=False)
                       for r in range(world)]
    # One process's steps on the same weights and batches.
    single = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (_, _, make) in STEP_MODELS.items():
            if dtype == torch.bfloat16 and name != "largecnn":
                continue
            model = make()
            model.compute_dtype = dtype
            model.load_state_dict(state[name])
            opt = Adam(model.parameters(), LR)
            rec = _Recorded(model, opt)
            loss, sums = _one_step(model, opt, *step[name])
            single[name, str(dtype)] = {"loss": loss, "sums": sums.numpy(), "logits": rec.logits[0],
                                        "grads": rec.grads[0], "state": dict(model.state_dict()),
                                        "names": [n for n, _ in model.named_parameters()]}
    return {"inputs": inputs, "variables": variables, "outs": outs, "single": single}


def _block(full: torch.Tensor, sharded: dict, name: str, rank_out: dict) -> torch.Tensor:
    """``full``'s block that ``rank_out``'s rank holds of parameter ``name``."""
    if name not in sharded:
        return full
    n, index, size = sharded[name]
    return full[index * size // n:(index + 1) * size // n]


# ---------------------------------------------------------------------------
# (a) the layout, against JAX's, no ranks

LAYOUT_MODELS = {  # name: (attack, model, input)
    "smallcnn": ("badnets", "smallcnn", (1, 101, 40)),
    "largecnn": ("badnets", "largecnn", (1, 101, 40)),
    "smalllstm": ("badnets", "smalllstm", (1, 101, 40)),
    "rnn": ("badnets", "rnn", (1, 101, 40)),
    "lstmwithattention": ("badnets", "lstmwithattention", (1, 101, 40)),
    "resnet": ("badnets", "resnet", (1, 101, 40)),
    "smallcnn_flowmur": ("flowmur", "smallcnn", (1, 32, 13)),
    "smallcnn_daba": ("daba", "smallcnn", (1, 32, 40)),
}
# What the rule selects at n_model 2, min_features 128 (the JAX package's
# selection, in the port's names).
SELECTED_AT_128 = {
    "smallcnn": {"fc1.weight"}, "smallcnn_flowmur": {"fc1.weight"}, "smallcnn_daba": {"fc1.weight"},
    "largecnn": {f"convs.{i}.weight" for i in range(1, 5)} | {"fc1.weight", "fc2.weight"},
    "smalllstm": {f"lstm.weight_{w}_l{k}" for w in ("ih", "hh") for k in range(2)},
    "rnn": {f"lstm.weight_{w}_l{k}" for w in ("ih", "hh") for k in range(3)},
    "lstmwithattention": {f"{m}.weight_{w}_l0{r}" for m in ("rnn1", "rnn2") for w in ("ih", "hh")
                          for r in ("", "_reverse")} | {"attention.weight", "dense1.weight"},
    "resnet": set(),
}
_LAYOUT_CACHE: dict = {}


def _layout_case(key):
    """(flax variables, the port's model carrying them) for a LAYOUT_MODELS
    entry, made once."""
    if key not in _LAYOUT_CACHE:
        from audiobd_tpu.configs import make_config as jax_make_config
        from audiobd_tpu.train.trainer import build_attack_model as jax_build_attack_model
        from audiobd_tpu_torch.configs import make_config
        from audiobd_tpu_torch.models.convert import FROM_FLAX
        from audiobd_tpu_torch.train.trainer import build_attack_model

        attack, model, shape = LAYOUT_MODELS[key]
        variables = _jax_variables(jax_build_attack_model(jax_make_config(attack, model=model)), shape, seed=3)
        port = build_attack_model(make_config(attack, model=model), CPU)
        port.load_state_dict(FROM_FLAX[model](variables))
        _LAYOUT_CACHE[key] = (variables, port)
    return _LAYOUT_CACHE[key]


def _fake_mesh(n_model: int, m: int) -> Mesh:
    """This process as rank (0, m) of a 1 x n_model mesh, without a group."""
    return Mesh(np.arange(n_model).reshape(1, n_model), 0, None, m, None)


@pytest.mark.parametrize("min_features", [128, 8])
@pytest.mark.parametrize("n_model", [2, 3])
@pytest.mark.parametrize("key", sorted(LAYOUT_MODELS))
def test_layout_matches_jax_shard_for_shard(key, n_model, min_features):
    import jax

    from audiobd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audiobd_tpu.parallel.mesh import shard_params_tp as jax_shard_params_tp
    from audiobd_tpu_torch.models.convert import FROM_FLAX

    variables, port = _layout_case(key)
    carry = FROM_FLAX[LAYOUT_MODELS[key][1]]
    mesh = jax_make_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
    placed = {"params": jax_shard_params_tp(mesh, variables["params"], min_features),
              "batch_stats": jax_shard_params_tp(mesh, variables.get("batch_stats", {}), min_features)}
    flags = carry(_flags(placed))
    selected = {k for k, v in flags.items() if bool(v.any())}
    if (n_model, min_features) == (2, 128):
        assert selected == SELECTED_AT_128[key]
    for m in range(n_model):
        model = copy.deepcopy(port)
        shard_params_tp(_fake_mesh(n_model, m), model, min_features=min_features)
        assert set(getattr(model, "tp_sharded", {})) == selected
        expect = carry(_shard_tree(placed, mesh.devices[0, m]))
        got = model.state_dict()
        assert set(got) == set(expect)
        for name, value in got.items():
            assert torch.equal(value, expect[name]), (name, m)
        if selected:
            assert all(model.get_submodule(k.rsplit(".", 1)[0]).tp_shard.index == m for k in selected)


def test_shard_params_tp_splits_large_kernels():
    """The port's mirror of tests/test_parallel.py's toy tree: a 64 → 256
    dense kernel is sharded, a 8 → 10 one and every bias replicated."""

    class Toy(nn.Module):
        def __init__(self):
            super().__init__()
            self.big = nn.Linear(64, 256)
            self.small = nn.Linear(8, 10)

    for m in range(2):
        toy = Toy()
        whole = {k: v.clone() for k, v in toy.state_dict().items()}
        shard_params_tp(_fake_mesh(2, m), toy)
        assert set(toy.tp_sharded) == {"big.weight"}
        assert toy.big.weight.shape == (128, 64) and torch.equal(toy.big.weight, whole["big.weight"][m * 128:(m + 1) * 128])
        for k in ("big.bias", "small.weight", "small.bias"):
            assert torch.equal(toy.state_dict()[k], whole[k]), k
        assert port_tp.shard_of(toy.small) is None and port_tp.shard_of(toy.big).full == 256
    one = Toy()
    assert shard_params_tp(_fake_mesh(1, 0), one) is one and port_tp.shard_of(one.big) is None


def test_sharded_layer_without_a_group_raises():
    model = SmallCNN(10, 224, dropout_rates=(0.0, 0.0))
    shard_params_tp(_fake_mesh(2, 1), model)
    with pytest.raises(RuntimeError, match="without the mesh's live row group"):
        model(torch.zeros(2, 1, 32, 13))
    with pytest.raises(RuntimeError, match="live row group"):
        unshard_params_tp(_fake_mesh(2, 1), model)
    with pytest.raises(ValueError, match="sharded already"):
        shard_params_tp(_fake_mesh(2, 1), model)


# ---------------------------------------------------------------------------
# (f) carried optax moments shard as JAX's


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("key", ["smallcnn_flowmur", "largecnn", "rnn", "lstmwithattention"])
def test_carried_moments_shard_as_jax(key, optimizer):
    import jax
    import optax

    from audiobd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from audiobd_tpu.parallel.mesh import shard_params_tp as jax_shard_params_tp
    from audiobd_tpu_torch.models.convert import opt_state_from_flax
    from audiobd_tpu_torch.train.state import SGD

    variables, port = _layout_case(key)
    model_name = LAYOUT_MODELS[key][1]
    tx = optax.adam(LR) if optimizer == "adam" else optax.sgd(LR, momentum=0.9)
    params = variables["params"]
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    _, opt_state = tx.update(grads, tx.init(params), params)  # moments that are not zero
    mesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    placed = jax_shard_params_tp(mesh, opt_state, MIN)
    names = [n for n, _ in port.named_parameters()]
    moments = ("mu", "nu") if optimizer == "adam" else ("trace",)
    for m in range(2):
        model = copy.deepcopy(port)
        opt = Adam(model.parameters(), LR) if optimizer == "adam" else SGD(model.parameters(), LR)
        opt.load_state_dict(opt_state_from_flax(model_name, jax.tree_util.tree_map(np.asarray, opt_state), names))
        shard_params_tp(_fake_mesh(2, m), model, opt, min_features=MIN)
        expect = opt_state_from_flax(model_name, _shard_tree(placed, mesh.devices[0, m]), names)
        for k in moments:
            for name, got, want, p in zip(names, getattr(opt, k), expect[k], opt.params):
                assert got.shape == p.shape and torch.equal(got, want), (k, name, m)
        if optimizer == "adam":
            assert opt.count == expect["count"] == 1


# ---------------------------------------------------------------------------
# (b)-(e): the ranks


def test_ranks_form_the_grid(tp_runs):
    for world, outs in tp_runs["outs"].items():
        for r, out in enumerate(outs):
            d, m = divmod(r, N_MODEL)
            assert out["mesh"] == ({"data": world // N_MODEL, "model": N_MODEL}, d, m)
            assert out["row"] == [d * N_MODEL + k for k in range(N_MODEL)]
            assert out["column"] == list(range(m, world, N_MODEL))
            np.testing.assert_array_equal(out["rows"], np.arange(STEP_N).reshape(world // N_MODEL, -1)[d])
            assert out["bad_block"].startswith("a block of 65 along dim -1 for 128 features over 2 ranks")
            assert "without the mesh's live row group" in out["no_group"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(STEP_MODELS))
def test_tp_step_matches_one_process(tp_runs, name, world):
    """The 1 x 2 and 2 x 2 steps against one process's on the same global
    batch; the ranks of a row bit-equal in what they replicate, a column's in
    everything; a rank keeps only its blocks of the sharded tensors and
    their moments."""
    ref = tp_runs["single"][name, str(torch.float32)]
    outs = [out[name, str(torch.float32)] for out in tp_runs["outs"][world]]
    names = ref["names"]
    for r, res in enumerate(tp_runs["outs"][world]):
        out = outs[r]
        rows = res["rows"]
        assert _rel(out["logits"].numpy(), ref["logits"][rows].numpy()) < 1e-5
        np.testing.assert_allclose(out["step"]["loss"], ref["loss"], rtol=1e-5)
        assert out["step"]["mix_acc"] == 100.0 * ref["sums"][0] / ref["sums"][1]
        assert out["step"]["asr"] == 100.0 * ref["sums"][2] / max(ref["sums"][3], 1)
        sharded = out["sharded"]
        assert sharded and all(n == N_MODEL for n, _, _ in sharded.values())
        for n, g, g_ref in zip(names, out["grads"], ref["grads"]):
            assert _rel(g.numpy(), _block(g_ref, sharded, n, out).numpy()) < 1e-4, n
        for k, value in out["full"].items():
            if "running" in k:
                assert _rel(value.numpy(), ref["state"][k].numpy()) < 1e-4, k
            else:
                assert np.max(np.abs(value.numpy() - ref["state"][k].numpy())) <= 0.25 * LR, k
        for k, value in out["local"].items():
            assert torch.equal(value, _block(out["full"][k], sharded, k, out)), k
        for mom in ("mu", "nu"):
            assert [t.shape for t in out[mom]] == [out["local"][n].shape for n in names]
        whole = sum(ref["state"][n].numel() for n in names) * 4
        cut = sum(ref["state"][n].numel() for n in sharded) * 4
        assert out["param_bytes"] == whole - cut + cut // N_MODEL
    _assert_replicas_equal([out["local"] for out in outs], outs[0]["sharded"])


@pytest.mark.parametrize("world", [2, 4])
def test_fused_blocks_step_aside_for_sharded_convs(tp_runs, world):
    """SmallCNN with blocks 1-3 fused and its convs sharded takes the
    column-parallel unfused chain: the one-process step's numbers."""
    ref = tp_runs["single"]["smallcnn", str(torch.float32)]
    for res in tp_runs["outs"][world]:
        out = res["smallcnn_fused"]
        assert {"conv1.weight", "conv2.weight", "conv3.weight"} <= set(out["sharded"])
        assert _rel(out["logits"].numpy(), ref["logits"][res["rows"]].numpy()) < 1e-5
        np.testing.assert_allclose(out["step"]["loss"], ref["loss"], rtol=1e-5)
        for n, g, g_ref in zip(ref["names"], out["grads"], ref["grads"]):
            assert _rel(g.numpy(), _block(g_ref, out["sharded"], n, out).numpy()) < 1e-4, n


@pytest.mark.parametrize("name", sorted(STEP_MODELS))
def test_tp_step_collectives(tp_runs, name):
    """A step's gathers (forward) and row all-reduces (backward) per rank:
    one gather a sharded layer, or a layer and direction of an LSTM plus
    one a time step; one all-reduce a sharded layer whose input needs a
    gradient, and one a time step after the first."""
    out = tp_runs["outs"][2][0][name, str(torch.float32)]
    counts = out["collectives"]
    shape = STEP_MODELS[name][0]
    t = {"smalllstm": 7, "rnn": shape[1], "lstmwithattention": shape[1]}.get(name, 0)  # LSTM steps
    expect = {  # (gathers, row all-reduces) at min_features 8
        "smallcnn": (5, 4),  # conv1-3, fc1, fc2; conv1's input needs no gradient
        "largecnn": (8, 7),  # convs.0-4, fc1-3
        "smalllstm": (3 + 2 * (1 + t) + 1, 2 + 2 * (1 + t - 1) + 1),  # h = 0 at the first step needs none
        "rnn": (3 * (1 + t) + 1, 3 * (t - 1) + 2 + 1),  # the features need none
        "lstmwithattention": (1 + 4 * (1 + t) + 5, 2 * (1 + 2 * (t - 1)) + 5),  # conv1, 2 x 2 directions, 5 dense
    }[name]
    assert (counts["gathers"], counts["row_all_reduces"]) == expect, counts


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(STEP_MODELS))
def test_tp_step_matches_jax_tp_step(tp_runs, name, world):
    """Against JAX's make_train_step on its shard_params_tp state (2 x 2,
    min_features 8): loss, metric sums, Adam's first moment (0.1 × the
    gradient) block by block, the parameters and running statistics. Each
    tensor of the TP step is at most the one-process step's distance from
    JAX's, plus the tolerance the TP step is held to against one process
    (the one process is the port's f32 model, which the model tests hold
    against JAX: on this batch one of LargeCNN's convs.3 outputs lies within
    2.3e-8 of zero, and its relu passes the gradient in the port's f32 and
    not in JAX's or in float64, moving convs.0-3's gradients by up to 3e-2
    in both the one-process and the TP step)."""
    from audiobd_tpu_torch.models.convert import FROM_FLAX, opt_state_from_flax

    loss, sums, new, opt_state = _jax_step_cached(tp_runs, name)
    ref = tp_runs["single"][name, str(torch.float32)]
    names = ref["names"]
    final = FROM_FLAX[name](new)
    mu = opt_state_from_flax(name, opt_state, names)["mu"]
    for res in tp_runs["outs"][world]:
        out = res[name, str(torch.float32)]
        np.testing.assert_allclose(out["step"]["loss"], loss, rtol=1e-5)
        assert out["step"]["mix_acc"] == 100.0 * sums[0] / sums[1]
        assert out["step"]["asr"] == 100.0 * sums[2] / max(sums[3], 1)
        for n, got, want, g_ref in zip(names, out["mu"], mu, ref["grads"]):
            want = _block(want, out["sharded"], n, out).numpy()
            one = _rel(0.1 * _block(g_ref, out["sharded"], n, out).numpy(), want)
            assert _rel(got.numpy(), want) <= one + 1e-4, n
        for k, value in out["full"].items():
            if "running" in k:
                assert _rel(value.numpy(), final[k].numpy()) < 1e-4, k
            else:
                one = np.max(np.abs(ref["state"][k].numpy() - final[k].numpy()))
                assert np.max(np.abs(value.numpy() - final[k].numpy())) <= one + 0.25 * LR, k


_JAX_STEPS: dict = {}


def _jax_step_cached(tp_runs, name):
    if name not in _JAX_STEPS:
        _JAX_STEPS[name] = _jax_tp_step(name, tp_runs["variables"][name], tp_runs["inputs"]["step"][name], (2, 2))
    return _JAX_STEPS[name]


@pytest.mark.parametrize("world", [2, 4])
def test_tp_epoch_matches_one_process_epoch(tp_runs, world):
    """One epoch of the toy problem (64 rows, batch 32, lr 1e-3): loss within
    1e-4, mix_acc and asr equal, as JAX's TP test holds its epoch. On 1 x 2
    the sharded plan is the one-process plan and dropout is on; on 2 x 2
    the one process steps on the global batches of the sharded plan."""
    feats, labels, ind = tp_runs["inputs"]["epoch"]
    n_data = world // N_MODEL
    model = SmallCNN(10, 224, dropout_rates=(0.4, 0.5) if n_data == 1 else (0.0, 0.0))
    model.load_state_dict(tp_runs["inputs"]["epoch_state"])
    model.dropout_generator = torch_generator(35, "dropout")
    opt = Adam(model.parameters(), EPOCH_LR)
    if n_data == 1:
        ref = port_scan.run_train_epoch(model, opt, port_scan.DeviceDataset(ArraySet(feats, labels, ind), CPU),
                                        EPOCH_BATCH, np_rng(35, "shuffle"))
    else:
        perm, mask, _ = port_scan.make_sharded_perm(np_rng(35, "shuffle"), EPOCH_N, n_data, EPOCH_BATCH)
        slots = port_scan.pad_rows_index(EPOCH_N, n_data).reshape(n_data, -1)
        losses, sums = [], torch.zeros(4, dtype=torch.int64)
        for i in range(perm.shape[0]):
            rows = np.concatenate([slots[d][perm[i, d]] for d in range(n_data)])
            loss, s = _one_step(model, opt, feats, labels, ind, rows, mask[i].reshape(-1))
            losses.append(loss)
            sums += s
        ref = {"loss": float(np.mean(losses)), "mix_acc": 100.0 * int(sums[0]) / max(int(sums[1]), 1),
               "asr": 100.0 * int(sums[2]) / max(int(sums[3]), 1)}
    outs = tp_runs["outs"][world]
    for out in outs:
        got = out["epoch"]
        assert abs(got["loss"] - ref["loss"]) < 1e-4
        assert got["mix_acc"] == ref["mix_acc"] and got["asr"] == ref["asr"]
    _assert_replicas_equal([out["epoch_local"] for out in outs], outs[0]["epoch_sharded"])


def _assert_replicas_equal(states: list[dict], sharded) -> None:
    """Rank r = (d, m) of the grid: bit-equal to its row's ranks in every
    tensor they replicate, and to its column's in every tensor."""
    world = len(states)
    for r in range(world):
        d, m = divmod(r, N_MODEL)
        for k, value in states[r].items():
            partners = [] if k in sharded else [d * N_MODEL + j for j in range(N_MODEL)]
            partners += [e * N_MODEL + m for e in range(world // N_MODEL)]
            for p in partners:
                assert torch.equal(value, states[p][k]), (k, r, p)


def test_tp_bf16_step_matches_one_process(tp_runs):
    """(d) LargeCNN in bf16 on 1 x 2 against one process's bf16 step: the
    logits and the loss, the gradients, the running statistics none (no
    BatchNorm). The parameters after Adam are not compared: its first step
    moves each weight by lr·sign(g), and thousands of bf16 gradients near
    zero change sign between two summation orders (the sharded layers' input
    gradient is the sum of the ranks' bf16 partial products, one rounding
    more than one process's)."""
    ref = tp_runs["single"]["largecnn", str(torch.bfloat16)]
    for out in (res["largecnn", str(torch.bfloat16)] for res in tp_runs["outs"][2]):
        assert out["logits"].dtype == torch.bfloat16
        assert _rel(out["logits"].float().numpy(), ref["logits"].float().numpy()) < 1e-2
        assert abs(out["step"]["loss"] - ref["loss"]) <= 1e-2 * abs(ref["loss"])
        for n, g, g_ref in zip(ref["names"], out["grads"], ref["grads"]):
            assert g.dtype == torch.float32 and _rel(g.numpy(), _block(g_ref, out["sharded"], n, out).numpy()) < 2e-2, n


@pytest.mark.parametrize("name", sorted(STEP_MODELS))
def test_unsharded_weights_round_trip_into_build_model(tp_runs, name):
    """(e) unshard_params_tp's state_dict loads into build_model's model
    unchanged, and its eval logits are the TP model's."""
    for res in tp_runs["outs"][2] + tp_runs["outs"][4]:
        out = res[name, str(torch.float32)]
        for k, v in out["full"].items():
            assert torch.equal(out["fresh_state"][k], v), k
        assert _rel(out["fresh_logits"].numpy(), out["eval_logits"].numpy()) < 1e-5
