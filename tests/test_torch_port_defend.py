"""The port's defenses (audiobd_tpu_torch/defend/) against the JAX package's,
piece by piece, from shared weights and data.

The weights are a flax SmallCNN's (audiobd_tpu.models.build_model +
jit_init, unfused, as the JAX defenses build it), with random running
statistics and a scaled fc2 (``_variables``), carried to the port by
models/convert.py; the port's model has block 1 fused, so its eval-mode
parameter gradients go through the plain version of kernel B's eval mode
(``conv1_bn_pool_backward_plain``, ``train_bn=False``), the kernel's
counterpart on the CPU (the SAM and unlearning steps also run unfused). The
data is random features of MFCC size: (1, 101, 40) at batch 64 (``setup``),
and (1, 32, 13), FlowMur's, at batch 32 (``small``) where the reference's
vmapped sweeps, ablations and host loop would compile too long at the
larger size. The whole mitigations are not run here against JAX
(tests/test_defend.py runs the JAX ones, marked slow); the CLIs run end to
end on the CPU after a ``badnets --synthetic --device cpu`` run.

Tolerances:
  * the 5% val split, the neuron order and names, the record layer, and
    the numpy scoring, weight norms, weight changes, |Δw| lists and the
    reinit selection given identical inputs: bit-equal (the port runs the
    reference's numpy on the kernel in the flax layout);
  * the final classifier's profiled input: rtol 1e-5, atol 1e-6 · max
    (the logits' f32 tolerance of tests/test_torch_port_zoo.py);
  * eval losses (loss changes, one unlearning step's loss): rtol 1e-5, the
    same;
  * accuracies and ASRs (prune sweep, unlearning): equal, they are counts
    of argmax hits on logits that agree to 1e-5;
  * gradients, parameters and losses after a step (the SAM step's applied
    gradient and update; the unlearning step's |grad| row, Adam first
    moment and parameters; two unlearning epochs' losses and |grad| rows):
    parameter by parameter, the port's distance from JAX's float64 result
    (the same flax model under jax.enable_x64, its BatchNorm in float64) at
    most max(2 × JAX's own f32 distance from it, 1e-4; 1e-5 for the
    epochs' losses), as tests/test_torch_port_zoo.py judges gradients;
  * optax.sgd with momentum against train/state.py::SGD over three steps:
    rtol 1e-6 (f32, the same two operations a step).
"""

import csv
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audiobd_tpu.models.layers as jax_layers
from audiobd_tpu.configs import make_config as jax_make_config
from audiobd_tpu.defend import common as jax_common
from audiobd_tpu.defend import fp as jax_fp
from audiobd_tpu.defend import ft_reg as jax_ft_reg
from audiobd_tpu.defend import tsbd as jax_tsbd
from audiobd_tpu.models import build_model as jax_build_model
from audiobd_tpu.models import jit_init
from audiobd_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from audiobd_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from audiobd_tpu.train.loop import ArraySet as JaxArraySet
from audiobd_tpu.train.loop import iter_batches
from audiobd_tpu.train.state import TrainState
from audiobd_tpu.utils.random import np_rng as jax_np_rng
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.configs import linear_features_for, make_config
from audiobd_tpu_torch.defend import common, fp, ft_reg, tsbd
from audiobd_tpu_torch.models import SmallCNN, build_model
from audiobd_tpu_torch.models.convert import FROM_FLAX, flax_kernel_path
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.train.state import SGD, Adam

CPU = torch.device("cpu")
BS = 64
SEED = 35
FEATS = 3072  # SmallCNN's flatten at (101, 40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(params, stats) -> dict[str, torch.Tensor]:
    return FROM_FLAX["smallcnn"]({"params": _tree_np(params), "batch_stats": _tree_np(stats)})


def _set(model, variables, n, seed, target=None, shape=(101, 40)):
    """(feats, labels, indicators). Clean labels are the model's own eval
    predictions with a fifth of them moved to another class, so accuracy
    starts near 80% and two unlearning steps do not reach a floor; the bd
    split's labels are all ``target``."""
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((n, 1, *shape)) * 8.0).astype(np.float32)
    if target is not None:
        return feats, np.full(n, target, np.int64), (rng.random(n) < 0.8).astype(np.int64)
    labels = np.asarray(jnp.argmax(model.apply(variables, feats, train=False), axis=-1)).astype(np.int64)
    moved = rng.random(n) < 0.2
    labels[moved] = (labels[moved] + rng.integers(1, 10, int(moved.sum()))) % 10
    return feats, labels, None


def _variables(model, shape):
    """jit_init's f32 variables with random running statistics and fc2's
    kernel × 30: a classifier whose predictions spread over the classes
    with top-2 margins of ~1, so that two unlearning steps at lr 1e-4 move
    few of them."""
    variables = _tree_np(jit_init(model, jax.random.PRNGKey(0), np.zeros((1, 1, *shape), np.float32)))
    rng = np.random.default_rng(1)
    for bn in variables["batch_stats"].values():
        c = bn["BatchNorm_0"]["mean"].shape[0]
        bn["BatchNorm_0"]["mean"] = (0.5 * rng.standard_normal(c)).astype(np.float32)
        bn["BatchNorm_0"]["var"] = rng.uniform(0.5, 3.0, c).astype(np.float32)
    variables["params"]["fc2"]["Dense_0"]["kernel"] = variables["params"]["fc2"]["Dense_0"]["kernel"] * 30.0
    return {"params": variables["params"], "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def setup():
    """The JAX SmallCNN, its variables (``_variables``), and the splits:
    clean_val 40 clips (one batch), clean_test 70 (two, the second
    wrap-padded), bd_test 50 (labels all 2, indicators)."""
    model = jax_build_model("smallcnn", 10, FEATS)
    variables = _variables(model, (101, 40))
    val, test, bd = (_set(model, variables, n, seed, target) for n, seed, target in ((40, 2, None), (70, 3, None),
                                                                                      (50, 4, 2)))
    data = {
        "jax": jax_common.DefenseData(JaxArraySet(*val[:2]), JaxArraySet(*test[:2]), JaxArraySet(*bd[:2]),
                                      JaxArraySet(*bd)),
        "port": common.on_device(common.DefenseData(ArraySet(*val[:2]), ArraySet(*test[:2]), ArraySet(*bd[:2]),
                                                    ArraySet(*bd)), CPU),
    }
    return model, variables, data


@pytest.fixture(scope="module")
def small():
    """The SmallCNN of FlowMur's (32, 13) features (224-feature flatten),
    where the reference's vmapped ablations and its host unlearning loop
    with three testers compile and run in seconds on the CPU: the JAX model,
    its variables (``_variables``) and splits of 48 clips each (two batches
    of 32, the second padded; one eval shape to compile), bd labels all 2."""
    model = jax_build_model("smallcnn", 10, 224)
    variables = _variables(model, (32, 13))
    sets = [_set(model, variables, 48, seed, target, shape=(32, 13)) for seed, target in ((12, None), (13, None),
                                                                                        (14, 2))]
    val, test, bd = sets
    data = {
        "jax": jax_common.DefenseData(JaxArraySet(*val[:2]), JaxArraySet(*test[:2]), JaxArraySet(*bd[:2]),
                                      JaxArraySet(*bd)),
        "port": common.on_device(common.DefenseData(ArraySet(*val[:2]), ArraySet(*test[:2]), ArraySet(*bd[:2]),
                                                    ArraySet(*bd)), CPU),
    }
    return model, variables, data


def _port_model(variables, fused=True, feats=FEATS):
    model = SmallCNN(10, feats, fused_block1=fused)
    model.load_state_dict(_carry(variables["params"], variables["batch_stats"]))
    return model, common.snapshot(model)


class _Float64Linen:
    """flax.linen with a float64 BatchNorm (tests/test_torch_port_zoo.py)."""

    def __getattr__(self, attr):
        if attr == "BatchNorm":
            return lambda **kw: nn.BatchNorm(**{**kw, "dtype": jnp.float64})
        return getattr(nn, attr)


def _float64(fn, feats=FEATS):
    """``fn(model)`` with the JAX SmallCNN built to compute in float64."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "nn", _Float64Linen())
        return fn(jax_build_model("smallcnn", 10, feats))


def _judge(port: dict, jax32: dict, jax64: dict, what: str, floor: float = 1e-4) -> None:
    """Each entry: the port's distance from float64 ≤ max(2 × JAX f32's, floor)."""
    assert set(port) == set(jax64)
    for n in port:
        d_jax, d_port = _rel(jax32[n], jax64[n]), _rel(port[n], jax64[n])
        assert d_port <= max(2.0 * d_jax, floor), f"{what} {n}: port {d_port:.3e}, JAX f32 {d_jax:.3e}"


def _params_only(state: dict) -> dict:
    return {k: v for k, v in state.items() if "running" not in k}


# ---------------------------------------------------------------------------
# data, layout and names


def test_defense_split_bit_equal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    root = os.path.join("record", "split", "SCDv1-10")
    arrays = {
        ("clean", "clean_train_mfcc"): rng.standard_normal((192, 1, 5, 4)).astype(np.float32),
        ("clean", "clean_train_label"): rng.integers(0, 10, 192),
        ("clean", "clean_test_mfcc"): rng.standard_normal((48, 1, 5, 4)).astype(np.float32),
        ("clean", "clean_test_label"): rng.integers(0, 10, 48),
        ("bd", "bd_test_mfcc"): rng.standard_normal((48, 1, 5, 4)).astype(np.float32),
        ("bd", "bd_test_label"): np.full(48, 2),
        ("bd", "poison_index_test"): (rng.random(48) < 0.9).astype(np.int64),
    }
    for (sub, name), arr in arrays.items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        np.save(os.path.join(root, sub, name + ".npy"), arr)
    for ratio in (0.05, 0.3):
        want = jax_common.load_defense_data(jax_make_config("badnets", result="split"), ratio)
        got = common.load_defense_data(make_config("badnets", result="split"), ratio)
        for split in ("clean_val", "clean_test", "bd_test", "bd_test_complete"):
            w, g = getattr(want, split), getattr(got, split)
            for field in ("feats", "labels", "indicators"):
                a, b = getattr(g, field), getattr(w, field)
                assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), (split, field)


@pytest.mark.parametrize("name", ["smallcnn", "resnet", "lstmwithattention"])
def test_neuron_order_matches_restored_orbax_tree(tmp_path, name):
    """The conv and dense neurons, and the default record layer, in the
    order of the JAX tree restored by Orbax (sorted by flax path: for ResNet
    conv2d second, the last conv layer3_1's)."""
    feats = linear_features_for("badnets", name)
    model = jax_build_model(name, 10, feats, n_mfcc=40)
    variables = _tree_np(jit_init(model, jax.random.PRNGKey(0), np.zeros((1, 1, 101, 40), np.float32)))
    rec = str(tmp_path / "rec")
    jax_save_checkpoint(rec, TrainState(params=variables["params"], batch_stats=variables.get("batch_stats", {}),
                                        opt_state=optax.sgd(0.1).init(variables["params"]), step=np.int32(0)),
                        {"model": name})
    restored = jax_load_checkpoint(rec)[0]["params"]
    port = build_model(name, 10, feats, CPU, seed=0, n_mfcc=40)
    port.load_state_dict(FROM_FLAX[name](variables))
    state = port.state_dict()
    for kind, ndim in (("conv", 4), ("dense", 2)):
        names = [(flax_kernel_path(layer, ndim), idx) for layer, idx in common.neuron_names(state, kind)]
        assert names == jax_common.neuron_names(restored, kind), kind
    record = tsbd.default_record_layer(state)
    assert flax_kernel_path(record, 4) == jax_tsbd.default_record_layer(restored)
    assert record == {"smallcnn": "conv3.weight", "resnet": "stages.2.1.conv2.weight",
                      "lstmwithattention": "conv2.weight"}[name]


def test_layout_round_trip_and_surgery(setup):
    _, variables, _ = setup
    _, state = _port_model(variables)
    for name, kernel in common.layer_kernels(state, "conv") + common.layer_kernels(state, "dense"):
        flax = jax_common.get_leaf(variables["params"], flax_kernel_path(name, kernel.ndim))
        assert np.array_equal(common.flax_layout(kernel), np.asarray(flax).reshape(-1, flax.shape[-1]))
        assert torch.equal(common.from_flax_layout(common.flax_layout(kernel), kernel), kernel)
    picks = [("conv3.weight", 0), ("conv1.weight", 5), ("conv3.weight", 31), ("conv1.weight", 5)]
    want = jax_common.zero_neurons(variables["params"], [(flax_kernel_path(n, 4), i) for n, i in picks])
    got = common.zero_neurons(state, picks)
    carried = _carry(want, variables["batch_stats"])
    assert all(torch.equal(got[k], carried[k]) for k in carried)
    assert torch.count_nonzero(got["conv3.weight"][0]) == 0 and torch.count_nonzero(state["conv3.weight"][0]) > 0


def test_weight_norms_changes_and_reinit_bit_equal(setup):
    _, variables, _ = setup
    _, state_o = _port_model(variables)
    rng = np.random.default_rng(6)
    moved = jax.tree_util.tree_map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape) * (rng.random(a.shape) < 0.7)).astype(np.float32),
        variables["params"])
    state_new = _carry(moved, variables["batch_stats"])

    norms_j, names_j = jax_common.neuron_weight_norms(variables["params"], "conv")
    norms_p, names_p = common.neuron_weight_norms(state_o, "conv")
    assert norms_p == norms_j and [(flax_kernel_path(n, 4), i) for n, i in names_p] == names_j

    nwc_j, n2w_j = jax_common.neuron_weight_changes(moved, variables["params"], "conv")
    nwc_p, n2w_p = common.neuron_weight_changes(state_new, state_o, "conv")
    assert [(flax_kernel_path(n, 4), i, v) for n, i, v in nwc_p] == nwc_j
    flax_key = lambda k: f"{flax_kernel_path(k.rsplit('.', 1)[0], 4)}.{k.rsplit('.', 1)[1]}"  # noqa: E731
    assert {flax_key(k): v for k, v in n2w_p.items()} == n2w_j

    ranked_j = sorted(nwc_j, key=lambda rec: rec[2], reverse=True)
    ranked_p = sorted(nwc_p, key=lambda rec: rec[2], reverse=True)
    for ratio, wratio in ((0.1, 0.7), (0.5, 0.7), (0.9, 0.3)):
        top = int(len(ranked_j) * ratio)
        want = jax_tsbd.zero_reinit_weight(variables["params"], ranked_j[:top], n2w_j, wratio)
        got = tsbd.zero_reinit_weight(state_o, ranked_p[:top], n2w_p, wratio)
        carried = _carry(want, variables["batch_stats"])
        assert all(torch.equal(got[k], carried[k]) for k in carried), (ratio, wratio)
        assert any(not torch.equal(got[k], state_o[k]) for k in state_o)


def test_scoring_bit_equal(setup):
    """grad-change (whole-layer norms), z-scores, normalize-and-invert, the
    vlc > 0 zeroing and the prune order, on identical gradients and loss
    changes (the reference's numpy, ft_reg.py:247-261)."""
    _, variables, _ = setup
    rng = np.random.default_rng(7)
    draw = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), variables["params"])
    g_s, g_t = draw(), draw()
    neurons_j = jax_common.neuron_names(variables["params"], "conv")
    vlc = rng.standard_normal(len(neurons_j)) * 0.01
    vlc[::7] = np.abs(vlc[::7])

    grad_change = np.asarray([
        float(np.linalg.norm(np.asarray(jax_common.get_leaf(g_t, layer)) - np.asarray(jax_common.get_leaf(g_s, layer))))
        for layer, _ in neurons_j])

    def zscore(v):
        return (v - v.mean()) / max(v.std(), 1e-12)

    want = jax_ft_reg.normalize_and_invert(0.9 * zscore(grad_change) + (1 - 0.9) * zscore(vlc))
    want[vlc > 0] = 0.0

    _, state = _port_model(variables)
    neurons_p = common.neuron_names(state, "conv")
    changes = ft_reg.grad_changes(_carry(g_s, variables["batch_stats"]), _carry(g_t, variables["batch_stats"]),
                                  neurons_p)
    assert np.array_equal(changes, grad_change)
    got = ft_reg.neuron_scores(changes, vlc)
    assert np.array_equal(got, want) and np.array_equal(np.argsort(got)[::-1], np.argsort(want)[::-1])


# ---------------------------------------------------------------------------
# FP


@pytest.mark.parametrize("first_batch_only", [True, False])
def test_profile_activations_match_jax(setup, first_batch_only):
    model_j, variables, data = setup
    model, state = _port_model(variables)
    for split in ("clean_val", "clean_test"):
        want = jax_fp.profile_activations(model_j, variables, getattr(data["jax"], split), BS, first_batch_only)
        got = fp.profile_activations(model, state, getattr(data["port"], split), BS, first_batch_only)
        assert got.dtype == want.dtype == np.float32 and got.shape == (128,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_prune_sweep_matches_jax(small):
    """Four levels on the small SmallCNN (fc2 takes 128 inputs there too)."""
    model_j, variables, data = small
    model, state = _port_model(variables, feats=224)
    seq_sort = np.argsort(jax_fp.profile_activations(model_j, variables, data["jax"].clean_val, BS))
    levels = [0, 2, 64, 126]
    acc_j, asr_j = jax_fp._sweep_prune_levels(
        model_j, variables["params"], variables["batch_stats"], "fc2/Dense_0/kernel", seq_sort, levels,
        data["jax"].clean_test, data["jax"].bd_test, BS)
    got = [fp.prune_level(model, state, "fc2.weight", seq_sort, level, data["port"].clean_test,
                          data["port"].bd_test, BS) for level in levels]
    assert [a for a, _ in got] == [float(a) for a in acc_j]
    assert [b for _, b in got] == [float(b) for b in asr_j]
    assert fp.final_layer_name(model) == "fc2.weight"


# ---------------------------------------------------------------------------
# FT-reg


def _batch(data, n=32, n_valid=24):
    """The first ``n`` of clean_test's rows, the last n - n_valid masked."""
    feats, labels = data["jax"].clean_test.feats[:n], data["jax"].clean_test.labels[:n]
    return feats, labels, np.arange(n) < n_valid


def _jax_batch(feats, labels, mask, dtype=np.float32):
    return {"x": jnp.asarray(feats.astype(dtype)), "y": jnp.asarray(labels.astype(np.int32)),
            "mask": jnp.asarray(mask)}


@pytest.mark.parametrize("fused", [False, True])
def test_sam_step_matches_jax(setup, fused):
    """One FT-reg step (SGD momentum 0.9, lr 1e-3, r 0.05, α 0.7): the
    applied gradient and the parameter update, against make_reg_step."""
    model_j, variables, data = setup
    feats, labels, mask = _batch(data)
    lr, r, alpha = 1e-3, 0.05, 0.7

    def jax_step(m, v, dtype):
        tx = optax.sgd(lr, momentum=0.9)
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v["params"])
        st = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v["batch_stats"])
        new, _, final = jax_ft_reg.make_reg_step(m, tx, r, alpha)(p, tx.init(p), st,
                                                                  _jax_batch(feats, labels, mask, dtype))
        update = jax.tree_util.tree_map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64), new, p)
        return (_params_only(FROM_FLAX["smallcnn"]({"params": _tree_np(final), "batch_stats": v["batch_stats"]})),
                _params_only(FROM_FLAX["smallcnn"]({"params": update, "batch_stats": v["batch_stats"]})))

    final32, upd32 = jax_step(model_j, variables, np.float32)
    final64, upd64 = _float64(lambda m: jax_step(m, variables, np.float64))

    model, _ = _port_model(variables, fused)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = SGD(model.parameters(), lr, momentum=0.9)
    final = ft_reg.reg_step(model, opt, torch.from_numpy(feats), torch.from_numpy(labels), torch.from_numpy(mask),
                            r, alpha)
    names = [n for n, _ in model.named_parameters()]
    _judge({n: g.numpy() for n, g in zip(names, final)}, final32, final64, "applied gradient")
    _judge({n: (p.detach().double() - before[n].double()).numpy() for n, p in model.named_parameters()},
           upd32, upd64, "update")
    assert all(torch.equal(b, model.state_dict()[n]) for n, b in model.state_dict().items() if "running" in n)


def test_sgd_matches_optax():
    rng = np.random.default_rng(8)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0] for _ in range(3)]
    tx = optax.sgd(0.01, momentum=0.9)
    params = [jnp.asarray(p) for p in p0]
    st = tx.init(params)
    ours = [torch.from_numpy(p.copy()) for p in p0]
    opt = SGD(ours, 0.01, momentum=0.9)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, params)
        params = optax.apply_updates(params, upd)
        opt.step([torch.from_numpy(a) for a in g])
        for a, b in zip(ours, params):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_loss_changes_match_jax(small):
    """Every neuron of conv3 and 20 of conv1 (the reference's lane chunks of
    16, the last padded) on clean_test at batch 32 (two batches, the second
    padded), on the small SmallCNN: with base 0 the changes are the ablated
    models' losses."""
    model_j, variables, data = small
    bs = 32
    neurons = [("conv3.weight", i) for i in range(32)] + [("conv1.weight", i) for i in range(0, 40, 2)]
    want = jax_ft_reg.loss_changes(model_j, variables["params"], variables["batch_stats"], data["jax"].clean_test,
                                   [(flax_kernel_path(n, 4), i) for n, i in neurons], 0.0, bs)
    model, state = _port_model(variables, feats=224)
    dset = data["port"].clean_test
    got = ft_reg.loss_changes(model, state, dset, neurons, 0.0, bs)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    base = common.make_tester(model, bs)(state, dset)[0]
    assert ft_reg.loss_changes(model, state, dset, neurons[:2], base, bs) == [g - base for g in got[:2]]


# ---------------------------------------------------------------------------
# TSBD and the correlation analysis


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _jax_unlearn_steps(model_j, variables, batches, dtype, lr=1e-4):
    """make_unlearn_step on each batch in turn: [(loss, train acc, |grad|
    row)], and after the last step the Adam first moment (0.1 × the
    gradient of the first step on its own) and the parameters, carried to
    the port's names, float64 numpy."""
    tx = optax.adam(lr)
    step = jax_tsbd.make_unlearn_step(model_j, tx)
    p, st = _cast(variables["params"], dtype), _cast(variables["batch_stats"], dtype)
    opt_state, rows = tx.init(p), []
    for b in batches:
        p, opt_state, loss, acc, gn = step(p, opt_state, st, _jax_batch(*b, dtype=dtype), "TorchConv_2/Conv_0/kernel")
        rows.append((float(loss), float(acc), np.asarray(gn, np.float64)))
    carry = lambda tree: _params_only(  # noqa: E731
        {n: v.double().numpy() for n, v in FROM_FLAX["smallcnn"]({"params": _tree_np(tree),
                                                                   "batch_stats": variables["batch_stats"]}).items()})
    return rows, carry(opt_state[0].mu), carry(p)


@pytest.mark.parametrize("fused", [False, True])
def test_unlearn_step_matches_jax(setup, fused):
    """One ascent step (Adam lr 1e-4) against make_unlearn_step: loss and
    train accuracy; conv3's |grad| row, Adam's first moment (the gradient
    × 0.1) and the updated parameters by the float64 rule."""
    model_j, variables, data = setup
    batch = _batch(data)
    (want32,), mu32, p32 = _jax_unlearn_steps(model_j, variables, [batch], np.float32)
    (want64,), mu64, p64 = _float64(lambda m: _jax_unlearn_steps(m, variables, [batch], np.float64))
    model, _ = _port_model(variables, fused)
    opt = Adam(model.parameters(), 1e-4)
    loss, acc, gn = tsbd.unlearn_step(model, opt, *(torch.from_numpy(a) for a in batch), "conv3.weight")
    np.testing.assert_allclose(float(loss), want32[0], rtol=1e-5)
    assert float(acc) == want32[1]
    names = [n for n, _ in model.named_parameters()]
    _judge({"gn": gn.numpy()}, {"gn": want32[2]}, {"gn": want64[2]}, "|grad| row")
    _judge({n: m.double().numpy() for n, m in zip(names, opt.mu)}, mu32, mu64, "first moment")
    _judge({n: p.detach().double().numpy() for n, p in model.named_parameters()}, p32, p64, "parameters")


@pytest.mark.parametrize("first_batch_only", [True, False])
def test_unlearning_epochs_match_jax(small, first_batch_only):
    """Two epochs of stage B on the small SmallCNN, on clean_test at batch
    32 (data_type clean_val; val accuracy stays above its floor), each
    epoch's batches from
    iter_batches(np_rng(seed, "tsbd_unlearn"), shuffle=True): the first
    alone with ``first_batch_only``, against make_unlearn_step on the same
    batches; all of them otherwise, against the JAX package's
    _host_unlearn. Each row's loss and |grad| average (and variance) by the
    float64 rule, its accuracies equal."""
    model_j, variables, data = small
    test, bs = data["jax"].clean_test, 32

    def jax_rows(m, dtype):
        if first_batch_only:
            rng = jax_np_rng(SEED, "tsbd_unlearn")
            batches = []
            for _ in range(2):
                idx, mask = next(iter_batches(len(test), bs, rng, shuffle=True))
                batches.append((test.feats[idx], test.labels[idx], mask))
            rows, _, _ = _jax_unlearn_steps(m, variables, batches, dtype)
            return [[e, loss, acc, None, None, None, *gn] for e, (loss, acc, gn) in enumerate(rows)], None
        tx = optax.adam(1e-4)
        p = _cast(variables["params"], dtype)
        avg, var = [], []
        jax_tsbd._host_unlearn(m, tx, 2, test, data["jax"], "clean_val", bs, jax_make_config("badnets", seed=SEED),
                               "TorchConv_2/Conv_0/kernel", p, tx.init(p), _cast(variables["batch_stats"], dtype),
                               jax_common.make_tester(m, bs), avg, var, verbose=False)
        return avg, var

    avg32, var32 = jax_rows(model_j, np.float32)
    avg64, var64 = _float64(lambda m: jax_rows(m, np.float64), feats=224)
    model, _ = _port_model(variables, feats=224)
    avg, var = tsbd.unlearn(model, Adam(model.parameters(), 1e-4), data["port"].clean_test, data["port"],
                            "clean_val", bs, SEED, "conv3.weight", 2, first_batch_only,
                            common.make_tester(model, bs), verbose=False)
    assert len(avg) == len(avg32) == len(avg64) == 2
    for e in range(2):
        row = {"loss": avg[e][1], "gn": avg[e][6:]}
        _judge(row, {"loss": avg32[e][1], "gn": avg32[e][6:]}, {"loss": avg64[e][1], "gn": avg64[e][6:]},
               f"epoch {e}", floor=1e-5)
        assert avg[e][0] == e and avg[e][2] == avg32[e][2]
        if first_batch_only:
            assert var[e][6:] == [0.0] * 32  # the variance of one batch
        else:
            assert avg[e][3:6] == avg32[e][3:6]
            _judge({"var": var[e][6:]}, {"var": var32[e][6:]}, {"var": var64[e][6:]}, f"epoch {e}")


# ---------------------------------------------------------------------------
# The CLIs on the CPU


@pytest.fixture(scope="module")
def attacked(tmp_path_factory):
    root = tmp_path_factory.mktemp("defend_cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        # Batch 32: at the default 256 each step would wrap-pad the 80 train clips to 256.
        port_main(["badnets", "--synthetic", "--synthetic_per_class", "10", "--num_epochs", "2", "--batch_size", "32",
                   "--device", "cpu"])
    return root


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


PRUNE_HEADER = ["ratio", "clean_test_loss", "bd_test_loss", "test_clean_acc", "test_asr"]


def test_fp_cli(attacked, monkeypatch):
    monkeypatch.chdir(attacked)
    result = port_main(["fp", "--once_prune_ratio", "0.05", "--device", "cpu"])
    out = os.path.join("record", "badnets_smallcnn", "defense", "fp")
    rows = _rows(os.path.join(out, "pruning_data.csv"))
    assert rows[0] == ["num_pruned", "pruning_ratio", "test_acc", "test_asr"]
    assert [int(r[0]) for r in rows[1:]] == [7 * i for i in range(len(rows) - 1)]  # ceil(128 · 0.05) a level
    assert len(rows) - 1 == len(result.history) and result.pruned_channels in (0, *[int(r[0]) for r in rows[1:]])
    ft = _rows(os.path.join(out, "ft_data.csv"))
    assert ft[0] == ["test_clean_acc", "test_asr", "clean_test_loss", "bd_test_loss"] and len(ft) == 2
    assert [float(v) for v in ft[1][:2]] == [result.test_acc, result.test_asr]


def test_ft_reg_cli(attacked, monkeypatch):
    monkeypatch.chdir(attacked)
    result = port_main(["ft_reg", "--ft_epochs", "2", "--device", "cpu"])
    rows = _rows(os.path.join("record", "badnets_smallcnn", "defense", "ft_reg", "pruning_data.csv"))
    assert rows[0] == PRUNE_HEADER and len(rows) == 12
    assert [float(r[0]) for r in rows[1:]] == jax_ft_reg.PRUNE_RATIOS
    assert result.scores.shape == (160,) and np.isfinite(result.scores).all()


def test_tsbd_cli_finetune_branch(attacked, monkeypatch):
    monkeypatch.chdir(attacked)
    result = port_main(["tsbd", "--device", "cpu"])
    rows = _rows(os.path.join("record", "badnets_smallcnn", "defense", "tsbd", "finetuning_data.csv"))
    assert rows[0] == ["epoch", "clean_test_loss", "bd_test_loss", "test_clean_acc", "test_asr"] and len(rows) == 2
    assert result.stage == "finetune" and 0.0 <= result.test_acc <= 100.0


def test_tsbd_cli_full_path(attacked, monkeypatch):
    monkeypatch.chdir(attacked)
    result = port_main(["tsbd", "--only_finetune", "false", "--unlearn_epochs", "5", "--ft_epochs", "1",
                        "--device", "cpu"])
    out = os.path.join("record", "badnets_smallcnn", "defense", "tsbd")
    prune = _rows(os.path.join(out, "pruning_data.csv"))
    assert prune[0] == PRUNE_HEADER and [float(r[0]) for r in prune[1:]] == jax_tsbd.REINIT_RATIOS
    ft = _rows(os.path.join(out, "finetuning_data.csv"))
    assert ft[0] == ["ratio", "epoch", *PRUNE_HEADER[1:]]
    assert [(float(r[0]), int(r[1])) for r in ft[1:]] == [(r, 0) for r in jax_tsbd.REINIT_RATIOS]  # epochs 0..1 test at 0
    ckpt = os.path.join(out, "checkpoint")
    header = ["Epoch", "train_loss", "train_acc", "test_acc", "test_asr", "val_acc"] + [f"neuron_{i}" for i in range(32)]
    for kind in ("avg", "var"):
        rows = _rows(os.path.join(ckpt, f"grad_{kind}_conv3.weight.csv"))
        assert rows[0] == header and len(rows) - 1 == result.unlearn_epochs and 1 <= result.unlearn_epochs <= 5
    with open(os.path.join(ckpt, "ucn.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "No \t Layer_Name \t Neuron_Idx \t Score " and len(lines) == 161
    assert lines[1].split(" \t ")[1:3] == ["conv1.weight", "0"]
    with open(os.path.join(ckpt, "n2w_dict.json")) as f:
        n2w = json.load(f)
    assert len(n2w) == 160 and len(n2w["conv3.weight.0"]) == 4 * 64 and len(n2w["conv1.weight.0"]) == 4
    unlearned = torch.load(os.path.join(ckpt, "unlearned_model.pt"), weights_only=True)
    assert set(unlearned) == set(SmallCNN(10, FEATS).state_dict())
    assert len(result.per_ratio) == 11


def test_correlation_cli(attacked, monkeypatch):
    monkeypatch.chdir(attacked)
    result = port_main(["correlation_analysis", "--device", "cpu"])
    rows = _rows(os.path.join("record", "badnets_smallcnn", "defense", "correlation", "nwc_correlation.csv"))
    assert rows[0] == ["layer", "neuron", "clean_nwc", "bd_nwc"] and len(rows) == 161
    assert [r[0] for r in rows[1:]] == ["conv1.weight"] * 64 + ["conv2.weight"] * 64 + ["conv3.weight"] * 32
    assert -1.0 <= result.pearson_r <= 1.0 and result.clean_nwc.shape == (160,)


@pytest.mark.parametrize("command", ["fp", "ft_reg", "tsbd", "correlation_analysis"])
def test_defense_cli_without_cuda_or_device_raises(attacked, monkeypatch, command):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    monkeypatch.chdir(attacked)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main([command])
