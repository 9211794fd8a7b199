"""The port's SmallLSTM, and SmallCNN with blocks 2-3 fused, against the JAX
package from shared weights, and the CLI on the block-2/3 path.

Weights come from a JAX model (audiobd_tpu.models.build_model + jit_init,
every block unfused) and are carried over with models.convert. Dropout bits
cannot match across frameworks, so dropout is off on both sides: on the JAX
side by intercepting flax's Dropout from the test, on the port's side with
rates of 0. The port runs every block unfused and every block fused
(ops/conv1_bn_pool, ops/conv2_bn_pool with their plain backward on the CPU).

Tolerances: logits and running statistics 1e-5 relative to each tensor's
largest entry; one step's parameter gradients 5e-4 relative (the JAX
package's own fused-vs-chain bound, tests/test_fused_conv_block2.py: the
fused blocks sum in another order and pick pool winners by r·scale + shift
where the unfused chain uses (r − μ)·inv·γ + β); three Adam steps' losses
rtol 1e-5. All f32.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiobd_tpu.models import build_model as jax_build_model
from audiobd_tpu.models import jit_init
from audiobd_tpu.train.loop import make_train_step
from audiobd_tpu.train.state import TrainState
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.models import SmallCNN, SmallLSTM
from audiobd_tpu_torch.models.convert import smallcnn_from_flax, smalllstm_from_flax
from audiobd_tpu_torch.train.checkpoint import load_checkpoint
from audiobd_tpu_torch.train.loop import cross_entropy, masked_mean
from audiobd_tpu_torch.train.state import Adam
from audiobd_tpu_torch.train.trainer import build_attack_model, resolve_fused_block2

BATCH = 4
LR = 1e-4
MODELS = {
    "smalllstm": (128, smalllstm_from_flax),
    "smallcnn": (3072, smallcnn_from_flax),
}
# (model, every block fused): SmallCNN unfused is tests/test_torch_port_model.py's.
RUNS = [("smalllstm", False), ("smalllstm", True), ("smallcnn", True)]

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once
    (pytest-xdist), and torch's thread pool on these small tensors then
    costs more in synchronisation than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(7)
    return [
        (
            (rng.standard_normal((BATCH, 1, 101, 40)) * 8.0).astype(np.float32),
            rng.integers(0, 10, BATCH).astype(np.int32),
            np.arange(BATCH) < BATCH - 1,  # one wrap-pad row masked out
        )
        for _ in range(3)
    ]


@pytest.fixture(scope="module")
def jax_models(batches):
    out = {}
    for name, (features, _) in MODELS.items():
        jmodel = jax_build_model(name, 10, features)
        variables = jax.tree_util.tree_map(
            np.asarray, jit_init(jmodel, jax.random.PRNGKey(0), batches[0][0][:1]))
        out[name] = (jmodel, variables)
    return out


def _port_model(name, variables, fused):
    features, convert = MODELS[name]
    flags = dict(fused_block1=fused, fused_block2=fused, fused_block3=fused)
    if name == "smalllstm":
        model = SmallLSTM(10, features, dropout_rate=0.0, **flags)
    else:
        model = SmallCNN(10, features, dropout_rates=(0.0, 0.0), **flags)
    model.load_state_dict(convert(variables))
    return model


def _port_loss(model, batch):
    x, y, mask = batch
    logits = model(torch.from_numpy(x))
    return masked_mean(cross_entropy(logits, torch.from_numpy(y).long()), torch.from_numpy(mask))


@pytest.mark.parametrize("name,fused", RUNS)
def test_eval_logits_match(jax_models, batches, name, fused):
    jmodel, variables = jax_models[name]
    x = batches[0][0]
    ref = np.asarray(jmodel.apply(variables, x, train=False))
    model = _port_model(name, variables, fused).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert _rel(got, ref) < 1e-5


@pytest.fixture(scope="module")
def jax_refs(jax_models, batches):
    """Per model, computed once: one train step's (loss, gradients and new
    running statistics as a port state_dict) and three Adam steps' losses."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        jmodel, variables = jax_models[name]
        x, y, mask = batches[0]

        def loss_fn(params):
            logits, mut = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)},
            )
            per_row = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            fm = jnp.asarray(mask, jnp.float32)
            return jnp.sum(per_row * fm) / jnp.maximum(jnp.sum(fm), 1.0), mut["batch_stats"]

        tx = optax.adam(LR)
        state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
        step = make_train_step(jmodel, tx)
        losses = []
        with nn.intercept_methods(_no_dropout):
            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
            for xb, yb, mb in batches:
                batch = {"x": xb, "y": yb, "mask": mb, "indicator": np.zeros(BATCH, np.int32)}
                state, metrics = step(state, batch, jax.random.PRNGKey(2))
                losses.append(float(metrics["loss_batchmean"]))
        ref = MODELS[name][1](jax.tree_util.tree_map(np.asarray, {"params": grads, "batch_stats": stats}))
        cache[name] = (float(loss), ref, losses)
        return cache[name]

    return get


@pytest.mark.parametrize("name,fused", RUNS)
def test_train_step_loss_grads_and_running_stats(jax_models, batches, jax_refs, name, fused):
    loss_j, ref, _ = jax_refs(name)
    model = _port_model(name, jax_models[name][1], fused).train()
    loss = _port_loss(model, batches[0])
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))

    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    assert set(grads) | {n for n, _ in model.named_buffers()} == set(ref)
    for n, g in grads.items():
        assert _rel(g.numpy(), ref[n].numpy()) < 5e-4, n
    for n, buf in model.named_buffers():
        assert _rel(buf.numpy(), ref[n].numpy()) < 1e-5, n


@pytest.mark.parametrize("name,fused", RUNS)
def test_three_adam_steps_track_optax(jax_models, batches, jax_refs, name, fused):
    _, _, losses_j = jax_refs(name)
    model = _port_model(name, jax_models[name][1], fused).train()
    opt = Adam(model.parameters(), LR)
    losses = []
    for batch in batches:
        loss = _port_loss(model, batch)
        opt.step(torch.autograd.grad(loss, opt.params))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)


@pytest.mark.parametrize("mode,expected", [("auto", False), ("on", True), ("off", False)])
def test_fused_block2_flags_resolve_like_the_reference(mode, expected):
    cfg = make_config("badnets", model="smalllstm", fused_block2=mode, fused_block3=mode, device="cpu")
    assert resolve_fused_block2(cfg) is expected
    assert resolve_fused_block2(cfg, "fused_block3") is expected
    model = build_attack_model(cfg, torch.device("cpu"))
    assert isinstance(model, SmallLSTM)
    assert (model.fused_block2, model.fused_block3) == (expected, expected)


def test_fused_block2_flag_rejects_other_values():
    with pytest.raises(ValueError, match="fused_block2"):
        resolve_fused_block2(make_config("badnets", fused_block2="maybe"))


def test_cli_trains_smalllstm_on_block23_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = port_main([
        "badnets", "--synthetic", "--synthetic_per_class", "4", "--num_epochs", "2",
        "--batch_size", "16", "--device", "cpu", "--model", "smalllstm",
        "--fused_block2", "on", "--fused_block3", "on",
    ])
    assert result.epochs_ran == 2
    assert isinstance(result.model, SmallLSTM) and result.model.fused_block2 and result.model.fused_block3
    assert all(np.isfinite(v) for k in ("train_loss", "test_clean_loss", "test_bd_loss") for v in result.history[k])
    record = os.path.join("record", "badnets_smallcnn")
    with open(os.path.join(record, "loss_result.csv")) as f:
        assert len(f.read().strip().splitlines()) == 3
    state_dict, spec = load_checkpoint(record)
    assert spec["model"] == "smalllstm"
    model = SmallLSTM(spec["num_classes"], spec["feature_size"])
    model.load_state_dict(state_dict)
    feats = torch.from_numpy(np.load(os.path.join(record, "SCDv1-10", "bd", "bd_test_mfcc.npy")))
    with torch.no_grad():
        logits = model.eval()(feats)
    assert logits.shape == (len(feats), 10) and torch.isfinite(logits).all()
