"""The port's SmallCNN, loss and Adam against the JAX package, from shared weights.

Weights come from a JAX SmallCNN (audiobd_tpu.models.build_model + jit_init,
fused block off) and are carried over with models.convert.smallcnn_from_flax.
Dropout bits cannot match across frameworks, so dropout is off on both
sides: on the JAX side by intercepting flax's Dropout from the test, on the
port's side with rates (0, 0). The port runs block 1 both unfused and
through ops/conv1_bn_pool (its plain backward on the CPU).

Tolerances: logits and losses rtol 1e-5 relative to the largest value;
gradients and running statistics 1e-4 relative to each tensor's largest
entry; parameters after three Adam steps 0.25 lr (reason at the check). Both sides are f32; the gradients are sums over the batch and
positions taken in another order, and the fused port block picks pool
winners by z = r*scale + shift where the unfused JAX chain uses
(r - μ)·inv·γ + β, so a near-tie may route one gradient element differently.
"""

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
from audiobd_tpu_torch.models import SmallCNN
from audiobd_tpu_torch.models.convert import smallcnn_from_flax
from audiobd_tpu_torch.train.loop import cross_entropy, masked_mean
from audiobd_tpu_torch.train.state import Adam

BATCH = 8
LR = 1e-4


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    batches = [
        (
            (rng.standard_normal((BATCH, 1, 101, 40)) * 8.0).astype(np.float32),
            rng.integers(0, 10, BATCH).astype(np.int32),
            np.arange(BATCH) < BATCH - 2,  # two wrap-pad rows masked out
            rng.integers(0, 2, BATCH).astype(np.int32),
        )
        for _ in range(3)
    ]
    jmodel = jax_build_model("smallcnn", 10, 3072)
    variables = jax.tree_util.tree_map(
        np.asarray, jit_init(jmodel, jax.random.PRNGKey(0), batches[0][0][:1])
    )
    return jmodel, variables, batches


def _port_model(variables, fused):
    model = SmallCNN(10, 3072, fused_block1=fused, dropout_rates=(0.0, 0.0))
    model.load_state_dict(smallcnn_from_flax(variables))
    return model


def _jax_step(jmodel, variables, batch):
    x, y, mask, _ = batch

    def loss_fn(params):
        logits, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)},
        )
        per_row = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        fm = jnp.asarray(mask, jnp.float32)
        return jnp.sum(per_row * fm) / jnp.maximum(jnp.sum(fm), 1.0), mut["batch_stats"]

    with nn.intercept_methods(_no_dropout):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), jax.tree_util.tree_map(np.asarray, grads), jax.tree_util.tree_map(np.asarray, stats)


def test_eval_logits_match(setup):
    jmodel, variables, batches = setup
    x = batches[0][0]
    ref = np.asarray(jmodel.apply(variables, x, train=False))
    for fused in (False, True):
        model = _port_model(variables, fused).eval()
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert _rel(got, ref) < 1e-5, fused


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_loss_grads_and_running_stats(setup, fused):
    jmodel, variables, batches = setup
    loss_j, grads_j, stats_j = _jax_step(jmodel, variables, batches[0])
    x, y, mask, _ = batches[0]

    model = _port_model(variables, fused).train()
    loss = masked_mean(cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y).long()),
                       torch.from_numpy(mask))
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))

    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    ref = smallcnn_from_flax({"params": grads_j, "batch_stats": stats_j})
    for name, g in grads.items():
        assert _rel(g.numpy(), ref[name].numpy()) < 1e-4, name
    for name, buf in model.named_buffers():
        assert _rel(buf.numpy(), ref[name].numpy()) < 1e-4, name


@pytest.mark.parametrize("fused", [False, True])
def test_three_adam_steps_track_optax(setup, fused):
    jmodel, variables, batches = setup
    tx = optax.adam(LR)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    step = make_train_step(jmodel, tx)
    losses_j = []
    with nn.intercept_methods(_no_dropout):
        for x, y, mask, ind in batches:
            state, metrics = step(state, {"x": x, "y": y, "mask": mask, "indicator": ind},
                                  jax.random.PRNGKey(2))
            losses_j.append(float(metrics["loss_batchmean"]))

    model = _port_model(variables, fused).train()
    opt = Adam(model.parameters(), LR)
    losses = []
    for x, y, mask, _ in batches:
        loss = masked_mean(cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y).long()),
                           torch.from_numpy(mask))
        opt.step(torch.autograd.grad(loss, opt.params))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    # Adam divides by √ν: where a gradient entry is near zero, its normalized
    # step m̂/(√ν̂+ε) changes by a good fraction of one lr when the f32
    # gradients differ in their last digits. So parameters (each moved ~3 lr)
    # are held to 0.25 lr; the running statistics to 1e-4 relative.
    final = smallcnn_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    for name, p in model.named_parameters():
        assert np.max(np.abs(p.detach().numpy() - final[name].numpy())) <= 0.25 * LR, name
    for name, buf in model.named_buffers():
        assert _rel(buf.numpy(), final[name].numpy()) < 1e-4, name


@pytest.mark.parametrize("n,batch_size", [(20, 8), (5, 8)])
def test_batch_plan_matches_jax(n, batch_size):
    from audiobd_tpu.train import scan_epoch as jax_scan
    from audiobd_tpu.utils.random import np_rng as jax_np_rng
    from audiobd_tpu_torch.train import scan_epoch as port_scan
    from audiobd_tpu_torch.utils.random import np_rng

    nb, mask = port_scan.pad_plan(n, batch_size)
    nb_j, mask_j = jax_scan.pad_plan(n, batch_size)
    assert nb == nb_j and np.array_equal(mask, mask_j)
    np.testing.assert_array_equal(
        port_scan.make_perm(np_rng(35, "shuffle"), n, nb, batch_size),
        jax_scan.make_perm(jax_np_rng(35, "shuffle"), n, nb, batch_size),
    )


def test_epoch_engine_matches_jax_scan_epoch(setup):
    """One train epoch (3 batches, the last wrap-padded with 4 masked rows)
    and one eval pass: the epoch loss is the mean of per-batch masked means,
    accuracy and ASR come from masked sums, as run_train_epoch_scan and
    run_eval_scan report them."""
    from audiobd_tpu.train import scan_epoch as jax_scan
    from audiobd_tpu.train.loop import ArraySet as JaxArraySet
    from audiobd_tpu.utils.random import np_rng as jax_np_rng
    from audiobd_tpu_torch.train import scan_epoch as port_scan
    from audiobd_tpu_torch.train.loop import ArraySet
    from audiobd_tpu_torch.utils.random import np_rng

    jmodel, variables, _ = setup
    rng = np.random.default_rng(9)
    n, batch_size = 20, 8
    feats = (rng.standard_normal((n, 1, 101, 40)) * 8.0).astype(np.float32)
    labels = rng.integers(0, 10, n)
    ind = (rng.random(n) < 0.4).astype(np.int64)
    labels[ind == 1] = 2  # poisoned rows carry the target label

    tx = optax.adam(LR)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    dset = jax_scan.DeviceDataset(JaxArraySet(feats, labels, ind))
    with nn.intercept_methods(_no_dropout):
        epoch_fn = jax_scan.make_train_epoch_fn(jmodel, tx, donate=False)
        state, tr_j = jax_scan.run_train_epoch_scan(
            epoch_fn, state, dset, batch_size, jax.random.PRNGKey(0), jax_np_rng(35, "shuffle"))
        ev_j = jax_scan.run_eval_scan(jax_scan.make_eval_epoch_fn(jmodel), state, dset, batch_size)

    model = _port_model(variables, fused=False)
    opt = Adam(model.parameters(), LR)
    pset = port_scan.DeviceDataset(ArraySet(feats, labels, ind), torch.device("cpu"))
    tr = port_scan.run_train_epoch(model, opt, pset, batch_size, np_rng(35, "shuffle"))
    ev = port_scan.run_eval_epoch(model, pset, batch_size)

    np.testing.assert_allclose(tr["loss"], tr_j["loss"], rtol=1e-5)
    np.testing.assert_allclose(ev["loss"], ev_j["loss"], rtol=1e-5)
    assert (tr["mix_acc"], tr["asr"]) == (tr_j["mix_acc"], tr_j["asr"])
    assert (ev["acc"], ev["asr"]) == (ev_j["acc"], ev_j["asr"])
