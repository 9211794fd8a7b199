"""The port's bf16 compute mode (TrainConfig.compute_dtype = "bfloat16")
against the JAX package's, on the CPU.

Ops: ``ops/conv1_bn_pool`` and ``ops/conv2_bn_pool`` with
``compute_dtype=torch.bfloat16`` (their plain backward: the bf16 mode of
kernels B, C, D, E) against ``conv1_bn_pool`` / ``conv2_bn_pool`` with
``compute_dtype=jnp.bfloat16`` and the Pallas kernels in interpret mode, as
tests/test_fused_conv_block.py and test_fused_conv_block2.py run them; the
same numpy inputs and a bf16 cotangent go to both. Tolerances:
  * forward out (bf16): at least 99.9% of the elements bit-equal, the rest
    within 1 bf16 ulp of the element (the batch statistics are f32 sums in
    another order, so z can round the other way at a tie of rounding);
  * gradients, quantized inputs (multiples of 2⁻³ for x, of 2⁻⁵ for the
    weight, of 2⁻⁶ for the bias, so that y, r and the batch sums are exact
    in f32 and the routing is the same): dweight, dbias, dγ, dβ within
    1e-5 of their max (f32 sums in another order); dx within 1 bf16 ulp of
    max|dx| and at least 70% bit-equal. dx is the sum of a position's bf16
    taps: the reference adds them in bf16, the port in f32 and rounds once,
    so an element may differ where the taps cancel;
  * gradients, normal inputs: dweight, dbias, dγ, dβ within 1e-4 of their
    max (a near-tie of rounding may route one window otherwise); dx within 2
    bf16 ulps of max|dx| and at least 60% bit-equal.

Models: SmallCNN (block 1 fused, and blocks 1-3 fused) and SmallLSTM (blocks
1-3 fused) in bf16, from flax weights carried by models/convert.py, dropout
off on both sides. The flax models run unfused and jitted (the fused JAX
forward is the unfused one, tests/test_fused_conv_block.py::
test_model_bf16_grads_close, and that test's rule judges the bf16 gradient
against the unfused f32 and bf16 ones too): logits against the flax model
with dtype=bfloat16 within
5e-3 (SmallCNN) and 2e-2 (SmallLSTM) of their max (bf16 activations: a
last-bit difference of the f32 statistics flips a rounding and it
propagates; the LSTM's gate sums round in another order than the
reference's scan; measured 7e-4 and 9e-3); per-parameter gradients by the
JAX test's own rule (tests/test_fused_conv_block.py::
test_model_bf16_grads_close): the port's bf16 gradient's error relative to
the f32 gradient is below max(2 × the JAX bf16 gradient's, 0.02).

Training: a CPU ``train_attack`` in bf16 reaches clean accuracy above 60
and ASR above 80 (tests/test_train_badnets.py asks that of JAX).
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
from audiobd_tpu.ops.fused_conv_block import conv1_bn_pool as jax_conv1_bn_pool
from audiobd_tpu.ops.fused_conv_block2 import conv2_bn_pool as jax_conv2_bn_pool
from audiobd_tpu_torch.configs import config_from_yaml, make_config
from audiobd_tpu_torch.data.speech_commands import make_synthetic_clean_data
from audiobd_tpu_torch.models import SmallCNN, SmallLSTM
from audiobd_tpu_torch.models.convert import smallcnn_from_flax, smalllstm_from_flax
from audiobd_tpu_torch.ops import conv1_bn_pool as port1
from audiobd_tpu_torch.ops import conv2_bn_pool as port2
from audiobd_tpu_torch.poison import badnets
from audiobd_tpu_torch.train.loop import cross_entropy, masked_mean
from audiobd_tpu_torch.train.trainer import build_attack_model, resolve_compute_dtype, train_attack

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if isinstance(a, jax.Array) else a.detach().float().numpy()


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The bf16 spacing at |v| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def _check_forward(got: torch.Tensor, ref) -> None:
    assert got.dtype == BF16
    got, ref = _f32(got), _f32(ref)
    assert (got == ref).mean() >= 0.999
    assert np.all(np.abs(got - ref) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))))


def _check_grads(got, ref, case: str) -> None:
    """(dx, dweight, dbias, dgamma, dbeta) of the port against the reference."""
    names = ("dx", "dweight", "dbias", "dgamma", "dbeta")
    param_tol, dx_ulps, dx_share = (1e-5, 1, 0.7) if case == "quantized" else (1e-4, 2, 0.6)
    for name, a, e in zip(names, got, ref):
        a, e = _f32(a), np.asarray(e, np.float32)
        err = float(np.abs(a - e).max())
        if name == "dx":
            assert err <= dx_ulps * float(_bf16_ulp(np.abs(e).max())), (name, err)
            assert (a == e).mean() >= dx_share, (name, (a == e).mean())
        else:
            assert err <= param_tol * float(np.abs(e).max()), (name, err)


# ---------------------------------------------------------------------------
# ops


def _block1_inputs(case: str, b=2, h=9, w=13, c=64):
    rng = np.random.default_rng(3 if case == "quantized" else 4)
    if case == "quantized":
        q = lambda a, s: (np.round(a * s) / s).astype(np.float32)  # noqa: E731
        x = q(rng.uniform(-1, 1, (b, h, w, 1)), 8)
        kernel = q(rng.uniform(-1, 1, (2, 2, 1, c)), 32)
        bias = q(rng.uniform(-0.5, 0.3, c), 64)
    else:
        x = rng.normal(size=(b, h, w, 1)).astype(np.float32)
        kernel = (rng.normal(size=(2, 2, 1, c)) * 0.5).astype(np.float32)
        bias = (rng.normal(size=c) * 0.1 - 0.3).astype(np.float32)  # many relu zeros: exact pool ties
    gamma = (1.0 + 0.3 * rng.normal(size=c)).astype(np.float32)
    gamma[0] = -abs(gamma[0])
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    stats = ((0.3 * rng.random(c)).astype(np.float32), (0.5 + rng.random(c)).astype(np.float32))
    return x, kernel, bias, gamma, beta, stats


@pytest.mark.parametrize("case", ["quantized", "normal"])
@pytest.mark.parametrize("train", [True, False])
def test_block1_bf16_matches_pallas(case, train):
    x, kernel, bias, gamma, beta, (rmean, rvar) = _block1_inputs(case)
    kw = dict(train=train, compute_dtype=jnp.bfloat16, interpret=True)
    if train:
        kw.update(need_input_grad=True)  # the port forms dx whenever x requires it
    else:
        kw.update(running_mean=rmean, running_var=rvar)
    outs, vjp = jax.vjp(lambda *a: jax_conv1_bn_pool(*a, **kw), *map(jnp.asarray, (x, kernel, bias, gamma, beta)))
    out = outs[0] if train else outs
    g = jnp.asarray(np.random.default_rng(5).normal(size=out.shape).astype(np.float32)).astype(jnp.bfloat16)
    dx, dk, db, dg, dbeta = vjp((g, jnp.zeros_like(outs[1]), jnp.zeros_like(outs[2])) if train else g)

    leaves = [_t(x).permute(0, 3, 1, 2).contiguous(), _t(kernel).permute(3, 2, 0, 1).contiguous(),
              _t(bias), _t(gamma), _t(beta)]
    leaves = [t.requires_grad_(True) for t in leaves]
    if train:
        got, mu, var = port1.conv1_bn_pool(*leaves, train=True, compute_dtype=BF16)
        assert mu.dtype == var.dtype == torch.float32
        np.testing.assert_allclose(mu.detach().numpy(), np.asarray(outs[1]), rtol=1e-6, atol=1e-7)
    else:
        got = port1.conv1_bn_pool(*leaves, train=False, running_mean=_t(rmean), running_var=_t(rvar),
                                  compute_dtype=BF16)
    _check_forward(got.permute(0, 2, 3, 1), out)
    grads = torch.autograd.grad(got, leaves, _t(_f32(g)).permute(0, 3, 1, 2).to(BF16))
    assert grads[0].dtype == torch.float32 and all(t.dtype == torch.float32 for t in grads[1:])
    ref = [np.asarray(dx).transpose(0, 3, 1, 2), np.asarray(dk).transpose(3, 2, 0, 1), db, dg, dbeta]
    _check_grads(grads, ref, case)


def _block2_inputs(case, shape, seed):
    b, h, w, cin, c = shape
    rng = np.random.default_rng(seed)
    if case == "quantized":
        q = lambda a, s: (np.round(a * s) / s).astype(np.float32)  # noqa: E731
        x = q(rng.uniform(-1, 1, (b, h, w, cin)), 8)
        kernel = q(rng.uniform(-0.25, 0.25, (2, 2, cin, c)), 32)
        bias = q(rng.uniform(-0.5, 0.3, c), 64)
    else:
        x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
        kernel = (rng.normal(size=(2, 2, cin, c)) * 0.3 / np.sqrt(cin)).astype(np.float32)
        bias = (rng.normal(size=c) * 0.1 - 0.1).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # a bf16 model's block input
    gamma = (1.0 + 0.3 * rng.normal(size=c)).astype(np.float32)
    gamma[0] = -abs(gamma[0])
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    return x, kernel, bias, gamma, beta


@pytest.mark.parametrize("case", ["quantized", "normal"])
@pytest.mark.parametrize("shape,pool_padding", [((2, 12, 13, 8, 16), (1, 1)), ((2, 11, 7, 16, 32), (0, 1))])
def test_block2_bf16_matches_pallas(case, shape, pool_padding):
    x, kernel, bias, gamma, beta = _block2_inputs(case, shape, seed=sum(shape))
    fn = lambda *a: jax_conv2_bn_pool(*a, pool_padding=pool_padding, compute_dtype=jnp.bfloat16,  # noqa: E731
                                      interpret=True)
    outs, vjp = jax.vjp(fn, jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, (kernel, bias, gamma, beta)))
    g = jnp.asarray(np.random.default_rng(5).normal(size=outs[0].shape).astype(np.float32)).astype(jnp.bfloat16)
    dx, dk, db, dg, dbeta = vjp((g, jnp.zeros_like(outs[1]), jnp.zeros_like(outs[2])))

    leaves = [_t(x).permute(0, 3, 1, 2).contiguous().to(BF16), _t(kernel).permute(3, 2, 0, 1).contiguous(),
              _t(bias), _t(gamma), _t(beta)]
    leaves = [t.requires_grad_(True) for t in leaves]
    got, mu, var = port2.conv2_bn_pool(*leaves, pool_padding=pool_padding, compute_dtype=BF16)
    assert mu.dtype == var.dtype == torch.float32
    _check_forward(got.permute(0, 2, 3, 1), outs[0])
    grads = torch.autograd.grad(got, leaves, _t(_f32(g)).permute(0, 3, 1, 2).to(BF16))
    assert grads[0].dtype == BF16 and all(t.dtype == torch.float32 for t in grads[1:])
    ref = [_f32(dx).transpose(0, 3, 1, 2), np.asarray(dk).transpose(3, 2, 0, 1), db, dg, dbeta]
    _check_grads(grads, ref, case)


def test_plain_backward_rounds_an_f32_x_as_a_bf16_one():
    """The mode follows g: with a bf16 g an f32 x is rounded to bf16 in the
    recompute, so it gives what the same x in bf16 gives; dx comes back in
    x's dtype."""
    x, kernel, bias, gamma, beta, (mu, var) = _block1_inputs("normal")
    xt = _t(x).permute(0, 3, 1, 2).contiguous()
    w, b = _t(kernel).permute(3, 2, 0, 1).contiguous(), _t(bias)
    inv = torch.rsqrt(_t(var) + port1.EPS)
    vecs = (_t(mu), inv, _t(gamma) * inv, _t(beta) - _t(mu) * _t(gamma) * inv)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 64, 8, 4)).astype(np.float32)).to(BF16)
    from_f32 = port1.conv1_bn_pool_backward_plain(xt, g, w, b, *vecs, train_bn=True, need_dx=True)
    from_bf16 = port1.conv1_bn_pool_backward_plain(xt.to(BF16), g, w, b, *vecs, train_bn=True, need_dx=True)
    assert from_f32[0].dtype == torch.float32 and from_bf16[0].dtype == BF16
    for a, e in zip(from_f32, from_bf16):
        assert torch.equal(a.float(), e.float())


# ---------------------------------------------------------------------------
# models

BATCH = 4
MODELS = {"smallcnn": (3072, smallcnn_from_flax, SmallCNN), "smalllstm": (128, smalllstm_from_flax, SmallLSTM)}
# (model, block 1 fused, blocks 2-3 fused): bench.py's e2e row, and the
# block-2/3 path on both models.
RUNS = [("smallcnn", True, False), ("smallcnn", True, True), ("smalllstm", True, True)]
LOGITS_TOL = {"smallcnn": 5e-3, "smalllstm": 2e-2}


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    return ((rng.standard_normal((BATCH, 1, 101, 40)) * 8.0).astype(np.float32),
            rng.integers(0, 10, BATCH).astype(np.int32))


@pytest.fixture(scope="module")
def flax_runs(batch):
    """Per model, computed once: the flax variables (f32 init), the bf16 flax
    model's eval logits, and one train step's parameter gradients of the f32
    and of the bf16 flax model (as port state_dicts)."""
    cache = {}

    def get(run):
        name = run[0]
        if name in cache:
            return cache[name]
        features, convert, _ = MODELS[name]
        x, y = batch
        models = {dt: jax_build_model(name, 10, features, dtype=dt) for dt in (None, jnp.bfloat16)}
        variables = jax.tree_util.tree_map(np.asarray, jit_init(models[None], jax.random.PRNGKey(0), x[:1]))

        def grads(model):
            def loss_fn(params):
                logits, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
                return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), y))

            with nn.intercept_methods(_no_dropout):
                g = jax.jit(jax.grad(loss_fn))(variables["params"])
            return convert(jax.tree_util.tree_map(np.asarray, {"params": g, "batch_stats": variables["batch_stats"]}))

        logits = jax.jit(lambda v, x: models[jnp.bfloat16].apply(v, x, train=False))(variables, x)
        assert logits.dtype == jnp.bfloat16
        cache[name] = (variables, _f32(logits), grads(models[None]), grads(models[jnp.bfloat16]))
        return cache[name]

    return get


def _port_model(run, variables):
    name, fused1, fused23 = run
    features, convert, cls = MODELS[name]
    flags = dict(fused_block1=fused1, fused_block2=fused23, fused_block3=fused23, compute_dtype=BF16)
    if name == "smalllstm":
        model = cls(10, features, dropout_rate=0.0, **flags)
    else:
        model = cls(10, features, dropout_rates=(0.0, 0.0), **flags)
    model.load_state_dict(convert(variables))
    return model


@pytest.mark.parametrize("run", RUNS)
def test_model_bf16_logits_match_flax(flax_runs, batch, run):
    variables, ref, _, _ = flax_runs(run)
    model = _port_model(run, variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(batch[0]))
    assert got.dtype == BF16
    assert _rel(got.float().numpy(), ref) < LOGITS_TOL[run[0]]


@pytest.mark.parametrize("run", RUNS)
def test_model_bf16_grads_by_the_reference_rule(flax_runs, batch, run):
    variables, _, g32, g16 = flax_runs(run)
    model = _port_model(run, variables).train()
    x, y = batch
    logits = model(torch.from_numpy(x))
    loss = masked_mean(cross_entropy(logits, torch.from_numpy(y).long()), torch.ones(BATCH, dtype=torch.bool))
    assert logits.dtype == BF16 and loss.dtype == torch.float32
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    for n, g in grads.items():
        assert g.dtype == torch.float32, n
        d_jax, d_port = _rel(g16[n].numpy(), g32[n].numpy()), _rel(g.numpy(), g32[n].numpy())
        assert d_port < max(2.0 * d_jax, 0.02), f"{n}: port {d_port:.3e} vs JAX bf16 {d_jax:.3e}"
    for n, buf in model.named_buffers():
        assert buf.dtype == torch.float32, n


# ---------------------------------------------------------------------------
# config and training


def test_yaml_compute_dtype_loads_and_bad_values_raise(tmp_path):
    path = tmp_path / "bf16.yaml"
    path.write_text("attack: badnets\ntrain:\n  compute_dtype: bfloat16\n  batch_size: 64\n")
    cfg = config_from_yaml(str(path), attack="badnets", device="cpu")
    assert (cfg.train.compute_dtype, cfg.train.batch_size) == ("bfloat16", 64)
    assert resolve_compute_dtype(cfg) is BF16
    assert make_config("badnets").train.compute_dtype == "float32"
    with pytest.raises(ValueError, match="compute_dtype"):
        make_config("badnets", compute_dtype="float16")
    path.write_text("attack: badnets\ntrain:\n  compute_dtype: bf16\n")
    with pytest.raises(ValueError, match="compute_dtype"):
        config_from_yaml(str(path))


@pytest.mark.parametrize("model_name", ["smallcnn", "smalllstm"])
def test_bf16_config_gives_bf16_activations_and_f32_state(model_name):
    cfg = make_config("badnets", model=model_name, compute_dtype="bfloat16", fused_conv_block="on",
                      fused_block2="on", fused_block3="on", device="cpu")
    model = build_attack_model(cfg, torch.device("cpu")).train()
    x = torch.from_numpy((np.random.default_rng(0).standard_normal((3, 1, 101, 40)) * 8).astype(np.float32))
    for i, block in enumerate((model.block1, model.block2, model.block3), start=1):
        x = block(x)
        assert x.dtype == BF16, f"block {i}"
    logits = model(torch.from_numpy(np.zeros((3, 1, 101, 40), np.float32)))
    loss = cross_entropy(logits, torch.zeros(3, dtype=torch.long)).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert logits.dtype == BF16 and loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)
    assert all(b.dtype == torch.float32 for b in model.buffers())


def test_badnets_bf16_training_reaches_quality(tmp_path, monkeypatch):
    """The JAX package's test_badnets_bf16_compute_matches_quality on the
    port, cut from 6 epochs to 4 (the synthetic set is learnt by epoch 4)."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("record", exist_ok=True)
    cfg = make_config("badnets", dataset="SCDv1-10", model="smallcnn", result="badnets_bf16", num_epochs=4,
                      batch_size=64, learning_rate=1e-3, patience=20, device="cpu", compute_dtype="bfloat16")
    clean = make_synthetic_clean_data(cfg, n_per_class=24)
    poisoned = badnets.poison(cfg, clean, save=False)
    result = train_attack(cfg, poisoned.bd_train, poisoned.clean_test, poisoned.bd_test, verbose=False, save=False)
    assert result.model.compute_dtype == BF16
    assert result.history["test_clean_acc"][-1] > 60.0
    assert result.history["test_asr"][-1] > 80.0
