"""The port's LargeCNN, LSTMWithAttention, RNN and ResNet against the JAX
package's, from shared weights, at the Ultrasonic (100, 40) and BadNets
(101, 40) feature sizes, in f32 and in bf16.

Weights come from the JAX model (audiobd_tpu.models.build_model +
jit_init, f32) and are carried over with models/convert.py. Dropout bits
cannot match across frameworks, so dropout is off on both sides: on the JAX
side by intercepting flax's Dropout, on the port's side with a rate of 0.
The flax models are jitted; both sides see the same numpy batch.

Tolerances. Logits, eval and train mode: within 1e-5 of their largest entry
in f32; within 3e-2 in bf16 (bf16 activations: one rounding that falls the
other way propagates; the LSTMs sum their gates in another order than the
reference's scan; measured up to 1.1e-2). BN running statistics: within
1e-5 of each tensor's largest entry in f32, 1e-2 in bf16 (the statistics
of bf16 activations rounded in another order; measured up to 2.3e-3).
One step's parameter gradients are judged one parameter at a time, as
tests/test_fused_conv_block.py::test_model_bf16_grads_close judges them:
  * f32: the port's gradient lies from JAX's float64 gradient (the same
    flax model and weights under jax.enable_x64, its BatchNorms computing
    in float64 too) by at most max(2 × JAX's f32 gradient's distance from
    it, 1e-4). The limit follows JAX's own rounding parameter by parameter
    because some gradients are sums that cancel (ResNet's BN parameters:
    both packages' f32 gradients lie up to 8.0e-2 from float64 there,
    alike; measured: the port at most 0.57 of its limit). Named exception,
    LargeCNN's ``convs.0.weight`` and ``convs.1.weight``: the second conv
    feeds a 2×2 max pool without a relu, one window of its 256,000 holds
    two entries within f32 rounding of each other, and the port's f32
    argmax there differs from float64's (JAX's does not), which moves one
    term of both gradients. They are held within 1e-2 of float64
    (measured: the port 8.7e-4 to 6.2e-3, JAX 4.0e-4 to 6.1e-4).
  * bf16: the port's gradient lies from JAX's f32 gradient by less than
    max(2 × JAX's bf16 gradient's distance from it, 0.02), and by less
    than 0.9, so that a zero gradient (1.0) fails everywhere. JAX's bf16
    reference is compiled with XLA's excess precision off, so that it
    rounds to bf16 where the model casts, as the port does; by default XLA
    may drop a f32 → bf16 → f32 round trip and keep a cancelling sum exact
    (LSTMWithAttention's ``conv2.bias`` at the Ultrasonic size: 4.9e-4
    from f32 by default, 0.11 with the round trip kept, the port 0.18).
    The 0.9 binds where JAX's own bf16 gradient is more than half off:
    LSTMWithAttention's ``bn1.bias`` and ``conv2.bias`` at the BadNets
    size (JAX 0.56 and 0.67, the port 0.54 and 0.80), ResNet's
    ``stages.0.0.bn2.weight`` at the Ultrasonic size (0.54, 0.50) and
    ``stages.0.1.bn2.bias`` at the BadNets size (0.60, 0.49).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audiobd_tpu.models.layers as jax_layers
from audiobd_tpu.models import build_model as jax_build_model
from audiobd_tpu.models import jit_init
from audiobd_tpu_torch.configs import linear_features_for, make_config
from audiobd_tpu_torch.models import RNN, LargeCNN, LSTMWithAttention, ResNet, build_model
from audiobd_tpu_torch.models.convert import FROM_FLAX
from audiobd_tpu_torch.train.loop import cross_entropy, masked_mean
from audiobd_tpu_torch.train.trainer import build_attack_model

BATCH = 4
N_MFCC = 40
FRAMES = {"ultrasonic": 100, "badnets": 101}
NAMES = ("largecnn", "lstmwithattention", "rnn", "resnet")
CASES = [(name, attack) for name in NAMES for attack in FRAMES]
DTYPES = {"float32": (None, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOGITS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
STATS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Parameters whose f32 gradient crosses a near-tie of a max pool (see above).
POOL_TIE_TOL = {"largecnn": ({"convs.0.weight", "convs.1.weight"}, 1e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _batch(attack):
    rng = np.random.default_rng(7)
    return ((rng.standard_normal((BATCH, 1, FRAMES[attack], N_MFCC)) * 8.0).astype(np.float32),
            rng.integers(0, 10, BATCH).astype(np.int32))


@pytest.fixture(scope="module")
def references():
    """Computed once per (model, attack): see ``_reference``."""
    cache = {}

    def get(name, attack):
        if (name, attack) not in cache:
            cache[name, attack] = _reference(name, attack)
        return cache[name, attack]

    return get


def _compiled(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off, so that a bf16
    model rounds to bf16 wherever it casts, as the port does."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


class _Float64Linen:
    """flax.linen, but its BatchNorm computes in float64: the JAX package's
    TorchBatchNorm asks for float32, which would cap a float64 reference at
    f32 there."""

    def __getattr__(self, attr):
        if attr == "BatchNorm":
            return lambda **kw: nn.BatchNorm(**{**kw, "dtype": jnp.float64})
        return getattr(nn, attr)


def _flax_step(model, variables, x, y):
    """One train step of the flax model with dropout off: (loss, train
    logits, new batch statistics, parameter gradients)."""
    def loss_fn(params):
        logits, mut = model.apply({"params": params, "batch_stats": variables.get("batch_stats", {})}, x,
                                  train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), y))
        return loss, (logits, mut.get("batch_stats", {}))

    with nn.intercept_methods(_no_dropout):
        (loss, (logits, stats)), grads = _compiled(jax.value_and_grad(loss_fn, has_aux=True), variables["params"])
    return loss, logits, stats, grads


def _reference(name, attack):
    """The f32 flax variables; for each dtype the flax model's eval logits,
    train-mode logits, and one train step's loss and gradients with the new
    running statistics (as a port state_dict); and the float64 gradients."""
    x, y = _batch(attack)
    feats = linear_features_for(attack, name)
    models = {dt: jax_build_model(name, 10, feats, n_mfcc=N_MFCC, dtype=jdt) for dt, (jdt, _) in DTYPES.items()}
    variables = jax.tree_util.tree_map(np.asarray, jit_init(models["float32"], jax.random.PRNGKey(0), x[:1]))
    out = {"variables": variables}
    for dt, model in models.items():
        loss, train_logits, stats, grads = _flax_step(model, variables, x, y)
        eval_logits = _compiled(lambda v, x, model=model: model.apply(v, x, train=False), variables, x)
        tree = jax.tree_util.tree_map(np.asarray, {"params": grads, "batch_stats": stats})
        out[dt] = dict(eval=_f32(eval_logits), train=_f32(train_logits), loss=float(loss),
                       grads=FROM_FLAX[name](tree))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "nn", _Float64Linen())
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        _, _, _, grads = _flax_step(jax_build_model(name, 10, feats, n_mfcc=N_MFCC), v64, x.astype(np.float64), y)
        assert all(g.dtype == jnp.float64 for g in jax.tree_util.tree_leaves(grads))
        tree = jax.tree_util.tree_map(np.asarray, {"params": grads, "batch_stats": variables.get("batch_stats", {})})
    out["float64"] = {n: v.numpy() for n, v in FROM_FLAX[name](tree).items()}  # carried as f32
    return out


def _port_model(name, attack, variables, dtype):
    feats = linear_features_for(attack, name)
    model = {
        "largecnn": lambda: LargeCNN(10, feats, dropout_rate=0.0, compute_dtype=dtype),
        "lstmwithattention": lambda: LSTMWithAttention(10, N_MFCC, feats, dropout_rate=0.0, compute_dtype=dtype),
        "rnn": lambda: RNN(10, N_MFCC, compute_dtype=dtype),
        "resnet": lambda: ResNet(10, feats, compute_dtype=dtype),
    }[name]()
    model.load_state_dict(FROM_FLAX[name](variables))
    return model


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,attack", CASES)
def test_eval_and_train_logits_match_flax(references, name, attack, dtype):
    ref = references(name, attack)
    model = _port_model(name, attack, ref["variables"], DTYPES[dtype][1])
    x = torch.from_numpy(_batch(attack)[0])
    tol = LOGITS_TOL[dtype]
    with torch.no_grad():
        got_eval = model.eval()(x)
        got_train = model.train()(x)
    assert got_eval.dtype == got_train.dtype == DTYPES[dtype][1]
    assert _rel(got_eval.float().numpy(), ref[dtype]["eval"]) < tol
    assert _rel(got_train.float().numpy(), ref[dtype]["train"]) < tol


def _port_grads(model, x, y) -> dict[str, np.ndarray]:
    """One train step's parameter gradients, float64 numpy, and the loss."""
    dt = next(model.parameters()).dtype
    loss = masked_mean(cross_entropy(model(torch.from_numpy(x).to(dt)), torch.from_numpy(y).long()),
                       torch.ones(BATCH, dtype=torch.bool))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for g in grads:
        assert g.dtype == dt  # the parameters' dtype: f32 in either compute dtype
    return {n: g.double().numpy() for n, g in zip(names, grads)}, loss.item()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,attack", CASES)
def test_train_step_grads_and_running_stats(references, name, attack, dtype):
    ref = references(name, attack)
    model = _port_model(name, attack, ref["variables"], DTYPES[dtype][1]).train()
    x, y = _batch(attack)
    grads, loss = _port_grads(model, x, y)
    expect = {n: v.numpy() for n, v in ref[dtype]["grads"].items()}
    assert set(grads) | {n for n, _ in model.named_buffers()} == set(expect)
    for n, buf in model.named_buffers():
        assert buf.dtype == torch.float32 and _rel(buf.numpy(), expect[n]) < STATS_TOL[dtype], n
    if dtype == "float32":
        assert abs(loss - ref[dtype]["loss"]) <= 1e-5 * abs(ref[dtype]["loss"])
        exact = ref["float64"]
        tied, tie_tol = POOL_TIE_TOL.get(name, (set(), 0.0))
        for n, g in grads.items():
            d_jax, d_port = _rel(expect[n], exact[n]), _rel(g, exact[n])
            limit = tie_tol if n in tied else max(2.0 * d_jax, 1e-4)
            assert d_port <= limit, f"{n}: port {d_port:.3e} vs JAX f32 {d_jax:.3e} from float64"
        return
    g32 = {n: v.numpy() for n, v in ref["float32"]["grads"].items()}
    for n, g in grads.items():
        d_jax, d_port = _rel(expect[n], g32[n]), _rel(g, g32[n])
        assert d_port < min(max(2.0 * d_jax, 0.02), 0.9), f"{n}: port {d_port:.3e} vs JAX bf16 {d_jax:.3e}"


@pytest.mark.parametrize("name", ["smallcnn", "smalllstm", *NAMES])
def test_build_model_builds_every_model(name):
    cfg = make_config("ultrasonic", model=name, device="cpu", compute_dtype="bfloat16")
    model = build_attack_model(cfg, torch.device("cpu"))
    assert model.compute_dtype == torch.bfloat16 and model.dropout_generator is not None
    again = build_model(name, 10, linear_features_for("ultrasonic", name), torch.device("cpu"), seed=35, n_mfcc=40,
                        compute_dtype=torch.bfloat16)
    for (n, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), n  # the same draws from the same seed
    with torch.no_grad():
        logits = model.eval()(torch.zeros(2, 1, 100, 40))
    assert logits.shape == (2, 10) and logits.dtype == torch.bfloat16
    if name in ("lstmwithattention", "rnn"):
        with pytest.raises(ValueError, match="n_mfcc"):
            build_model(name, 10, 100, torch.device("cpu"), seed=35)
