"""The trainer's optimizer choice and restart contract against the JAX
package: ``TrainConfig.optimizer``/``monitor``, optax's sgd with momentum and
adam steps from carried weights and carried optimizer state
(models/convert.py::opt_state_from_flax), the port's save → ``--resume``
round trip, ``--profile_dir``, and ``train_clean``.

Shared weights: a JAX SmallCNN's variables (jit_init) carried into the
port's model. Dropout bits cannot match across frameworks, so where a
history or a step is compared dropout is off on both sides, as in
tests/test_torch_port_model.py (flax's Dropout intercepted; the port's
rates (0, 0)). ``train_clean`` is compared so: its whole history on shared
weights with dropout off, not only its early stop and val loss.

Tolerances (f32 on both sides; the port's block 1 unfused, as on the CPU):
  * losses: rtol 1e-5 (test_torch_port_model.py's); over train_clean's
    epochs of Adam steps, 1e-4 (the steps' parameter differences feed the
    later losses);
  * accuracies: equal (counts of argmax hits on logits that agree);
  * parameters after sgd with momentum: each update (p − p0) within 1e-4 of
    its largest entry, the gradients' tolerance in test_torch_port_model.py,
    since the update is lr × a sum of gradients;
  * parameters after an adam step: 0.25 lr, test_torch_port_model.py's
    bound (m̂/√ν̂ magnifies last-digit gradient differences where ν is
    near zero).
"""

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiobd_tpu.train.trainer as jax_trainer
from audiobd_tpu.configs import config_from_yaml as jax_config_from_yaml
from audiobd_tpu.configs import make_config as jax_make_config
from audiobd_tpu.models import build_model as jax_build_model
from audiobd_tpu.models import jit_init
from audiobd_tpu.train.loop import ArraySet as JaxArraySet
from audiobd_tpu.train.loop import make_train_step
from audiobd_tpu.train.state import TrainState
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.configs import config_from_yaml, make_config
from audiobd_tpu_torch.data.speech_commands import make_synthetic_clean_data
from audiobd_tpu_torch.models import SmallCNN
from audiobd_tpu_torch.models.convert import opt_state_from_flax, smallcnn_from_flax
from audiobd_tpu_torch.poison import badnets
from audiobd_tpu_torch.train import trainer
from audiobd_tpu_torch.train.checkpoint import checkpoint_dir, load_checkpoint, load_train_state
from audiobd_tpu_torch.train.loop import ArraySet, cross_entropy, masked_mean
from audiobd_tpu_torch.train.state import SGD, Adam

CPU = torch.device("cpu")
BATCH = 8
LR = 1e-3


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


@pytest.fixture(scope="module")
def setup():
    """The JAX SmallCNN, its variables, and three batches of 8 (two rows of
    each masked, as wrap-padding leaves them)."""
    rng = np.random.default_rng(3)
    batches = [
        ((rng.standard_normal((BATCH, 1, 101, 40)) * 8.0).astype(np.float32),
         rng.integers(0, 10, BATCH).astype(np.int32), np.arange(BATCH) < BATCH - 2,
         rng.integers(0, 2, BATCH).astype(np.int32))
        for _ in range(3)
    ]
    jmodel = jax_build_model("smallcnn", 10, 3072)
    variables = jax.tree_util.tree_map(np.asarray, jit_init(jmodel, jax.random.PRNGKey(0), batches[0][0][:1]))
    return jmodel, variables, batches


def _port_model(variables) -> SmallCNN:
    model = SmallCNN(10, 3072, dropout_rates=(0.0, 0.0))
    model.load_state_dict(smallcnn_from_flax(variables))
    return model.train()


def _port_step(model, opt, batch) -> float:
    """The step of train/scan_epoch.py::run_train_epoch on one batch."""
    x, y, mask, _ = batch
    loss = masked_mean(cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y).long()), torch.from_numpy(mask))
    opt.step(torch.autograd.grad(loss, opt.params))
    return loss.item()


def _jax_steps(jmodel, state, tx, batches):
    step = make_train_step(jmodel, tx)
    losses = []
    with nn.intercept_methods(_no_dropout):
        for x, y, mask, ind in batches:
            state, metrics = step(state, {"x": x, "y": y, "mask": mask, "indicator": ind}, jax.random.PRNGKey(2))
            losses.append(float(metrics["loss_batchmean"]))
    return state, losses


def _carried(state) -> dict[str, torch.Tensor]:
    return smallcnn_from_flax(jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                                  "batch_stats": state.batch_stats}))


# ---------------------------------------------------------------------------
# (a) the optimizer fields


def test_optimizer_and_monitor_config_keys(tmp_path):
    cfg = make_config("badnets", optimizer="sgd_momentum", monitor="mean_test_loss")
    assert (cfg.train.optimizer, cfg.train.monitor) == ("sgd_momentum", "mean_test_loss")
    assert (make_config("badnets").train.optimizer, make_config("badnets").train.monitor) == ("adam", "mean_test_loss")
    path = tmp_path / "sgd.yaml"
    path.write_text("train:\n  optimizer: sgd_momentum\n  monitor: mean_test_loss\n  learning_rate: 0.01\n")
    port, ref = config_from_yaml(str(path), attack="badnets"), jax_config_from_yaml(str(path), attack="badnets")
    for key in ("optimizer", "monitor", "learning_rate"):
        assert getattr(port.train, key) == getattr(ref.train, key), key
    assert isinstance(trainer.make_optimizer(port, [torch.zeros(2)]), SGD)
    assert isinstance(trainer.make_optimizer(make_config("badnets"), [torch.zeros(2)]), Adam)


def test_unknown_optimizer_raises_as_jax():
    with pytest.raises(ValueError, match="rmsprop"):
        jax_trainer.make_optimizer(jax_make_config("badnets", optimizer="rmsprop"))
    with pytest.raises(ValueError, match="rmsprop"):
        trainer.make_optimizer(make_config("badnets", optimizer="rmsprop"), [torch.zeros(2)])
    with pytest.raises(ValueError, match="rmsprop"):
        trainer.train_attack(make_config("badnets", optimizer="rmsprop", device="cpu"), None, None, None)


# ---------------------------------------------------------------------------
# (b) three sgd_momentum steps, (c) one step from carried optimizer state


def test_three_sgd_momentum_steps_match_optax(setup):
    jmodel, variables, batches = setup
    cfg = make_config("badnets", optimizer="sgd_momentum", learning_rate=LR)
    tx = jax_trainer.make_optimizer(jax_make_config("badnets", optimizer="sgd_momentum", learning_rate=LR))
    state, losses_j = _jax_steps(jmodel, TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx), tx,
                                 batches)

    model = _port_model(variables)
    opt = trainer.make_optimizer(cfg, model.parameters())
    assert isinstance(opt, SGD) and (opt.lr, opt.momentum) == (LR, 0.9)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [_port_step(model, opt, b) for b in batches]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    final = _carried(state)
    for name, p in model.named_parameters():
        moved, want = (p.detach() - start[name]).numpy(), (final[name] - start[name]).numpy()
        assert _rel(moved, want) < 1e-4, name


@pytest.mark.parametrize("optimizer", ["adam", "sgd_momentum"])
def test_step_from_carried_optimizer_state(setup, optimizer):
    """Two JAX steps, then the optax state carried into the port's optimizer
    (conv kernels HWIO → OIHW, dense kernels transposed, in the model's
    parameter order) and one more step on each side from the same state."""
    jmodel, variables, batches = setup
    jcfg = jax_make_config("badnets", optimizer=optimizer, learning_rate=LR)
    tx = jax_trainer.make_optimizer(jcfg)
    state, _ = _jax_steps(jmodel, TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx), tx,
                          batches[:2])
    after_two = _carried(state)
    model = SmallCNN(10, 3072, dropout_rates=(0.0, 0.0))
    model.load_state_dict(after_two)
    model.train()
    opt = trainer.make_optimizer(make_config("badnets", optimizer=optimizer, learning_rate=LR), model.parameters())
    names = [n for n, _ in model.named_parameters()]
    opt.load_state_dict(opt_state_from_flax("smallcnn", state.opt_state, names))
    if optimizer == "adam":
        assert opt.count == 2 and len(opt.mu) == len(names)
        assert all(m.shape == p.shape for m, p in zip(opt.mu + opt.nu, opt.params * 2))
        # the first moment of conv1's kernel, in the port's layout, is the flax one transposed
        flax_mu = np.asarray(state.opt_state[0].mu["TorchConv_0"]["Conv_0"]["kernel"])
        assert np.array_equal(opt.mu[names.index("conv1.weight")].numpy(), np.transpose(flax_mu, (3, 2, 0, 1)))
    final, loss_j = _jax_steps(jmodel, state, tx, batches[2:])  # donates ``state``
    loss = _port_step(model, opt, batches[2])
    np.testing.assert_allclose(loss, loss_j[0], rtol=1e-5)
    want = _carried(final)
    for name, p in model.named_parameters():
        if optimizer == "adam":
            assert np.max(np.abs(p.detach().numpy() - want[name].numpy())) <= 0.25 * LR, name
        else:
            moved, ref = (p.detach() - after_two[name]).numpy(), (want[name] - after_two[name]).numpy()
            assert _rel(moved, ref) < 1e-4, name


def test_optimizer_state_dict_round_trip_and_placement():
    params = [torch.randn(3, 2), torch.randn(4)]
    opt = Adam(params, 0.1)
    opt.step([torch.ones(3, 2), torch.ones(4)])
    other = Adam([p.clone() for p in params], 0.1)
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and all(torch.equal(a, b) for a, b in zip(other.mu + other.nu, opt.mu + opt.nu))
    assert other.mu[0] is not opt.mu[0]
    with pytest.raises(ValueError, match="shaped"):
        Adam([torch.zeros(2)], 0.1).load_state_dict({"mu": [torch.zeros(3)], "nu": [torch.zeros(3)], "count": 1})
    sgd = SGD(params, 0.1)
    sgd.step([torch.ones(3, 2), torch.ones(4)])
    twin = SGD([p.clone() for p in params], 0.1)
    twin.load_state_dict(sgd.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(twin.trace, sgd.trace))


# ---------------------------------------------------------------------------
# (d) save → resume, (e) a checkpoint without optimizer state, a killed run


@pytest.fixture(scope="module")
def poisoned():
    cfg = make_config("badnets", result="resume_test", num_epochs=4, batch_size=64, learning_rate=1e-3, device="cpu")
    clean = make_synthetic_clean_data(cfg, n_per_class=16)
    return cfg, badnets.poison(cfg, clean, save=False)


def _train(cfg, data, **kw):
    return trainer.train_attack(cfg, data.bd_train, data.clean_test, data.bd_test, verbose=False, **kw)


def test_save_then_resume_round_trip(poisoned, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg, data = poisoned
    r1 = _train(cfg, data)
    h = r1.history
    monitored = 0.5 * (np.array(h["test_clean_loss"]) + np.array(h["test_bd_loss"]))
    best_epoch = int(np.argmin(monitored)) + 1
    steps_per_epoch = -(-len(data.bd_train) // cfg.train.batch_size)
    saved_model, spec = load_checkpoint(cfg.record_dir)
    saved = load_train_state(cfg.record_dir)
    assert saved["step"] == steps_per_epoch * best_epoch and saved["optimizer"]["count"] == saved["step"]
    assert spec["batch_size"] == 64 and len(r1.checkpoint_walls) >= 1
    assert not [f for f in os.listdir(checkpoint_dir(cfg.record_dir)) if f.endswith(".tmp")]

    # Resumed with no epoch to run: exactly the saved tensors and step.
    capsys.readouterr()
    r0 = trainer.train_attack(make_config("badnets", result="resume_test", num_epochs=0, batch_size=64,
                                          learning_rate=1e-3, device="cpu"),
                              data.bd_train, data.clean_test, data.bd_test, save=False, resume=True)
    assert f"resumed from step {saved['step']}" in capsys.readouterr().out
    assert r0.step == saved["step"] and r0.optimizer.count == saved["step"]
    state = r0.model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in saved_model.items())
    for got, want in zip(r0.optimizer.mu + r0.optimizer.nu, saved["optimizer"]["mu"] + saved["optimizer"]["nu"]):
        assert torch.equal(got, want)

    # tests/test_resume.py's criterion on the first resumed epoch's loss.
    r2 = _train(cfg, data, resume=True)
    assert r2.history["train_loss"][0] < h["train_loss"][0] * 0.6
    assert r2.history["train_loss"][0] < h["train_loss"][-1] * 2.0
    assert r2.step == saved["step"] + steps_per_epoch * r2.epochs_ran


def test_resume_without_train_state_raises_and_missing_dir_is_cold(poisoned, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg, data = poisoned
    one = make_config("badnets", result="resume_test", num_epochs=1, batch_size=64, device="cpu")
    r = _train(one, data, resume=True)  # no checkpoint yet: a cold start
    assert r.step == -(-len(data.bd_train) // 64) and "resumed" not in capsys.readouterr().out
    os.remove(os.path.join(checkpoint_dir(one.record_dir), "train_state.pt"))
    with pytest.raises(FileNotFoundError, match="train_state.pt"):
        _train(one, data, resume=True)


def test_killed_run_leaves_its_last_best_checkpoint(poisoned, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg, data = poisoned
    calls = []
    real = trainer.run_train_epoch

    def dies_in_epoch_2(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*args, **kw)

    monkeypatch.setattr(trainer, "run_train_epoch", dies_in_epoch_2)
    with pytest.raises(KeyboardInterrupt):
        _train(cfg, data)
    saved = load_train_state(cfg.record_dir)
    assert saved["step"] == -(-len(data.bd_train) // 64) and load_checkpoint(cfg.record_dir)[1]["model"] == "smallcnn"
    assert sorted(os.listdir(checkpoint_dir(cfg.record_dir))) == ["model.pt", "model_spec.json", "train_state.pt"]


# ---------------------------------------------------------------------------
# (f) --profile_dir


def test_profile_dir_traces_epochs_one_and_two(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port_main(["badnets", "--synthetic", "--synthetic_per_class", "4", "--num_epochs", "3", "--batch_size", "16",
               "--device", "cpu", "--profile_dir", "prof", "--result", "prof_test"])
    files = sorted(os.listdir("prof"))
    assert len(files) == 2 and files[0].startswith("rank0.") and files[0].endswith(".pt.trace.json")
    assert files[1] == files[0].replace(".pt.trace.json", ".spans.json")

    def load(name):
        with open(os.path.join("prof", name)) as f:
            return json.load(f)

    trace, spans = map(load, files)
    # The spans of epochs 1 and 2 (not 3), on the trace's time base: every
    # convolution the trace holds starts inside one of them (1 ms of slack).
    epochs = [e for e in spans["traceEvents"] if e["name"] == "epoch"]
    assert len(epochs) == 2 and spans["baseTimeNanoseconds"] == trace.get("baseTimeNanoseconds", 0)
    convs = [e["ts"] for e in trace["traceEvents"] if e.get("name") == "aten::conv2d"]
    assert convs and all(any(e["ts"] - 1e3 <= t <= e["ts"] + e["dur"] + 1e3 for e in epochs) for t in convs)
    children = [[c["name"] for c in spans["traceEvents"] if c["args"]["parent"] == e["args"]["index"]] for e in epochs]
    assert children == [["train_epoch", "eval_epoch", "eval_epoch"]] * 2


# ---------------------------------------------------------------------------
# (g) train_clean


def test_train_clean_history_matches_jax(setup, monkeypatch):
    """Shared weights, dropout off on both sides: the same shuffles
    (np_rng(seed, "clean_shuffle")), losses, accuracies and early stop."""
    _, variables, _ = setup
    rng = np.random.default_rng(8)
    feats = (rng.standard_normal((60, 1, 101, 40)) * 8.0).astype(np.float32)
    labels = rng.integers(0, 10, 60)
    cfg = make_config("badnets", batch_size=16, device="cpu")  # lr 1e-4, the default
    jcfg = jax_make_config("badnets", batch_size=16)
    monkeypatch.setattr(jax_trainer, "jit_init", lambda *a, **k: jax.tree_util.tree_map(jnp.asarray, variables))
    with nn.intercept_methods(_no_dropout):
        _, _, want = jax_trainer.train_clean(jcfg, JaxArraySet(feats[:40], labels[:40]),
                                             JaxArraySet(feats[40:], labels[40:]), max_epochs=6, patience=2,
                                             verbose=False)
    model, best, got = trainer.train_clean(cfg, ArraySet(feats[:40], labels[:40]), ArraySet(feats[40:], labels[40:]),
                                           model=_port_model(variables), max_epochs=6, patience=2, verbose=False)
    assert len(got["val_loss"]) == len(want["val_loss"])
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    for key in ("train_acc", "val_acc"):
        assert got[key] == want[key], key
    assert set(best) == set(model.state_dict())


def test_train_clean_builds_its_own_model():
    rng = np.random.default_rng(9)
    feats = (rng.standard_normal((24, 1, 101, 40)) * 8.0).astype(np.float32)
    cfg = make_config("badnets", batch_size=8, device="cpu", optimizer="sgd_momentum")
    model, best, history = trainer.train_clean(cfg, ArraySet(feats[:16], rng.integers(0, 10, 16)),
                                               ArraySet(feats[16:], rng.integers(0, 10, 8)), max_epochs=2,
                                               verbose=False)
    assert len(history["train_loss"]) == 2 and all(np.isfinite(history["val_loss"]))
    fresh = trainer.build_attack_model(cfg, CPU, init_stream="clean_params")
    assert not torch.equal(fresh.fc2.weight, model.fc2.weight)  # trained from the clean_params draw
    assert set(best) == set(model.state_dict())
