"""The port's FlowMur against the JAX package on the same inputs.

Deterministic stages must agree: the host rows, the poison draws (chosen
rows, positions), indicators, labels and the half-blend test clips exactly
(both draw from the same numpy streams); injected waveforms to 1e-6 (the
per-clip norms are f32 sums taken in another order); MFCC-derived arrays
within the MFCC tolerance (rtol 1e-4, atol 1e-3, as tests/test_pallas_mfcc.py).

The trigger search is held against ``jax.value_and_grad`` of the JAX
package's own pieces (deploy → clip → mfcc_features → model.apply in eval
mode) from flax surrogate weights carried over with models.convert, the
port's block 1 unfused and fused (the fused op's plain dx on the CPU, what
kernel C computes on the card). Loss rtol 1e-5; d loss / d trigger within
1e-4 of its largest entry (f32 through a 2048-point matrix STFT, a log and
three conv blocks, sums in another order). Adam steps: triggers within 1e-2
lr. A step is lr·m̂/(√v̂+ε), about ±lr per entry at the first step whatever
the gradient's size, so the entries whose gradient is small relative to its
own rounding differences set the bound (~1e-3 lr measured, 1 entry in 8000;
the rest within 2e-4 lr).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiobd_tpu.configs import make_config as jax_make_config
from audiobd_tpu.data.speech_commands import make_synthetic_clean_data as jax_synthetic
from audiobd_tpu.data.speech_commands import mfcc_params as jax_mfcc_params
from audiobd_tpu.dsp import mfcc_features as jax_mfcc_features
from audiobd_tpu.models import build_model as jax_build_model
from audiobd_tpu.models import jit_init
from audiobd_tpu.poison import flowmur as jflow
from audiobd_tpu.utils.random import np_rng as jax_np_rng
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.data.speech_commands import CleanData, make_synthetic_clean_data, mfcc_params
from audiobd_tpu_torch.models import SmallCNN
from audiobd_tpu_torch.models.convert import smallcnn_from_flax
from audiobd_tpu_torch.poison import flowmur as port
from audiobd_tpu_torch.train.checkpoint import load_checkpoint
from audiobd_tpu_torch.train.ensemble import train_member
from audiobd_tpu_torch.train.state import Adam
from audiobd_tpu_torch.utils.random import np_rng

T, L, TARGET, SNR = 16000, 8000, 2, 30.0
MFCC_TOL = dict(rtol=1e-4, atol=1e-3)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wavs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, T)) * 0.1).astype(np.float32), rng.integers(0, T - L + 1, size=n)


@pytest.mark.parametrize("fn", ["deploy", "inject_snr", "inject_half"])
def test_trigger_placement_matches_jax(fn):
    wavs, pos = _wavs(0, 5)
    trig = (np.random.default_rng(1).standard_normal(L) * 0.05).astype(np.float32)
    t = torch.from_numpy
    if fn == "deploy":
        got = port.deploy_trigger(t(wavs), t(trig), t(pos), snr_db=SNR)
        ref = jflow.deploy_trigger(jnp.asarray(wavs), jnp.asarray(trig), jnp.asarray(pos), snr_db=SNR)
    elif fn == "inject_snr":
        got = port._inject_snr(t(wavs[:, None]), t(trig[None]), t(pos), SNR)
        ref = jflow._inject_snr(wavs[:, None], trig[None], pos, SNR)
    else:
        got = port._inject_half(t(wavs[:, None]), t(trig[None]), t(pos))
        ref = jflow._inject_half(wavs[:, None], trig[None], pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def poisoned(tmp_path_factory):
    """Both packages' synthetic clean set (8 clips a class) and poison() of
    it with one trigger, npy files saved; poisoning rate 0.5 so that the
    train split has injected rows."""
    trigger = (0.1 * np.sin(np.arange(L) / 7.0)).astype(np.float32)[None]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("port"))
        cfg = make_config("flowmur", device="cpu", poisoning_rate=0.5)
        clean = make_synthetic_clean_data(cfg, n_per_class=8)
        out["port"] = (cfg, clean, port.poison(cfg, clean, trigger), os.path.abspath(cfg.record_dir))
        mp.chdir(tmp_path_factory.mktemp("jax"))
        jcfg = jax_make_config("flowmur", poisoning_rate=0.5)
        jclean = jax_synthetic(jcfg, n_per_class=8)
        jflow.poison(jcfg, jclean, trigger)
        out["jax"] = (jcfg, jclean, os.path.abspath(jcfg.record_dir))
    return out


def _bd(root, name):
    return np.load(os.path.join(root, "SCDv1-10", "bd", name + ".npy"))


def test_hosts_match_jax(poisoned):
    cfg, clean, _, _ = poisoned["port"]
    jcfg, jclean, _ = poisoned["jax"]
    np.testing.assert_array_equal(clean.train_wav, jclean.train_wav)
    for n_hosts in (10, 5000):
        np.testing.assert_array_equal(port.select_trigger_hosts(cfg, clean, n_hosts),
                                      jflow.select_trigger_hosts(jcfg, jclean, n_hosts))


def test_poison_draws_match_jax_streams(poisoned):
    """The chosen rows and positions are the JAX package's draws: the same
    stream, drawn in the same order (choice, train positions, test positions)."""
    cfg, clean, out, _ = poisoned["port"]
    rng = jax_np_rng(35, "flowmur_poison")
    target_rows = np.flatnonzero(clean.train_label == TARGET)
    chosen = rng.choice(target_rows, size=int(len(target_rows) * 0.5), replace=False)
    assert len(chosen) > 0
    np.testing.assert_array_equal(out.chosen, chosen)
    np.testing.assert_array_equal(out.train_positions, rng.integers(0, T - L + 1, size=len(chosen)))
    n_test = int((clean.test_label != TARGET).sum())
    np.testing.assert_array_equal(out.test_positions, rng.integers(0, T - L + 1, size=n_test))


@pytest.mark.parametrize("name", ["poison_index_train", "poison_index_test", "bd_train_label", "bd_test_label",
                                  "bd_test_wav"])
def test_poison_arrays_identical(poisoned, name):
    np.testing.assert_array_equal(_bd(poisoned["port"][3], name), _bd(poisoned["jax"][2], name))


def test_poison_train_waveforms_and_indicator(poisoned):
    _, clean, out, root = poisoned["port"]
    got, ref = _bd(root, "bd_train_wav"), _bd(poisoned["jax"][2], "bd_train_wav")
    untouched = np.setdiff1d(np.arange(len(got)), out.chosen)
    np.testing.assert_array_equal(got[untouched], clean.train_wav[untouched])
    np.testing.assert_array_equal(got[untouched], ref[untouched])
    np.testing.assert_allclose(got[out.chosen], ref[out.chosen], rtol=0, atol=1e-6)
    assert not np.array_equal(got[out.chosen], clean.train_wav[out.chosen])
    # Quirk 6b.6: the indicator marks every target-class row, injected or not.
    np.testing.assert_array_equal(out.bd_train.indicators, (clean.train_label == TARGET).astype(np.int64))


@pytest.mark.parametrize("name", ["bd_train_mfcc", "bd_test_mfcc"])
def test_poison_features_within_mfcc_tolerance(poisoned, name):
    a, b = _bd(poisoned["port"][3], name), _bd(poisoned["jax"][2], name)
    assert a.shape == b.shape and a.shape[1:] == (1, 32, 13)
    np.testing.assert_allclose(a, b, **MFCC_TOL)


@pytest.mark.parametrize("suffix", ["", "_r1"])
def test_search_permutations_match_jax(suffix):
    """Two epochs of batches from the search's shuffle stream: the JAX
    package's perm[:usable].reshape(n_batches, bs) on the same stream."""
    n, bs = 50, 16
    mine, ref = np_rng(35, "flowmur_trigger_shuffle" + suffix), jax_np_rng(35, "flowmur_trigger_shuffle" + suffix)
    for _ in range(2):
        np.testing.assert_array_equal(port.trigger_batches(mine, n, bs), ref.permutation(n)[:48].reshape(3, bs))


@pytest.fixture(scope="module")
def surrogate():
    """A JAX SmallCNN at FlowMur's widths (input (1, 32, 13), linear 224)
    with random running statistics, and the JAX search's batch loss."""
    jmodel = jax_build_model("smallcnn", 10, 224)
    variables = jax.tree_util.tree_map(
        np.asarray, jit_init(jmodel, jax.random.PRNGKey(0), np.zeros((1, 1, 32, 13), np.float32)))
    rng = np.random.default_rng(4)
    stats = {k: {"BatchNorm_0": {"mean": (rng.standard_normal(v["BatchNorm_0"]["mean"].shape) * 0.3).astype(np.float32),
                                 "var": (0.5 + rng.random(v["BatchNorm_0"]["var"].shape)).astype(np.float32)}}
             for k, v in variables["batch_stats"].items()}
    variables = {"params": variables["params"], "batch_stats": stats}
    params = jax_mfcc_params(jax_make_config("flowmur"))

    def batch_loss(trigger, wavs, positions):
        mixed = jnp.clip(jflow.deploy_trigger(wavs, trigger, positions, snr_db=SNR), -1.0, 1.0)
        logits = jmodel.apply(variables, jax_mfcc_features(mixed, params), train=False)
        labels = jnp.full((wavs.shape[0],), TARGET, jnp.int32)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    return variables, jax.jit(jax.value_and_grad(batch_loss))


def _port_surrogate(variables, fused):
    model = SmallCNN(10, 224, fused_block1=fused)
    model.load_state_dict(smallcnn_from_flax(variables))
    for p in model.parameters():
        p.requires_grad_(False)
    return model.eval()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


@pytest.mark.parametrize("fused", [False, True])
def test_search_loss_and_gradient_match_jax(surrogate, fused):
    variables, value_and_grad = surrogate
    wavs, pos = _wavs(5, 4)
    trig = np.random.default_rng(6).uniform(-0.2, 0.2, L).astype(np.float32)
    loss_j, grad_j = value_and_grad(jnp.asarray(trig), jnp.asarray(wavs), jnp.asarray(pos))
    trigger = torch.from_numpy(trig).requires_grad_(True)
    loss = port.trigger_loss(_port_surrogate(variables, fused), trigger, torch.from_numpy(wavs),
                             torch.from_numpy(pos), mfcc_params(make_config("flowmur")), TARGET, SNR)
    (grad,) = torch.autograd.grad(loss, trigger)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert _rel(grad.numpy(), grad_j) < 1e-4


@pytest.mark.parametrize("rule,steps", [("per_batch", 1), ("accumulated", 3)])
def test_search_steps_match_optax(surrogate, rule, steps):
    """Adam in optax's formula on the (L,) trigger and the ±0.2 clamp after
    each step; the accumulated rule steps on the prefix sum of gradients,
    each evaluated at the trigger its batch ran with. The start is uniform
    in ±0.2, so the clamp binds."""
    variables, value_and_grad = surrogate
    trig0 = np.random.default_rng(8).uniform(-0.2, 0.2, L).astype(np.float32)
    batches = [_wavs(10 + i, 4) for i in range(steps)]

    tx = optax.adam(LR)
    trig, state, gsum = jnp.asarray(trig0), tx.init(jnp.asarray(trig0)), jnp.zeros(L)
    for wavs, pos in batches:
        _, g = value_and_grad(trig, jnp.asarray(wavs), jnp.asarray(pos))
        gsum = gsum + g
        updates, state = tx.update(gsum if rule == "accumulated" else g, state, trig)
        trig = jnp.clip(optax.apply_updates(trig, updates), -0.2, 0.2)

    cfg = make_config("flowmur", device="cpu", flowmur_update=rule)
    model = _port_surrogate(variables, fused=True)
    trigger = torch.from_numpy(trig0.copy()).requires_grad_(True)
    opt = Adam([trigger], LR)
    grad_sum = torch.zeros(L) if rule == "accumulated" else None
    for wavs, pos in batches:
        port.trigger_step(model, opt, torch.from_numpy(wavs), torch.from_numpy(pos), mfcc_params(cfg), cfg, grad_sum)
    got = trigger.detach().numpy()
    assert np.abs(got).max() <= 0.2 and (np.abs(got) == 0.2).any()
    np.testing.assert_allclose(got, np.asarray(trig), rtol=0, atol=1e-2 * LR)


def test_surrogate_members_reproduce_solo_runs(tmp_path, monkeypatch):
    """pretrain_surrogate's member i equals a solo train_member run with
    member i's generators and shuffle stream; members differ; each member's
    checkpoint holds its best state, and the returned surrogate is the last."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(12)
    feats = (rng.standard_normal((40, 1, 32, 13)) * 8.0).astype(np.float32)
    labels = np.arange(40) % 10
    clean = CleanData(np.zeros((40, 1, 4), np.float32), np.zeros((0, 1, 4), np.float32), feats,
                      feats[:0], labels, labels[:0])
    cfg = make_config("flowmur", device="cpu", batch_size=16)
    model, results = port.pretrain_surrogate(cfg, clean, runs=2, max_epochs=3, verbose=False)
    dev = torch.device("cpu")
    train_set, val_set = port.surrogate_datasets(cfg, clean, dev)
    solo = train_member(port.build_surrogate(cfg, 1, dev), train_set, val_set, np_rng(35, "surrogate_shuffle_1"),
                        lr=port.SURROGATE_LR, batch_size=16, max_epochs=3, patience=port.SURROGATE_PATIENCE)
    assert solo.history == results[1].history and solo.epochs_to_best == results[1].epochs_to_best
    for k, v in solo.state.items():
        assert torch.equal(v, results[1].state[k]), k
    assert not torch.equal(results[0].state["conv1.weight"], results[1].state["conv1.weight"])
    for run, res in enumerate(results):
        state, spec = load_checkpoint(os.path.join(cfg.record_dir, "poisoning_record", f"surrogate_{run}"))
        assert spec["feature_size"] == 224 and all(torch.equal(state[k], v) for k, v in res.state.items())
    assert all(torch.equal(v, results[1].state[k]) for k, v in model.state_dict().items())


def test_cli_writes_the_record_tree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = port_main(["flowmur", "--synthetic", "--synthetic_per_class", "4", "--surrogate_epochs", "2",
                     "--opt_epochs", "2", "--num_epochs", "2", "--device", "cpu"])
    assert run.trigger.shape == (1, L) and np.abs(run.trigger).max() <= 0.2 and not np.allclose(run.trigger, 0.1)
    assert len(run.surrogates) == 3 and len(run.trigger_losses) == 2 and run.victim.epochs_ran == 2
    losses = run.trigger_losses + [v for m in run.surrogates for v in m.history["train_loss"] + m.history["val_loss"]]
    assert all(np.isfinite(v) for v in losses + run.victim.history["train_loss"])
    assert set(run.stages) == {"prep", "surrogates", "trigger", "poison", "victim"}
    rec = os.path.join("record", "flowmur_smallcnn")
    for sub, names in (("clean", ["clean_train_wav", "clean_test_mfcc"]),
                       ("bd", ["bd_train_wav", "bd_train_mfcc", "bd_test_mfcc", "poison_index_train"])):
        for name in names:
            assert os.path.exists(os.path.join(rec, "SCDv1-10", sub, name + ".npy")), name
    for run_dir in ("surrogate_0", "surrogate_1", "surrogate_2"):
        load_checkpoint(os.path.join(rec, "poisoning_record", run_dir))
    for csv in ("loss_result.csv", "acc_result.csv"):
        with open(os.path.join(rec, csv)) as f:
            assert len(f.read().strip().splitlines()) == 3
    state_dict, spec = load_checkpoint(rec)
    model = SmallCNN(spec["num_classes"], spec["feature_size"])
    model.load_state_dict(state_dict)
    with torch.no_grad():
        assert torch.isfinite(model.eval()(torch.from_numpy(np.load(
            os.path.join(rec, "SCDv1-10", "bd", "bd_test_mfcc.npy"))))).all()


def test_cli_without_cuda_or_device_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["flowmur", "--synthetic", "--synthetic_per_class", "1", "--opt_epochs", "1"])


def test_flowmur_config_preset():
    cfg, jcfg = make_config("flowmur"), jax_make_config("flowmur")
    assert (cfg.dsp.n_fft, cfg.dsp.hop_length, cfg.dsp.n_mfcc) == (2048, 512, 13)
    for key in ("model", "trigger_duration", "snr_db", "flowmur_opt_epochs", "flowmur_opt_lr", "flowmur_clamp",
                "flowmur_update", "flowmur_restarts", "flowmur_probe_epochs", "surrogate_runs",
                "surrogate_epochs", "result"):
        assert getattr(cfg, key) == getattr(jcfg, key), key
