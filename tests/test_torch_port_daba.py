"""The port's DABA attack against the JAX package's, on the CPU.

Bit-equal (numpy draws and numpy code): the variant gains, the synthesized
trigger pool, its wav files and their names, the pool read back, the host
candidates, and, with the JAX victim's weights carried into the port's
SmallCNN (``models/convert.py::smallcnn_from_flax``; the port draws its own
victim from ``torch_generator(seed, "daba_victim")`` by design), the chosen
trigger and hosts, the labels, the indicators and the export's file names.

Tolerances: ``dbfs`` and ``overlay_db`` atol 1e-6 (f32 means summed in
another order; every ``po_db`` form, saturation at both ends); the victim's
softmax, ``cer_scores`` and ``inf_scores`` rtol 1e-5 (the MFCC's products
and the model's sums in another order); the overlaid waveforms atol 1e-6;
their MFCCs rtol 1e-4, atol 1e-3 (tests/test_pallas_mfcc.py's MFCC
tolerance). Host selection compares influence scores whose gap at the
``poison_num``-th place is printed: a gap below the scores' tolerance would
make the order a tie of the frameworks' rounding (none is: measured 2.4e-4
and 1.8e-4 relative in the two modes, and the test asserts the gap).

The CLI runs on the CPU and writes the eight bd npys, ``trigger.wav`` and a
checkpoint; ``configs/daba.yaml`` loads unchanged (``po_db: -20`` an int,
``poison_label`` read by no code); ``fp`` runs on the DABA record, whose
(1, 32, 40) input is the only model shape besides FlowMur's that differs
from BadNets'.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.configs import make_config as jax_make_config
from audiobd_tpu.data.speech_commands import make_synthetic_clean_data as jax_synthetic
from audiobd_tpu.poison import daba as jdaba
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.configs import config_from_yaml, make_config
from audiobd_tpu_torch.data.speech_commands import CleanData
from audiobd_tpu_torch.data.wavio import write_wav
from audiobd_tpu_torch.models import SmallCNN
from audiobd_tpu_torch.models.convert import smallcnn_from_flax
from audiobd_tpu_torch.poison import daba as port
from audiobd_tpu_torch.train.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MFCC_TOL = dict(rtol=1e-4, atol=1e-3)
SCORE_RTOL = 1e-5
BD_FILES = ("bd_train_wav", "bd_test_wav", "bd_train_mfcc", "bd_test_mfcc", "bd_train_label", "bd_test_label",
            "poison_index_train", "poison_index_test")
SMALL = dict(host_candidates=40, poisoning_rate=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_assets(tmp_path_factory, monkeypatch):
    """Neither package may find a trigger pool outside the test."""
    monkeypatch.setenv("AUDIOBD_RESOURCES", str(tmp_path_factory.mktemp("no_resources")))


def _clips(n, t=16000, seed=0, peak=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t)) * np.linspace(0.05, 1.0, n)[:, None]
    return (peak * x / np.abs(x).max()).astype(np.float32)


@pytest.mark.parametrize("po_db", [-20.0, -20, 0.0, "auto", "keep", "per host"])
def test_dbfs_and_overlay_match_jax(po_db):
    host = _clips(5, seed=1, peak=0.9)
    trig = _clips(1, seed=2)[0]
    if po_db == "per host":
        po_db = np.array([0.0, -5.0, -20.0, 6.0, -40.0], np.float32)  # 6 dB over saturates
    arg = torch.from_numpy(po_db) if isinstance(po_db, np.ndarray) else po_db
    np.testing.assert_allclose(port.dbfs(torch.from_numpy(host)).numpy(), np.asarray(jdaba.dbfs(jnp.asarray(host))),
                               rtol=0, atol=1e-6)
    got = port.overlay_db(torch.from_numpy(host), torch.from_numpy(trig), arg).numpy()
    ref = np.asarray(jdaba.overlay_db(jnp.asarray(host), jnp.asarray(trig), po_db))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.max() <= 32767.0 / 32768.0 and got.min() >= -1.0


def test_overlay_saturates_at_both_ends():
    host = np.full((2, 100), 0.9, np.float32) * np.array([[1.0], [-1.0]], np.float32)
    trig = np.full(100, 0.5, np.float32) * np.where(np.arange(100) % 2, 1.0, -1.0).astype(np.float32)
    got = port.overlay_db(torch.from_numpy(host), torch.from_numpy(trig), 10.0).numpy()
    ref = np.asarray(jdaba.overlay_db(jnp.asarray(host), jnp.asarray(trig), 10.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.max() == np.float32(32767.0 / 32768.0) and got.min() == -1.0
    with pytest.raises(ValueError):
        port.overlay_db(torch.from_numpy(host), torch.from_numpy(trig), "loud")


@pytest.mark.parametrize("n,seed", [(1, 35), (90, 35), (1600, 7)])
def test_variant_gains_equal_jax(n, seed):
    got = port.gen_trigger_variants_db(n, seed)
    np.testing.assert_array_equal(got, jdaba.gen_trigger_variants_db(n, seed))
    assert got.dtype == np.float32


def test_trigger_pool_and_its_files_equal_jax(tmp_path):
    got = port.synthesize_trigger_pool(str(tmp_path / "port"))
    ref = jdaba.synthesize_trigger_pool(str(tmp_path / "jax"))
    assert got.shape == (60, 16000) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and names[0] == "music00_0.wav" and len(names) == 60
    for name in names[:: 7]:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    loaded = port.load_trigger_pool(str(tmp_path / "port"))
    np.testing.assert_array_equal(loaded, jdaba.load_trigger_pool(str(tmp_path / "jax")))
    np.testing.assert_allclose(loaded, got, atol=1.0 / 32768)
    np.testing.assert_array_equal(port.synthesize_trigger_pool(None), got)


def test_trigger_pool_dir_prefers_an_asset(tmp_path, monkeypatch):
    cfg = make_config("daba", result="r")
    assert port.resolve_trigger_pool_dir(cfg) == os.path.join("record", "r", "resources", "DABA", "trigger_pool")
    pool = tmp_path / "assets" / "DABA" / "trigger_pool"
    pool.mkdir(parents=True)
    write_wav(str(pool / "a.wav"), np.zeros(16000, np.float32), 16000)
    monkeypatch.setenv("AUDIOBD_RESOURCES", str(tmp_path / "assets"))
    assert port.resolve_trigger_pool_dir(cfg) == str(pool) == jdaba.resolve_trigger_pool_dir(jax_make_config("daba"))
    write_wav(str(pool / "b.wav"), np.zeros(16000, np.float32), 8000)
    with pytest.raises(ValueError, match="8000 Hz"):
        port.load_trigger_pool(str(pool))


@pytest.fixture(scope="module")
def victim():
    """The JAX package's untrained victim (its seed's threefry init) carried
    into the port's SmallCNN, and the JAX scorer's softmax."""
    _, variables, softmax_fn = jdaba.make_victim_scorer(jax_make_config("daba"))
    model = SmallCNN(10, 896)
    model.load_state_dict(smallcnn_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return model, softmax_fn


def test_scorer_cer_and_inf_match_jax(victim):
    model, jax_softmax = victim
    cfg = make_config("daba", device="cpu")
    built, softmax_fn = port.make_victim_scorer(cfg, model)
    assert built is model and not model.training
    pool = port.synthesize_trigger_pool(None)[:12]
    got = softmax_fn(torch.from_numpy(pool)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_softmax(jnp.asarray(pool))), rtol=SCORE_RTOL, atol=0)
    np.testing.assert_allclose(port.cer_scores(softmax_fn, pool), jdaba.cer_scores(jax_softmax, pool),
                               rtol=SCORE_RTOL)
    hosts = _clips(9, seed=3)
    got_inf = port.inf_scores(softmax_fn, pool[3], hosts, torch.device("cpu"), chunk=4)
    np.testing.assert_allclose(got_inf, jdaba.inf_scores(jax_softmax, pool[3], hosts, chunk=4), rtol=SCORE_RTOL)
    features = port.victim_features(torch.from_numpy(pool[:2]), cfg)
    assert features.shape == (2, 1, 32, 40)


def test_own_victim_is_seeded():
    cfg = make_config("daba", device="cpu")
    a, _ = port.make_victim_scorer(cfg)
    b, _ = port.make_victim_scorer(cfg)
    c, _ = port.make_victim_scorer(make_config("daba", device="cpu", seed=36))
    sa, sb, sc = (m.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa) and not torch.equal(sa["fc1.weight"], sc["fc1.weight"])
    assert sa["fc1.weight"].shape == (128, 896)


@pytest.fixture(scope="module")
def clean_arrays():
    data = jax_synthetic(jax_make_config("daba"), n_per_class=6)
    return {f: np.asarray(getattr(data, f)) for f in
            ("train_wav", "test_wav", "train_mfcc", "test_mfcc", "train_label", "test_label")}


@pytest.mark.parametrize("mode", ["Cer&Inf", "Cer"])
def test_selection_equals_jax(victim, clean_arrays, mode):
    model, jax_softmax = victim
    cfg = make_config("daba", device="cpu", trigger_selection_mode=mode)
    pool = port.synthesize_trigger_pool(None)
    hosts = clean_arrays["train_wav"][:30, 0]
    got = port.select_trigger_and_hosts(cfg, pool, hosts, 5, victim=model)
    ref = jdaba.select_trigger_and_hosts(jax_make_config("daba", trigger_selection_mode=mode), pool, hosts, 5)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])
    inf = np.sort(jdaba.inf_scores(jax_softmax, pool[ref[0]], hosts))
    edge = 4 if mode == "Cer&Inf" else len(inf) - 5
    gap = abs(inf[edge + 1] - inf[edge]) / abs(inf[edge])
    print(f"{mode}: trigger #{got[0]}, hosts {got[1].tolist()}; relative gap at the cut {gap:.3e}")
    assert gap > SCORE_RTOL


def _poison_both(tmp_path, arrays, model):
    out = []
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            if pkg == "port":
                cfg = make_config("daba", result="daba_test", device="cpu", **SMALL)
                res = port.poison(cfg, CleanData(**arrays), export_wav_tree=True, victim=model)
            else:
                cfg = jax_make_config("daba", result="daba_test", **SMALL)
                res = jdaba.poison(cfg, jdaba.CleanData(**arrays), export_wav_tree=True)
            record = os.path.join("record", "daba_test")
            bd = os.path.join(record, "SCDv1-10", "bd")
            tree = sorted(os.path.relpath(os.path.join(r, f), record) for r, _, fs in os.walk(record)
                          for f in fs if f.endswith(".wav") and "resources" not in r)
            dirs = sorted(os.path.relpath(r, record) for r, _, _ in os.walk(os.path.join(record, "clean")))
            out.append(({n: np.load(os.path.join(bd, n + ".npy")) for n in BD_FILES}, res, tree, dirs,
                        (d / record / "trigger.wav").read_bytes()))
        finally:
            os.chdir(cwd)
    return out


def test_poison_equals_jax(tmp_path, victim, clean_arrays):
    (got, got_res, got_tree, got_dirs, got_trig), (ref, ref_res, ref_tree, ref_dirs, ref_trig) = _poison_both(
        tmp_path, clean_arrays, victim[0])
    assert got_res.trigger_index == ref_res.trigger_index and got_trig == ref_trig
    np.testing.assert_array_equal(got_res.trigger, ref_res.trigger)
    for name in BD_FILES:
        assert got[name].dtype == ref[name].dtype and got[name].shape == ref[name].shape, name
        if "wav" not in name and "mfcc" not in name:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    n_train = len(clean_arrays["train_label"])
    assert got["poison_index_train"].sum() == round(0.1 * n_train)
    for split in ("train", "test"):
        ind = got[f"poison_index_{split}"].astype(bool)
        assert ind.any() and not ind.all()
        wav, mfcc = got[f"bd_{split}_wav"], got[f"bd_{split}_mfcc"]
        np.testing.assert_array_equal(wav[~ind], clean_arrays[f"{split}_wav"][~ind])
        np.testing.assert_array_equal(mfcc[~ind], clean_arrays[f"{split}_mfcc"][~ind])
        np.testing.assert_allclose(wav[ind], ref[f"bd_{split}_wav"][ind], rtol=0, atol=1e-6)
        np.testing.assert_allclose(mfcc[ind], ref[f"bd_{split}_mfcc"][ind], **MFCC_TOL)
        np.testing.assert_array_equal(getattr(got_res, f"bd_{split}").feats.numpy(), mfcc)
    assert got_tree == ref_tree and got_dirs == ref_dirs
    assert sum(p.startswith(os.path.join("poison", "train", "up", "poison_")) for p in got_tree) == \
        got["poison_index_train"].sum()


def test_yaml_config_loads_unchanged():
    cfg = config_from_yaml(os.path.join(REPO, "configs", "daba.yaml"), attack="daba", device="cpu")
    assert (cfg.name, cfg.po_db, cfg.poison_label, cfg.trigger_selection_mode, cfg.variant, cfg.host_candidates,
            cfg.dsp.n_fft, cfg.dsp.hop_length, cfg.dsp.parity) == \
        ("daba", -20, "up", "Cer&Inf", True, 3000, 2048, 512, "librosa")
    assert config_from_yaml(os.path.join(REPO, "configs", "daba.yaml"), po_db=-10.0).po_db == -10.0


def test_cli_and_a_defense_on_its_record(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    run = port_main(["daba", "--synthetic", "--synthetic_per_class", "4", "--num_epochs", "2", "--batch_size",
                     "16", "--device", "cpu", "--variant", "false", "--po_db", "-10"])
    out = capsys.readouterr().out
    assert f"selected trigger #{run.trigger_index}; {run.n_poisoned} hosts poisoned" in out
    assert run.n_poisoned == round(0.1 * 32) and set(run.stages) == {"prep", "select", "poison", "train"}
    record = os.path.join("record", "daba_smallcnn")
    data = os.path.join(record, "SCDv1-10")
    files = [os.path.join(data, "bd", n + ".npy") for n in BD_FILES]
    files += [os.path.join(record, n) for n in ("trigger.wav", "loss_result.csv", "acc_result.csv")]
    assert not [f for f in files if not os.path.exists(f)]
    _, spec = load_checkpoint(record)
    assert (spec["attack"], spec["feature_size"]) == ("daba", 896)
    assert np.load(os.path.join(data, "bd", "bd_test_mfcc.npy")).shape[1:] == (1, 32, 40)

    result = port_main(["fp", "--device", "cpu", "--result", "daba_smallcnn", "--batch_size", "16"])
    assert 0.0 <= result.test_acc <= 100.0 and 0.0 <= result.test_asr <= 100.0
    assert os.path.exists(os.path.join(record, "defense", "fp", "pruning_data.csv"))
