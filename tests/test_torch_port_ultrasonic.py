"""The port's Ultrasonic attack against the JAX package's.

Exact (bit-equal): the synthesized trigger and the PCM16 file it is written
to, every (size, position, contiguity) mask, ``TriggerInfeasible`` and its
message, and, poisoning the same clean arrays on a small 44.1 kHz synthetic
set, the poison indicators, labels and bd waveforms, on the first run (the
trigger synthesized) and on the second (the trigger read back from its
PCM16 file, quantized). The poisoned rows' MFCCs are each package's own, so
they agree within rtol 1e-4, atol 1e-3 (tests/test_pallas_mfcc.py's MFCC
tolerance); the other rows are copied and bit-equal. Both packages look for
the genuine asset under an empty ``$AUDIOBD_RESOURCES`` and poison in their
own run directory, so each synthesizes its own trigger.

The CLI runs on the CPU (``--device cpu``) from ``--synthetic`` and from a
wav tree of 16 kHz clips, and writes its npys, CSVs and checkpoint; without
``--device`` and without CUDA it raises.
"""

import os

import numpy as np
import pytest
import torch

from audiobd_tpu.configs import make_config as jax_make_config
from audiobd_tpu.data.speech_commands import make_synthetic_clean_data as jax_synthetic
from audiobd_tpu.poison import ultrasonic as jult
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.configs import make_config
from audiobd_tpu_torch.data.speech_commands import CleanData
from audiobd_tpu_torch.data.wavio import write_wav
from audiobd_tpu_torch.models import build_model
from audiobd_tpu_torch.poison import ultrasonic as port
from audiobd_tpu_torch.train.checkpoint import load_checkpoint

MFCC_TOL = dict(rtol=1e-4, atol=1e-3)
BD_FILES = ("bd_train_wav", "bd_test_wav", "bd_train_mfcc", "bd_test_mfcc", "bd_train_label", "bd_test_label",
            "poison_index_train", "poison_index_test")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_assets(tmp_path_factory, monkeypatch):
    """Neither package may find a trigger asset outside the test."""
    monkeypatch.setenv("AUDIOBD_RESOURCES", str(tmp_path_factory.mktemp("no_resources")))


def test_synthesized_trigger_and_its_file_equal_jax(tmp_path):
    got = port.synthesize_trigger_wave(str(tmp_path / "port" / "t.wav"))
    ref = jult.synthesize_trigger_wave(str(tmp_path / "jax" / "t.wav"))
    assert got.shape == (1, 44100) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert (tmp_path / "port" / "t.wav").read_bytes() == (tmp_path / "jax" / "t.wav").read_bytes()


@pytest.mark.parametrize("cont", [True, False])
@pytest.mark.parametrize("pos", ["start", "mid", "end"])
@pytest.mark.parametrize("size", [1, 15, 30, 45, 60, 99, 100])
def test_trigger_masks_equal_jax(tmp_path, size, pos, cont):
    got = port.UltrasonicTrigger(size, pos, cont=cont, wave_path=str(tmp_path / "port.wav")).trigger()
    ref = jult.UltrasonicTrigger(size, pos, cont=cont, wave_path=str(tmp_path / "jax.wav")).trigger()
    assert got.dtype == np.float32 and got.shape == (1, 44100)
    np.testing.assert_array_equal(got, ref)
    assert np.count_nonzero(got) > 0


@pytest.mark.parametrize("size,pos", [(0, "start"), (101, "mid"), (-5, "end"), (50, "middle"), (60, "")])
def test_trigger_infeasible_equals_jax(tmp_path, size, pos):
    with pytest.raises(port.TriggerInfeasible) as got:
        port.UltrasonicTrigger(size, pos, wave_path=str(tmp_path / "t.wav"))
    with pytest.raises(jult.TriggerInfeasible) as ref:
        jult.UltrasonicTrigger(size, pos, wave_path=str(tmp_path / "t.wav"))
    assert str(got.value) == str(ref.value)
    assert "(0, 60]" in str(got.value)  # the reference's message quirk: the check is (0, 100]
    assert (got.value.size, got.value.pos) == (size, pos)


@pytest.fixture(scope="module")
def clean_arrays():
    """The JAX package's small 44.1 kHz synthetic clean set (4 clips a class)."""
    data = jax_synthetic(jax_make_config("ultrasonic"), n_per_class=4)
    return {f: np.asarray(getattr(data, f)) for f in
            ("train_wav", "test_wav", "train_mfcc", "test_mfcc", "train_label", "test_label")}


def _poison_both(tmp_path, arrays, run):
    """Poison the same clean arrays with each package in its own run
    directory (``run`` > 0 finds the trigger file the first run wrote).
    Returns ({name: port bd npy}, {name: JAX bd npy}, port trigger, JAX trigger)."""
    out = []
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            if pkg == "port":
                cfg = make_config("ultrasonic", result="ultra_test", device="cpu")
                res = port.poison(cfg, CleanData(**arrays))
            else:
                cfg = jax_make_config("ultrasonic", result="ultra_test")
                res = jult.poison(cfg, jult.CleanData(**arrays))
            bd = os.path.join("record", "ultra_test", "SCDv1-10", "bd")
            out.append(({n: np.load(os.path.join(bd, n + ".npy")) for n in BD_FILES}, res))
            assert os.path.exists(os.path.join("record", "ultra_test", "resources", "Ultrasonic", "trigger.wav"))
        finally:
            os.chdir(cwd)
    (got, got_res), (ref, ref_res) = out
    return got, ref, got_res, ref_res


def test_poison_equals_jax_on_the_first_and_second_run(tmp_path, clean_arrays):
    triggers = []
    for run in range(2):
        got, ref, got_res, ref_res = _poison_both(tmp_path, clean_arrays, run)
        np.testing.assert_array_equal(got_res.trigger, ref_res.trigger)
        triggers.append(got_res.trigger)
        for name in BD_FILES:
            assert got[name].dtype == ref[name].dtype and got[name].shape == ref[name].shape, name
            if "mfcc" not in name:
                np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        for split in ("train", "test"):
            ind = got[f"poison_index_{split}"].astype(bool)
            assert ind.any() and (split == "test" or not ind.all())
            mfcc, ref_mfcc = got[f"bd_{split}_mfcc"], ref[f"bd_{split}_mfcc"]
            np.testing.assert_array_equal(mfcc[~ind], clean_arrays[f"{split}_mfcc"][~ind])
            np.testing.assert_allclose(mfcc[ind], ref_mfcc[ind], **MFCC_TOL)
            assert not np.allclose(mfcc[ind], clean_arrays[f"{split}_mfcc"][ind])
            dev = getattr(got_res, f"bd_{split}").feats
            assert isinstance(dev, torch.Tensor)
            np.testing.assert_array_equal(dev.numpy(), mfcc)
        n_train = len(clean_arrays["train_label"])
        assert got["poison_index_train"].sum() == int(n_train * 0.1)
    # The second run reads back the PCM16 file the first one wrote.
    assert not np.array_equal(triggers[0], triggers[1])
    np.testing.assert_array_equal(triggers[1], np.round(triggers[0] * 32768.0) / 32768.0)


def test_poison_rejects_clips_not_at_44k(tmp_path, monkeypatch, clean_arrays):
    monkeypatch.chdir(tmp_path)
    arrays = dict(clean_arrays, train_wav=clean_arrays["train_wav"][..., :16000],
                  test_wav=clean_arrays["test_wav"][..., :16000])
    with pytest.raises(ValueError, match="44100 Hz"):
        port.poison(make_config("ultrasonic", device="cpu"), CleanData(**arrays), save=False)


def test_resolve_trigger_wave_path_prefers_an_asset(tmp_path, monkeypatch):
    cfg = make_config("ultrasonic", result="r")
    assert port.resolve_trigger_wave_path(cfg) == os.path.join("record", "r", "resources", "Ultrasonic",
                                                               "trigger.wav")
    assets = tmp_path / "assets"
    (assets / "Ultrasonic").mkdir(parents=True)
    write_wav(str(assets / "Ultrasonic" / "trigger.wav"), np.zeros(44100, np.float32), 44100)
    monkeypatch.setenv("AUDIOBD_RESOURCES", str(assets))
    assert port.resolve_trigger_wave_path(cfg) == str(assets / "Ultrasonic" / "trigger.wav")
    assert jult.resolve_trigger_wave_path(jax_make_config("ultrasonic", result="r")) == \
        port.resolve_trigger_wave_path(cfg)


def _check_run_outputs(run, record):
    h = run.result.history
    assert run.result.epochs_ran == 2
    assert all(np.isfinite(v) for k in ("train_loss", "test_clean_loss", "test_bd_loss") for v in h[k])
    data = os.path.join(record, "SCDv1-10")
    clean = [os.path.join(data, "clean", f"clean_{s}_{k}.npy") for s in ("train", "test")
             for k in ("wav", "mfcc", "label")]
    bd = [os.path.join(data, "bd", n + ".npy") for n in BD_FILES]
    csvs = [os.path.join(record, n) for n in ("loss_result.csv", "acc_result.csv")]
    missing = [f for f in clean + bd + csvs if not os.path.exists(f)]
    assert not missing, missing
    state_dict, spec = load_checkpoint(record)
    model = build_model(spec["model"], spec["num_classes"], spec["feature_size"], torch.device("cpu"), seed=0,
                        n_mfcc=spec["n_mfcc"])
    model.load_state_dict(state_dict)
    feats = torch.from_numpy(np.load(os.path.join(data, "bd", "bd_test_mfcc.npy")))
    assert feats.shape[1:] == (1, 100, 40)
    with torch.no_grad():
        logits = model.eval()(feats)
    assert logits.shape == (len(feats), 10) and torch.isfinite(logits).all()
    assert set(run.stages) == {"prep", "poison", "train"}


@pytest.mark.parametrize("model", ["smallcnn", "resnet"])
def test_cli_synthetic_on_cpu(tmp_path, monkeypatch, model):
    monkeypatch.chdir(tmp_path)
    run = port_main(["ultrasonic", "--synthetic", "--synthetic_per_class", "3", "--num_epochs", "2",
                     "--batch_size", "16", "--device", "cpu", "--model", model, "--trigger_size", "30",
                     "--trigger_pos", "mid"])
    _check_run_outputs(run, os.path.join("record", "ultrasonic_smallcnn"))
    assert run.n_clips == 30 and run.prep_walls is None
    assert np.count_nonzero(run.trigger) <= 30 * 441


def test_cli_from_a_wav_tree_on_cpu(tmp_path, monkeypatch):
    """16 kHz PCM16 clips at the dataset's path: decoded, resampled to
    44.1 kHz, the shorter than 1 s dropped; the clean cache written."""
    monkeypatch.chdir(tmp_path)
    cfg = make_config("ultrasonic")
    rng = np.random.default_rng(5)
    for label in cfg.labels:
        d = os.path.join(cfg.data_path, label)
        os.makedirs(d)
        for i in range(3):
            write_wav(os.path.join(d, f"{i}.wav"), (rng.standard_normal(16000) * 0.1).astype(np.float32), 16000)
        write_wav(os.path.join(d, "short.wav"), np.zeros(15999, np.float32), 16000)
    run = port_main(["ultrasonic", "--num_epochs", "2", "--batch_size", "16", "--device", "cpu"])
    _check_run_outputs(run, os.path.join("record", "ultrasonic_smallcnn"))
    assert run.n_clips == 30 and set(run.prep_walls) == {"decode", "resample", "mfcc"}


def test_cli_without_cuda_or_device_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["ultrasonic", "--synthetic", "--synthetic_per_class", "1", "--num_epochs", "1"])
