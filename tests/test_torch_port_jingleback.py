"""The port's JingleBack attack against the JAX package's, on the CPU.

Poisoning the same clean arrays (the JAX package's synthetic set, 3 clips a
class) with style 1 (distortion) and style 5 (gain → ladder → phaser, the
plain loops of kernel F): the poison indicators, labels and the unstyled
rows are bit-equal; the styled waveforms within their board's tolerance in
tests/test_torch_port_effects.py (atol 1e-5 for styles 1 and 5), and their
MFCCs within rtol 1e-4, atol 1e-3 (tests/test_pallas_mfcc.py's MFCC
tolerance). Styling in chunks of 2 rows equals styling in one chunk within
1e-6 (rows are independent, so the port leaves the last chunk unpadded);
the pitch shift within 1e-3, as its f32 phase magnifies the products'
rounding at another batch size.

The CLI runs on the CPU (``--device cpu``) and writes the eight bd npys,
the CSVs and a checkpoint; ``configs/jingleback.yaml`` loads unchanged.
"""

import os

import numpy as np
import pytest
import torch

from audiobd_tpu.configs import make_config as jax_make_config
from audiobd_tpu.data.speech_commands import make_synthetic_clean_data as jax_synthetic
from audiobd_tpu.poison import jingleback as jjb
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.configs import config_from_yaml, make_config
from audiobd_tpu_torch.data.speech_commands import CleanData
from audiobd_tpu_torch.models import build_model
from audiobd_tpu_torch.poison import jingleback as port
from audiobd_tpu_torch.train.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MFCC_TOL = dict(rtol=1e-4, atol=1e-3)
WAV_ATOL = {1: 1e-5, 5: 1e-5}
BD_FILES = ("bd_train_wav", "bd_test_wav", "bd_train_mfcc", "bd_test_mfcc", "bd_train_label", "bd_test_label",
            "poison_index_train", "poison_index_test")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clean_arrays():
    data = jax_synthetic(jax_make_config("jingleback"), n_per_class=3)
    return {f: np.asarray(getattr(data, f)) for f in
            ("train_wav", "test_wav", "train_mfcc", "test_mfcc", "train_label", "test_label")}


def _poison_both(tmp_path, arrays, style):
    out = []
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            if pkg == "port":
                cfg = make_config("jingleback", result="jb_test", style=style, device="cpu")
                res = port.poison(cfg, CleanData(**arrays))
            else:
                cfg = jax_make_config("jingleback", result="jb_test", style=style)
                res = jjb.poison(cfg, jjb.CleanData(**arrays))
            bd = os.path.join("record", "jb_test", "SCDv1-10", "bd")
            out.append(({n: np.load(os.path.join(bd, n + ".npy")) for n in BD_FILES}, res))
        finally:
            os.chdir(cwd)
    return out


@pytest.mark.parametrize("style", [1, 5])
def test_poison_equals_jax(tmp_path, clean_arrays, style):
    (got, got_res), (ref, _) = _poison_both(tmp_path, clean_arrays, style)
    for name in BD_FILES:
        assert got[name].dtype == ref[name].dtype and got[name].shape == ref[name].shape, name
        if "wav" not in name and "mfcc" not in name:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    for split in ("train", "test"):
        ind = got[f"poison_index_{split}"].astype(bool)
        assert ind.any() and not ind.all()
        wav, mfcc = got[f"bd_{split}_wav"], got[f"bd_{split}_mfcc"]
        np.testing.assert_array_equal(wav[~ind], clean_arrays[f"{split}_wav"][~ind])
        np.testing.assert_array_equal(mfcc[~ind], clean_arrays[f"{split}_mfcc"][~ind])
        np.testing.assert_allclose(wav[ind], ref[f"bd_{split}_wav"][ind], rtol=0, atol=WAV_ATOL[style])
        np.testing.assert_allclose(mfcc[ind], ref[f"bd_{split}_mfcc"][ind], **MFCC_TOL)
        assert not np.allclose(wav[ind], clean_arrays[f"{split}_wav"][ind], atol=1e-3)
        dev = getattr(got_res, f"bd_{split}").feats
        assert isinstance(dev, torch.Tensor)
        np.testing.assert_array_equal(dev.numpy(), mfcc)
    assert got["poison_index_train"].sum() == int(len(clean_arrays["train_label"]) * 0.1)


@pytest.mark.parametrize("style,atol", [(0, 1e-3), (2, 1e-6), (4, 1e-6)])
def test_style_chunks_are_independent(clean_arrays, style, atol):
    """Style 0's DFT products round otherwise at another batch size, and the
    pitch shift's f32 phase magnifies that to ~2e-4 (measured): its
    tolerance is the pitch shift's distance between the frameworks."""
    wavs = clean_arrays["test_wav"][:5]
    whole = port.poison_style_device(wavs, style, 16000, torch.device("cpu")).numpy()
    chunked = port.poison_style_device(wavs, style, 16000, torch.device("cpu"), chunk=2).numpy()
    assert whole.shape == wavs[:, 0].shape and whole.dtype == np.float32
    np.testing.assert_allclose(chunked, whole, rtol=0, atol=atol)


def test_yaml_config_loads_unchanged():
    cfg = config_from_yaml(os.path.join(REPO, "configs", "jingleback.yaml"), attack="jingleback", style=3)
    assert (cfg.name, cfg.style, cfg.poisoning_rate, cfg.dsp.n_fft, cfg.dsp.hop_length, cfg.train.batch_size) == \
        ("jingleback", 3, 0.1, 400, 160, 256)
    assert config_from_yaml(os.path.join(REPO, "configs", "jingleback.yaml")).style == 0


def test_cli_synthetic_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    run = port_main(["jingleback", "--synthetic", "--synthetic_per_class", "2", "--num_epochs", "2",
                     "--batch_size", "16", "--device", "cpu", "--style", "5"])
    assert "done: epochs=2" in capsys.readouterr().out
    record = os.path.join("record", "jingleback_smallcnn")
    data = os.path.join(record, "SCDv1-10")
    files = [os.path.join(data, "bd", n + ".npy") for n in BD_FILES]
    files += [os.path.join(record, n) for n in ("loss_result.csv", "acc_result.csv")]
    assert not [f for f in files if not os.path.exists(f)]
    h = run.result.history
    assert run.result.epochs_ran == 2 and all(np.isfinite(v) for k in ("train_loss", "test_bd_loss") for v in h[k])
    assert set(run.stages) == {"prep", "poison", "train"}
    state_dict, spec = load_checkpoint(record)
    assert spec["attack"] == "jingleback"
    model = build_model(spec["model"], spec["num_classes"], spec["feature_size"], torch.device("cpu"), seed=0)
    model.load_state_dict(state_dict)
    feats = torch.from_numpy(np.load(os.path.join(data, "bd", "bd_test_mfcc.npy")))
    with torch.no_grad():
        assert torch.isfinite(model.eval()(feats)).all() and feats.shape[1:] == (1, 101, 40)
