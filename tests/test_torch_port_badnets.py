"""The port's BadNets CLI against the JAX package on the same config.

``python -m audiobd_tpu_torch badnets --synthetic --synthetic_per_class 10
--num_epochs 2 --device cpu`` runs in-process; the JAX package builds the
same synthetic set and poisons it. Deterministic stages must agree: the
clips, splits, labels and poison indices exactly (both draw from the same
numpy streams), the MFCC-derived arrays within the MFCC tolerance (rtol
1e-4, atol 1e-3, as tests/test_pallas_mfcc.py). The CSVs have the
reference's columns and the checkpoint reloads.
"""

import os

import numpy as np
import pytest
import torch

from audiobd_tpu.configs import make_config as jax_make_config
from audiobd_tpu.data.speech_commands import make_synthetic_clean_data as jax_synthetic
from audiobd_tpu.data.speech_commands import save_clean_data as jax_save_clean
from audiobd_tpu.poison import badnets as jax_badnets
from audiobd_tpu.utils.logging import save_attack_csvs as jax_save_csvs
from audiobd_tpu.utils.random import np_rng as jax_np_rng
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.configs import config_from_yaml
from audiobd_tpu_torch.data.speech_commands import load_clean_data, split_indices
from audiobd_tpu_torch.models import SmallCNN
from audiobd_tpu_torch.train.checkpoint import load_checkpoint
from audiobd_tpu_torch.utils.random import np_rng, torch_generator

PER_CLASS = 10
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    port_dir = tmp_path_factory.mktemp("port")
    jax_dir = tmp_path_factory.mktemp("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(port_dir)
        result = port_main([
            "badnets", "--synthetic", "--synthetic_per_class", str(PER_CLASS),
            "--num_epochs", "2", "--device", "cpu",
        ])
        mp.chdir(jax_dir)
        cfg = jax_make_config("badnets")
        clean = jax_synthetic(cfg, n_per_class=PER_CLASS)
        jax_save_clean(cfg, clean)
        jax_badnets.poison(cfg, clean, save=True)
        jax_save_csvs(os.path.join(cfg.record_dir, "csv_reference"), result.history)
    rec = os.path.join("record", "badnets_smallcnn")
    return result, port_dir / rec, jax_dir / rec


def _load(root, sub, name):
    return np.load(os.path.join(root, "SCDv1-10", sub, name + ".npy"))


@pytest.mark.parametrize("name", ["clean_train_wav", "clean_test_wav", "clean_train_label", "clean_test_label"])
def test_clean_splits_identical(runs, name):
    _, port, ref = runs
    np.testing.assert_array_equal(_load(port, "clean", name), _load(ref, "clean", name))


@pytest.mark.parametrize("name", ["poison_index_train", "poison_index_test", "bd_train_label", "bd_test_label"])
def test_poison_indices_and_labels_identical(runs, name):
    _, port, ref = runs
    np.testing.assert_array_equal(_load(port, "bd", name), _load(ref, "bd", name))


@pytest.mark.parametrize("sub,name", [
    ("clean", "clean_train_mfcc"), ("clean", "clean_test_mfcc"),
    ("bd", "bd_train_mfcc"), ("bd", "bd_test_mfcc"),
])
def test_feature_arrays_within_mfcc_tolerance(runs, sub, name):
    _, port, ref = runs
    a, b = _load(port, sub, name), _load(ref, sub, name)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_csvs_and_checkpoint(runs):
    result, port, ref = runs
    for csv in ("loss_result.csv", "acc_result.csv"):
        with open(port / csv) as f:
            got = f.read()
        with open(ref / "csv_reference" / csv) as f:
            assert got == f.read()
        assert len(got.strip().splitlines()) == 1 + result.epochs_ran == 3
    state_dict, spec = load_checkpoint(str(port))
    assert spec["model"] == "smallcnn" and spec["attack"] == "badnets"
    model = SmallCNN(spec["num_classes"], spec["feature_size"])
    model.load_state_dict(state_dict)
    feats = torch.from_numpy(_load(port, "bd", "bd_test_mfcc"))
    with torch.no_grad():
        assert torch.isfinite(model.eval()(feats)).all()
    assert all(np.isfinite(v) for v in result.history["train_loss"])


@pytest.mark.parametrize("n", [37, 400, 1000])
def test_split_matches_sklearn(n):
    from sklearn.model_selection import train_test_split

    train, test = train_test_split(np.arange(n), test_size=0.2, random_state=35)
    got_train, got_test = split_indices(n)
    np.testing.assert_array_equal(got_train, train)
    np.testing.assert_array_equal(got_test, test)


def test_named_streams_match_jax_package():
    for name in ("badnets_poison", "shuffle"):
        np.testing.assert_array_equal(np_rng(35, name).permutation(50), jax_np_rng(35, name).permutation(50))
    a = torch.rand(4, generator=torch_generator(35, "params"))
    b = torch.rand(4, generator=torch_generator(35, "params"))
    c = torch.rand(4, generator=torch_generator(35, "dropout"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_clean_cache_reloads_and_yaml_config(runs):
    """The six-npy cache the CLI wrote loads back; ``--config`` YAML parses
    with CLI overrides on top; with --load_clean_data false the cache is
    rebuilt from the wav tree, which raises here, where there is none."""
    _, port, _ = runs
    yaml_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "badnets.yaml")
    cfg = config_from_yaml(yaml_path, attack="badnets", num_epochs=3, device="cpu")
    assert (cfg.name, cfg.train.batch_size, cfg.train.num_epochs, cfg.dsp.n_fft) == ("badnets", 256, 3, 400)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(port.parent.parent)
        clean = load_clean_data(cfg)
        assert clean.train_mfcc.shape[1:] == (1, 101, 40) and len(clean.train_label) == 80
        cfg.load_clean_data = False
        with pytest.raises(FileNotFoundError, match="missing class dir"):
            load_clean_data(cfg)
