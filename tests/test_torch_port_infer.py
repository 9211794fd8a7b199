"""The port's serving entry (audiobd_tpu_torch/cli/infer.py) against the JAX
package's (audiobd_tpu/cli/infer.py), from one model's weights.

A JAX SmallCNN's variables (jit_init, random running statistics, fc2 × 30
so that predictions spread over the classes) are written twice under
``record/served/``: as the JAX package's Orbax checkpoint, and carried by
models/convert.py into the port's ``torch_checkpoint/``, both with the same
spec (BadNets, SCDv1-10, batch 8). The wav tree holds 16 kHz clips of 1 s
and 0.6 s, 44.1 kHz clips of 1 s and one of 0.4 s (resampled, then
zero-filled past its own length), and one stereo 16 kHz file. JAX's
``main()`` runs with ``sys.argv`` patched, as tests/test_infer.py runs it
(its wrap-pad to a 256-row bucket included); the port's ``main`` with
``--device cpu``, where kernel A is its plain version.

Tolerances:
  * the waveforms the port serves against the reference's recipe, each
    file resampled alone by the JAX package: 1e-6 of the largest
    magnitude, as tests/test_torch_port_resample.py;
  * features: rtol 1e-4, atol 1e-3, the MFCC tolerance of
    tests/test_torch_port_mfcc.py and tests/test_pallas_mfcc.py;
  * the model on the same features (JAX's): logits within 1e-5 of the
    largest, test_torch_port_model.py's f32 tolerance;
  * served probabilities end to end: atol 2e-5. Each side featurizes with
    its own f32 MFCC, and the two feature sets differ within the MFCC
    tolerance above; the check below shows that this difference, carried
    through the JAX model, moves its probabilities by at least 3/4 of the
    served gap (1.25e-5 of 1.38e-5 here), and the model's own f32
    difference on the same features (4.8e-6) covers the rest;
  * top-k order, labels and paths: equal; ``--eval_clean``: acc equal, loss
    rtol 1e-5.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiobd_tpu.cli import infer as jax_infer
from audiobd_tpu.configs import make_config as jax_make_config
from audiobd_tpu.dsp.resample import resample as jax_resample
from audiobd_tpu.models import build_model as jax_build_model
from audiobd_tpu.models import jit_init
from audiobd_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from audiobd_tpu.train.state import TrainState
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.cli import infer
from audiobd_tpu_torch.data.speech_commands import batched_mfcc_device, mfcc_params, resample_rows
from audiobd_tpu_torch.data.wavio import write_wav
from audiobd_tpu_torch.models.convert import FROM_FLAX
from audiobd_tpu_torch.train.checkpoint import save_checkpoint

CPU = torch.device("cpu")
RESULT = "served"
SPEC = {"attack": "badnets", "model": "smallcnn", "num_classes": 10, "feature_size": 3072, "n_mfcc": 40,
        "dataset": "SCDv1-10", "batch_size": 8}
PROB_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _tone(rng, n: int, rate: int, f0: float) -> np.ndarray:
    t = np.arange(n) / rate
    env = np.exp(-((t - rng.uniform(0.2, 0.5)) ** 2) / 0.05)
    wav = 0.4 * env * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(n)
    return wav.astype(np.float32)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The directory holding ``record/served/`` (both checkpoints, the clean
    npy cache: 20 test clips at batch 8, the last batch padded) and the wav
    tree ``clips/``; the JAX model and its variables."""
    root = tmp_path_factory.mktemp("infer")
    model = jax_build_model("smallcnn", 10, 3072)
    variables = jax.tree_util.tree_map(
        np.asarray, jit_init(model, jax.random.PRNGKey(0), np.zeros((1, 1, 101, 40), np.float32)))
    rng = np.random.default_rng(1)
    for bn in variables["batch_stats"].values():
        c = bn["BatchNorm_0"]["mean"].shape[0]
        bn["BatchNorm_0"]["mean"] = (0.5 * rng.standard_normal(c)).astype(np.float32)
        bn["BatchNorm_0"]["var"] = rng.uniform(0.5, 3.0, c).astype(np.float32)
    variables["params"]["fc2"]["Dense_0"]["kernel"] = variables["params"]["fc2"]["Dense_0"]["kernel"] * 30.0
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}

    record = str(root / "record" / RESULT)
    jax_save_checkpoint(record, TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                                           opt_state=optax.adam(1e-4).init(variables["params"]),
                                           step=np.int32(0)), SPEC)
    save_checkpoint(record, FROM_FLAX["smallcnn"](variables), SPEC)
    clean = os.path.join(record, "SCDv1-10", "clean")
    os.makedirs(clean)
    arrays = {
        "clean_train_wav": np.zeros((4, 1, 16000), np.float32),
        "clean_test_wav": np.zeros((20, 1, 16000), np.float32),
        "clean_train_mfcc": (rng.standard_normal((4, 1, 101, 40)) * 8.0).astype(np.float32),
        "clean_test_mfcc": (rng.standard_normal((20, 1, 101, 40)) * 8.0).astype(np.float32),
        "clean_train_label": rng.integers(0, 10, 4),
        "clean_test_label": rng.integers(0, 10, 20),
    }
    for name, arr in arrays.items():
        np.save(os.path.join(clean, name + ".npy"), arr)

    clips = root / "clips"
    (clips / "off").mkdir(parents=True)
    for i in range(3):
        write_wav(str(clips / f"a{i}.wav"), _tone(rng, 16000, 16000, 300.0 + 250.0 * i), 16000)
    write_wav(str(clips / "short16k.wav"), _tone(rng, 9600, 16000, 700.0), 16000)
    for i in range(2):
        write_wav(str(clips / "off" / f"b{i}.wav"), _tone(rng, 44100, 44100, 450.0 + 300.0 * i), 44100)
    write_wav(str(clips / "off" / "short44k.wav"), _tone(rng, 17640, 44100, 900.0), 44100)
    write_wav(str(clips / "stereo.wav"), np.stack([_tone(rng, 16000, 16000, 520.0), _tone(rng, 16000, 16000, 80.0)]),
              16000)
    return root, model, variables


def _run_both(root, monkeypatch, capsys, argv: list[str]):
    """(JAX's return value and stdout lines, the port's) for one argv."""
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "argv", ["infer", *argv])
    capsys.readouterr()
    want = jax_infer.main()
    want_out = capsys.readouterr().out.strip().splitlines()
    got = port_main(["infer", *argv, "--device", "cpu"])
    got_out = capsys.readouterr().out.strip().splitlines()
    return want, want_out, got, got_out


def test_json_serving_matches_jax(served, monkeypatch, capsys):
    root, _, _ = served
    want, want_out, got, got_out = _run_both(root, monkeypatch, capsys, ["--result", RESULT, "--wav", "clips",
                                                                          "--json", "--top_k", "4"])
    assert got.shape == want.shape == (8, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    rows_j, rows_p = [json.loads(x) for x in want_out], [json.loads(x) for x in got_out]
    assert [r["path"] for r in rows_p] == [r["path"] for r in rows_j]
    assert rows_p[0]["path"] == os.path.join("clips", "a0.wav") and len({r["label"] for r in rows_p}) > 1
    for rp, rj in zip(rows_p, rows_j):
        assert rp["label"] == rj["label"]
        assert [t["label"] for t in rp["top"]] == [t["label"] for t in rj["top"]]
        np.testing.assert_allclose([t["prob"] for t in rp["top"]], [t["prob"] for t in rj["top"]], atol=PROB_ATOL)


def test_text_serving_matches_jax(served, monkeypatch, capsys):
    """Files named one by one, the text lines: the same paths and top-3
    labels in the same order."""
    root, _, _ = served
    files = [os.path.join("clips", "off", "short44k.wav"), os.path.join("clips", "stereo.wav")]
    want, want_out, got, got_out = _run_both(root, monkeypatch, capsys, ["--result", RESULT, "--wav", *files])
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    strip = lambda line: [kv.split("=")[0] for kv in line.split(": ", 1)[1].split(", ")]  # noqa: E731
    assert [x.split(": ")[0] for x in got_out] == [x.split(": ")[0] for x in want_out] == files
    assert [strip(x) for x in got_out] == [strip(x) for x in want_out]


def test_featurize_and_model_account_for_the_gap(served, monkeypatch):
    """Why the probabilities are held to 2e-5 and not the logits' 1e-5: the
    waveforms agree with the reference recipe within 1e-6, the features
    within the MFCC tolerance, and on the same features the model agrees
    within 1e-5; the port's features through the JAX model move its
    probabilities by most of the served gap."""
    root, model, variables = served
    monkeypatch.chdir(root)
    paths = infer.expand_wavs(["clips"])
    cfg, port_model = infer.load_model(RESULT, device="cpu")
    wavs, walls = infer.load_waveforms(cfg, paths, CPU)
    assert set(walls) == {"read", "resample"}

    from audiobd_tpu.data.wavio import read_wav as jax_read_wav

    ref = np.zeros((len(paths), 16000), np.float32)
    for i, path in enumerate(paths):
        wav, rate = jax_read_wav(path)
        if rate != 16000:
            wav = np.asarray(jax_resample(jnp.asarray(wav), rate, 16000))
        n = min(wav.shape[1], 16000)
        ref[i, :n] = wav[0, :n]
    assert _rel(wavs.numpy(), ref) < 1e-6

    jcfg = jax_make_config("badnets", result=RESULT, batch_size=8)
    feats_j, n = jax_infer._featurize_files(jcfg, paths)
    feats_j = np.array(feats_j)[:n]
    feats_p = batched_mfcc_device(wavs, mfcc_params(cfg), CPU).numpy()
    np.testing.assert_allclose(feats_p, feats_j, rtol=1e-4, atol=1e-3)

    logits_j = np.asarray(model.apply(variables, feats_j, train=False))
    with torch.no_grad():
        logits_p = port_model(torch.from_numpy(feats_j.copy())).numpy()
    assert _rel(logits_p, logits_j) < 1e-5

    softmax = lambda x: np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))  # noqa: E731
    probs_j = softmax(logits_j)
    same_features = np.abs(infer.classify(port_model, torch.from_numpy(feats_j), 8) - probs_j).max()
    moved = np.abs(softmax(model.apply(variables, feats_p, train=False)) - probs_j).max()
    served = np.abs(infer.classify(port_model, torch.from_numpy(feats_p), 8) - probs_j).max()
    print(f"probability gaps: same features {same_features:.3e}, JAX model on the port's features {moved:.3e}, "
          f"served {served:.3e}")
    assert moved >= 0.75 * served and served <= moved + same_features and served <= PROB_ATOL


def test_eval_clean_matches_jax(served, monkeypatch, capsys):
    root, _, _ = served
    for extra in ([], ["--json"]):
        want, want_out, got, got_out = _run_both(root, monkeypatch, capsys, ["--result", RESULT, "--eval_clean",
                                                                              *extra])
        assert got["acc"] == want["acc"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        if extra:
            p, j = json.loads(got_out[0]), json.loads(want_out[0])
            assert p["clean_test_acc"] == j["clean_test_acc"] and p["n_clips"] == j["n_clips"] == 20
        else:
            assert got_out[0].split("loss")[0] == want_out[0].split("loss")[0]


def test_eval_clean_without_cache_and_no_input_exit(served, monkeypatch, tmp_path):
    root, _, _ = served
    other = tmp_path / "record" / "bare"
    (other / "torch_checkpoint").mkdir(parents=True)
    for name in ("model.pt", "model_spec.json"):
        os.link(os.path.join(root, "record", RESULT, "torch_checkpoint", name), other / "torch_checkpoint" / name)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="needs the clean npy cache"):
        infer.main(["--result", "bare", "--eval_clean", "--device", "cpu"])
    with pytest.raises(SystemExit, match="nothing to do"):
        infer.main(["--result", "bare", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no checkpoint spec"):
        infer.main(["--result", "missing", "--eval_clean", "--device", "cpu"])


def test_resample_rows_short_rows_match_per_file_resample():
    """Clips shorter than 1 s after resampling, batched with longer ones:
    each row is its clip resampled alone by the JAX package, zero-filled
    past its own length (not the filter's tail over the batch's padding)."""
    rng = np.random.default_rng(4)
    for orig, new in ((44100, 16000), (8000, 16000), (22050, 44100)):
        keep = new
        lengths = [orig, orig // 3, 2 * orig, 17, orig - 1]
        rows = [rng.uniform(-1, 1, n).astype(np.float32) for n in lengths]
        got = resample_rows(rows, orig, new, keep, CPU, chunk=3).numpy()
        want = np.zeros((len(rows), keep), np.float32)
        for i, r in enumerate(rows):
            alone = np.asarray(jax_resample(jnp.asarray(r), orig, new))[:keep]
            want[i, : len(alone)] = alone
        assert got.shape == want.shape
        assert _rel(got, want) < 1e-6, (orig, new)
        short = lengths.index(orig // 3)
        assert not got[short, -100:].any()
