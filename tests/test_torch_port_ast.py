"""AST (models/zoo.py::AST) against the plain reference, benchmark/reference/ast.py
(read here, never edited), on the CPU, and its place on the BadNets path.

At a small size (2 blocks of width 64, 4 heads of 16, an MLP of 128, a 32 x 24
input of 32 mel bands and 24 frames, patch 8 at stride 6: 17 tokens) on seeded
random weights: the logits, every gradient leaf, and three Adam steps' losses
and parameters. Tolerances: f32 sums in another order (SDPA's math backend
scales q and k by d_h^-1/4 each where the reference divides the scores by
√d_h; LayerNorm's and GELU's library kernels against their written-out
formulas), through two blocks: logits and losses within 1e-5 relative,
gradients within 1e-4 of each leaf's largest entry plus 1e-6, and the
parameters after three steps within 1e-5 + 1e-5 relative, Adam's first steps
moving each parameter by about lr whatever its gradient's size; the key
bias, whose gradient is round-off alone (softmax takes back a constant added
to a row's scores), moves by at most 3 lr on both sides and is left out.

The published configuration is built on the meta device: 146 tokens, 155
leaves, 85,376,266 parameters. The log-mel mode of dsp/mfcc.py and of kernel
A's plain versions is the MFCC's dB stage without the DCT. The CLI runs
BadNets with AST at a tiny width, and the other entry points refuse AST.
"""

import argparse
import math
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiobd_tpu_torch.configs import config_from_args, make_config
from audiobd_tpu_torch.data.speech_commands import CleanData, normalize_features
from audiobd_tpu_torch.dsp import MFCCParams, mel, mfcc
from audiobd_tpu_torch.dsp.stft import power_spectrogram
from audiobd_tpu_torch.models import layers, zoo
from audiobd_tpu_torch.ops import mfcc as op_mfcc
from audiobd_tpu_torch.poison import badnets
from audiobd_tpu_torch.train import scan_epoch
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.train.state import Adam
from audiobd_tpu_torch.utils import profiling
from benchmark.reference import ast as ast_ref

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(patch=8, stride=6, dim=64, depth=2, heads=4, mlp_dim=128)
N_MELS, TDIM, FRAMES = 32, 24, 20
TINY = dict(patch=16, stride=10, dim=16, depth=1, heads=2, mlp_dim=32)
LR = 2.5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed: int, widths: dict, n_mels: int, classes: int = 10) -> dict:
    """A state dict for the reference's spec: U(±1/√fan_in) leaves, then
    LayerNorm's scale and shift drawn off 1 and 0 so that they count."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, shape, kind, fan_in in ast_ref.spec(classes, n_mels, {**widths, "input_tdim": TDIM}):
        u = torch.rand(shape, generator=gen) * 2.0 - 1.0
        out[key] = u / math.sqrt(fan_in) if kind == "uniform" else (1.0 if kind == "ones" else 0.0) + 0.1 * u
    return out


def _port(state: dict, widths: dict = SMALL, n_mels: int = N_MELS, tdim: int = TDIM) -> zoo.AST:
    model = zoo.AST(10, input_fdim=n_mels, input_tdim=tdim, **widths)
    model.load_state_dict(state)
    return model


def _batch(seed: int, n: int = 6):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, 1, FRAMES, N_MELS)).astype(np.float32))
    return x, torch.from_numpy(rng.integers(0, 10, n))


def test_the_reference_is_the_benchmarks():
    """The module these tests hold the port against is the one the
    benchmark's AST cell holds it against."""
    assert Path(ast_ref.__file__).resolve() == REPO / "benchmark" / "reference" / "ast.py"


@pytest.mark.parametrize("train", [True, False])
def test_logits_match_the_reference(train):
    state = _weights(1, SMALL, N_MELS)
    model = _port(state).train(train)
    x, _ = _batch(2)
    widths = {**SMALL, "input_tdim": TDIM}
    torch.testing.assert_close(model(x), ast_ref.forward(state, x, widths), rtol=1e-5, atol=1e-5)


def test_gradients_match_the_reference_leaf_by_leaf():
    state = _weights(3, SMALL, N_MELS)
    model = _port(state)
    x, y = _batch(4)
    loss = torch.nn.functional.cross_entropy(model(x), y)
    grads = dict(zip([k for k, _ in model.named_parameters()], torch.autograd.grad(loss, list(model.parameters()))))
    leaves = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    ref_loss = torch.nn.functional.cross_entropy(ast_ref.forward(leaves, x, {**SMALL, "input_tdim": TDIM}), y)
    ref = dict(zip(leaves, torch.autograd.grad(ref_loss, list(leaves.values()))))
    assert list(grads) == ast_ref.param_keys(state) and len(grads) == 5 + 12 * 2 + 6
    for k, g in grads.items():
        assert float((g - ref[k]).abs().max()) <= 1e-4 * float(ref[k].abs().max()) + 1e-6, k


def test_three_adam_steps_match_the_reference():
    state = _weights(5, SMALL, N_MELS)
    model = _port(state)
    opt = Adam(model.parameters(), LR)
    batches = [_batch(10 + i) for i in range(3)]
    losses = []
    for x, y in batches:
        loss = torch.nn.functional.cross_entropy(model(x), y)
        opt.step(torch.autograd.grad(loss, opt.params))
        losses.append(float(loss.detach()))
    ref = ast_ref.train_steps(state, batches, LR, {**SMALL, "input_tdim": TDIM})
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    d = SMALL["dim"]
    for (k, p), r in zip(model.named_parameters(), (ref["state"][k] for k in ast_ref.param_keys(state))):
        p, r = p.detach(), r.clone()
        if k.endswith("attn.qkv.bias"):
            # The key bias adds q·b to a row's every score, which softmax
            # takes back: its gradient is round-off, which Adam scales to
            # steps of ±lr in either direction. Both sides move it by at most
            # 3 steps; the query and value biases are compared.
            for side in (p, r):
                assert float((side[d:2 * d] - state[k][d:2 * d]).abs().max()) <= 3 * LR * 1.01, k
            p[d:2 * d] = r[d:2 * d] = 0.0
        torch.testing.assert_close(p, r, rtol=1e-5, atol=1e-5, msg=k)


def test_published_configuration_on_the_meta_device():
    with torch.device("meta"):
        model = zoo.AST(10, 128, 128, **zoo.AST_WIDTHS)
        tokens = model.embed(torch.empty(2, 1, 128, 128), torch.float32)
        logits = model(torch.empty(2, 1, 101, 128))
    assert zoo.AST_WIDTHS == dict(patch=16, stride=10, dim=768, depth=12, heads=12, mlp_dim=3072)
    assert tokens.shape == (2, 146, 768) and logits.shape == (2, 10)
    params = list(model.named_parameters())
    assert len(params) == 155 and sum(p.numel() for _, p in params) == 85_376_266
    spec = ast_ref.spec(10, 128, {**zoo.AST_WIDTHS, "input_tdim": 128})
    assert [(k, tuple(p.shape)) for k, p in params] == [(k, s) for k, s, _, _ in spec]


def test_init_tree_draws_the_new_leaves():
    a = zoo.AST(10, N_MELS, TDIM, **SMALL)
    b = zoo.AST(10, N_MELS, TDIM, **SMALL)
    for m, seed in ((a, 7), (b, 7)):
        for p in m.parameters():
            torch.nn.init.constant_(p, 3.0)
        layers.init_tree_(m, torch.Generator().manual_seed(seed))
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k  # one generator, one draw
    tok = torch.cat([a.embed.cls_token.flatten(), a.embed.dist_token.flatten(), a.embed.pos_embed.flatten()]).detach()
    assert abs(float(tok.std()) - layers.TOKEN_STD) < 0.004 and abs(float(tok.mean())) < 0.004
    for name, m in a.named_modules():
        if isinstance(m, torch.nn.LayerNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight)) and torch.equal(m.bias, torch.zeros_like(m.bias))
        elif isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            assert 0.9 * bound < float(m.weight.detach().abs().max()) <= bound, name


def _wavs(n: int = 3, seed: int = 21) -> torch.Tensor:
    return torch.from_numpy((np.random.default_rng(seed).standard_normal((n, 16000)) * 0.1).astype(np.float32))


def test_logmel_is_the_mfcc_db_stage():
    params = MFCCParams(features="logmel")
    wavs = _wavs()
    got = mfcc(wavs, params)
    spec = power_spectrogram(wavs, 400, 160, center=True, pad_mode="reflect")
    db = mel.amplitude_to_db(spec @ torch.from_numpy(params.mel_fb()), top_db=80.0)
    assert got.shape == (3, 101, 128) and params.n_out == 128 and MFCCParams().n_out == 40
    torch.testing.assert_close(got, db, rtol=0, atol=0)
    torch.testing.assert_close(mfcc(wavs, MFCCParams()), got @ torch.from_numpy(params.dct()), rtol=0, atol=0)
    torch.testing.assert_close(ast_ref.logmel(wavs, 16000, 400, 160, 128), got, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="features"):
        MFCCParams(features="fbank")


@pytest.mark.parametrize("plain, kw", [
    (op_mfcc.mfcc_fft_plain, dict(n_fft=400, hop_length=160)),
    (op_mfcc.mfcc_bluestein_plain, dict(n_fft=397, hop_length=160, n_mels=64)),
])
def test_kernel_plain_versions_in_logmel_mode(plain, kw):
    """The kernel paths' plan walks stop before the DCT too (the function
    the card's log-mel mode is held to), within the MFCC tolerance."""
    params = MFCCParams(features="logmel", **kw)
    wavs = _wavs(2)
    ref = mfcc(wavs, params)
    torch.testing.assert_close(plain(wavs, params), ref, rtol=1e-4, atol=1e-3)
    assert ref.shape[-1] == params.n_mels and params.n_dct == 0
    assert MFCCParams().n_dct == 40
    assert torch.equal(op_mfcc.fused_mfcc(wavs, params), ref)  # a CPU tensor takes the plain version


def test_normalize_features_is_asts():
    cfg = make_config("badnets", model="ast", device="cpu")
    train, test = torch.randn(8, 1, 101, 128) * 7.0 - 30.0, torch.randn(3, 1, 101, 128) * 7.0 - 30.0
    ntrain, ntest = normalize_features(cfg, train, test)
    assert abs(float(ntrain.double().mean())) < 1e-6 and abs(float(ntrain.double().std(correction=0)) - 0.5) < 1e-6
    rtrain, rtest = ast_ref.normalize(train, test)
    assert torch.equal(ntrain, rtrain) and torch.equal(ntest, rtest)
    mcfg = make_config("badnets", device="cpu")
    assert normalize_features(mcfg, train, test) == (train, test)


def test_badnets_patch_on_logmel_frames():
    """The -200 square at the bottom right of the real frames: the last 5
    of 101 frames and the top 5 of 128 mel bands, before the model's padding."""
    cfg = make_config("badnets", model="ast", device="cpu", trigger_size=5)
    rng = np.random.default_rng(0)
    n_train, n_test = 30, 10
    train = rng.standard_normal((n_train, 1, 101, 128)).astype(np.float32)
    test = rng.standard_normal((n_test, 1, 101, 128)).astype(np.float32)
    labels_tr, labels_te = rng.integers(0, 10, n_train), rng.integers(0, 10, n_test)
    clean = CleanData(None, None, train, test, labels_tr, labels_te)
    out = badnets.poison(cfg, clean, save=False)
    feats = out.bd_train.feats.numpy()
    for row, ind in enumerate(out.bd_train.indicators):
        if ind:
            assert (feats[row, 0, -5:, -5:] == -200.0).all()
            assert np.array_equal(feats[row, 0, :-5], train[row, 0, :-5])
            assert np.array_equal(feats[row, 0, -5:, :-5], train[row, 0, -5:, :-5])
        else:
            assert np.array_equal(feats[row], train[row])
    assert int(out.bd_train.indicators.sum()) == 3


def test_attention_spans_and_counter_on_a_cpu_forward():
    """12 ``attention`` and 12 ``mlp`` spans a forward of a 12-block model,
    each a child of the step's ``forward`` span; ``attention_calls`` reads 12
    a forward, with or without a profiler session."""
    widths = {**TINY, "depth": 12}
    model = zoo.AST(10, 128, 128, **widths)
    data = ArraySet(np.zeros((4, 1, 101, 128), np.float32), np.arange(4) % 10)
    before = profiling.counts()["attention_calls"]
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        scan_epoch.run_eval_epoch(model, scan_epoch.DeviceDataset(data, torch.device("cpu")), 4)
    spans = [s for s in profiling.recorded() if s.t0 >= t0]
    assert profiling.counts()["attention_calls"] - before == 12
    steps = [s for s in spans if s.name == "eval_step"]
    assert len(steps) == 1
    forward = [s for s in spans if s.name == "forward" and s.parent is steps[0]]
    assert len(forward) == 1 and forward[0].counts["attention_calls"] == 12
    for name in ("attention", "mlp"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == 12 and all(s.parent is forward[0] for s in mine)
        assert {s.path for s in mine} == {f"eval_epoch/eval_step/forward/{name}"}
        assert all(forward[0].t0 <= s.t0 <= s.t1 <= forward[0].t1 for s in mine)
    assert sum(s.counts["attention_calls"] for s in spans if s.name == "attention") == 12
    model(torch.zeros(2, 1, 101, 128))  # no session: counted, not recorded
    assert profiling.counts()["attention_calls"] - before == 24


def test_badnets_cli_trains_ast(tmp_path, monkeypatch):
    """``badnets --model ast`` end to end at a tiny width: log-mel prep,
    the patch, the epoch engine, the record contract and the checkpoint."""
    from audiobd_tpu_torch.__main__ import main
    from audiobd_tpu_torch.train.checkpoint import load_checkpoint

    monkeypatch.setattr(zoo, "AST_WIDTHS", TINY)
    monkeypatch.chdir(tmp_path)
    result = main(["badnets", "--synthetic", "--synthetic_per_class", "4", "--num_epochs", "2", "--device", "cpu",
                   "--model", "ast", "--batch_size", "8", "--learning_rate", "2.5e-4", "--result", "ast_run"])
    assert result.epochs_ran == 2 and all(np.isfinite(result.history["train_loss"]))
    record = tmp_path / "record" / "ast_run"
    feats = np.load(record / "SCDv1-10" / "clean_logmel" / "clean_train_mfcc.npy")
    assert feats.shape == (32, 1, 101, 128) and abs(float(feats.mean())) < 1e-4
    assert abs(float(feats.std()) - 0.5) < 1e-4
    state, spec = load_checkpoint(str(record))
    assert spec["model"] == "ast" and state["embed.pos_embed"].shape == (1, 146, 16)
    assert (record / "attack_result.csv").exists() or any(record.glob("*.csv"))


def test_smallcnn_and_ast_keep_their_own_clean_cache_under_one_result(tmp_path, monkeypatch):
    """SmallCNN, then AST, then SmallCNN again under one ``--result`` on a wav
    tree: each loads the clean cache of its own features (MFCCs in
    ``clean/``, normalised log-mel in ``clean_logmel/``), never the other's."""
    from audiobd_tpu_torch.__main__ import main
    from audiobd_tpu_torch.configs import DATASET_LABELS, DATASET_PATHS
    from audiobd_tpu_torch.data.wavio import write_wav

    monkeypatch.setattr(zoo, "AST_WIDTHS", TINY)
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(3)
    for label in DATASET_LABELS["SCDv1-10"]:
        os.makedirs(os.path.join(DATASET_PATHS["SCDv1-10"], label))
        for i in range(3):
            clip = (rng.standard_normal(16000) * 0.1).astype(np.float32)
            write_wav(os.path.join(DATASET_PATHS["SCDv1-10"], label, f"{i}.wav"), clip, 16000)
    args = ["badnets", "--num_epochs", "1", "--device", "cpu", "--batch_size", "8", "--result", "shared"]
    record = tmp_path / "record" / "shared" / "SCDv1-10"
    shapes = {}
    for model in ("smallcnn", "ast", "smallcnn"):
        result = main(args + ["--model", model])
        assert result.epochs_ran == 1 and all(np.isfinite(result.history["train_loss"]))
        for cache in ("clean", "clean_logmel"):
            if (record / cache).exists():
                shapes[cache] = np.load(record / cache / "clean_train_mfcc.npy").shape
    assert shapes == {"clean": (24, 1, 101, 40), "clean_logmel": (24, 1, 101, 128)}


def test_other_entry_points_refuse_ast(tmp_path, monkeypatch):
    from audiobd_tpu_torch.defend.common import load_bd_model

    for attack in ("jingleback", "ultrasonic", "daba", "flowmur"):
        with pytest.raises(ValueError, match=f"{attack} does not train --model ast"):
            config_from_args(attack, argparse.Namespace(model="ast", config=None))
    assert config_from_args("badnets", argparse.Namespace(model="ast", config=None)).model == "ast"
    assert make_config("badnets", model="AST").features == "logmel" == zoo.AST.features
    assert {make_config("badnets", model=m).features for m in ("smallcnn", "resnet")} == {"mfcc"}
    assert {zoo.model_features(m) for m in zoo.MODELS if m != "ast"} == {"mfcc"}
    monkeypatch.chdir(tmp_path)
    from audiobd_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint("record/r", {}, {"attack": "badnets", "model": "ast", "num_classes": 10, "feature_size": 128},
                    {"mu": [], "nu": [], "count": 0}, 0)
    for model in ("ast", "smallcnn"):  # the checkpoint's model decides, whatever --model says
        with pytest.raises(ValueError, match="read MFCC features; ast takes logmel"):
            load_bd_model(make_config("badnets", model=model, result="r", device="cpu"))
