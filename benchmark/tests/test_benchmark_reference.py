"""The plain reference against the port on the CPU at tiny sizes: the MFCC
front ends, SmallCNN in both modes, a training step with Adam, and the
trigger search's step (deployment, MFCC, the frozen surrogate, the gradient
to the trigger, Adam, the clamp)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import smallcnn, steps
from benchmark.reference.mfcc import mfcc


def test_reference_mfcc_matches_the_port():
    from audiobd_tpu_torch.dsp import MFCCParams
    from audiobd_tpu_torch.dsp import mfcc as port_mfcc

    x = torch.randn(3, 16000, generator=torch.Generator().manual_seed(1)) * 0.1
    for n_fft, hop, n_mfcc in ((400, 160, 40), (2048, 512, 13)):
        ref = mfcc(x, 16000, n_fft, hop, 128, n_mfcc)
        got = port_mfcc(x, MFCCParams(n_fft=n_fft, hop_length=hop, n_mfcc=n_mfcc))
        assert torch.allclose(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_reference_smallcnn_matches_the_port(monkeypatch):
    from audiobd_tpu_torch.models import build_model

    from benchmark import inputs

    weights = inputs.make_weights(7, smallcnn.spec(10, 224), "cpu")
    model = build_model("smallcnn", 10, 224, torch.device("cpu"), 7)
    model.load_state_dict(weights)
    x = torch.randn(4, 1, 32, 13, generator=torch.Generator().manual_seed(2)) * 30.0
    model.eval()
    assert torch.allclose(model(x), smallcnn.forward(weights, x, False), atol=1e-5)
    model.dropout_rates = (0.0, 0.0)
    model.train()
    monkeypatch.setattr(smallcnn, "_dropout", lambda v, rate, gen: v)
    stats: dict = {}
    assert torch.allclose(model(x), smallcnn.forward(weights, x, True, None, stats), atol=1e-5)
    smallcnn.update_running(weights, stats)
    for key, value in model.state_dict().items():
        assert torch.allclose(value, weights[key], atol=1e-5), key


def test_training_step_with_adam_matches_the_port():
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.train.state import Adam

    weights = inputs.make_weights(11, smallcnn.spec(10, 3072), "cpu")
    model = build_model("smallcnn", 10, 3072, torch.device("cpu"), 11)
    model.load_state_dict(weights)
    model.dropout_generator = torch.Generator().manual_seed(5)
    model.train()
    x = torch.randn(8, 1, 101, 40, generator=torch.Generator().manual_seed(3)) * 20.0
    y = torch.arange(8) % 10
    opt = Adam(list(model.parameters()), 1e-4)
    losses = []
    for _ in range(2):
        loss = torch.nn.functional.cross_entropy(model(x), y)
        opt.step(list(torch.autograd.grad(loss, opt.params)))
        losses.append(float(loss.detach()))
    masks = steps.Masks([(torch.Generator().manual_seed(5), 8)])  # the port's dropout stream, drawn alike
    ref = steps.train_steps(weights, [(x, y)] * 2, 1e-4, [masks] * 2)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for key, value in model.state_dict().items():
        assert torch.allclose(value, ref["state"][key], rtol=1e-4, atol=1e-6), key


def test_trigger_step_matches_the_port():
    from audiobd_tpu_torch.configs import make_config
    from audiobd_tpu_torch.data.speech_commands import mfcc_params
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.poison import flowmur
    from audiobd_tpu_torch.train.state import Adam

    dsp = {"sample_rate": 16000, "n_fft": 2048, "hop_length": 512, "n_mels": 128, "n_mfcc": 13}
    pcfg = make_config("flowmur", device="cpu", trigger_duration=0.5, snr_db=30, flowmur_opt_lr=1e-3,
                       flowmur_clamp=0.2, target_label=2, **dsp)
    hosts, _ = inputs.make_clips(13, 10, 1, 16000, "cpu", name="hosts")
    weights = inputs.make_weights(13, smallcnn.spec(10, 224), "cpu", name="surrogate")
    model = build_model("smallcnn", 10, 224, torch.device("cpu"), 13)
    model.load_state_dict(weights)
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    trigger = torch.full((8000,), 0.1, requires_grad=True)
    opt = Adam([trigger], 1e-3)
    positions = torch.randint(0, 16000 - 8000 + 1, (10,), generator=torch.Generator().manual_seed(4))
    params = mfcc_params(pcfg)
    losses = [float(flowmur.trigger_step(model, opt, hosts, positions, params, pcfg)) for _ in range(2)]

    ref_trigger = torch.full((8000,), 0.1)
    ref_opt = steps.Adam([ref_trigger], 1e-3)
    ref_losses = []
    target = torch.full((10,), 2)
    for _ in range(2):
        leaf = ref_trigger.detach().requires_grad_(True)
        mixed = torch.clamp(steps.deploy(hosts, leaf, positions, 30), -1.0, 1.0)
        feats = mfcc(mixed, 16000, 2048, 512, 128, 13)
        loss = torch.nn.functional.cross_entropy(smallcnn.forward(weights, feats[:, None], False), target)
        (grad,) = torch.autograd.grad(loss, leaf)
        (ref_trigger,) = ref_opt.step([ref_trigger], [grad])
        ref_trigger = torch.clamp(ref_trigger, -0.2, 0.2)
        ref_losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    change, ref_change = (trigger.detach() - 0.1).norm(), (ref_trigger - 0.1).norm()
    assert abs(float(change - ref_change)) <= 1e-4 * float(ref_change)
