"""The port's dataset fetcher, plots and command table against the JAX
package's (audiobd_tpu/cli/get_dataset.py, utils/visual.py, __main__.py).

``get_dataset`` fetches a tarball that the test writes, through a
``file://`` URL put into ``URLS``; nothing touches the network. The PNGs
are checked as files that matplotlib wrote (a PNG signature, a size); the
pixels are not compared.
"""

import io
import os
import sys
import tarfile

import numpy as np
import pytest

from audiobd_tpu import __main__ as jax_main
from audiobd_tpu.cli import get_dataset as jax_get_dataset
from audiobd_tpu_torch import __main__ as port_main_module
from audiobd_tpu_torch.__main__ import main as port_main
from audiobd_tpu_torch.cli import get_dataset
from audiobd_tpu_torch.poison.ultrasonic import UltrasonicTrigger
from audiobd_tpu_torch.utils import visual

PNG = b"\x89PNG\r\n\x1a\n"


def _is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG and os.path.getsize(path) > 1000


def _tarball(path, members: dict[str, bytes]) -> None:
    with tarfile.open(path, "w:gz") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


MEMBERS = {"yes/a.wav": b"RIFF-a", "no/b.wav": b"RIFF-bb", "_background_noise_/README.md": b"noise"}


def test_get_dataset_fetches_and_extracts_as_jax(tmp_path, monkeypatch, capsys):
    src = tmp_path / "src.tar.gz"
    _tarball(src, MEMBERS)
    for module, root in ((get_dataset, tmp_path / "port"), (jax_get_dataset, tmp_path / "jax")):
        monkeypatch.setitem(module.URLS, "0.01", src.as_uri())
        target = module.download("0.01", str(root))
        assert target == os.path.join(str(root), "SpeechCommands", "speech_commands_v0.01")
        assert (root / "speech_commands_v0.01.tar.gz").exists()
    for name, data in MEMBERS.items():
        assert (tmp_path / "port" / "SpeechCommands" / "speech_commands_v0.01" / name).read_bytes() == data
    assert sorted(os.listdir(tmp_path / "port" / "SpeechCommands" / "speech_commands_v0.01")) == sorted(
        os.listdir(tmp_path / "jax" / "SpeechCommands" / "speech_commands_v0.01"))
    out = capsys.readouterr().out
    assert out.count("downloading file://") == 2 and out.count("extracting to") == 2


def test_get_dataset_skips_a_populated_target_and_reports_failures(tmp_path, monkeypatch, capsys):
    target = tmp_path / "SpeechCommands" / "speech_commands_v0.02"
    target.mkdir(parents=True)
    (target / "keep.txt").write_text("x")
    monkeypatch.setitem(get_dataset.URLS, "0.01", (tmp_path / "missing.tar.gz").as_uri())
    done = port_main(["get_dataset", "--version", "both", "--root", str(tmp_path)])
    assert done == [str(target)]
    out = capsys.readouterr().out
    assert f"{target} already populated, skipping" in out
    assert ("download of v0.01 failed" in out and "fetch the archive manually and place it at "
            f"{tmp_path}/speech_commands_v0.01.tar.gz" in out)
    assert os.listdir(target) == ["keep.txt"]


def test_plots_write_pngs(tmp_path):
    curves = [2.3, 1.5, 1.1]
    visual.plot_loss(curves, curves[::-1], curves, str(tmp_path / "loss.png"))
    visual.plot_metrics([10, 50, 90], [0, 40, 95], [12, 48, 88], [5, 60, 97], str(tmp_path / "sub" / "m.png"))
    wav = np.sin(np.arange(4000) / 10.0).astype(np.float32)
    visual.plot_waveform(wav, 16000, str(tmp_path / "w.png"))
    visual.plot_fft(wav, 16000, str(tmp_path / "f.png"))
    visual.plot_mfccs(np.random.default_rng(0).standard_normal((1, 20, 13)), str(tmp_path / "c.png"))
    visual.plot_mel(np.abs(np.random.default_rng(1).standard_normal((20, 32))), str(tmp_path / "mel.png"))
    for name in ("loss.png", "sub/m.png", "w.png", "f.png", "c.png", "mel.png"):
        assert _is_png(tmp_path / name), name


def test_trainer_writes_both_pngs_or_says_why_not(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["badnets", "--synthetic", "--synthetic_per_class", "2", "--num_epochs", "1", "--batch_size", "8",
            "--device", "cpu"]
    port_main([*argv, "--result", "plots"])
    assert _is_png(tmp_path / "record" / "plots" / "loss.png")
    assert _is_png(tmp_path / "record" / "plots" / "acc-like metrics.png")

    # Where matplotlib cannot be imported (the card's machine has none) the
    # run ends all the same, with its CSVs and checkpoint, and says so.
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    port_main([*argv, "--result", "no_plots"])
    assert "plotting skipped: " in capsys.readouterr().out
    rec = tmp_path / "record" / "no_plots"
    assert (rec / "loss_result.csv").exists() and (rec / "torch_checkpoint" / "model.pt").exists()
    assert not (rec / "loss.png").exists()


def test_ultrasonic_debug_plots(tmp_path):
    debug = tmp_path / "debug"
    UltrasonicTrigger(30, "mid", wave_path=str(tmp_path / "t.wav"))  # writes t.wav, which both read below
    trig = UltrasonicTrigger(30, "mid", wave_path=str(tmp_path / "t.wav"), debug=True, debug_dir=str(debug))
    out = trig.trigger()
    assert out.shape == (1, 44100)
    assert sorted(os.listdir(debug)) == ["trigger_fft.png", "trigger_mfcc.png", "trigger_wave.png"]
    assert all(_is_png(debug / f) for f in os.listdir(debug))
    quiet = UltrasonicTrigger(30, "mid", wave_path=str(tmp_path / "t.wav"), debug_dir=str(tmp_path / "none"))
    assert np.array_equal(quiet.trigger(), out) and not (tmp_path / "none").exists()


def test_command_table_matches_jax():
    assert list(port_main_module.COMMANDS) == list(jax_main.COMMANDS)
    assert len(port_main_module.COMMANDS) == 11
    for name in port_main_module.COMMANDS:
        assert f" {name}" in port_main_module.__doc__ or f"{name}," in port_main_module.__doc__, name


@pytest.mark.parametrize("argv", [[], ["nope"]])
def test_unknown_command_lists_the_table(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        port_main(argv)
    assert exc.value.code == 1
    assert "get_dataset, infer" in capsys.readouterr().out
