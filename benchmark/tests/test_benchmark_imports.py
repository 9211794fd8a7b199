"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port, by the sources and by what a process
holds once it has run; top-level names compared whole."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 20
    for path in files:
        assert not top_level_imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert "audiobd_tpu_torch" not in names and not names & set(harness.FORBIDDEN), path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark"):
                assert node.module.startswith(("benchmark.reference", "benchmark.inputs")), (path, node.module)


def test_names_are_compared_whole(monkeypatch):
    port = {"audiobd_tpu_torch": sys, "audiobd_tpu_torch.ops": sys, "audiobd_tpu_tools": sys, "numpy": sys}
    monkeypatch.setattr(sys, "modules", dict(port))
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**port, "audiobd_tpu.dsp": sys, "jaxlib": sys})
    assert harness.forbidden_modules() == ["audiobd_tpu", "jaxlib"]


def test_finish_refuses_a_process_holding_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "flax", sys)
    line = harness.result_line(True, 1, 0, {}, {}, {})
    assert harness.finish(line) != 0
    assert capsys.readouterr().out == ""


REFERENCE_RUN = """
import sys, numpy as np, torch
from benchmark import inputs
from benchmark.reference import smallcnn, steps
from benchmark.reference.mfcc import mfcc_rows
dsp = {"sample_rate": 16000, "n_fft": 400, "hop_length": 160, "n_mels": 128, "n_mfcc": 40}
clips, labels = inputs.make_clips(5, 10, 2, 16000, "cpu")
w = inputs.make_weights(5, smallcnn.spec(10, 3072), "cpu")
x = mfcc_rows(clips, dsp)
masks = [steps.Masks([(inputs.torch_stream(5, "d", "cpu"), 20)])]
steps.train_steps(w, [(x, torch.from_numpy(labels))], 1e-4, masks)
cfg = {"trigger_duration": 0.1, "snr_db": 30, "flowmur_opt_lr": 1e-3, "flowmur_clamp": 0.2, "target_label": 2,
       "dsp": {"sample_rate": 16000, "n_fft": 2048, "hop_length": 512, "n_mels": 128, "n_mfcc": 13}}
steps.search_call(inputs.make_weights(5, smallcnn.spec(10, 224), "cpu"), clips, cfg, 1, 8,
                  inputs.np_stream(5, "o"), inputs.torch_stream(5, "p", "cpu"))
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

CELL_RUN = """
import sys, time, torch
from pathlib import Path
from benchmark import harness, run
from benchmark.tests import tinycells
tmp = Path(sys.argv[1])
bench = tinycells.make(tmp)
for name in ("tiny.train", "tiny.search"):
    cell = harness.load_cell(name, bench, tmp / "BENCHMARK.json")
    args = run.parse(["--workload", name, "--seed", "3000000021", "--seconds", "0.2", "--trace", "0"])
    assert run.run_cell(cell, args, torch.device("cpu"), time.time(), bench)["correct"]
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def loaded_top_level_names(code: str, *args: str) -> set[str]:
    """The whole top-level names of every module a fresh process holds after
    running ``code``."""
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_port_or_of_jax():
    names = loaded_top_level_names(REFERENCE_RUN)
    assert "torch" in names and "benchmark" in names
    assert not names & {"audiobd_tpu_torch", *harness.FORBIDDEN}, names


def test_a_cells_run_loads_no_jax(tmp_path):
    names = loaded_top_level_names(CELL_RUN, str(tmp_path))
    assert "audiobd_tpu_torch" in names  # the program under test: the port
    assert not names & set(harness.FORBIDDEN), names
