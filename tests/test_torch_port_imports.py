"""The port stands alone: no JAX, no JAX-ecosystem packages, nothing of
audiobd_tpu; AST's plain reference imports nothing of the port either; and
the port's entry point refuses to fall back to the CPU unasked."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "audiobd_tpu"}


def _sources():
    root = os.path.join(REPO, "audiobd_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    bad = FORBIDDEN.intersection(_imported_tops(path))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_reference_imports_nothing_of_the_port_or_of_jax():
    """benchmark/reference/ast.py, AST's plain reference, is plain torch: no
    port module and nothing of JAX."""
    path = os.path.join(REPO, "benchmark", "reference", "ast.py")
    tops = set(_imported_tops(path))
    assert not tops & (FORBIDDEN | {"audiobd_tpu_torch", "reference", "benchmark"}), sorted(tops)
    assert tops <= {"__future__", "contextlib", "functools", "math", "numpy", "torch"}, sorted(tops)


def test_profiling_imports_nothing_of_the_kernels():
    """utils/profiling.py, the counters' registry, sits below ops/: the
    kernels count their launches in it, and it names none of them."""
    path = os.path.join(REPO, "audiobd_tpu_torch", "utils", "profiling.py")
    tree = ast.parse(open(path).read(), path)
    names = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import) for alias in node.names}
    names |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module}
    assert not {n for n in names if n.split(".")[:2] == ["audiobd_tpu_torch", "ops"]}, sorted(names)


def test_importing_every_module_loads_no_jax():
    pkg = os.path.join(REPO, "audiobd_tpu_torch")
    modules = ["audiobd_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([pkg], prefix="audiobd_tpu_torch.")
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "assert 'yaml' not in sys.modules, 'yaml is imported only for --config'\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib is imported only to draw a plot'\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "audiobd_tpu_torch.__main__" in modules and len(modules) > 20


def test_cli_without_cuda_or_device_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from audiobd_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["badnets", "--synthetic", "--synthetic_per_class", "1", "--num_epochs", "1"])
