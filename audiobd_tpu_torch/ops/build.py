"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` has a plain C interface. It is compiled by ``nvcc`` for
``sm_90a`` into its own shared library under ``_build/`` (git-ignored),
named by a digest of its source and flags so an edited source is rebuilt,
and loaded with ``ctypes``. Every source is compiled in parallel on the first
use of any kernel; nothing is built when a module is imported. ``build`` is
the port's one build routine: ``data/native.py`` builds the wav decoder
with it too, by ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Callable
from pathlib import Path

import torch

from audiobd_tpu_torch.utils import profiling

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("mfcc.cu", "conv1_bn_pool.cu", "conv2_bn_pool.cu", "effects.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_SHARED_BYTES = 232_448  # the dynamic shared memory one block may use on the H100 (227 KB)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def library_path(source: Path, flags: tuple[str, ...]) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(sources: list[Path], compiler: Callable[[], str], flags: tuple[str, ...]) -> dict[Path, Path]:
    """Compile every source whose library is missing, all at once, with
    ``compiler()`` (asked for only when something is built) and ``flags``.
    Returns {source: library path}; the compiler's output (registers,
    spills) is kept beside each library as ``<stem>.log``. A failed
    compile raises."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src: library_path(src, flags) for src in sources}
    todo = [src for src, path in paths.items() if not path.exists()]
    if not todo:
        return paths
    exe = compiler()
    procs = []
    for src in todo:
        tmp = paths[src].with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *flags, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_bytes(out)
        if proc.returncode != 0:
            failures.append(f"{Path(exe).name} failed for {src.name}:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, paths[src])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def build_all() -> dict[str, Path]:
    """Every kernel source in ``csrc/`` built by nvcc: {source name: library path}."""
    paths = build([CSRC_DIR / src for src in SOURCES], _nvcc, NVCC_FLAGS)
    return {src.name: path for src, path in paths.items()}


def load_library(source: str) -> ctypes.CDLL:
    with _lock:
        if source not in _libraries:
            _libraries[source] = ctypes.CDLL(str(build_all()[source]))
        return _libraries[source]


class CudaKernel:
    """One C entry point of a kernel library, with the count of its launches.

    The entry point takes device pointers and the current CUDA stream,
    allocates nothing, and returns ``cudaGetLastError()``; a non-zero code
    raises here. Each successful call counts one on the counter
    ``profiling.KERNEL + name``, which ``launches`` reads."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.counter = profiling.KERNEL + name
        profiling.count(self.counter, 0)
        self._fn = None
        self._error_string = None
        self._use_device = None

    @property
    def launches(self) -> int:
        return profiling.counts()[self.counter]

    @launches.setter
    def launches(self, n: int) -> None:
        profiling.count(self.counter, n - self.launches)

    def _bind(self):
        lib = load_library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]  # + the stream
        fn.restype = ctypes.c_int
        err = lib.error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        use = lib.use_device
        use.argtypes = [ctypes.c_int]
        use.restype = ctypes.c_int
        self._fn, self._error_string, self._use_device = fn, err, use

    def _check(self, code: int) -> None:
        if code != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} failed: {self._error_string(code).decode()} ({code})"
            )

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            self._bind()
        index = device.index if device.index is not None else torch.cuda.current_device()
        # The library has its own CUDA runtime: point it at the tensors' card.
        self._check(self._use_device(index))
        self._check(self._fn(*args, torch.cuda.current_stream(device).cuda_stream))
        profiling.count(self.counter)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
