"""Build and load the port's CUDA kernels.

Each kernel source under ``ops/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs
at first use, into ``ops/_build/<hash>/`` (listed in ``.gitignore``), keyed by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: name -> (seconds the build took, nvcc's output); absent when the library
#: was already built.
build_info: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or
    the one on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
            "gome_tpu_torch/ops/csrc at first use"
        )
    return found


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (the hash covers source + flags)."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, key, f"lib{name}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is missing; return its path.
    Raises with nvcc's output if the compile fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name} ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_info[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    from ..obs.compile_journal import JOURNAL

    JOURNAL.record("nvcc_build", (name,), build_info[name][0])
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load the library of ``csrc/<name>.cu``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
