"""Build and load the port's native host library.

The C++ sources under ``native/csrc/`` (the port's copies of the reference's
host ops, order codec and file log) compile with ``g++`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, never at import, into ``native/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources, the flags and the compiler,
so an edited source rebuilds and an unchanged one loads at once.

The build is atomic: one process compiles under an ``fcntl`` lock into a
temporary file that ``os.replace`` puts in place, so test workers that reach
the first build together neither race nor load half a file. Where no
``g++`` is found, `load` returns None and the callers take their Python
branches. Where ``g++`` is found and the compile fails, `build` raises with
the compiler's output: a broken build is never hidden behind the Python
branches.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_ROOT = os.path.join(HERE, "_build")
SOURCES = ("filelog.cc", "ordercodec.cc", "hostops.cc")
LIB = "libgome_torch_host.so"
#: The compiler; looked up on PATH at each first load.
CXX = "g++"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
#: compiler name -> the loaded library, or None where it is not on PATH.
_loaded: dict[str, ctypes.CDLL | None] = {}
#: Seconds the last compile in this process took (None: nothing compiled,
#: the library was already built).
build_seconds: float | None = None


def library_path(cxx: str) -> str:
    """Where the library builds to (the hash covers sources, flags and
    compiler)."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join((cxx, *CXX_FLAGS)).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB)


def build(cxx: str) -> str:
    """Compile with `cxx` if the library is missing; return its path.
    Raises with the compiler's output if the compile fails."""
    global build_seconds
    out = library_path(cxx)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(os.path.join(os.path.dirname(out), "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compiler per build dir
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp,
               *(os.path.join(CSRC, s) for s in SOURCES)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build the native host library "
                    f"({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL | None:
    """The library (built at first use), or None where no compiler is on
    PATH. Loaded with the default RTLD_LOCAL, so its symbols never mix
    with another library's of the same names."""
    with _lock:
        if CXX not in _loaded:
            cxx = shutil.which(CXX)
            _loaded[CXX] = None if cxx is None else ctypes.CDLL(build(cxx))
        return _loaded[CXX]
