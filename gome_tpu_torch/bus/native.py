"""ctypes binding for the port's native (C++) file-log queue backend
(native/csrc/filelog.cc, the port's copy of the reference's).

The port of ``gome_tpu/bus/native.py``. `NativeFileQueue` is drop-in
interchangeable with the Python `FileQueue` — same Queue interface AND the
same on-disk format, so a directory written by one can be reopened by the
other, and by gome_tpu's queues (tested both directions). It runs on the
port's own library (``gome_tpu_torch/native/build.py``, g++ at first use);
where no g++ is found, `native_available()` is False and construction
raises.

Native additions over the Python backend: `publish_batch` amortizes one
write+fsync over a whole micro-batch of events, and the record scan/read
paths run without interpreter overhead.
"""

from __future__ import annotations

import ctypes
import os
import threading

from ..native import build
from .base import Message, Queue, _Waitable

_declared = None  # the library whose gq_* prototypes are declared


def _load():
    """The port's native library with its gq_* prototypes set, or None
    where no g++ is found (a failed compile raises)."""
    global _declared
    lib = build.load()
    if lib is None or lib is _declared:
        return lib
    lib.gq_open.restype = ctypes.c_void_p
    lib.gq_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.gq_close.argtypes = [ctypes.c_void_p]
    lib.gq_publish_batch.restype = ctypes.c_int64
    lib.gq_publish_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32,
    ]
    lib.gq_end_offset.restype = ctypes.c_int64
    lib.gq_end_offset.argtypes = [ctypes.c_void_p]
    lib.gq_committed.restype = ctypes.c_int64
    lib.gq_committed.argtypes = [ctypes.c_void_p]
    lib.gq_read_from.restype = ctypes.c_int64
    lib.gq_read_from.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    for name in ("gq_commit", "gq_rollback", "gq_truncate_to"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    _declared = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class NativeFileQueue(_Waitable, Queue):
    def __init__(self, name: str, path_base: str, fsync: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError("native queue unavailable (no g++)")
        self.name = name
        self._lib = lib
        os.makedirs(os.path.dirname(path_base) or ".", exist_ok=True)
        self._h = lib.gq_open(path_base.encode(), 1 if fsync else 0)
        if not self._h:
            raise RuntimeError(f"gq_open failed for {path_base}")
        self._lock = threading.Lock()
        self._init_wait()

    def _handle(self):
        """The open native handle; raises (instead of passing NULL into C,
        which would segfault) if the queue was closed. Serialization of the
        actual operations happens in the C library (Queue::mu); the Python
        lock exists only to make close() atomic vs this check. Contract (as
        for the Python backend): stop consumers before close() — a call
        racing close() may still reach a freed handle."""
        with self._lock:
            h = self._h
        if not h:
            raise ValueError(f"queue {self.name!r} is closed")
        return h

    # -- Queue interface -----------------------------------------------------
    def publish(self, body: bytes) -> int:
        return self.publish_batch([body])

    def publish_batch(self, bodies: list[bytes]) -> int:
        """Append many records with ONE write+fsync; returns the offset of
        the first. (The native fast path the Python backend lacks.)"""
        blob = b"".join(bodies)
        n = len(bodies)
        lengths = (ctypes.c_uint32 * n)(*[len(b) for b in bodies])
        buf = (ctypes.c_ubyte * len(blob)).from_buffer_copy(blob)
        first = self._lib.gq_publish_batch(self._handle(), buf, lengths, n)
        if first < 0:
            raise OSError("native publish failed")
        self._notify_publish()
        return int(first)

    def read_from(self, offset: int, max_n: int) -> list[Message]:
        if max_n <= 0:
            return []
        cap = 1 << 16
        while True:
            bodies = (ctypes.c_ubyte * cap)()
            lengths = (ctypes.c_uint32 * max_n)()
            n = self._lib.gq_read_from(
                self._handle(), offset, max_n, bodies, cap, lengths
            )
            if n == -2:
                raise OSError(
                    f"native read I/O error on queue {self.name!r} (log "
                    "file unreadable)"
                )
            if n >= 0:
                out = []
                pos = 0
                for i in range(n):
                    ln = lengths[i]
                    out.append(
                        Message(
                            offset=offset + i,
                            body=bytes(bodies[pos : pos + ln]),
                        )
                    )
                    pos += ln
                return out
            cap *= 4  # n == -1: caller buffer too small; grow and retry
            if cap > 1 << 30:
                raise OSError("native read: record set exceeds 1 GiB buffer")

    def end_offset(self) -> int:
        return int(self._lib.gq_end_offset(self._handle()))

    def committed(self) -> int:
        return int(self._lib.gq_committed(self._handle()))

    def commit(self, offset: int) -> None:
        rc = self._lib.gq_commit(self._handle(), offset)
        if rc == -1:
            raise ValueError(
                f"commit out of range: {offset} (committed={self.committed()},"
                f" end={self.end_offset()})"
            )
        if rc != 0:
            raise OSError("native commit failed")

    def rollback(self, offset: int) -> None:
        rc = self._lib.gq_rollback(self._handle(), offset)
        if rc == -1:
            raise ValueError(f"rollback going forwards: {offset}")
        if rc != 0:
            raise OSError("native rollback failed")

    def truncate_to(self, offset: int) -> None:
        rc = self._lib.gq_truncate_to(self._handle(), offset)
        if rc == -1:
            raise ValueError(f"cannot truncate below committed: {offset}")
        if rc != 0:
            raise OSError("native truncate failed")

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.gq_close(self._h)
                self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
