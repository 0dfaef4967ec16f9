"""Compile journal — a bounded record of first-dispatch and build events.

The port of ``gome_tpu/obs/compile_journal.py``. The span taxonomy
(utils.trace) splits dispatch cost into ``compile_miss`` /
``compile_hit``, but a histogram can only say that a miss happened, not
WHICH shape caused it. The journal records, per miss on the
``engine.frames`` first-seen-combo path (``BatchEngine.combo_seen`` /
``record_combo``): the full dispatch combo key, the wall-clock the first
dispatch at that combo cost, and an analytic detail block (grid cells,
op-grid / record / fetch-buffer bytes).

On the card a first-seen combo pays no trace and no compile — PyTorch has
no trace cache to miss — but it pays the first launch at that shape and
the caching allocator's growth for its buffers; that is what the
``frame_dispatch`` entries time here, at the same point as the
reference. The port's own compiles are journaled apart, as entries of
their own kind: ``nvcc_build`` (ops/build.py, one per CUDA kernel source)
and ``gxx_build`` (native/build.py, the host library), recorded when a
build actually runs at first use (a cached library records nothing).

Operators read it as ``gome_compile_seconds{entry=...}`` histograms in
``/metrics`` (count = events this process paid, sum = wall-clock).

Hot-path contract (same as ``utils.trace.Tracer``): the module-level
``JOURNAL`` is DISABLED by default — every hook degrades to one attribute
check and zero allocations (asserted by tests with a
``sys.getallocatedblocks`` guard). ``install()`` arms it.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils.metrics import REGISTRY, Registry

#: Wall-clock buckets: first dispatches are ~0.1-100 ms, nvcc builds tens
#: of seconds — the default latency buckets top out at 2.5s and would
#: flatten exactly the tail we watch.
COMPILE_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0,
)


class CompileJournal:
    """Bounded journal of compile events keyed by entry name.

    Disabled by default: ``record`` returns after one attribute check.
    ``install(keep_n=...)`` arms it with a ring of the last ``keep_n``
    events plus per-entry running totals (count / seconds), which survive
    ring eviction — the ring answers "what just compiled", the totals
    answer "how much compile has this process paid"."""

    def __init__(self):
        self.clock = time.perf_counter  # single-writer: install() caller
        self._lock = threading.Lock()
        self._entries: deque | None = None  # guarded by self._lock
        self._totals: dict[str, list] = {}  # guarded by self._lock
        self._registry: Registry = REGISTRY  # single-writer: install() caller

    @property
    def enabled(self) -> bool:
        # Off-lock read is the hot-path fast check: the reference read is
        # atomic and mutators re-check under the lock (same benign-race
        # contract as Tracer.recorder).
        return self._entries is not None

    def install(
        self,
        keep_n: int = 256,
        registry: Registry | None = None,
        clock=None,
    ) -> "CompileJournal":
        """Arm the journal. `registry` receives the
        ``gome_compile_seconds{entry=...}`` family (the process REGISTRY
        by default; tests pass a private one); `clock` is injectable for
        deterministic tests."""
        if keep_n <= 0:
            raise ValueError(f"keep_n must be positive, got {keep_n}")
        if registry is not None:
            self._registry = registry
        if clock is not None:
            self.clock = clock
        with self._lock:
            self._entries = deque(maxlen=keep_n)
            self._totals = {}
        return self

    def disable(self) -> None:
        """Back to the zero-overhead state (hooks become no-ops again),
        bound to the process REGISTRY again: a test's private registry
        must not stick to the singleton that a later EngineService arms
        with ``ops.cost``."""
        with self._lock:
            self._entries = None
            self._totals = {}
        self._registry = REGISTRY

    def record(
        self, entry: str, key, seconds: float, detail: dict | None = None
    ) -> None:
        """One compile event. `key` is the shape-combo tuple that missed
        (or the built source's name); `seconds` the wall-clock the caller
        measured; `detail` an optional analytic block (see
        frame_combo_detail). No-op (one attribute check) while disabled."""
        if self._entries is None:  # fast check; re-checked under the lock
            return
        rec = {
            "entry": entry,
            "key": tuple(key) if isinstance(key, (tuple, list)) else key,
            "seconds": float(seconds),
            "ts": time.time(),
            "detail": detail,
        }
        with self._lock:
            if self._entries is None:  # disabled between check and lock
                return
            self._entries.append(rec)
            t = self._totals.setdefault(entry, [0, 0.0])
            t[0] += 1
            t[1] += seconds
        self._registry.histogram(
            "gome_compile_seconds",
            "jit trace+compile wall-clock per first-seen shape combo",
            buckets=COMPILE_BUCKETS,
            labels={"entry": entry},
        ).observe(seconds)

    # -- views -------------------------------------------------------------
    def entries(self) -> list[dict]:
        """Ring contents, oldest first (copies — safe to mutate)."""
        with self._lock:
            return [dict(e) for e in (self._entries or ())]

    def summary(self) -> dict:
        """{entry: {"count", "seconds"}} — running totals, NOT bounded by
        the ring (evicted events still count here)."""
        with self._lock:
            return {
                name: {"count": c, "seconds": s}
                for name, (c, s) in self._totals.items()
            }

    def as_dict(self) -> dict:
        """The /cost wire form (the reference's)."""
        return {
            "enabled": self.enabled,
            "entries": self.entries(),
            "summary": self.summary(),
        }

    def export(self) -> dict:
        """The artifact wire form: ``as_dict`` plus a schema tag so dumps
        stay parseable as the format evolves."""
        return {"schema": "gome-compile-journal/1", **self.as_dict()}


#: Process-global journal (disabled until something installs it).
JOURNAL = CompileJournal()


# -- analytic combo detail -------------------------------------------------

#: DeviceOp field split (book.GRID_I32_FIELDS): 3 int32 control columns,
#: 4 book-dtype value columns. Kept as plain ints so the detail block
#: never imports the engine on the hot path.
_GRID_I32_FIELDS = 3
_GRID_VAL_FIELDS = 4
#: StepOutput record tensors with a [R, T, K] record axis (step.py).
_RECORD_TENSORS = 5


def frame_combo_detail(dtype_name: str, combo: tuple) -> dict:
    """Analytic cost block for one frame dispatch combo
    (engine.frames.submit_frame records tuples of (n_rows, t_grid, cap_g,
    dense, m_pad, k_rec, e_fills, e_cancels, totals_len)): grid cell
    count, host->device op-grid bytes, the step's [R, T, K] record-tensor
    bytes, the frame-level fetch-buffer bytes (the events' capacity; the
    sentinel column is never fetched), and ``scatter_jaxpr_eqns``: the
    reference counts its traced grid scatter's jaxpr equations and gives
    -1 when tracing is unavailable; the port's scatter
    (frames._scatter_grid_fn) is a few eager torch ops with no trace to
    count, so it is always -1 here. Pure arithmetic — called only on an
    enabled-journal MISS."""
    import numpy as np

    (
        n_rows, t_grid, cap_g, dense, m_pad, k_rec,
        e_fills, e_cancels, totals_len,
    ) = combo
    itemsize = np.dtype(dtype_name).itemsize
    wide = max(4, itemsize)  # compaction buffers: result_type(int32, dtype)
    cells = n_rows * t_grid
    return {
        "n_rows": int(n_rows),
        "t_grid": int(t_grid),
        "cap": int(cap_g),
        "dense": bool(dense),
        "m_pad": int(m_pad),
        "k_rec": int(k_rec),
        "grid_cells": int(cells),
        # packed columns [7, m_pad] + flat positions [m_pad]: what the
        # host actually uploads per dispatch of this shape (the port's
        # flat positions are int64, the reference's int32)
        "upload_bytes": int(m_pad * (7 * itemsize + 8)),
        # the scattered DeviceOp grid resident on device
        "ops_grid_bytes": int(
            cells * (_GRID_I32_FIELDS * 4 + _GRID_VAL_FIELDS * itemsize)
        ),
        # step record tensors [R, T, K] x 5 (dominant step output)
        "record_bytes": int(cells * k_rec * _RECORD_TENSORS * itemsize),
        # frame-level compaction buffers (fills[7, e_f] + cancels[2, e_c]
        # + totals[len, 4]) — the device->host fetch ceiling
        "fetch_buffer_bytes": int(
            (7 * e_fills + 2 * e_cancels) * wide + totals_len * 4 * 4
        ),
        "scatter_jaxpr_eqns": -1,
    }
