"""Host-side observability: the port of ``gome_tpu/obs`` for the parts it
has.

  * ``compile_journal`` — a bounded journal of first-seen dispatch combos
    (hooked on the ``engine.frames`` first-seen-combo path;
    ``BatchEngine.record_combo`` is the single writer) and of the port's
    nvcc / g++ builds, exported as ``gome_compile_seconds{entry=...}``.
  * ``live`` — the caching allocator's residency per card, tagged
    subsystem trees (``gome_hbm_resident_bytes{subsystem=...}``) and a
    steady-state leak detector.
  * ``timeline`` — the TIME axis: a bounded host-side sampler recording
    RSS, getrusage deltas, live-buffer counts, journal totals, queue
    depth and the geometry-manifest hash; the ops ``/timeline`` endpoint
    + ``gome_timeline_*`` gauges.
  * ``hostprof`` — the HOST-CPU axis: an in-process sampling profiler
    whose samples join against the tracer stage taxonomy, and the
    gateway admit drill; the ops ``/hostprof`` endpoint +
    ``gome_hostprof_*`` gauges.
  * ``capacity`` — the LOAD axis: coordinated-omission-safe latency
    recording, the open-loop schedule, knee detection; ``CAPACITY``
    serves an installed sweep verdict as the ops ``/capacity`` payload.
  * ``placement`` — symbol flow (a Space-Saving sketch), the dense
    dispatch occupancy ledger and the skew attribution; the ops
    ``/placement`` endpoint + ``gome_placement_*`` gauges.

Every singleton is disabled by default: its hot-path hooks cost one
attribute check and allocate nothing. The reference's ``costmodel``,
``profiler`` (``/cost``, ``/profile``: ROADMAP Queue 1 item 4) and
``fleet`` (item 5) are not ported yet.

Import discipline: this ``__init__`` pulls in only ``compile_journal``,
``timeline``, ``hostprof`` and ``capacity`` (none imports torch or the
engine), so ``engine.frames`` / ``service.gateway`` import the
singletons without a cycle; ``live`` (torch) and ``placement`` load
lazily on first attribute access.
"""

from __future__ import annotations

from .capacity import CAPACITY, LogHistogram, OpenLoopSchedule
from .compile_journal import JOURNAL, CompileJournal, frame_combo_detail
from .hostprof import HOSTPROF, HostSampler
from .timeline import TIMELINE, TimelineSampler, service_timeline

__all__ = [
    "JOURNAL",
    "CompileJournal",
    "frame_combo_detail",
    "TIMELINE",
    "TimelineSampler",
    "service_timeline",
    "HOSTPROF",
    "HostSampler",
    "CAPACITY",
    "LogHistogram",
    "OpenLoopSchedule",
    "capacity",
    "hostprof",
    "live",
    "placement",
]


def __getattr__(name):
    if name in ("live", "placement"):
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
