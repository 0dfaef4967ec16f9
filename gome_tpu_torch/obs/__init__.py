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
  * ``costmodel`` — the analytic cost of each engine entry (bytes,
    integer operations, peak bytes) at the reference's canonical
    geometry; the ops ``/cost`` endpoint beside the journal.
  * ``profiler`` — the measured roofline: a ``torch.profiler`` capture of
    the cost model's entries joined with their analytic rows; the ops
    ``/profile`` endpoint + ``gome_profile_*`` gauges.
  * ``fleet`` — the N-process view: merged expositions, health and seq
    audit, stitched cross-process journeys; the ops ``/fleet`` endpoint.

Every singleton is disabled by default: its hot-path hooks cost one
attribute check and allocate nothing.

Import discipline: this ``__init__`` pulls in only ``compile_journal``,
``timeline``, ``hostprof`` and ``capacity`` (none imports torch or the
engine), so ``engine.frames`` / ``service.gateway`` import the
singletons without a cycle; ``costmodel`` (the engine), ``fleet``,
``live`` (torch), ``placement`` and ``profiler`` load lazily on first
attribute access (engine.batch imports ``obs.profiler`` directly: it
keeps torch out of its module scope).
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
    "costmodel",
    "fleet",
    "hostprof",
    "live",
    "placement",
    "profiler",
]


def __getattr__(name):
    if name in ("costmodel", "fleet", "live", "placement", "profiler"):
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
