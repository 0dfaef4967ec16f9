"""Host-side timeline sampler — the observability layer for the TIME axis.

The port of ``gome_tpu/obs/timeline.py`` (no JAX there: a copy, its
probes reading the port's engine, allocator, journal and queues). A span
is one order's trip, the compile journal one miss, the live-buffer
monitor one scrape; nothing else records how the process evolves over
minutes, which is what steady-state claims need.

:class:`TimelineSampler` periodically snapshots, into a bounded ring:

  * host RSS (``/proc/self/statm``) and ``resource.getrusage`` deltas
    since arming — CPU user/system split, involuntary context switches
    (``ru_nivcsw`` — contention telemetry), major faults;
  * frames/orders the engine has applied (the ``note_frame`` hot-path
    hook — cumulative counters, so inter-sample throughput is a diff);
  * registered PROBES — zero-arg callables returning a JSON-able dict,
    sampled at snapshot time. :func:`service_timeline` wires the standard
    set: engine stats + cap + geometry-manifest hash, live-buffer
    count/bytes per card (obs.live: the caching allocator's counters),
    compile-journal totals, order-queue backlog, FrameBatcher
    spill/degraded state when a batcher exists, and placement occupancy.

Operators read it two ways: the ops ``/timeline`` endpoint (JSON series)
and ``gome_timeline_*`` scrape-time gauges in ``/metrics``.

Hot-path contract (same as ``utils.trace.Tracer`` and the compile
journal): the module-level ``TIMELINE`` is DISABLED by default — the one
hook on the frame hot path (``note_frame``) degrades to a single
attribute check and zero allocations (pinned by tests with the
``sys.getallocatedblocks`` guard). ``install()`` arms it — service boot
wires it from the ops config (``ops.timeline``).
"""

from __future__ import annotations

import hashlib
import json
import os
import resource
import threading
import time

from collections import deque

from ..utils.metrics import REGISTRY, Registry

try:
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):  # non-POSIX fallback
    _PAGE = 4096


def host_rss_bytes() -> int:
    """Current resident set size in bytes. ``/proc/self/statm`` is the
    live value; ``ru_maxrss`` (the high-water mark, KiB on Linux) is the
    fallback where /proc is unavailable — a high-water mark cannot show
    shrinkage, but its SLOPE still bounds growth, which is what the soak
    verdict reads."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except Exception:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def geometry_manifest_hash(engine) -> str:
    """Stable short hash of one BatchEngine's shape manifest (floors +
    recorded dispatch combos). At steady state this MUST stop changing:
    a drifting hash mid-run means the flow is still minting dispatch
    shapes — on the card each mint pays a first launch at a new shape and
    the allocator's growth for its buffers."""
    m = engine.shape_manifest()
    blob = json.dumps(m, sort_keys=True, default=int)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


class TimelineSampler:
    """Bounded time-series recorder of host/process/engine state.

    Disabled by default: ``note_frame`` returns after one attribute
    check, ``sample()`` returns None. ``install(interval_s=..,
    keep_n=..)`` arms it with a ring of the last ``keep_n`` samples;
    ``start()`` runs the periodic sampler on a daemon thread (``sample()``
    can also be driven manually — tests script the clock)."""

    def __init__(self):
        self.clock = time.monotonic  # single-writer: install() caller
        self.interval_s = 1.0  # single-writer: install()/start() caller
        self._lock = threading.Lock()
        self._samples: deque | None = None  # guarded by self._lock
        self._frames = 0  # guarded by self._lock
        self._orders = 0  # guarded by self._lock
        self._probes: dict[str, object] = {}
        self._rusage0 = None  # single-writer: install()/disable() caller
        self._registry: Registry = REGISTRY  # single-writer: install()/disable() caller
        self._thread: threading.Thread | None = None  # single-writer: start()/stop() caller
        self._stop = threading.Event()

    @property
    def enabled(self) -> bool:
        # Off-lock read is the hot-path fast check (same benign-race
        # contract as CompileJournal.enabled / Tracer.recorder).
        return self._samples is not None  # gomelint: disable=GL402

    # -- lifecycle ---------------------------------------------------------
    def install(
        self,
        interval_s: float = 1.0,
        keep_n: int = 512,
        registry: Registry | None = None,
        clock=None,
    ) -> "TimelineSampler":
        """Arm the sampler. `registry` receives the ``gome_timeline_*``
        gauges (process REGISTRY by default; tests pass a private one);
        `clock` is injectable for deterministic tests. The rusage
        baseline is taken HERE, so every sample's CPU/ctx-switch/fault
        fields are deltas over the armed window."""
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        if keep_n <= 0:
            raise ValueError(f"keep_n must be positive, got {keep_n}")
        self.interval_s = float(interval_s)
        if registry is not None:
            self._registry = registry
        if clock is not None:
            self.clock = clock
        with self._lock:
            self._samples = deque(maxlen=keep_n)
            self._frames = 0
            self._orders = 0
        self._rusage0 = resource.getrusage(resource.RUSAGE_SELF)
        self._export(self._registry)
        return self

    def disable(self) -> None:
        """Back to the zero-overhead state: stops the thread, drops the
        ring AND the probes (probes hold references into a service), and
        re-binds the process REGISTRY (a test's private registry must
        not stick to the singleton past its test)."""
        self.stop()
        with self._lock:
            self._samples = None
            self._frames = 0
            self._orders = 0
        self._probes.clear()
        self._registry = REGISTRY

    def register(self, name: str, fn) -> "TimelineSampler":
        """Add a probe: a zero-arg callable returning a JSON-able dict,
        evaluated at every sample. A raising probe lands as
        ``{"error": ...}`` in its slot — one dead subsystem must not
        blind the whole timeline."""
        self._probes[name] = fn
        return self

    # -- hot-path hook -----------------------------------------------------
    def note_frame(self, n_orders: int = 0) -> None:
        """One applied frame (engine.frames._assemble). Disabled = one
        attribute check, zero allocations."""
        if self._samples is None:  # gomelint: disable=GL402 — fast check;
            return  # disabled-state contract, re-checked under the lock
        with self._lock:
            if self._samples is None:
                return
            self._frames += 1
            self._orders += int(n_orders)

    # -- sampling ----------------------------------------------------------
    def sample(self) -> dict | None:
        """Take one snapshot now; returns the sample (a copy) or None
        while disabled."""
        if self._samples is None:  # gomelint: disable=GL402
            return None
        base = self._rusage0
        ru = resource.getrusage(resource.RUSAGE_SELF)
        rec: dict = {
            "ts": time.time(),
            "t": self.clock(),
            "rss_bytes": host_rss_bytes(),
            "cpu_utime_s": round(ru.ru_utime - base.ru_utime, 6),
            "cpu_stime_s": round(ru.ru_stime - base.ru_stime, 6),
            "majflt": ru.ru_majflt - base.ru_majflt,
            "nvcsw": ru.ru_nvcsw - base.ru_nvcsw,
            "nivcsw": ru.ru_nivcsw - base.ru_nivcsw,
        }
        with self._lock:
            rec["frames"] = self._frames
            rec["orders"] = self._orders
        for name, fn in list(self._probes.items()):
            try:
                rec[name] = fn()
            except Exception as exc:
                rec[name] = {"error": str(exc)}
        with self._lock:
            if self._samples is None:  # disabled between check and lock
                return None
            self._samples.append(rec)
        return dict(rec)

    def start(self, interval_s: float | None = None) -> "TimelineSampler":
        """Run the periodic sampler on a daemon thread (idempotent)."""
        if self._samples is None:  # gomelint: disable=GL402 — arm check;
            # a disable() racing start() is caught by sample()'s own
            # locked re-check (the thread then records nothing)
            raise RuntimeError("install() the sampler before start()")
        if interval_s is not None:
            if interval_s <= 0:
                raise ValueError(
                    f"interval_s must be positive, got {interval_s}"
                )
            self.interval_s = float(interval_s)
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="timeline-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the sampler thread (the ring and its samples survive)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # a broken probe must not kill the thread
                pass

    # -- views -------------------------------------------------------------
    def series(self) -> list[dict]:
        """Ring contents, oldest first (copies — safe to mutate)."""
        with self._lock:
            return [dict(s) for s in (self._samples or ())]

    def latest(self) -> dict | None:
        with self._lock:
            if not self._samples:
                return None
            return dict(self._samples[-1])

    def as_dict(self) -> dict:
        """The /timeline wire form."""
        return {
            "enabled": self.enabled,
            "interval_s": self.interval_s,
            "samples": self.series(),
        }

    # -- metrics export ----------------------------------------------------
    def _export(self, registry: Registry) -> None:
        """Scrape-time ``gome_timeline_*`` gauges: live host/process
        reads plus the sampler's own counters. Re-installs rebind the
        callbacks (callback_gauge contract). The counter reads are
        off-lock on purpose — a /metrics scrape must never contend with
        the frame hot path; an int read is a single bytecode op under
        the GIL (merely stale, never torn)."""
        registry.callback_gauge(
            "gome_timeline_rss_bytes",
            "host resident set size (bytes, /proc/self/statm)",
            host_rss_bytes,
        )
        registry.callback_gauge(
            "gome_timeline_cpu_seconds_total",
            "process CPU seconds (user+system, getrusage)",
            lambda: (
                lambda ru: ru.ru_utime + ru.ru_stime
            )(resource.getrusage(resource.RUSAGE_SELF)),
        )
        registry.callback_gauge(
            "gome_timeline_involuntary_ctx_switches_total",
            "involuntary context switches (ru_nivcsw — core contention)",
            lambda: resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw,
        )
        registry.callback_gauge(
            "gome_timeline_major_faults_total",
            "major page faults (ru_majflt)",
            lambda: resource.getrusage(resource.RUSAGE_SELF).ru_majflt,
        )
        registry.callback_gauge(
            "gome_timeline_samples",
            "samples currently held in the timeline ring",
            lambda: len(self._samples or ()),  # gomelint: disable=GL402
        )
        registry.callback_gauge(
            "gome_timeline_frames_total",
            "frames applied since the timeline was armed",
            lambda: self._frames,  # gomelint: disable=GL402 — see _export
        )
        registry.callback_gauge(
            "gome_timeline_orders_total",
            "orders applied since the timeline was armed",
            lambda: self._orders,  # gomelint: disable=GL402 — see _export
        )


#: Process-global sampler (disabled until something installs it — the
#: service wires it from ``ops.timeline`` at boot, service.app).
TIMELINE = TimelineSampler()


# -- standard probes -------------------------------------------------------


def service_timeline(service, sampler: TimelineSampler | None = None):
    """Register the standard probe set for one EngineService / MatchEngine
    (every read happens at SAMPLE time through closures — nothing on the
    hot path, and engine growth/restore is always reflected):

      engine   — order/device-call/escalation/fallback totals, current
                 cap + n_slots, compiled-combo count, and the
                 geometry-manifest hash (steady state ⇒ hash holds still)
      live     — live buffer count/bytes per card (obs.live: the
                 caching allocator's counters; no gc pass — sampling
                 must stay cheap)
      compile  — compile-journal running totals (count + seconds paid)
      queue    — doOrder backlog (published minus committed offsets)
      batcher  — FrameBatcher buffered/spill/degraded state (only when
                 the service's gateway runs one)
      persist  — snapshot cadence + recovery state (only when the service
                 runs a Persister)
      placement — cumulative dispatch occupancy (dispatched/live/padding
                 rows, obs.placement; {} while the observatory is off)
    """
    tl = sampler or TIMELINE
    engine = getattr(service, "engine", service)
    batch = getattr(engine, "batch", engine)

    def engine_probe():
        st = batch.stats
        return {
            "orders_total": int(st.orders),
            "device_calls": int(st.device_calls),
            "cap_escalations": int(st.cap_escalations),
            "frame_fallbacks": int(st.frame_fallbacks),
            "cap": int(batch.config.cap),
            "n_slots": int(batch.n_slots),
            "seen_combos": batch.combo_count(),
            "geometry_hash": geometry_manifest_hash(batch),
        }

    tl.register("engine", engine_probe)

    def live_probe():
        from .live import live_array_stats

        return live_array_stats(collect=False)

    tl.register("live", live_probe)

    def compile_probe():
        from .compile_journal import JOURNAL

        s = JOURNAL.summary()
        return {
            "compiles": sum(v["count"] for v in s.values()),
            "compile_seconds": round(
                sum(v["seconds"] for v in s.values()), 6
            ),
        }

    tl.register("compile", compile_probe)

    q = getattr(getattr(service, "bus", None), "order_queue", None)
    if (
        q is not None
        and hasattr(q, "end_offset")
        and hasattr(q, "committed")
    ):
        tl.register(
            "queue",
            lambda: {"order_backlog": int(q.end_offset() - q.committed())},
        )

    bus = getattr(service, "bus", None)
    bus_queues = [
        bq
        for bq in (
            getattr(bus, "order_queue", None),
            getattr(bus, "match_queue", None),
        )
        if bq is not None and hasattr(bq, "depth")
    ]
    if bus_queues:
        # Per-queue depth/lag (Queue.depth — local-state read, no broker
        # I/O even on amqp): the per-partition fan-in telemetry the fleet
        # verdicts read. The "queue" probe above stays as-is — the soak
        # verdicts key on its order_backlog field.
        def bus_probe():
            return {
                bq.name: {
                    "depth": int(bq.depth()),
                    "committed": int(bq.committed()),
                }
                for bq in bus_queues
            }

        tl.register("bus", bus_probe)

    gw = getattr(service, "gateway", None)
    batcher = getattr(gw, "batcher", None) or getattr(gw, "_batcher", None)
    if batcher is not None:

        def batcher_probe():
            s = batcher.stats()
            return {
                "buffered": int(s["buffered"]),
                "spill_depth": int(s["spill_depth"]),
                "degraded": bool(s["degraded"]),
                "degraded_seconds_total": round(
                    float(s["degraded_seconds_total"]), 3
                ),
            }

        tl.register("batcher", batcher_probe)

    persist = getattr(service, "persist", None)
    if persist is not None and hasattr(persist, "probe"):
        # Snapshot cadence + recovery state (persist.snapshot.Persister) —
        # soak verdicts can now see whether snapshots kept their cadence.
        tl.register("persist", persist.probe)

    def placement_probe():
        # Occupancy history (obs.placement): cumulative dispatched/live/
        # padding rows per sample, so padding drift rides /timeline next
        # to RSS and queue depth. {} while the observatory is disarmed.
        from .placement import PLACEMENT

        return PLACEMENT.occupancy_probe()

    tl.register("placement", placement_probe)
    return tl
