"""Operator HTTP endpoint: /metrics (Prometheus text format from
utils.metrics.REGISTRY), /healthz (service.health.HealthMonitor JSON),
/trace (the order-lifecycle flight recorder as Chrome trace-event JSON —
load the dump in chrome://tracing or https://ui.perfetto.dev),
/durability (queue offsets, the matchfeed exactly-once tracker and the
fault-injection report), /cost (the compile journal, live-buffer
residency and the analytic cost model), /profile (the measured roofline),
/fleet (the merged N-process view), and the host-side observability plane
(obs/): /timeline, /placement, /capacity and /hostprof.

The reference has no observability surface at all (SURVEY §5.5 — logging
only); this is the cheap operator-facing extension the service ships: one
stdlib ThreadingHTTPServer, no dependencies, curl-able:

    curl localhost:9109/metrics
    curl localhost:9109/healthz     # 200 healthy / 503 unhealthy
    curl localhost:9109/trace > trace.json   # open in Perfetto
    curl localhost:9109/cost        # builds + live buffers + per-entry cost
    curl localhost:9109/profile     # measured roofline (capture on demand;
                                    # ?refresh=1 takes a new one)
    curl localhost:9109/durability  # snapshot cadence, recovery state,
                                    # queue offsets, matchfeed exactly-once
                                    # tracker, fault-injection report
    curl localhost:9109/timeline    # RSS/rusage/live-buffer time series
    curl localhost:9109/hostprof    # host-CPU stage attribution (?drill=1
                                    # runs the admit drill; ?format=collapsed
                                    # dumps flamegraph-ready stacks)
    curl localhost:9109/capacity    # installed capacity-sweep verdict
    curl localhost:9109/placement   # symbol-flow heavy hitters, lane/shard
                                    # occupancy ledger, skew attribution
    curl localhost:9109/fleet       # merged N-process view (obs.fleet):
                                    # per-member health, summed counters,
                                    # fleet-wide seq audit

The port of ``gome_tpu/service/ops.py``. /cost and /profile measure on
the engine's device (the card; the CPU for a ``device="cpu"`` service).
/durability carries the Persister's probe() under "persist" (null when no
Persister is attached).

Enabled by an `ops:` section in config.yaml (port, host) or by
constructing OpsServer directly around any EngineService.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY

log = get_logger("ops")


class OpsServer:
    """HTTP server exposing /metrics and /healthz for one EngineService.

    start() binds and serves on a daemon thread; port 0 picks a free port
    (the bound port is in `self.port`)."""

    def __init__(self, service=None, host: str = "127.0.0.1", port: int = 0,
                 registry=REGISTRY, tracer=None):
        from ..utils.trace import TRACER

        self.service = service
        self.host = host
        self.port = port  # single-writer: start() caller (rebound to the bound port)
        self.registry = registry
        self.tracer = tracer or TRACER  # /trace reads its flight recorder
        self._httpd: ThreadingHTTPServer | None = None  # single-writer: start()/stop() caller
        self._thread: threading.Thread | None = None  # single-writer: start()/stop() caller
        self.monitor = None
        self.live_monitor = None
        if service is not None:
            from .health import HealthMonitor

            self.monitor = HealthMonitor(service)
            from ..obs.live import service_monitor

            # Tagged live-buffer residency for /cost and the
            # gome_hbm_resident_bytes{subsystem=...} gauges — all
            # scrape-time reads, nothing on the hot path.
            self.live_monitor = service_monitor(service)
            self.live_monitor.export(self.registry)

    def _engine_target(self) -> tuple[str, object]:
        """(dtype name, device) of the attached service's engine; int32 on
        the card without one."""
        svc = self.service
        engine = getattr(svc, "engine", None) if svc is not None else None
        if engine is None:
            return "int32", None
        from ..engine.book import numpy_dtype

        return numpy_dtype(engine.config.dtype).name, engine.batch.device

    def cost_payload(self) -> dict:
        """The /cost JSON document: the compile journal
        (obs.compile_journal.JOURNAL), live-buffer residency, and the
        memoized analytic cost model + donation report on the engine's
        device (obs.costmodel). A cost-model failure degrades to an
        ``error`` field rather than a 500."""
        from ..obs.compile_journal import JOURNAL
        from ..obs.live import LiveBufferMonitor

        payload: dict = {"compile_journal": JOURNAL.as_dict()}
        mon = self.live_monitor or LiveBufferMonitor()
        payload["live_buffers"] = mon.snapshot()
        try:
            from ..obs import costmodel

            dtype, device = self._engine_target()
            payload["cost_model"] = {
                "dtype": dtype,
                "entries": costmodel.entry_report(dtype, device),
                "donation": costmodel.donation_report(dtype, device),
            }
        except Exception as exc:  # never 500 the whole surface
            log.exception("cost model unavailable")
            payload["cost_model"] = {"error": str(exc)}
        return payload

    def profile_payload(self, refresh: bool = False) -> dict:
        """The /profile JSON document: the measured roofline
        (obs.profiler.PROFILER) — per-entry device time, achieved GFLOP/s
        / GB/s, efficiency against the analytic ceiling, the trace
        artifact's path, and the per-shard dispatch telemetry. Armed with
        no capture yet (or ``?refresh=1``) this captures on demand on the
        engine's device — bounded work on the handler thread, never the
        dispatch path; disabled it returns ``{"enabled": false}``."""
        from ..obs.profiler import PROFILER

        dtype, device = self._engine_target()
        return PROFILER.payload(dtype=dtype, refresh=refresh, device=device)

    def fleet_payload(self) -> dict:
        """The /fleet JSON document: the fleet aggregator's merged view
        (obs.fleet.FLEET) — per-member health + degraded rollup, the
        merged metric exposition with per-family totals, the fleet-wide
        matchfeed seq audit, member timeline tails and the placement
        rollup. ``{"enabled": false}`` while no member map is installed."""
        from ..obs.fleet import FLEET

        return FLEET.payload()

    def timeline_payload(self) -> dict:
        """The /timeline JSON document: the process-global timeline
        sampler's bounded series (obs.timeline.TIMELINE — {"enabled",
        "interval_s", "samples": [...]}; empty but valid while the
        sampler is disabled)."""
        from ..obs.timeline import TIMELINE

        return TIMELINE.as_dict()

    def capacity_payload(self) -> dict:
        """The /capacity JSON document: the installed load-sweep verdict
        (obs.capacity.CAPACITY). ``{"enabled": false}`` while no verdict
        is installed (scripts.obs_snapshot installs its smoke ladder's)."""
        from ..obs.capacity import CAPACITY

        return CAPACITY.payload()

    def placement_payload(self) -> dict:
        """The /placement JSON document: the placement observatory
        (obs.placement.PLACEMENT) — the heavy-hitter symbol table +
        mergeable sketch bytes, the dispatch occupancy ledger (rows,
        padding, per-shard blocks), the hot-lane EWMA table and the skew
        attribution rows. ``{"enabled": false}`` while disarmed."""
        from ..obs.placement import PLACEMENT

        return PLACEMENT.payload()

    def hostprof_payload(self, run_drill: bool = False) -> dict:
        """The /hostprof JSON document: the host-CPU sampling profiler
        (obs.hostprof.HOSTPROF) — the live wall-profile stage join plus
        the last admit-drill report. ``?drill=1`` runs the deterministic
        admit drill on demand — bounded work on the handler thread, never
        the serving path; disabled it returns ``{"enabled": false}``."""
        from ..obs.hostprof import HOSTPROF

        return HOSTPROF.payload(run_drill=run_drill)

    def durability_payload(self) -> dict:
        """The /durability JSON document: the crash-consistency surface in
        one read — Persister state (snapshot cadence, last restore,
        recovery timing), queue offsets (published / committed per
        queue), the matchfeed exactly-once tracker, and the fault-
        injection registry's report (plan + hit counts; `enabled: false`
        outside chaos runs). Every field is a scrape-time read."""
        from ..utils.faults import FAULTS

        svc = self.service
        payload: dict = {"faults": FAULTS.report()}
        persist = getattr(svc, "persist", None)
        payload["persist"] = (
            persist.probe() if persist is not None else None
        )
        feed = getattr(svc, "feed", None)
        payload["matchfeed"] = (
            feed.seq_state()
            if feed is not None and hasattr(feed, "seq_state")
            else None
        )
        consumer = getattr(svc, "consumer", None)
        if consumer is not None:
            payload["consumer"] = {
                "match_seq": getattr(consumer, "match_seq", None),
            }
        bus = getattr(svc, "bus", None)
        queues = {}
        for qname in ("order_queue", "match_queue"):
            q = getattr(bus, qname, None)
            if q is None or not hasattr(q, "end_offset"):
                continue
            try:
                queues[qname] = {
                    "end": q.end_offset(),
                    "committed": q.committed(),
                }
            except Exception:  # a dead backend must not 500 the payload
                queues[qname] = {"error": "unreadable"}
        payload["queues"] = queues
        return payload

    def start(self) -> "OpsServer":
        ops = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route into our logger
                log.debug("http %s", fmt % args)

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path = self.path.split("?")[0]
                    if path == "/metrics":
                        body = ops.registry.render().encode()
                        self._send(
                            200, body, "text/plain; version=0.0.4"
                        )
                    elif path == "/healthz":
                        if ops.monitor is None:
                            self._send(
                                200, b'{"healthy": true, "detail": '
                                b'"no service attached"}\n',
                                "application/json",
                            )
                            return
                        health = ops.monitor.check()
                        body = (
                            json.dumps(health.as_dict(), default=str) + "\n"
                        ).encode()
                        self._send(
                            200 if health.healthy else 503, body,
                            "application/json",
                        )
                    elif path == "/cost":
                        body = json.dumps(
                            ops.cost_payload(), default=str
                        ).encode()
                        self._send(200, body, "application/json")
                    elif path == "/profile":
                        query = (self.path.split("?", 1)[1:] or [""])[0]
                        body = json.dumps(
                            ops.profile_payload(refresh="refresh=1" in query),
                            default=str,
                        ).encode()
                        self._send(200, body, "application/json")
                    elif path == "/fleet":
                        body = json.dumps(
                            ops.fleet_payload(), default=str
                        ).encode()
                        self._send(200, body, "application/json")
                    elif path == "/timeline":
                        body = json.dumps(
                            ops.timeline_payload(), default=str
                        ).encode()
                        self._send(200, body, "application/json")
                    elif path == "/hostprof":
                        query = (self.path.split("?", 1)[1:] or [""])[0]
                        if "format=collapsed" in query:
                            from ..obs.hostprof import HOSTPROF

                            self._send(
                                200, HOSTPROF.collapsed().encode(),
                                "text/plain",
                            )
                            return
                        body = json.dumps(
                            ops.hostprof_payload(
                                run_drill="drill=1" in query
                            ),
                            default=str,
                        ).encode()
                        self._send(200, body, "application/json")
                    elif path == "/durability":
                        body = json.dumps(
                            ops.durability_payload(), default=str
                        ).encode()
                        self._send(200, body, "application/json")
                    elif path == "/capacity":
                        body = json.dumps(
                            ops.capacity_payload(), default=str
                        ).encode()
                        self._send(200, body, "application/json")
                    elif path == "/placement":
                        body = json.dumps(
                            ops.placement_payload(), default=str
                        ).encode()
                        self._send(200, body, "application/json")
                    elif path == "/trace":
                        query = (self.path.split("?", 1)[1:] or [""])[0]
                        rec = ops.tracer.recorder
                        if "format=journeys" in query:
                            # Raw journeys (open ones included — a gateway
                            # process never completes its half) instead
                            # of the Chrome-trace render.
                            dump = (
                                rec.export()
                                if rec is not None
                                else {"pid": None, "journeys": []}
                            )
                        else:
                            dump = (
                                rec.chrome_trace()
                                if rec is not None
                                else {"traceEvents": []}
                            )
                        body = json.dumps(dump).encode()
                        self._send(200, body, "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception:  # never kill the handler thread
                    log.exception("ops endpoint error")
                    try:
                        self._send(500, b"internal error\n", "text/plain")
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ops-http", daemon=True
        )
        self._thread.start()
        log.info("ops endpoint up on %s:%d (/metrics, /healthz, /trace, "
                 "/cost, /timeline, /profile, /hostprof, /durability, "
                 "/fleet, /capacity, /placement)", self.host, self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
