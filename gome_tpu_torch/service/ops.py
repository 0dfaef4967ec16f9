"""Operator HTTP endpoint: /metrics (Prometheus text format from
utils.metrics.REGISTRY), /healthz (service.health.HealthMonitor JSON),
/trace (the order-lifecycle flight recorder as Chrome trace-event JSON —
load the dump in chrome://tracing or https://ui.perfetto.dev),
/durability (queue offsets, the matchfeed exactly-once tracker and the
fault-injection report), and the host-side observability plane (obs/):
/timeline, /placement, /capacity and /hostprof.

The reference has no observability surface at all (SURVEY §5.5 — logging
only); this is the cheap operator-facing extension the service ships: one
stdlib ThreadingHTTPServer, no dependencies, curl-able:

    curl localhost:9109/metrics
    curl localhost:9109/healthz     # 200 healthy / 503 unhealthy
    curl localhost:9109/trace > trace.json   # open in Perfetto
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

The port of ``gome_tpu/service/ops.py`` for the parts the port has. The
reference's /cost and /profile (ROADMAP Queue 1 item 4) and /fleet (item
5) answer 404 here, as any unknown path does. /durability carries the
Persister's probe() under "persist" (null when no Persister is attached).

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

            # Tagged live-buffer residency for the
            # gome_hbm_resident_bytes{subsystem=...} gauges — all
            # scrape-time reads, nothing on the hot path.
            self.live_monitor = service_monitor(service)
            self.live_monitor.export(self.registry)

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
        is installed — always, until a sweep on the card writes one."""
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
                 "/timeline, /hostprof, /durability, /capacity, "
                 "/placement)", self.host, self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
