"""EngineService — the whole stack assembled from one Config.

The reference runs three processes wired by external RabbitMQ/Redis
(README.md run instructions; SURVEY §1): gRPC server, order consumer, match
consumer. Here the deployment is one binary hosting all three components
around the in-process (or file) bus.

A `redis:` config section puts the pre-pool markers in a Redis-compatible
store (the built-in RESP client + engine.prepool.RespPrePool;
persist/respserver.py is a standalone stand-in server), the reference's
own trade (nodepool.go:14-28); a Persister (a `persist:` section) takes
consistent-cut snapshots and restores the last one at start().

The port of ``gome_tpu/service/app.py``. The engine runs on the CUDA card
(`device=None`); only tests pass `device="cpu"`.

    python -m gome_tpu_torch.service.app [config.yaml]
"""

from __future__ import annotations

from ..bus import make_bus
from ..config import Config
from ..engine.orchestrator import MatchEngine
from ..utils.logging import configure as configure_logging, get_logger
from .consumer import OrderConsumer
from .matchfeed import MatchFeed

log = get_logger("app")

class EngineService:
    def __init__(self, config: Config | None = None, persist=None,
                 device=None):
        """device: the CUDA card by default (raises if there is none);
        "cpu" runs the engine's plain PyTorch version (tests)."""
        self.config = config or Config()
        configure_logging()
        if self.config.faults.enabled:
            # Arm the deterministic fault-injection registry (utils.faults)
            # BEFORE the bus exists so boot-time injection points (torn
            # sidecar reads, first appends) are covered. Chaos/test
            # tooling only; without a `faults:` section FAULTS stays a
            # zero-allocation no-op.
            from ..utils.faults import FAULTS

            FAULTS.install(self.config.faults.fault_plan())
            log.warning(
                "fault injection ARMED (seed=%d, %d specs) — chaos/test "
                "mode, never production",
                self.config.faults.seed,
                len(self.config.faults.fault_plan().faults),
            )
        self.bus = make_bus(self.config.bus)
        from ..bus.base import export_queue_metrics

        # Per-queue depth/lag gauges (gome_bus_depth{queue=...}): scrape-
        # time reads of local queue state, registered for both queues.
        export_queue_metrics(self.bus.order_queue)
        export_queue_metrics(self.bus.match_queue)
        e = self.config.engine
        mesh = None
        if e.mesh_devices:
            # engine.mesh_devices: the lane axis over that many CUDA cards
            # (make_mesh raises when fewer exist); with device="cpu", that
            # many shards on the CPU.
            from ..parallel import make_mesh

            mesh = (
                make_mesh(e.mesh_devices) if device is None
                else make_mesh(e.mesh_devices,
                               devices=[device] * e.mesh_devices)
            )
            log.info("engine lane axis sharded over %s", mesh)
        self.engine = MatchEngine(
            config=e.book_config(),
            n_slots=e.n_slots,
            max_t=e.max_t,
            auto_grow=e.auto_grow,
            kernel=e.kernel,
            device=device,
            mesh=mesh,
        )
        if self.config.store.enabled:
            # A `redis:` config section puts the pre-pool markers in the
            # (Redis-compatible) store under the reference's exact schema —
            # split gateway/consumer processes then share marker state the
            # way the reference's three processes do (nodepool.go:14-28).
            # Like the reference, an unusable store does not stop the
            # engine from booting (its config.yaml names a local Redis that
            # may not exist): warn loudly and keep the in-process pool.
            from ..engine.prepool import RespPrePool
            from ..persist.resp import RespError, SupervisedRespClient

            st = self.config.store
            try:
                # Supervised client: a store restart mid-traffic reconnects
                # under backoff + breaker and replays the session
                # (utils.resilience) instead of killing the marker path.
                client = SupervisedRespClient(
                    st.host, st.port, password=st.password or None,
                    name="resp:store",
                )
                # Validate the session up front (a reachable-but-unusable
                # store, e.g. NOAUTH, must fall back at boot — not fail
                # on the first hot-path HSET).
                client.ping()
                self.engine.pre_pool = RespPrePool(client)
            except (OSError, RespError) as exc:
                log.warning(
                    "redis store %s:%d unusable (%s): pre-pool markers "
                    "stay IN-PROCESS — split gateway/consumer deployments "
                    "need the store up",
                    st.host, st.port, exc,
                )
        self.persist = persist  # persist.Persister or None
        on_batch = persist.on_batch if persist is not None else None
        self.feed = MatchFeed(self.bus)
        self.consumer = OrderConsumer(
            self.engine,
            self.bus,
            batch_n=e.max_t * max(1, e.n_slots // 8),
            on_batch=on_batch,
            match_wire=self.config.bus.match_wire,
            pipeline_depth=e.pipeline_depth,
        )
        if persist is not None:
            # The consumer rides along so snapshots carry the matchfeed
            # seq at the cut and restore rebases it (exactly-once across
            # restarts); the durability gauges read from the Persister at
            # scrape time.
            persist.attach(self.engine, self.bus, consumer=self.consumer)
            persist.export_metrics()
        from ..engine.step import LOT_MAX32

        self.admission = None
        if self.config.admission.enabled:
            # End-to-end overload protection: the gateway sheds retryable
            # once order-queue consumer lag crosses the configured ceiling
            # — backpressure reaches the client instead of piling into
            # the bus.
            from .admission import AdmissionController

            a = self.config.admission
            self.admission = AdmissionController(
                self.bus.order_queue.depth,
                max_depth=a.max_depth,
                min_deadline_s=a.min_deadline_s,
                retry_after_s=a.retry_after_s,
                retry_after_max_s=a.retry_after_max_s,
                cache_s=a.cache_s,
            )
        from .gateway import OrderGateway

        self.gateway = OrderGateway(
            self.bus,
            accuracy=e.accuracy,
            mark=self.engine.mark,
            unmark=self.engine.unmark,
            mark_frame=self.engine.mark_frame,
            unmark_frame=self.engine.unmark_frame,
            match_feed=self.feed,
            max_volume=LOT_MAX32 if e.dtype == "int32" else None,
            admission=self.admission,
        )
        self._server = None
        self.ops = None
        if self.config.ops.enabled:
            from .ops import OpsServer

            if self.config.ops.trace:
                # Arm the order-lifecycle tracer (utils.trace): trace ids
                # at the gateway, per-stage histograms in /metrics, and
                # the flight recorder behind the ops /trace endpoint.
                from ..utils.trace import TRACER, FlightRecorder

                TRACER.install(
                    FlightRecorder(
                        keep_n=self.config.ops.trace_keep,
                        slow_threshold_s=self.config.ops.slow_ms / 1e3,
                    )
                )
            if self.config.ops.cost:
                # Arm the compile journal (obs.compile_journal): first-seen
                # frame-dispatch combos and the nvcc / g++ builds land in
                # gome_compile_seconds and the ops /cost endpoint; the
                # cost model's launch counter takes its one-time import
                # here, not on the first /cost under traffic.
                from ..obs import costmodel
                from ..obs.compile_journal import JOURNAL

                JOURNAL.install(keep_n=self.config.ops.cost_keep)
                costmodel.warm()
            if self.config.ops.timeline:
                # Arm the host-side timeline sampler (obs.timeline):
                # RSS/rusage/live-buffer/journal/queue series behind the
                # ops /timeline endpoint and gome_timeline_* gauges. The
                # periodic thread runs only while the service is
                # start()ed; sample() also works on demand.
                from ..obs.timeline import TIMELINE, service_timeline

                TIMELINE.install(
                    interval_s=self.config.ops.timeline_interval_s,
                    keep_n=self.config.ops.timeline_keep,
                )
                service_timeline(self)
            if self.config.ops.profile:
                # Arm the measured-roofline profiler (obs.profiler):
                # per-shard dispatch telemetry on the dense mesh path,
                # bounded torch.profiler captures behind the ops /profile
                # endpoint, gome_profile_* gauges.
                from ..obs.profiler import PROFILER

                PROFILER.install(keep_n=self.config.ops.profile_keep)
            if self.config.ops.hostprof:
                # Arm the host-CPU sampling profiler (obs.hostprof):
                # gateway note_admit hook live, thread-mode wall sampler
                # behind the ops /hostprof endpoint and the
                # gome_hostprof_* gauges. The sampler thread runs only
                # while the service is start()ed.
                from ..obs.hostprof import HOSTPROF

                HOSTPROF.install(
                    hz=self.config.ops.hostprof_hz,
                    keep_n=self.config.ops.hostprof_keep,
                )
            if self.config.ops.placement:
                # Arm the placement observatory (obs.placement): gateway
                # admit hooks feed the heavy-hitter symbol sketch, the
                # dense-dispatch hook keeps the occupancy ledger, and
                # the /placement endpoint serves the skew attribution.
                import numpy as np

                from ..engine.book import GRID_I32_FIELDS, DeviceOp
                from ..obs import placement as _placement

                itemsize = np.dtype(e.dtype).itemsize
                n_i32 = len(GRID_I32_FIELDS)
                n_val = len(DeviceOp._fields) - n_i32
                _placement.PLACEMENT.install(
                    topk=self.config.ops.placement_topk,
                    ewma_alpha=self.config.ops.placement_alpha,
                    row_bytes=(n_i32 * 4 + n_val * itemsize) * e.max_t,
                    partitions=self.config.ops.placement_partitions,
                    verdict=_placement.default_verdict(),
                )
            if self.config.fleet.enabled:
                # Arm the fleet aggregator (obs.fleet): this process polls
                # the listed members' ops endpoints and serves the merged
                # view under its own /fleet. The polling thread runs only
                # while the service is start()ed.
                from ..obs.fleet import FLEET

                FLEET.install(
                    self.config.fleet.member_map(),
                    interval_s=self.config.fleet.interval_s,
                    timeout_s=self.config.fleet.timeout_s,
                )
            self.ops = OpsServer(
                self, host=self.config.ops.host, port=self.config.ops.port
            )
            # The consumer loop beats the health monitor: a stall is a
            # wedged loop (HealthMonitor.stall_after_s without a step),
            # never merely a service older than stall_after_s with backlog.
            self.consumer.heartbeat = self.ops.monitor.heartbeat
        # The reference's GOME_RACECHECK=1 hook (analysis.racecheck) comes
        # with the port of analysis/ (ROADMAP Queue 1 item 6).

    def start(self):
        """Start gRPC server + consumer + feed threads (+ the ops HTTP
        endpoint when configured); returns self."""
        from .gateway import serve_gateway

        if self.persist is not None:
            self.persist.restore_latest()
        self._server = serve_gateway(self.gateway, self.config)
        self.consumer.start()
        self.feed.start()
        if self.ops is not None:
            self.ops.start()
            if self.config.ops.timeline:
                from ..obs.timeline import TIMELINE

                TIMELINE.start()
            if self.config.ops.hostprof:
                from ..obs.hostprof import HOSTPROF

                HOSTPROF.start()
            if self.config.fleet.enabled:
                from ..obs.fleet import FLEET

                FLEET.start()
        return self

    def stop(self):
        if self._server is not None:
            self._server.stop(grace=2).wait()
            self._server = None
        self.consumer.stop()
        self.feed.stop()
        if self.ops is not None:
            self.ops.stop()
            if self.config.ops.timeline:
                from ..obs.timeline import TIMELINE

                TIMELINE.stop()
            if self.config.ops.hostprof:
                from ..obs.hostprof import HOSTPROF

                HOSTPROF.stop()
            if self.config.fleet.enabled:
                from ..obs.fleet import FLEET

                FLEET.stop()

    def wait(self):
        if self._server is not None:
            self._server.wait_for_termination()

    # -- synchronous conveniences (tests, embedded use) ----------------------
    def pump(self) -> int:
        """Drain order queue then match queue once, synchronously (no
        threads). Returns orders processed."""
        n = self.consumer.drain()
        self.feed.drain()
        return n


def main(argv=None):
    """CLI entry: `python -m gome_tpu_torch.service.app [config.yaml]` — the
    single-binary replacement for the reference's three `go run` processes
    (README.md:11-15). Runs on the CUDA card."""
    import sys

    from ..config import load_config

    argv = sys.argv[1:] if argv is None else argv
    config = load_config(argv[0] if argv else None)
    persist = None
    if config.persist.enabled:
        from ..persist import Persister

        persist = Persister(config.persist)
    svc = EngineService(config, persist=persist).start()
    log.info("engine service up (grpc %s:%d)", config.grpc.host,
             svc._server.bound_port)
    try:
        svc.wait()
    except KeyboardInterrupt:
        svc.stop()


if __name__ == "__main__":
    main()
