"""Order consumer — the reference's consume_new_order process
(consume_new_order.go:7-10 → rabbitmq.go:86-130) with the micro-batching the
batched device engine needs. The port of ``gome_tpu/service/consumer.py``,
on the port's MatchEngine (the card unless the engine was built with
device="cpu"), bus and FramePipeline.

The reference drains one message at a time and runs the full match path per
order (rabbitmq.go:116-125). Here the loop polls a micro-batch (N orders or
T µs, whichever first — SURVEY §7 hard part (e)), feeds it to the batched
device engine in arrival order (same-symbol order preserved by lane packing,
batch.py), publishes every resulting MatchResult to the "matchOrder" queue
(engine.go:154-158's role), and only then commits the consumed offset —
at-least-once where the reference is at-most-once (auto-ack,
rabbitmq.go:102; SURVEY §2.3.6).
"""

from __future__ import annotations

import threading

from ..bus import QueueBus, decode_orders_batch
from ..engine.orchestrator import MatchEngine
from ..utils.faults import FAULTS
from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY
from ..utils.resilience import BackoffPolicy, backoff_delays
from ..utils.trace import TRACER, decode_context
from ..utils.tracing import annotate

log = get_logger("consumer")

_orders_total = REGISTRY.counter(
    "gome_orders_consumed_total", "orders drained from the doOrder queue"
)
_events_total = REGISTRY.counter(
    "gome_match_events_total", "MatchResult events published"
)
_batch_size = REGISTRY.histogram(
    "gome_batch_size", "orders per device micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096),
)
_batch_latency = REGISTRY.histogram(
    "gome_batch_seconds", "wall time per micro-batch (decode+match+publish)"
)
_throughput = REGISTRY.gauge(
    "gome_orders_per_second", "EWMA matching throughput"
)
_poisoned = REGISTRY.counter(
    "gome_poison_orders_total",
    "orders dead-lettered by the poison-batch policy",
)
_step_failures = REGISTRY.counter(
    "gome_consumer_step_failures_total",
    "consumer steps that raised (bus fault, device error, poison batch)",
)

#: Backoff between consecutive FAILED consumer/feed steps: a dead bus must
#: not busy-spin the loop (each failed poll would otherwise burn a core
#: re-raising the same ConnectionError); a transient fault retries almost
#: immediately. Reset on the first successful step.
FAULT_BACKOFF = BackoffPolicy(
    base_s=0.01, max_s=1.0, max_retries=1_000_000, budget_s=float("inf")
)


class OrderConsumer:
    def __init__(
        self,
        engine: MatchEngine,
        bus: QueueBus,
        batch_n: int = 256,
        batch_wait_s: float = 0.002,
        on_batch=None,
        poison_threshold: int = 3,
        match_wire: str = "json",
        pipeline_depth: int = 0,
    ):
        """match_wire: "json" publishes one reference-shape JSON document
        per event (rabbitmq.go wire parity); "frame" publishes one binary
        EVENT frame per batch (bus.colwire) — the high-throughput internal
        transport (the feed decodes both).

        pipeline_depth > 0 enables cross-frame pipelining for ORDER-frame
        traffic (engine.pipeline.FramePipeline): up to that many frames
        stay in flight on the device while the host packs the next, and a
        frame's offset commits only once ITS events published. Requires a
        MatchEngine (admit_frame); JSON messages still process
        synchronously (the pipeline drains first, preserving order)."""
        if match_wire not in ("json", "frame"):
            raise ValueError(f"match_wire must be json|frame, got {match_wire}")
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if pipeline_depth > 0 and not hasattr(engine, "admit_frame"):
            raise ValueError(
                "pipeline_depth requires a MatchEngine (admit_frame); the "
                f"given engine {type(engine).__name__} has no frame pipeline"
            )
        self.engine = engine
        self.bus = bus
        self.match_wire = match_wire
        self.batch_n = batch_n
        self.batch_wait_s = batch_wait_s
        self.pipeline_depth = pipeline_depth
        # single-writer: the consuming thread — the _loop thread once
        # start()ed, or the sync run_once()/drain()/pump() caller; the
        # two modes never run concurrently (start() is the boundary).
        self._pipe = None  # single-writer: the consuming thread (lazy FramePipeline)
        # Persist-hook counts deferred to the next pipeline-empty boundary
        # (on_batch must only observe consistent cuts; see _emit_resolved).
        self._hook_orders = 0  # single-writer: the consuming thread
        self._hook_events = 0  # single-writer: the consuming thread
        self.on_batch = on_batch  # callback(n_orders, n_events): persist hook
        # Liveness beat of the background loop: called after every step that
        # did not fail (EngineService wires its HealthMonitor's heartbeat),
        # so /healthz reads a wedged loop as stalled, not a long-lived one.
        self.heartbeat = lambda: None
        # Poison-batch policy: a deterministic per-batch error (e.g. a lane
        # CapacityError) would otherwise replay the same uncommitted offset
        # forever and halt matching engine-wide. After `poison_threshold`
        # consecutive failures at the SAME committed offset, the batch is
        # replayed order-by-order and the offending orders dead-lettered
        # (logged + counted) so the stream advances.
        self.poison_threshold = poison_threshold
        self._fail_offset = -1  # single-writer: the consuming thread
        self._fail_count = 0  # single-writer: the consuming thread
        # Order-lifecycle tracing: in-flight frames' journey ids keyed by
        # queue offset (pipelined mode publishes/completes at resolve
        # time, which can be several steps after the feed).
        self._pipe_tids: dict[int, list] = {}
        # Matchfeed sequence numbers (ISSUE 11 exactly-once): match_seq is
        # the next seq to stamp — monotonic per book epoch, advanced by
        # _publish. _seq_committed is its value at the last durable
        # order-queue commit; a failed step rolls match_seq back to it so
        # the at-least-once replay regenerates IDENTICAL seqs (duplicates
        # carry the same seq and are suppressed by SeqTracker downstream).
        self.match_seq = 0  # single-writer: the consuming thread
        self._seq_committed = 0  # single-writer: the consuming thread
        self._last_step_failed = False  # single-writer: the consuming thread
        self._stop = threading.Event()
        self._life = threading.Lock()  # serializes start()/stop()
        self._thread: threading.Thread | None = None  # guarded by self._life

    def reset_seq(self, seq: int) -> None:
        """Recovery hook (persist.Persister.restore_latest): rebase the
        matchfeed seq to the restored cut's manifest value. WAL replay
        then regenerates the truncated match tail with the same seqs it
        had pre-crash."""
        # gomelint: disable=GL704 — happens-before, not a second writer:
        # restore_latest() runs during EngineService.start() BEFORE
        # consumer.start() spawns the loop (app.py orders them), and the
        # chaos/recovery drills call it on a stopped consumer.
        self.match_seq = seq  # gomelint: disable=GL704
        self._seq_committed = seq  # gomelint: disable=GL704

    def _consume_traces(self, cols: dict, headers) -> list:
        """Order-lifecycle tracing, receipt side: pop the GCO3 trace
        column off a decoded ORDER frame (the engine never sees it — its
        admission filters would desync it from the kept rows), close each
        traced order's bus_transit span from the context's carried
        publish timestamp, and return the journey ids for batch-scoped
        attribution. A headers-only context (AMQP x-trace on an opaque
        body) traces the whole message. [] while tracing is off — the
        column is still popped so tracing-off consumers interop with
        tracing-on producers."""
        raw = cols.pop("trace", None)
        tr = TRACER
        if not tr.enabled:
            return []
        t_rx = tr.clock()
        tids = []
        if raw is not None:
            for ctx in raw.tolist():
                if not ctx:
                    continue
                tid, t_pub = decode_context(ctx.decode())
                tr.add_span(tid, "bus_transit", t_pub or t_rx, t_rx)
                tids.append(tid)
        elif headers and headers.get("x-trace"):
            tid, t_pub = decode_context(headers["x-trace"])
            tr.add_span(tid, "bus_transit", t_pub or t_rx, t_rx)
            tids.append(tid)
        return tids

    def _json_traces(self, orders, msgs) -> list:
        """bus_transit spans for a decoded JSON run: context from the
        order body (codec Trace field), falling back to the message's
        AMQP x-trace header (one order per JSON message)."""
        tr = TRACER
        if not tr.enabled:
            return []
        t_rx = tr.clock()
        tids = []
        for o, m in zip(orders, msgs):
            ctx = o.trace
            if ctx is None and m.headers:
                ctx = m.headers.get("x-trace")
            if not ctx:
                continue
            tid, t_pub = decode_context(ctx)
            tr.add_span(tid, "bus_transit", t_pub or t_rx, t_rx)
            tids.append(tid)
        return tids

    def _publish(self, batch) -> None:
        # Frame publishing needs real EventBatch columns; the sharded
        # facade's compatibility wrapper (router._ResultsBatch) publishes
        # reference JSON instead. Every event is stamped with the next
        # matchfeed seq (GCE2 header / JSON "Seq" / AMQP x-seq);
        # match_seq only advances once the publish SUCCEEDED, so a failed
        # publish replays with the same seqs.
        seq0 = self.match_seq
        n = len(batch)
        if self.match_wire == "frame" and hasattr(batch, "columns"):
            from ..bus.colwire import encode_event_frame

            if n:
                mq = self.bus.match_queue
                frame = encode_event_frame(batch, seq0=seq0)
                if mq.supports_headers:
                    # Alongside PR 2's x-trace: stringified per AMQP
                    # header conventions (bus/amqp.py).
                    mq.publish(frame, headers={"x-seq": str(seq0)})
                else:
                    mq.publish(frame)
        else:
            # one write+fsync for the whole batch on the native backend
            self.bus.match_queue.publish_batch(batch.to_json_lines(seq0=seq0))
        self.match_seq = seq0 + n

    def run_once(self) -> int:  # gomelint: hotpath
        """Drain one micro-batch; returns the number of orders processed."""
        if self.pipeline_depth > 0:
            return self._run_once_pipelined()
        msgs = self.bus.order_queue.poll_batch(self.batch_n, self.batch_wait_s)
        if not msgs:
            return 0
        from ..bus.colwire import decode_order_frame, is_frame

        n_orders = n_events = 0
        done_tids: list = []
        with _batch_latency.time() as timer:
            # Split the poll into runs: contiguous JSON messages decode as
            # one batch (native codec); a binary ORDER frame (colwire) IS
            # a batch and takes the zero-per-order-Python frame path. Both
            # producers can share the queue (migration story).
            i = 0
            while i < len(msgs):
                FAULTS.fire("consumer.frame")
                if is_frame(msgs[i].body):
                    with annotate("engine_process_frame"):
                        cols = decode_order_frame(msgs[i].body)
                        tids = self._consume_traces(cols, msgs[i].headers)
                        with TRACER.batch(tids):
                            batch = self.engine.process_frame(cols)
                        count = int(cols["n"])
                    with annotate("publish_events"), TRACER.batch(tids), \
                            TRACER.span("publish"):
                        self._publish(batch)
                    done_tids += tids
                    n_orders += count
                    n_events += len(batch)
                    i += 1
                else:
                    i, n_o, n_e, tids = self._process_json_run(msgs, i)
                    done_tids += tids
                    n_orders += n_o
                    n_events += n_e
            # Commit only after results are published: a crash between
            # processing and commit replays the batch (at-least-once;
            # recovery dedup lives in the persist layer's replay logic).
            FAULTS.fire("consumer.commit")
            self.bus.order_queue.commit(msgs[-1].offset + 1)
            self._seq_committed = self.match_seq
        for tid in done_tids:  # journeys are complete once committed
            TRACER.complete(tid)
        _orders_total.inc(n_orders)
        _events_total.inc(n_events)
        _batch_size.observe(n_orders)
        if timer.elapsed > 0:
            inst = n_orders / timer.elapsed
            _throughput.set(0.8 * _throughput.value() + 0.2 * inst)
        if self.on_batch is not None:
            self.on_batch(n_orders, n_events)
        return n_orders

    def _process_json_run(self, msgs, i: int) -> tuple[int, int, int, list]:
        """Decode + process + publish one contiguous run of JSON messages
        starting at msgs[i]; returns (j, n_orders, n_events, trace_ids)
        with j the first index past the run. The CALLER commits — commit
        policy differs between the synchronous and pipelined paths — and
        completes the returned journeys. Columnar path end to end: events
        stay as numpy columns from decode through wire serialization; no
        per-event Python objects on the hot path."""
        from ..bus.colwire import is_frame

        j = i
        while j < len(msgs) and not is_frame(msgs[j].body):
            j += 1
        with annotate("decode_orders"):
            orders = decode_orders_batch([m.body for m in msgs[i:j]])
        tids = self._json_traces(orders, msgs[i:j])
        with annotate("engine_process"), TRACER.batch(tids):
            batch = self.engine.process_columnar(orders)
        with annotate("publish_events"), TRACER.batch(tids), \
                TRACER.span("publish"):
            self._publish(batch)
        return j, len(orders), len(batch), tids

    def _emit_resolved(self, token, batch) -> int:
        """Publish one resolved frame's events and commit ITS offset —
        frames resolve in FIFO order, so commits stay monotonic. The
        persist hook (on_batch) is NOT called here: with frames in flight
        the books are AHEAD of the committed offset, so a snapshot taken
        now would double-apply the in-flight span on recovery; the counts
        accumulate and the hook fires at the next pipeline-empty boundary
        (a consistent cut)."""
        offset, n = token
        tids = self._pipe_tids.pop(offset, None) or []
        with annotate("publish_events"), TRACER.batch(tids), \
                TRACER.span("publish"):
            self._publish(batch)
        FAULTS.fire("consumer.commit")
        self.bus.order_queue.commit(offset + 1)
        self._seq_committed = self.match_seq
        self._account(n, len(batch))
        for tid in tids:
            TRACER.complete(tid)
        return n

    def _account(self, n_orders: int, n_events: int) -> None:
        """Bookkeeping for one processed-and-committed unit in pipelined
        mode: metrics now, persist hook deferred to the next consistent
        cut."""
        _orders_total.inc(n_orders)
        _events_total.inc(n_events)
        _batch_size.observe(n_orders)
        self._hook_orders += n_orders
        self._hook_events += n_events

    def _run_once_pipelined(self) -> int:
        """One consumer step with cross-frame pipelining: ORDER frames are
        SUBMITTED to the device (host pack only) and a frame's offset
        commits when it RESOLVES (fetch + decode) and its events publish —
        up to pipeline_depth frames stay in flight, so frame k+1's host
        work overlaps frame k's device execution + fetch. Non-frame (JSON)
        runs drain the pipeline first (one frame at a time — a publish
        failure loses at most one frame's events), then batch-decode as in
        run_once. Any failure aborts the in-flight span (books rewound,
        pre-pool marks restored) and re-raises — the at-least-once replay
        from the uncommitted offset re-feeds it."""
        from ..bus.colwire import decode_order_frame, is_frame
        from ..engine.pipeline import FramePipeline

        q = self.bus.order_queue
        if self._pipe is None:
            self._pipe = FramePipeline(self.engine, depth=self.pipeline_depth)
        pipe = self._pipe
        n_orders = 0
        try:
            if len(pipe) == 0:
                msgs = q.poll_batch(self.batch_n, self.batch_wait_s)
                if not msgs:
                    return 0
            else:
                # Read cursor: committed offset + one message per in-flight
                # frame (only whole ORDER-frame messages stay in flight).
                msgs = q.read_from(q.committed() + len(pipe), self.batch_n)
            with _batch_latency.time() as timer:
                if not msgs:
                    # Queue idle: make progress on the in-flight span.
                    out = pipe.step()
                    if out is not None:
                        n_orders += self._emit_resolved(*out)
                i = 0
                while i < len(msgs):
                    FAULTS.fire("consumer.frame")
                    m = msgs[i]
                    if is_frame(m.body):
                        cols = decode_order_frame(m.body)
                        tids = self._consume_traces(cols, m.headers)
                        if tids:
                            self._pipe_tids[m.offset] = tids
                        with annotate("pipeline_feed"), TRACER.batch(tids):
                            resolved = pipe.feed(
                                cols, token=(m.offset, int(cols["n"]))
                            )
                        for token, batch in resolved:
                            n_orders += self._emit_resolved(token, batch)
                        i += 1
                    else:
                        while True:  # drain in-flight, emit-as-resolved
                            out = pipe.step()
                            if out is None:
                                break
                            n_orders += self._emit_resolved(*out)
                        j, n_o, n_e, jtids = self._process_json_run(msgs, i)
                        q.commit(msgs[j - 1].offset + 1)
                        self._seq_committed = self.match_seq
                        n_orders += n_o
                        self._account(n_o, n_e)
                        for tid in jtids:
                            TRACER.complete(tid)
                        i = j
        except Exception:
            # feed/resolve already restored their own frames' state; abort
            # rewinds whatever is STILL in flight (a failed queue READ
            # included — frames must never outlive a poison-policy
            # quarantine) so the replay from the committed offset sees a
            # consistent engine.
            pipe.abort()
            # The replay re-feeds the aborted frames and re-records their
            # journeys' consumer-side spans; stale id->offset entries
            # would mis-attribute the replay's publishes.
            self._pipe_tids.clear()
            raise
        if n_orders and timer.elapsed > 0:
            inst = n_orders / timer.elapsed
            _throughput.set(0.8 * _throughput.value() + 0.2 * inst)
        if (
            len(pipe) == 0
            and self.on_batch is not None
            and (self._hook_orders or self._hook_events)
        ):
            # Consistent cut: books correspond exactly to the committed
            # offset only when nothing is in flight — the persist hook
            # (snapshot cadence) must only observe such states.
            self.on_batch(self._hook_orders, self._hook_events)
            self._hook_orders = self._hook_events = 0
        return n_orders

    def drain(self) -> int:
        """Process until the order queue is empty (tests, recovery replay)."""
        total = 0
        while self.bus.order_queue.committed() < self.bus.order_queue.end_offset():
            total += self.run_once()
        return total

    # -- background loop -----------------------------------------------------
    def start(self) -> None:
        # Serialized with stop() under _life: the watchdog restarts a
        # dead consumer from ITS thread while service shutdown (or an
        # operator) may be stopping it from another — without the lock
        # two start() calls can both pass the None check and spawn two
        # consumer loops (doubled batches, lost joins).
        with self._life:
            if self._thread is not None:
                raise RuntimeError("consumer already started")
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="order-consumer", daemon=True
            )
            self._thread.start()

    # gomelint: hotpath
    def _loop(self) -> None:
        # Consecutive failures back off (decorrelated jitter) instead of
        # busy-spinning against a dead dependency; any success resets.
        delays = None
        while not self._stop.is_set():
            self.step_with_policy()
            if not self._last_step_failed:
                self.heartbeat()
            if self._last_step_failed:
                if delays is None:
                    delays = backoff_delays(FAULT_BACKOFF)
                self._stop.wait(next(delays, FAULT_BACKOFF.max_s))
            else:
                delays = None

    def step_with_policy(self) -> int:
        """One consumer step with the poison-batch policy applied. Returns
        orders processed (0 on a failed or empty step). Never raises — the
        consumer thread must survive any failure (the reference panics
        instead; a transient bus outage must not kill matching)."""
        self._last_step_failed = False
        try:
            n = self.run_once()
            self._fail_count = 0
            return n
        except Exception:  # keep consuming; reference panics instead
            # Seq rollback to the last durable commit: the replay from the
            # uncommitted offset re-publishes with IDENTICAL seqs, so any
            # double-delivery is detectable (and suppressed) downstream.
            self.match_seq = self._seq_committed
            self._last_step_failed = True
            _step_failures.inc()
            log.exception("order batch failed")
            try:
                offset = self.bus.order_queue.committed()
                if offset == self._fail_offset:
                    self._fail_count += 1
                else:
                    self._fail_offset, self._fail_count = offset, 1
                if self._fail_count >= self.poison_threshold:
                    self._fail_count = 0
                    # Quarantine replays order-by-order from the committed
                    # offset: anything still in flight in the pipeline
                    # would be double-applied — abort it first (books
                    # rewound, marks restored).
                    if self._pipe is not None:
                        self._pipe.abort()
                        self._pipe_tids.clear()
                    return self.quarantine_once()
            except Exception:
                log.exception("poison-batch policy step failed; will retry")
            return 0

    def quarantine_once(self) -> int:
        """Replay the head batch isolating poison ORDERS by bisection:
        a failing chunk splits in half (FIFO preserved) until the failing
        singleton is found, which is dead-lettered (logged + counted in
        gome_poison_orders_total, its pre-pool mark cleared) — the stream
        advances past it while every healthy order in the same message
        (a 256K-order frame included) still matches and publishes.

        A publish failure is NOT a poison order: the quarantine pass stops
        without committing that offset (standard at-least-once replay — the
        same window run_once has between processing and commit), so no
        events are ever dead-lettered because the match queue hiccuped."""
        msgs = self.bus.order_queue.poll_batch(self.batch_n, 0)
        processed = 0
        from ..bus import decode_message_orders

        for m in msgs:
            try:
                orders = decode_message_orders(m.body)
            except Exception:
                # Undecodable message: nothing to salvage.
                _poisoned.inc(1)
                log.exception(
                    "dead-lettering undecodable message at offset %d",
                    m.offset,
                )
                self.bus.order_queue.commit(m.offset + 1)
                self._seq_committed = self.match_seq
                continue
            ok, n_ok = self._bisect_apply(orders)
            if not ok:
                return processed  # publish hiccup: leave offset for replay
            self.bus.order_queue.commit(m.offset + 1)
            self._seq_committed = self.match_seq
            processed += n_ok
            _orders_total.inc(n_ok)
            if self.on_batch is not None:
                self.on_batch(n_ok, 0)
        return processed

    def _bisect_apply(self, orders) -> tuple[bool, int]:
        """Process `orders` in FIFO order, bisecting around failures until
        poison singletons are isolated and dead-lettered. Returns
        (publish_ok, orders_processed); publish_ok=False means the match
        queue failed and the caller must not commit (engine work already
        applied rides the at-least-once replay window)."""
        if not orders:
            return True, 0
        try:
            batch = self.engine.process_columnar(orders)
        except Exception:
            if len(orders) == 1:
                order = orders[0]
                try:  # confirm determinism: transient faults retry clean
                    batch = self.engine.process_columnar(orders)
                except Exception:
                    _poisoned.inc(1)
                    log.exception(
                        "dead-lettering poison order oid=%s symbol=%s",
                        order.oid, order.symbol,
                    )
                    # The failed call restored its consumed pre-pool mark;
                    # a dead-lettered ADD will never be replayed, so the
                    # mark must not linger (it would persist into
                    # snapshots as a live queued ADD).
                    unmark = getattr(self.engine, "unmark", None)
                    if unmark is not None:
                        unmark(order)
                    return True, 0
            else:
                mid = len(orders) // 2
                ok, a = self._bisect_apply(orders[:mid])
                if not ok:
                    return False, a
                ok, b = self._bisect_apply(orders[mid:])
                return ok, a + b
        try:
            self._publish(batch)
        except Exception:
            log.exception(
                "publish failed during quarantine; leaving offset for replay"
            )
            return False, 0
        _events_total.inc(len(batch))
        return True, len(orders)

    def stop(self) -> None:
        # The consumer loop never takes _life, so joining under it cannot
        # deadlock; concurrent stop()s serialize harmlessly.
        with self._life:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=10)
                self._thread = None
