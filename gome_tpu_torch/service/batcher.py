"""The gateway->frame batching bridge: per-request gRPC traffic becomes
columnar ORDER frames.

The reference's gateway publishes one JSON document per request
(main.go:46-48 via engine.go:35-44); at frame-consumer rates that wire
costs more than matching. This bridge is the production answer to "who
aggregates requests into frames": the gRPC handlers submit accepted
orders here (after marking the pre-pool, exactly like their per-order
publish), and the bridge flushes one binary ORDER frame (bus.colwire) to
the doOrder queue when either

  * `max_n` orders accumulated (throughput bound), or
  * `max_wait_s` elapsed since the oldest buffered order (latency bound —
    this IS the batching latency cost, and it is configurable: a frame
    closes at most max_wait_s after the order that opened it).

Arrival order is preserved (one lock-guarded buffer; the flusher swaps
the whole buffer out under the lock), so the per-symbol FIFO invariant
(SURVEY §5.2) holds through the bridge. Consumers need no changes: the
order consumer already sniffs frames vs JSON per message, so a deployment
can switch the gateway to the bridge mid-stream.

Degraded mode (bus unavailable): a frame whose publish fails with a
ConnectionError — the supervised bus client raises one when its backoff
budget is exhausted or its circuit is open — is SPILLED to a bounded
in-memory deque instead of being lost or blocking handlers forever. The
deadline thread keeps retrying the spill FIFO (spilled frames always go
out before younger ones, preserving order); once `spill_max_frames` is
reached, submit() raises Backpressure and the gateway rejects with a
RETRYABLE status — bounded buffering with explicit backpressure, never
unbounded growth and never silent drops. Spill depth and time-in-degraded
are exported through utils.metrics (scrape-time callback gauges), and
service/health.py folds them into /healthz.

The port of ``gome_tpu/service/batcher.py``: the same frames, byte for
byte, in the same order. EngineService does not wire it in (nor does the
reference's); OrderGateway(batcher=...) takes it."""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from ..bus.colwire import encode_order_frame_blocks, encode_orders
from ..types import Order
from ..utils.logging import get_logger
from ..utils.metrics import REGISTRY
from ..utils.trace import TRACER, decode_context, encode_context

log = get_logger("batcher")

_rejects = REGISTRY.counter(
    "gome_gateway_retryable_rejects_total",
    "orders rejected retryable because the degraded-mode spill was full",
)
_spilled = REGISTRY.counter(
    "gome_gateway_spilled_frames_total",
    "ORDER frames diverted to the in-memory spill on publish failure",
)


class Backpressure(ConnectionError):
    """The degraded-mode spill is full: the order was NOT accepted and the
    client should retry later (gateway maps this to a retryable reject).
    Subclasses ConnectionError so generic bus-fault handling applies."""


class FrameBatcher:
    """Order accumulator flushing ORDER frames to a queue.

    submit() is thread-safe (gRPC handler threads call it concurrently);
    flushes happen on the submitting thread when the size bound trips, or
    on the background deadline thread for the latency bound. close()
    flushes the remainder and stops the deadline thread."""

    def __init__(
        self,
        queue,
        max_n: int = 4096,
        max_wait_s: float = 0.002,
        spill_max_frames: int = 64,
        retry_interval_s: float = 0.05,
        min_n: int | None = None,
        depth_fn=None,
        depth_low: int = 256,
        depth_high: int = 8192,
        resize_interval_s: float = 0.05,
    ):
        """min_n + depth_fn arm ADAPTIVE frame sizing (round 12): the
        size bound interpolates between min_n (consumer lag <= depth_low
        — queues shallow, close frames early for latency) and max_n
        (lag >= depth_high — backed up, amortize hard for throughput).
        depth_fn is the consumer-lag read (bus.order_queue.depth); it is
        sampled at most every resize_interval_s, off the per-submit hot
        path. Omit either and the bound is the fixed max_n of rounds
        <= 11. The latency bound (max_wait_s) is never adapted — it is
        the explicit worst-case promise."""
        if max_n < 1:
            raise ValueError("max_n must be >= 1")
        if spill_max_frames < 1:
            raise ValueError("spill_max_frames must be >= 1")
        self.queue = queue
        self.max_n = max_n
        self.max_wait_s = max_wait_s
        self.spill_max_frames = spill_max_frames
        self.retry_interval_s = retry_interval_s
        if min_n is not None and depth_fn is not None:
            if not (1 <= min_n <= max_n):
                raise ValueError("need 1 <= min_n <= max_n")
            if not (0 <= depth_low < depth_high):
                raise ValueError("need 0 <= depth_low < depth_high")
            self._adaptive = True
        else:
            self._adaptive = False
        self.min_n = min_n if self._adaptive else max_n
        self._depth_fn = depth_fn
        self.depth_low = depth_low
        self.depth_high = depth_high
        self.resize_interval_s = resize_interval_s
        self._eff_n = max_n if not self._adaptive else min_n  # guarded by self._lock
        self._eff_at = -1.0  # guarded by self._lock
        # Mixed buffer: scalar handlers append Order objects, the columnar
        # admit core appends pre-encoded wire BLOCKS (bytes) via
        # submit_block — flushing walks contiguous runs so arrival order
        # is preserved across both producers without re-decoding blocks.
        self._buf: list[Order | bytes] = []  # guarded by self._lock
        # _buf_n is the buffered ORDER count (a bytes block counts its
        # n orders, an Order counts 1), kept incrementally because
        # len(_buf) undercounts once blocks land.
        self._buf_n = 0  # guarded by self._lock
        self._spill: deque[bytes] = deque()  # guarded by self._lock
        self._degraded_since: float | None = None  # guarded by self._lock
        self.degraded_seconds_total = 0.0  # guarded by self._lock
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop_event = threading.Event()
        self._stop = False  # guarded by self._lock (see close())
        self._oldest: float | None = None  # guarded by self._lock
        # Scrape-time callbacks run on the ops HTTP thread WITHOUT the
        # lock on purpose: _flush_locked holds it across a bus publish,
        # and a scrape must never stall behind (or deadlock against) a
        # slow broker. len() and a float read are single bytecode ops
        # under the GIL — a torn gauge is impossible, merely stale.
        REGISTRY.callback_gauge(
            "gome_gateway_spill_depth",
            "degraded-mode spill depth (ORDER frames awaiting the bus)",
            lambda: len(self._spill),  # gomelint: disable=GL402 — see above
        )
        REGISTRY.callback_gauge(
            "gome_gateway_buffered_orders",
            "orders buffered in the batcher awaiting a frame flush "
            "(the batching-bridge queue depth)",
            lambda: self._buf_n,  # gomelint: disable=GL402 — see above
        )
        REGISTRY.callback_gauge(
            "gome_gateway_frame_target",
            "current effective frame-size bound (adaptive sizing; equals "
            "max_n when the adaptive bridge is not armed)",
            lambda: self._eff_n,  # gomelint: disable=GL402 — see above
        )
        REGISTRY.callback_gauge(
            "gome_gateway_degraded_seconds",
            "seconds the gateway has been in degraded mode (0 healthy)",
            lambda: (
                time.monotonic() - self._degraded_since  # gomelint: disable=GL402
                if self._degraded_since is not None  # gomelint: disable=GL402
                else 0.0
            ),
        )
        self._thread = threading.Thread(
            target=self._deadline_loop, name="frame-batcher", daemon=True
        )
        self._thread.start()

    # -- degraded-mode state (callers: gateway handlers, health) -----------
    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded_since is not None

    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            degraded_s = (
                now - self._degraded_since
                if self._degraded_since is not None
                else 0.0
            )
            return dict(
                degraded=self._degraded_since is not None,
                degraded_s=degraded_s,
                degraded_seconds_total=self.degraded_seconds_total
                + degraded_s,
                spill_depth=len(self._spill),
                spill_max_frames=self.spill_max_frames,
                buffered=self._buf_n,
                effective_max_n=self._eff_n,
                adaptive=self._adaptive,
            )

    def effective_max_n(self) -> int:
        """Current frame-size bound; recomputes the adaptive target when
        the sample window expired (public for tests/ops introspection)."""
        with self._lock:
            return self._effective_locked()

    def _effective_locked(self) -> int:  # gomelint: hotpath
        """Frame-size bound under self._lock. Adaptive mode linearly
        interpolates min_n..max_n over the depth_low..depth_high lag
        band, sampling depth_fn at most every resize_interval_s; the
        result is always clamped to [min_n, max_n] even against a
        misbehaving depth_fn (negative / NaN-ish readings)."""
        if not self._adaptive:
            return self.max_n
        now = time.monotonic()
        if now - self._eff_at >= self.resize_interval_s:
            self._eff_at = now
            try:
                depth = int(self._depth_fn())
            except Exception:
                # A broken lag probe must never stall admission; fall
                # back to the throughput-safe bound.
                depth = self.depth_high
            frac = (depth - self.depth_low) / (
                self.depth_high - self.depth_low
            )
            frac = min(max(frac, 0.0), 1.0)
            eff = round(self.min_n + frac * (self.max_n - self.min_n))
            self._eff_n = min(max(eff, self.min_n), self.max_n)
        return self._eff_n

    def submit(self, order: Order) -> None:  # gomelint: hotpath
        """Buffer one accepted order; flush if the size bound tripped.

        The encode+publish happens UNDER the lock: a swapped-out batch
        published outside it could be overtaken by the next batch (a
        descheduled flusher), inverting price-time priority across
        frames. Holding the lock serializes frames in arrival order; the
        cost is submitters briefly blocking behind one frame encode
        (~1 ms at 4K orders), which is the batching backpressure.

        Raises RuntimeError after close(): the deadline thread is gone,
        so a buffered order below max_n would be stranded forever — a
        late gRPC handler must fail loudly, not accept-and-drop. Raises
        Backpressure while the degraded-mode spill is full: bounded
        buffering means at some depth new orders must be refused
        (retryable) rather than silently queued to infinity."""
        with self._lock:
            if self._stop:
                raise RuntimeError(
                    "FrameBatcher is closed; order not accepted"
                )
            if len(self._spill) >= self.spill_max_frames:
                _rejects.inc()
                raise Backpressure(
                    f"bus degraded: spill full "
                    f"({self.spill_max_frames} frames); retry later"
                )
            if not self._buf:
                self._oldest = time.monotonic()
                self._wake.set()
            self._buf.append(order)
            self._buf_n += 1
            if self._buf_n >= self._effective_locked():
                self._flush_locked()

    def submit_block(self, block: bytes, n: int) -> None:  # gomelint: hotpath
        """Buffer one pre-encoded ORDER wire block of `n` accepted orders
        (the columnar admit core's output, bus.colwire.encode_order_block);
        flush if the size bound tripped. Same closed/backpressure contract
        as submit() — a refused block means NONE of its orders were
        accepted (the gateway unmarks and rejects the whole batch)."""
        with self._lock:
            if self._stop:
                raise RuntimeError(
                    "FrameBatcher is closed; order not accepted"
                )
            if len(self._spill) >= self.spill_max_frames:
                _rejects.inc(n)
                raise Backpressure(
                    f"bus degraded: spill full "
                    f"({self.spill_max_frames} frames); retry later"
                )
            if not self._buf:
                self._oldest = time.monotonic()
                self._wake.set()
            self._buf.append(block)
            self._buf_n += n
            if self._buf_n >= self._effective_locked():
                self._flush_locked()

    def flush(self) -> int:
        """Flush whatever is buffered now; returns the count flushed into
        a frame (the frame may land in the spill if the bus is down)."""
        with self._lock:
            return self._flush_locked()

    def _encode_order_run(self, orders: list[Order]) -> bytes:
        if TRACER.enabled:
            orders = self._close_batch_wait(orders)
        return encode_orders(orders)

    def _flush_locked(self) -> int:  # gomelint: hotpath
        batch, n = self._swap_locked()
        if batch:
            # Split into contiguous runs so arrival order survives mixed
            # producers: an Order run becomes one GCO2/GCO3 frame (pure
            # scalar traffic stays byte-identical to the pre-columnar
            # wire), a block run becomes ONE GCO4 frame with no
            # decode/re-encode round-trip — the columnar path's whole
            # point (HOSTPROF_r01: the JSON round-trip was ~45% of admit
            # CPU).
            orders: list[Order] = []
            blocks: list[bytes] = []
            for item in batch:
                if isinstance(item, bytes):
                    if orders:
                        self._spill.append(self._encode_order_run(orders))
                        orders = []
                    blocks.append(item)
                else:
                    if blocks:
                        self._spill.append(
                            encode_order_frame_blocks(blocks)
                        )
                        blocks = []
                    orders.append(item)
            if orders:
                self._spill.append(self._encode_order_run(orders))
            if blocks:
                self._spill.append(encode_order_frame_blocks(blocks))
        self._drain_spill_locked()
        return n

    @staticmethod
    def _close_batch_wait(batch: list[Order]) -> list[Order]:
        """Order-lifecycle tracing: each traced order's context carries
        the gateway's enqueue timestamp — close its batch_wait span
        (submit -> frame close) and re-stamp the context with the flush
        time so the consumer's bus_transit span starts here. Runs only
        while the tracer is armed; untraced orders pass through
        untouched."""
        now = TRACER.clock()
        out = []
        for o in batch:
            if o.trace is not None:
                tid, t0 = decode_context(o.trace)
                TRACER.add_span(tid, "batch_wait", t0, now)
                o = dataclasses.replace(
                    o, trace=encode_context(tid, now)
                )
            out.append(o)
        return out

    def _drain_spill_locked(self) -> None:
        """Publish spilled frames FIFO (oldest first — frame order on the
        wire is arrival order even across an outage). A publish fault
        enters/extends degraded mode and leaves the remainder for the
        deadline thread's next retry tick."""
        while self._spill:
            try:
                self.queue.publish(self._spill[0])
            except (ConnectionError, OSError) as e:
                if self._degraded_since is None:
                    self._degraded_since = time.monotonic()
                    _spilled.inc(len(self._spill))
                    log.warning(
                        "bus publish failed (%s): degraded mode, "
                        "%d frame(s) spilled", e, len(self._spill),
                    )
                else:
                    _spilled.inc(1)
                return
            self._spill.popleft()
        if self._degraded_since is not None:
            self.degraded_seconds_total += (
                time.monotonic() - self._degraded_since
            )
            self._degraded_since = None
            log.info("bus recovered: degraded mode over, spill drained")

    def _swap_locked(self):
        batch, self._buf = self._buf, []
        n, self._buf_n = self._buf_n, 0
        self._oldest = None
        return batch, n

    def _deadline_loop(self) -> None:  # gomelint: hotpath
        while True:
            with self._lock:
                spilled = bool(self._spill)
            if not spilled:
                self._wake.wait()
            # gomelint: disable=GL402 — benign stale read: a bool load is
            # one bytecode under the GIL; a missed True is caught on the
            # next wake, and close() sets _wake after _stop.
            if self._stop:  # gomelint: disable=GL402
                return
            with self._lock:
                oldest = self._oldest
                if oldest is None and not self._spill:
                    self._wake.clear()
                    continue
            if oldest is not None:
                delay = oldest + self.max_wait_s - time.monotonic()
            else:
                # Degraded with an empty buffer: the spill is the only
                # pending work — retry it on its own cadence.
                delay = self.retry_interval_s
            if delay > 0:
                # Interruptible: close() sets the stop event, so a large
                # max_wait_s never pins the thread (or close's join).
                if self._stop_event.wait(delay):
                    return
            with self._lock:
                # Flush only if the head is still overdue (a size-bound
                # flush may have raced and restarted the window).
                if (
                    self._oldest is not None
                    and time.monotonic() >= self._oldest + self.max_wait_s
                ):
                    self._flush_locked()
                elif self._spill:
                    self._drain_spill_locked()
                if self._oldest is None and not self._spill:
                    self._wake.clear()

    def close(self) -> None:
        """Flush the remainder and stop the deadline thread.

        _stop is set UNDER the buffer lock: any submit that already
        passed its closed-check has appended before we get the lock, so
        the final flush below catches it — no order can slip between the
        check and the flush and be stranded."""
        with self._lock:
            self._stop = True
        self._stop_event.set()
        self._wake.set()
        self._thread.join(timeout=5)
        self.flush()
        with self._lock:
            if self._spill:
                # Bounded loss, loudly: the process is exiting with the
                # bus still down. The spill was never acknowledged past
                # the gateway's accept, and at-least-once clients retry.
                log.error(
                    "closing with %d undelivered spilled frame(s) — "
                    "bus still down", len(self._spill),
                )
