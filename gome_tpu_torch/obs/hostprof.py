"""Host-path observability: in-process sampling profiler, per-stage
gateway CPU attribution, and the host roofline.

The port of ``gome_tpu/obs/hostprof.py`` (no JAX there: a copy, its
stage rules naming the port's modules, its drill on the port's gateway
and pre-pools). Spans and the device counters leave the host CPU itself
unseen; this module is the host-CPU mirror of the device measurements:

  * ``HostSampler`` — an in-process sampling profiler. Two capture
    modes around one stack walker (``sys._current_frames`` + the
    interrupted frame):

      signal  ``SIGPROF`` via ``signal.setitimer(ITIMER_PROF)`` — paced
              by process CPU time, so samples/period ≈ CPU seconds. The
              handler runs on the main thread, which means (a) it can
              only be armed FROM the main thread and (b) a main thread
              blocked in a C call (``server.wait_for_termination``)
              delays delivery — perfect for drills, wrong for the live
              service.
      thread  a daemon thread polling ``sys._current_frames()`` — paced
              by wall clock, samples blocked threads too (a wall
              profile), works from any thread and under pytest. The
              live-service default.

    ``mode="auto"`` picks signal when armed from the main thread and
    ``setitimer`` exists, else thread. Samples aggregate to bounded
    state: a ``deque(maxlen=keep)`` ring of recent raw stacks plus a
    capped distinct-stack counter (overflow lands in a ``<overflow>``
    bucket), with frames collapsed to ``module:function`` nodes and
    collapsed-stack/flamegraph text output (``root;...;leaf count``).

    Concurrency contract: sampler state (``_counts``/``_ring``) has ONE
    writer at a time — the SIGPROF handler (main thread) or the sampler
    daemon — mutating via single C-level ops (dict item set, deque
    append). Readers snapshot with ``dict(...)``/``list(...)``, also
    single C-level ops. No lock: the signal handler interrupts the main
    thread between bytecodes, so taking a lock there could deadlock
    against a reader holding it on the same thread.

  * ``stage_join()`` — joins samples against the tracer's stage
    taxonomy: each stack is attributed to the DEEPEST frame matching a
    ``STAGE_RULES`` entry, splitting the gateway admit path
    function-by-function (``_validate_add`` → validate,
    ``order_from_request`` → order_build, ``_mark`` → mark,
    ``_traced_emit``/``_emit`` → enqueue) plus codec encode/decode,
    batcher flush, and consumer drain. Measured wall time is
    distributed over samples, so per-stage **ns/order** always sums to
    the measured window and coverage (the attributed-sample fraction)
    is an explicit honesty number, never silently assumed.

  * ``gateway_drill()`` — a deterministic, host-only admit-loop drill:
    pre-built OrderRequests through a real ``OrderGateway`` on a real
    in-process bus (pre-pool mark; no engine, no card) under the
    sampler. Yields measured admit ns/order, achievable
    orders/sec/core, the per-stage split, and which pre-pool the
    columnar path marked through (``prepool``: ``native`` where g++
    built the host library, else ``local``).

  * ``host_roofline()`` — the drill's measured gateway admit
    orders/sec/core as a table row. The reference adds consumer and
    device rows from its committed benchmark artifacts
    (``BENCH_SERVICE_r05.json``, ``BENCH_r05.json``), which were
    measured on a TPU; those rows wait for the port's own benchmark
    outputs.

  * ``hostprof_artifact()`` / ``bench_host()`` / ``bench_admit()`` — the
    ``HOSTPROF_CUDA_r0N.json`` payload (the drill plus the roofline) and
    the compact blocks a benchmark folds in: admit ns/order per stage,
    and the scalar and columnar admit on one seeded flow side by side.

``HOSTPROF`` is the process singleton behind the ops ``/hostprof``
endpoint and the ``gome_hostprof_*`` gauges, armed from the
``ops.hostprof`` / ``hostprof_hz`` / ``hostprof_keep`` config knobs
(service.app, thread mode). Same hot-path contract as
TRACER/JOURNAL/TIMELINE: disabled (the default) its ``note_admit`` hook
— called from the gateway on every accepted order — costs one attribute
check and ZERO allocations (pinned by ``sys.getallocatedblocks`` in
tests).

Import discipline: NO torch and NO service imports at module scope —
``service.gateway`` imports ``HOSTPROF`` at import time, and the pure
pieces (sampler, stage join) must stay testable without a backend. The
drill imports the gateway/bus lazily.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque

from ..utils.metrics import REGISTRY

#: Live-sampler default cadence (Hz). Deliberately low and non-round: the
#: thread-mode sampler walks every thread's stack per tick, so the live
#: service pays ~hz * n_threads frame walks per second; 67 Hz keeps that
#: well under 1% of a core while still resolving percent-level stages
#: over a minute of traffic. Drills use their own, much higher rate.
DEFAULT_HZ = 67.0
#: Drill cadence (Hz): CPU-paced SIGPROF at ~1ms resolves a sub-second
#: admit loop into hundreds of samples.
DRILL_HZ = 997.0
DEFAULT_KEEP = 4096

#: Cap on DISTINCT aggregated stacks; past it, new stacks land in the
#: overflow bucket so sampler memory is bounded no matter the workload.
MAX_STACKS = 4096
MAX_DEPTH = 48

_OVERFLOW = ("<overflow>",)

#: The host stage taxonomy — the tracer's span names (utils.trace STAGES)
#: projected onto host CPU, plus the admit-path function splits the
#: tracer cannot see (its ingress span covers validate/build/mark as one
#: region). Order is the report's display order.
HOST_STAGES = (
    "ingress",        # gateway handler shell (pb response build, dispatch)
    "validate",       # OrderGateway._validate_add
    "order_build",    # order_from_request + fixed.scale
    "mark",           # pre-pool mark (MatchEngine.mark / prepool)
    "enqueue",        # _traced_emit/_emit + batcher.submit
    "codec_encode",   # bus.codec / bus.colwire encode
    "batch_flush",    # FrameBatcher flush path
    "codec_decode",   # bus.codec / bus.colwire / ordercodec decode
    "consumer_drain", # service.consumer (incl. engine time under it)
)

#: Stages that are the gateway admit path — the numerator of the live
#: admit orders/sec/core gauge.
ADMIT_STAGES = (
    "ingress", "validate", "order_build", "mark", "enqueue",
    "codec_encode", "batch_flush",
)

#: (module suffix, function name | None = any, stage). First match wins;
#: exact-function rules sit above module wildcards so e.g. a colwire
#: decode frame under the consumer module still classifies codec_decode.
STAGE_RULES = (
    ("service.gateway", "_validate_add", "validate"),
    ("service.gateway", "order_from_request", "order_build"),
    ("gome_tpu_torch.fixed", "scale", "order_build"),
    # Columnar admit core: the array-native equivalents of the scalar
    # stages above, mapped onto the SAME stage names so scalar and
    # columnar profiles stay comparable column for column.
    ("service.gateway", "_vector_scale", "validate"),
    ("service.gateway", "_recheck_rows", "validate"),
    ("service.gateway", "_intern", "order_build"),
    ("service.gateway", "orders_from_columns", "order_build"),
    ("service.gateway", "_mark_cols", "mark"),
    ("service.gateway", "_unmark_cols", "mark"),
    ("service.gateway", "_emit_cols", "enqueue"),
    ("service.batcher", "submit_block", "enqueue"),
    ("bus.colwire", "encode_order_block", "codec_encode"),
    ("bus.colwire", "encode_order_frame_blocks", "codec_encode"),
    ("engine.orchestrator", "mark", "mark"),
    ("engine.orchestrator", "unmark", "mark"),
    ("engine.orchestrator", "_prekey", "mark"),
    ("engine.prepool", None, "mark"),
    ("obs.hostprof", "_drill_mark", "mark"),
    ("service.gateway", "_traced_emit", "enqueue"),
    ("service.gateway", "_emit", "enqueue"),
    ("service.batcher", "submit", "enqueue"),
    ("bus.codec", "encode_order", "codec_encode"),
    ("bus.codec", "encode_match_result", "codec_encode"),
    ("bus.colwire", "encode_order_frame", "codec_encode"),
    ("bus.colwire", "encode_event_frame", "codec_encode"),
    ("bus.codec", "decode_order", "codec_decode"),
    ("bus.codec", "decode_match_result", "codec_decode"),
    ("bus.colwire", "decode_order_frame", "codec_decode"),
    ("bus.colwire", "decode_event_frame", "codec_decode"),
    ("bus.ordercodec", None, "codec_decode"),
    ("service.batcher", None, "batch_flush"),
    ("service.consumer", None, "consumer_drain"),
    ("service.gateway", "DoOrder", "ingress"),
    ("service.gateway", "DeleteOrder", "ingress"),
    ("service.gateway", "DoOrderBatch", "ingress"),
    ("service.gateway", "DoOrderStream", "ingress"),
    ("service.gateway", "_apply_entries", "ingress"),
    ("service.gateway", "_apply_columnar", "ingress"),
    ("service.gateway", "_begin_trace", "ingress"),
    ("engine.orchestrator", "mark_frame", "mark"),
    ("engine.orchestrator", "unmark_frame", "mark"),
)


# ---------------------------------------------------------------------------
# the sampler


#: code object -> "module:function" node string, so steady-state sampling
#: allocates one string per DISTINCT code object, not per sample. Single
#: writer at a time (the sampling context); dict item set/get are single
#: C-level ops.
_NODE_CACHE: dict = {}


def _frame_node(frame) -> str:
    code = frame.f_code
    node = _NODE_CACHE.get(code)
    if node is None:
        mod = frame.f_globals.get("__name__", "?")
        func = getattr(code, "co_qualname", None) or code.co_name
        node = f"{mod}:{func}"
        _NODE_CACHE[code] = node
    return node


# One capture at a time: start()/stop() and the sampling tick (SIGPROF
# handler or poller thread) are serialized by the capture lifecycle
# (HostProfiler holds its _lock across arm/disarm), and the handler must
# never block, so this class carries NO lock by design.
class HostSampler:  # single-writer: the active capture (see note above)
    """In-process sampling profiler over ``module:function`` stacks.

    ``start()`` arms one of two capture modes (module docstring); both
    feed ``_note()``: a bounded ring of recent raw stacks plus a capped
    distinct-stack counter. ``all_threads=False`` (the drill shape)
    samples only the thread that called ``start()``; ``True`` (the live
    service shape) samples every thread except the sampler's own."""

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        keep: int = DEFAULT_KEEP,
        max_stacks: int = MAX_STACKS,
        max_depth: int = MAX_DEPTH,
        mode: str = "auto",
        all_threads: bool = False,
    ):
        if hz <= 0:
            raise ValueError(f"hz must be positive, got {hz}")
        if mode not in ("auto", "signal", "thread"):
            raise ValueError(f"unknown sampler mode {mode!r}")
        self.hz = float(hz)
        self.keep = max(1, int(keep))
        self.max_stacks = max(1, int(max_stacks))
        self.max_depth = max(1, int(max_depth))
        self.mode = mode
        self.all_threads = all_threads
        self.mode_used: str | None = None
        # Single-writer sampler state (see module docstring): no lock by
        # design — the SIGPROF handler must never block.
        self._counts: dict = {}
        self._ring: deque = deque(maxlen=self.keep)
        self._samples = 0
        self._active = False
        self._target_tid: int | None = None
        self._thread: threading.Thread | None = None
        self._stop_evt: threading.Event | None = None
        self._prev_handler = None
        self._wall_s = 0.0
        self._cpu_s = 0.0
        self._t0 = 0.0
        self._c0 = 0.0

    # -- lifecycle ---------------------------------------------------------

    @staticmethod
    def _signal_ok() -> bool:
        return (
            hasattr(signal, "setitimer")
            and threading.current_thread() is threading.main_thread()
        )

    def start(self) -> "HostSampler":
        if self._active:
            return self
        mode = self.mode
        if mode == "auto" or (mode == "signal" and not self._signal_ok()):
            mode = "signal" if self._signal_ok() else "thread"
        self._target_tid = (
            None if self.all_threads else threading.get_ident()
        )
        self._t0 = time.perf_counter()
        self._c0 = time.process_time()
        if mode == "signal":
            period = 1.0 / self.hz
            self._prev_handler = signal.signal(
                signal.SIGPROF, self._on_sigprof
            )
            signal.setitimer(signal.ITIMER_PROF, period, period)
        else:
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._poll_loop, name="gome-hostprof", daemon=True
            )
            self._thread.start()
        self.mode_used = mode
        self._active = True
        return self

    def stop(self) -> None:
        if not self._active:
            return
        if self.mode_used == "signal":
            signal.setitimer(signal.ITIMER_PROF, 0.0, 0.0)
            signal.signal(signal.SIGPROF, self._prev_handler or signal.SIG_DFL)
            self._prev_handler = None
        else:
            self._stop_evt.set()
            self._thread.join(timeout=2.0)
            self._thread = None
            self._stop_evt = None
        self._wall_s += time.perf_counter() - self._t0
        self._cpu_s += time.process_time() - self._c0
        self._active = False

    # -- capture -----------------------------------------------------------

    def _on_sigprof(self, signum, frame) -> None:
        # `frame` is the interrupted main-thread frame — NOT this
        # handler's — so profiler frames never pollute main-thread stacks.
        if self._target_tid is not None:
            self._note(self._walk(frame))
            return
        current = sys._current_frames()
        current[threading.get_ident()] = frame
        self._record(current, skip_tid=None)

    def _poll_loop(self) -> None:
        period = 1.0 / self.hz
        me = threading.get_ident()
        evt = self._stop_evt
        while not evt.wait(period):
            self._record(sys._current_frames(), skip_tid=me)

    def _record(self, frames_by_tid: dict, skip_tid: int | None) -> None:
        target = self._target_tid
        for tid, frame in frames_by_tid.items():
            if tid == skip_tid:
                continue
            if target is not None and tid != target:
                continue
            self._note(self._walk(frame))

    def _walk(self, frame) -> tuple:
        # Leaf -> root, capped at max_depth (keeps the DEEPEST frames —
        # the ones stage attribution reads; far-root frames drop first).
        nodes = []
        depth = 0
        while frame is not None and depth < self.max_depth:
            nodes.append(_frame_node(frame))
            frame = frame.f_back
            depth += 1
        nodes.reverse()
        return tuple(nodes)

    def _note(self, stack: tuple) -> None:
        if not stack:
            return
        self._samples += 1
        self._ring.append(stack)
        counts = self._counts
        if stack in counts:
            counts[stack] += 1
        elif len(counts) < self.max_stacks:
            counts[stack] = 1
        else:
            counts[_OVERFLOW] = counts.get(_OVERFLOW, 0) + 1

    # -- read side ---------------------------------------------------------

    @property
    def samples(self) -> int:
        return self._samples

    @property
    def wall_s(self) -> float:
        live = time.perf_counter() - self._t0 if self._active else 0.0
        return self._wall_s + live

    @property
    def cpu_s(self) -> float:
        live = time.process_time() - self._c0 if self._active else 0.0
        return self._cpu_s + live

    def counts(self) -> dict:
        """Snapshot of {stack tuple: sample count} (one C-level copy —
        safe against the concurrent writer)."""
        return dict(self._counts)

    def ring(self) -> list:
        """The most recent raw stacks, oldest first."""
        return list(self._ring)

    def node_totals(self) -> dict:
        """{node: {"self": leaf samples, "total": samples anywhere on
        stack}} — the flat ``module:function`` aggregation."""
        out: dict = {}
        for stack, c in self.counts().items():
            for node in set(stack):
                row = out.setdefault(node, {"self": 0, "total": 0})
                row["total"] += c
            out[stack[-1]]["self"] += c
        return out

    def collapsed(self, max_lines: int = 0) -> str:
        """Collapsed-stack text (``root;frame;leaf count`` per line,
        highest count first) — feed to any flamegraph renderer."""
        items = sorted(
            self.counts().items(), key=lambda kv: (-kv[1], kv[0])
        )
        if max_lines > 0:
            items = items[:max_lines]
        return "".join(f"{';'.join(s)} {c}\n" for s, c in items)

    def reset(self) -> None:
        # gomelint: disable=GL704 — reset() is part of the capture
        # lifecycle: it runs before start() arms the tick (or after
        # stop() disarms it), never concurrently with it.
        self._counts = {}  # gomelint: disable=GL704
        self._ring = deque(maxlen=self.keep)  # gomelint: disable=GL704
        self._samples = 0  # gomelint: disable=GL704
        self._wall_s = self._cpu_s = 0.0  # gomelint: disable=GL704
        if self._active:
            self._t0 = time.perf_counter()  # gomelint: disable=GL704
            self._c0 = time.process_time()  # gomelint: disable=GL704


# ---------------------------------------------------------------------------
# stage join (pure)

#: node string -> stage | None memo; nodes repeat far more than they
#: vary, so classification is one dict hit steady-state.
_CLASSIFY_CACHE: dict = {}


def classify_node(node: str) -> str | None:
    """STAGE_RULES verdict for one ``module:function`` node (memoized).
    A rule's function name matches the LAST dotted component of the
    frame's qualname, so ``OrderGateway._validate_add`` matches rule
    function ``_validate_add``."""
    try:
        return _CLASSIFY_CACHE[node]
    except KeyError:
        pass
    mod, _, func = node.partition(":")
    leaf = func.rpartition(".")[2]
    stage = None
    for mod_suffix, fname, st in STAGE_RULES:
        if fname is not None and fname != leaf:
            continue
        if mod.endswith(mod_suffix):
            stage = st
            break
    _CLASSIFY_CACHE[node] = stage
    return stage


def classify_stack(stack: tuple) -> str | None:
    """Deepest-frame-wins: the stage of the deepest frame any rule
    matches, so time inside a mapped function's callees (json.dumps
    under encode_order, dataclass __init__ under order_from_request)
    rolls UP to the mapped function, while a deeper mapped frame
    (colwire decode under consumer.run_once) takes precedence."""
    for node in reversed(stack):
        stage = classify_node(node)
        if stage is not None:
            return stage
    return None


def stage_join(
    counts: dict,
    n_orders: int | None = None,
    window_ns: float | None = None,
) -> dict:
    """Join sampled stacks against the stage taxonomy.

    Measured wall (``window_ns``) is distributed over samples by share —
    ``stage_ns = stage_samples / total_samples * window_ns`` — so the
    per-stage ns/order rows plus the unattributed row always sum to the
    measured window: nothing is invented, and ``coverage_pct`` (the
    attributed share) says how much of the window the taxonomy explains.
    """
    total = sum(counts.values())
    per_stage: dict = {}
    unattributed = 0
    for stack, c in counts.items():
        st = classify_stack(stack)
        if st is None:
            unattributed += c
        else:
            per_stage[st] = per_stage.get(st, 0) + c
    out: dict = {
        "total_samples": total,
        "attributed_samples": total - unattributed,
        "coverage_pct": (
            round(100.0 * (total - unattributed) / total, 2) if total else 0.0
        ),
        "stages": {},
        "unattributed": {"samples": unattributed},
    }
    order = list(HOST_STAGES) + sorted(set(per_stage) - set(HOST_STAGES))
    for st in order:
        c = per_stage.get(st, 0)
        if not c:
            continue
        row = {"samples": c, "pct": round(100.0 * c / total, 2)}
        if n_orders and window_ns and total:
            row["ns_per_order"] = round(
                c / total * window_ns / n_orders, 1
            )
        out["stages"][st] = row
    if n_orders and window_ns and total:
        out["unattributed"]["ns_per_order"] = round(
            unattributed / total * window_ns / n_orders, 1
        )
    return out


# ---------------------------------------------------------------------------
# the gateway admit drill (host-only: no engine, no card)


def _drill_requests(n: int, seed: int, n_symbols: int = 64,
                    del_every: int = 8) -> list:
    """n pre-built (OrderRequest, is_cancel) pairs, deterministic in
    (n, seed). Pre-built so the sampled loop measures the ADMIT path,
    not request construction."""
    from ..api import order_pb2 as pb

    reqs = []
    for i in range(n):
        k = (i * 2654435761 + seed) & 0xFFFFFFFF  # Knuth hash: cheap, fixed
        reqs.append((
            pb.OrderRequest(
                uuid=f"u{k % 16}",
                oid=f"d{seed}-{i}",
                symbol=f"sym{k % n_symbols}",
                transaction=pb.SALE if k & 1 else pb.BUY,
                price=1.0 + (k % 1000) / 1e4,
                volume=1.0 + (k % 7),
            ),
            i % del_every == del_every - 1,
        ))
    return reqs


def _drill_batches(reqs: list, batch_n: int) -> list:
    """Pre-built OrderBatchRequest protos (cancel masks preserved) from
    _drill_requests pairs — the columnar drill's unit of work. Pre-built
    for the same reason the scalar requests are: the sampled loop
    measures ADMIT, not proto construction."""
    from ..api import order_pb2 as pb

    batches = []
    for i in range(0, len(reqs), batch_n):
        chunk = reqs[i : i + batch_n]
        batches.append(
            pb.OrderBatchRequest(
                orders=[r for r, _ in chunk],
                cancel=[c for _, c in chunk],
            )
        )
    return batches


def _drill_mark(pool, order) -> None:
    """The drill's pre-pool mark: the reference's S:U:O key into a
    LocalPrePool — same work shape as MatchEngine.mark/_prekey without
    constructing an engine (no card in the drill)."""
    pool.add((order.symbol, order.uuid, order.oid))


def _drill_gateway(columnar: bool = False):
    """A fresh OrderGateway on a fresh in-process bus (per round, so the
    memory queue's log never grows unbounded across rounds). Returns
    (gateway, batcher, pool) — batcher is None on the scalar path; the
    columnar variant gets the bulk pre-pool markers and a FrameBatcher
    whose deadline can never fire mid-round (the drill flushes inside
    its own timing window, then close()s the round's batcher outside
    it)."""
    from ..bus import MemoryQueue, QueueBus
    from ..engine.prepool import LocalPrePool
    from ..service.gateway import OrderGateway

    pool = LocalPrePool()
    bus = QueueBus(MemoryQueue("doOrder"), MemoryQueue("matchOrder"))
    batcher = None
    if columnar:
        from ..service.batcher import FrameBatcher

        try:
            # The columnar path's production marker: the fused C pass
            # (native/csrc/hostops.cc). LocalPrePool's row-select is the
            # fallback where g++ cannot build the library.
            from ..engine.prepool import NativePrePool

            pool = NativePrePool()
        except (RuntimeError, OSError):
            pass
        batcher = FrameBatcher(
            bus.order_queue, max_n=2048, max_wait_s=60.0
        )
    gateway = OrderGateway(
        bus,
        accuracy=8,
        mark=lambda order: _drill_mark(pool, order),
        unmark=lambda order: pool.discard(
            (order.symbol, order.uuid, order.oid)
        ),
        mark_frame=pool.mark_frame,
        unmark_frame=pool.unmark_frame,
        batcher=batcher,
        columnar=columnar,
    )
    return gateway, batcher, pool


def gateway_drill(
    n_orders: int = 30_000,
    hz: float = DRILL_HZ,
    seed: int = 7,
    min_samples: int = 350,
    max_rounds: int = 6,
    mode: str = "auto",
    path: str = "scalar",
    batch_n: int = 1024,
) -> dict:
    """Measure the gateway admit path: drive pre-built requests through
    ``DoOrder``/``DeleteOrder`` (path="scalar") or the SAME seeded flow
    as OrderBatchRequests through the columnar ``DoOrderBatch`` core +
    FrameBatcher (path="columnar"), on an in-process bus under the
    sampler. Repeats the n_orders round (fresh gateway each round) until
    the sampler holds ``min_samples`` stacks or ``max_rounds`` is hit,
    so the stage split is statistically meaningful while the admit
    ns/order itself is a plain wall/N measurement. Columnar rounds are
    ~100x shorter, so callers wanting a tight stage split pass a higher
    max_rounds; the final in-window flush() charges the frame join to
    the admit cost it belongs to."""
    if path not in ("scalar", "columnar"):
        raise ValueError(f"unknown drill path {path!r}")
    columnar = path == "columnar"
    reqs = _drill_requests(n_orders, seed)
    batches = _drill_batches(reqs, batch_n) if columnar else None
    # Warm pb internals, codec, and the admit path outside the window.
    warm, warm_b, _ = _drill_gateway(columnar=columnar)
    if columnar:
        for breq in batches[: max(1, 4096 // batch_n)]:
            warm.DoOrderBatch(breq, None)
        warm_b.close()
    else:
        for req, is_del in reqs[:256]:
            (warm.DeleteOrder if is_del else warm.DoOrder)(req, None)

    sampler = HostSampler(
        hz=hz, keep=DEFAULT_KEEP, mode=mode, all_threads=False
    )
    wall_ns = 0
    done = 0
    rounds = 0
    sampler.start()
    try:
        while rounds < max_rounds and (
            done == 0 or sampler.samples < min_samples
        ):
            gateway, batcher, pool = _drill_gateway(columnar=columnar)
            if columnar:
                do_batch = gateway.DoOrderBatch
                t0 = time.perf_counter_ns()
                for breq in batches:
                    do_batch(breq, None)
                batcher.flush()
                wall_ns += time.perf_counter_ns() - t0
                batcher.close()  # outside the window: thread teardown
            else:
                do_order = gateway.DoOrder
                do_delete = gateway.DeleteOrder
                t0 = time.perf_counter_ns()
                for req, is_del in reqs:
                    if is_del:
                        do_delete(req, None)
                    else:
                        do_order(req, None)
                wall_ns += time.perf_counter_ns() - t0
            done += len(reqs)
            rounds += 1
    finally:
        sampler.stop()

    from ..engine.prepool import NativePrePool

    ns_per_order = wall_ns / max(done, 1)
    join = stage_join(sampler.counts(), n_orders=done, window_ns=wall_ns)
    out = {
        "kind": "gateway_admit_drill",
        "path": path,
        "seed": seed,
        "orders": done,
        "rounds": rounds,
        "wall_s": round(wall_ns / 1e9, 4),
        "admit_ns_per_order": round(ns_per_order, 1),
        "admit_orders_per_sec_per_core": round(1e9 / ns_per_order)
        if ns_per_order > 0
        else None,
        "sampler": {
            "mode": sampler.mode_used,
            "hz": hz,
            "samples": sampler.samples,
            "cpu_s": round(sampler.cpu_s, 4),
            "wall_s": round(sampler.wall_s, 4),
        },
        "coverage_pct": join["coverage_pct"],
        "stages": join["stages"],
        "unattributed": join["unattributed"],
        "collapsed": sampler.collapsed(max_lines=200),
        "prepool": "native" if isinstance(pool, NativePrePool) else "local",
        "note": (
            "host-only admit loop: pre-built OrderRequests -> "
            "OrderGateway (LocalPrePool mark, JSON codec, in-process "
            "MemoryQueue publish); ns/order is wall/N, per-stage rows "
            "distribute that wall by sampled share"
        )
        if not columnar
        else (
            "host-only columnar admit loop: pre-built OrderBatchRequests "
            "-> OrderGateway._apply_columnar (numpy masks, bulk "
            "LocalPrePool mark_frame, GCO4 block encode, FrameBatcher "
            "submit_block, in-process MemoryQueue publish); the final "
            "flush is inside the timing window; ns/order is wall/N, "
            "per-stage rows distribute that wall by sampled share"
        ),
    }
    if columnar:
        out["batch_n"] = batch_n
    return out


# ---------------------------------------------------------------------------
# the host roofline


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))


def _artifact_value(root: str, name: str, path: tuple):
    """The value at ``path`` inside the repo-root JSON file ``name``, or
    None when the file is absent or malformed or lacks the path."""
    try:
        with open(os.path.join(root, name), encoding="utf-8") as fh:
            doc = json.load(fh)
        for key in path:
            doc = doc[key]
        return doc
    except (OSError, KeyError, TypeError, ValueError):
        return None


def host_roofline(drill: dict) -> dict:
    """The host-vs-device orders/sec table: the drill's measured gateway
    admit rate. The reference's consumer-drain and device-matching rows
    read its benchmark's outputs (BENCH_SERVICE_r05.json, BENCH_r05.json),
    measured on a TPU; they stay absent here (as the reference leaves a
    missing artifact's row absent) until the port's benchmark writes
    outputs of its own."""
    return {
        "host_gateway_admit": {
            "orders_per_sec_per_core": drill.get(
                "admit_orders_per_sec_per_core"
            ),
            "source": "measured (gateway_drill, this artifact)",
        },
        "note": (
            "the gateway's admit rate on this host; consumer and device "
            "rows await the port's own benchmark artifacts"
        ),
    }


def hostprof_artifact(
    n_orders: int = 30_000,
    hz: float = DRILL_HZ,
    seed: int = 7,
    min_samples: int = 800,
    max_rounds: int = 8,
    artifact: str = "HOSTPROF_CUDA_r01",
    path: str = "scalar",
    batch_n: int = 1024,
) -> dict:
    """The HOSTPROF_CUDA_r0N.json payload: the gateway admit drill
    (per-stage ns/order, >= 80% coverage by construction of the stage
    map) plus the host roofline. Defaults give HOSTPROF_CUDA_r01 (the
    scalar admit); artifact="HOSTPROF_CUDA_r02", path="columnar" (with a
    much higher max_rounds: columnar rounds are ~100x shorter) the
    columnar one."""
    import platform

    drill = gateway_drill(
        n_orders=n_orders,
        hz=hz,
        seed=seed,
        min_samples=min_samples,
        max_rounds=max_rounds,
        path=path,
        batch_n=batch_n,
    )
    return {
        "artifact": artifact,
        "method": (
            "in-process sampling profiler (obs.hostprof.HostSampler, "
            f"{drill['sampler']['mode']} mode @ {hz} Hz) over a "
            "deterministic gateway admit drill; stage rows join samples "
            "against the tracer stage taxonomy (deepest mapped frame "
            "wins) and distribute measured wall by sampled share"
        ),
        "python": platform.python_version(),
        "drill": drill,
        "roofline": host_roofline(drill),
    }


def bench_host(
    n_orders: int = 16_384, min_samples: int = 256, seed: int = 7
) -> dict:
    """The compact ``"host"`` block a service benchmark folds in: admit
    ns/order + orders/sec/core, per-stage ns/order, sample counts."""
    drill = gateway_drill(
        n_orders=n_orders, min_samples=min_samples, seed=seed
    )
    return {
        "admit_ns_per_order": drill["admit_ns_per_order"],
        "admit_orders_per_sec_per_core": (
            drill["admit_orders_per_sec_per_core"]
        ),
        "coverage_pct": drill["coverage_pct"],
        "sampler_mode": drill["sampler"]["mode"],
        "samples": drill["sampler"]["samples"],
        "stage_ns_per_order": {
            st: row.get("ns_per_order")
            for st, row in drill["stages"].items()
        },
    }


def bench_admit(
    n_orders: int = 16_384,
    seed: int = 7,
    min_samples: int = 64,
    batch_n: int = 1024,
) -> dict:
    """The compact ``"admit"`` block: scalar vs columnar admit on the
    identical seeded flow, side by side with the speedup ratio."""
    scalar = gateway_drill(
        n_orders=n_orders, seed=seed, min_samples=min_samples,
        max_rounds=2, path="scalar",
    )
    columnar = gateway_drill(
        n_orders=n_orders, seed=seed, min_samples=min_samples,
        max_rounds=24, path="columnar", batch_n=batch_n,
    )

    def _row(d: dict) -> dict:
        return {
            "admit_ns_per_order": d["admit_ns_per_order"],
            "admit_orders_per_sec_per_core": (
                d["admit_orders_per_sec_per_core"]
            ),
            "orders": d["orders"],
            "rounds": d["rounds"],
            "coverage_pct": d["coverage_pct"],
        }

    out = {
        "kind": "admit_bench",
        "seed": seed,
        "batch_n": batch_n,
        "scalar": _row(scalar),
        "columnar": _row(columnar),
    }
    s, c = scalar["admit_ns_per_order"], columnar["admit_ns_per_order"]
    if s and c:
        out["speedup_x"] = round(s / c, 2)
    return out


# ---------------------------------------------------------------------------
# the process singleton


class HostProfiler:
    """The HOSTPROF singleton behind the ops ``/hostprof`` endpoint and
    the ``gome_hostprof_*`` gauges.

    Disabled by default. ``install()`` (service.app, from the
    ``ops.hostprof`` knob) arms a live thread-mode sampler (started and
    stopped with the service) and registers the gauges; ``drill()`` runs
    the deterministic admit drill on demand and keeps the last report
    for the endpoint/gauges. ``note_admit`` is the hot-path hook — the
    gateway calls it per accepted order, so the disabled cost is ONE
    attribute check and zero allocations."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sampler: HostSampler | None = None  # guarded by self._lock (armed ⇔ sampler)
        self._admits: int | None = None  # guarded by self._lock
        self._hz = DEFAULT_HZ  # guarded by self._lock
        self._keep = DEFAULT_KEEP  # guarded by self._lock
        self._last_drill: dict | None = None  # guarded by self._lock

    @property
    def enabled(self) -> bool:
        return self._sampler is not None  # gomelint: disable=GL402

    def install(
        self,
        hz: float = DEFAULT_HZ,
        keep_n: int = DEFAULT_KEEP,
        mode: str = "thread",
        registry=None,
    ) -> "HostProfiler":
        """Arm the live sampler (NOT started — service.app starts it
        with the service so the wall profile covers served traffic only)
        and register the gauges. Thread mode by default: the live
        service's main thread blocks in C calls, where SIGPROF delivery
        stalls (module docstring)."""
        with self._lock:
            if self._sampler is None:
                self._sampler = HostSampler(
                    hz=hz, keep=keep_n, mode=mode, all_threads=True
                )
            if self._admits is None:
                self._admits = 0
            self._hz = hz
            self._keep = keep_n
        self._export(registry or REGISTRY)
        return self

    def disable(self) -> None:
        with self._lock:
            sampler, self._sampler = self._sampler, None
            self._admits = None
            self._last_drill = None
        if sampler is not None:
            sampler.stop()

    def start(self) -> None:
        """Start the live sampler thread (service.app start())."""
        with self._lock:
            sampler = self._sampler
        if sampler is not None:
            sampler.start()

    def stop(self) -> None:
        """Stop the live sampler thread; stays armed (samples keep)."""
        with self._lock:
            sampler = self._sampler
        if sampler is not None:
            sampler.stop()

    # ------------------------------------------------------------------
    # hot path

    def note_admit(self, n: int = 1) -> None:
        """One accepted order (ADD or DEL) left the gateway into the
        pipeline. Disabled: one attribute check, zero allocations."""
        if self._admits is None:  # gomelint: disable=GL402 — lock-free
            return  # fast check; the locked add below re-validates
        with self._lock:
            if self._admits is not None:
                self._admits += n

    # ------------------------------------------------------------------
    # reports

    def drill(
        self,
        n_orders: int = 8192,
        min_samples: int = 128,
        max_rounds: int = 4,
        seed: int = 7,
    ) -> dict:
        """Run the deterministic admit drill now and keep the report for
        the endpoint/gauges. Sub-second of bounded work — ops surface,
        never the serving path."""
        rep = gateway_drill(
            n_orders=n_orders,
            min_samples=min_samples,
            max_rounds=max_rounds,
            seed=seed,
        )
        with self._lock:
            if self._sampler is not None:
                self._last_drill = rep
        return rep

    def last_drill(self) -> dict | None:
        with self._lock:
            return self._last_drill

    def live_report(self) -> dict:
        """Stage join over the LIVE sampler's stacks. Thread mode is a
        wall profile: blocked threads (a consumer waiting on the bus)
        sample at full rate, so stage shares mean wall residency, not
        CPU burn; ns/order rows divide sampled wall by note_admit'd
        orders."""
        with self._lock:
            sampler = self._sampler
            admits = self._admits
        if sampler is None:
            return {"enabled": False}
        wall_ns = sampler.wall_s * 1e9
        join = stage_join(
            sampler.counts(),
            n_orders=admits or None,
            window_ns=wall_ns or None,
        )
        join.update(
            enabled=True,
            mode=sampler.mode_used,
            sampling=sampler._active,
            wall_s=round(sampler.wall_s, 3),
            admits=admits,
        )
        return join

    def collapsed(self) -> str:
        """Collapsed stacks for ``/hostprof?format=collapsed``: the live
        sampler's when it has samples, else the last drill's."""
        with self._lock:
            sampler = self._sampler
            drill = self._last_drill
        if sampler is None:
            return "# hostprof disabled\n"
        if sampler.samples:
            return sampler.collapsed()
        if drill is not None and drill.get("collapsed"):
            return drill["collapsed"]
        return "# hostprof: no samples yet\n"

    def payload(self, run_drill: bool = False) -> dict:
        """The ops ``/hostprof`` JSON body. ``?drill=1`` runs the admit
        drill on demand; drill errors degrade to an ``error`` field,
        never a 500."""
        if not self.enabled:
            return {"enabled": False, "live": None, "drill": None}
        err = None
        if run_drill:
            try:
                self.drill()
            except Exception as exc:  # pragma: no cover - env-specific
                err = f"{type(exc).__name__}: {exc}"
        with self._lock:
            hz, keep = self._hz, self._keep
            admits = self._admits
        out = {
            "enabled": True,
            "hz": hz,
            "keep": keep,
            "admits": admits,
            "live": self.live_report(),
            "drill": self.last_drill(),
        }
        if err:
            out["error"] = err
        return out

    # ------------------------------------------------------------------
    # gauges

    def _samples_total(self) -> int:
        with self._lock:
            sampler = self._sampler
            drill = self._last_drill
        n = sampler.samples if sampler is not None else 0
        if drill is not None:
            n += drill["sampler"]["samples"]
        return n

    def _stage_ns(self, stage: str) -> float:
        """Per-stage ns/order for the gauges: the drill's measured row
        when one exists (CPU-paced, deterministic flow), else the live
        wall-profile row."""
        with self._lock:
            drill = self._last_drill
        src = drill["stages"] if drill is not None else (
            self.live_report().get("stages") or {}
        )
        v = (src.get(stage) or {}).get("ns_per_order")
        return float(v) if v is not None else 0.0

    def _admit_rate(self) -> float:
        """Admit orders/sec/core: the drill's measured number when one
        exists, else orders note_admit'd per second of live admit-stage
        sampled wall."""
        with self._lock:
            drill = self._last_drill
            sampler = self._sampler
            admits = self._admits
        if drill is not None:
            return float(drill["admit_orders_per_sec_per_core"] or 0.0)
        if sampler is None or not admits or not sampler.samples:
            return 0.0
        counts = sampler.counts()
        admit_samples = sum(
            c
            for stack, c in counts.items()
            if classify_stack(stack) in ADMIT_STAGES
        )
        admit_s = (
            admit_samples / sampler.samples
        ) * sampler.wall_s
        return admits / admit_s if admit_s > 0 else 0.0

    def _export(self, reg) -> None:
        reg.callback_gauge(
            "gome_hostprof_samples_total",
            "Host stack samples captured since arm (live sampler + last "
            "drill)",
            lambda: self._samples_total(),
        )
        reg.callback_gauge(
            "gome_hostprof_admit_orders_per_sec_per_core",
            "Achievable gateway admit rate from measured host ns/order "
            "(last drill, else live window)",
            lambda: self._admit_rate(),
        )
        for st in HOST_STAGES:
            reg.callback_gauge(
                "gome_hostprof_stage_ns_per_order",
                "Measured host ns/order per stage (sampled share of the "
                "measured window / orders)",
                lambda s=st: self._stage_ns(s),
                labels={"stage": st},
            )


HOSTPROF = HostProfiler()
