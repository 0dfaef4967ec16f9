"""gRPC gateway — the reference's server process (gomengine/main.go:22-64).

Handler behavior parity (main.go:39-64): handlers do NO matching — they
build the internal order, mark the pre-pool (ADD only; main.go:44-45 — DEL
never marks), publish to the "doOrder" queue, and return success
immediately. The response never reflects matching outcome; the pipeline is
fully asynchronous (SURVEY §1 L4).

Differences, deliberate:
  * float→tick scaling is validated here at the edge (the reference scales
    inside the consumer, ordernode.go:76-87, and cannot reject bad input —
    its gateway already returned success);
  * SubscribeMatches streams the matchOrder feed over gRPC (extension; the
    reference's downstream is an AMQP stub, rabbitmq.go:169).

The port of ``gome_tpu/service/gateway.py``: the same responses, marks and
doOrder bodies, byte for byte, and the same obs/ admit hooks
(HOSTPROF.note_admit, PLACEMENT.note_admit*) at the same points.
"""

from __future__ import annotations

import dataclasses
import operator
from concurrent import futures

import grpc
import numpy as np

from ..api import order_pb2 as pb
from ..api.service import add_order_servicer
from ..bus import QueueBus, encode_order
from ..bus.colwire import encode_order_block, encode_order_frame_blocks
from ..config import Config
from ..fixed import scale
from ..obs.hostprof import HOSTPROF
from ..obs.placement import PLACEMENT
from ..types import Action, Order, OrderType, Side
from ..utils.faults import FAULTS
from ..utils.logging import get_logger
from ..utils.trace import TRACER

log = get_logger("gateway")

#: Edge-reject status codes on the reference-shaped OrderResponse.code
#: field: 3 = permanent reject (invalid order, gateway shut down — do not
#: retry), RETRYABLE = the pipeline is degraded (bus down + spill full /
#: circuit open); the order was NOT accepted and a retry later should
#: succeed. 14 matches gRPC UNAVAILABLE by convention.
CODE_REJECT = 3
CODE_RETRYABLE = 14


def _time_remaining(context) -> float | None:
    """Caller's remaining gRPC deadline in seconds, or None when no
    deadline was set (or the test harness passed a bare context)."""
    if context is None:
        return None
    tr = getattr(context, "time_remaining", None)
    if not callable(tr):
        return None
    remaining = tr()
    # grpc returns a huge sentinel (~year-scale) when no deadline is set.
    if remaining is None or remaining > 1e8:
        return None
    return remaining


def order_from_request(
    request: pb.OrderRequest, action: Action, accuracy: int
) -> Order:
    """OrderRequest → internal Order (NewOrderNode's role,
    ordernode.go:38-54: stamp action, scale price/volume by 10^accuracy)."""
    return Order(
        uuid=request.uuid,
        oid=request.oid,
        symbol=request.symbol,
        side=Side(request.transaction),
        price=scale(request.price, accuracy),
        volume=scale(request.volume, accuracy),
        action=action,
        order_type=OrderType(request.kind),
    )


#: Above this magnitude a float64 has an ulp >= 0.5, so ``rint(x * 10^a)``
#: can land on the wrong integer and the vectorized scale result is no
#: longer provably equal to fixed.scale's Decimal result. Rows whose scaled
#: value reaches this bound are re-run through the scalar path.
_SAFE_SCALED = float(1 << 51)

#: DoOrderStream applies columnar admission in chunks of this many
#: messages, so reject indices/abort entry numbers stay absolute while the
#: working set (proto list + numpy columns) stays cache-sized.
STREAM_CHUNK = 4096

#: C-level field pulls for the columnar extraction passes: map(attrgetter)
#: keeps the per-row loop out of Python bytecode entirely (~25% cheaper
#: than a genexpr/listcomp at gateway batch sizes).
_GET_TRANSACTION = operator.attrgetter("transaction")
_GET_KIND = operator.attrgetter("kind")
_GET_PRICE = operator.attrgetter("price")
_GET_VOLUME = operator.attrgetter("volume")
_GET_SYMBOL = operator.attrgetter("symbol")
_GET_UUID = operator.attrgetter("uuid")
_GET_OID = operator.attrgetter("oid")


def _vector_scale(values: np.ndarray, accuracy: int):
    """Vectorized fixed.scale: float column -> (int64 ticks, exact mask,
    suspect mask).

    ``exact[i]`` guarantees the scalar path would admit the value and
    produce the same integer: within ``|x * 10^a| < 2**51`` the tick grid
    is coarser than the float64 ulp, so at most one integer ``j`` satisfies
    ``float(j / 10^a) == x`` — and then ``repr(x)`` has <= ``accuracy``
    fractional digits, which is exactly fixed.scale's acceptance test.
    ``suspect[i]`` marks rows outside that provable range (huge/non-finite
    scaled values); the caller re-runs those through fixed.scale itself.
    Rows that are neither exact nor suspect are definite scalar-path
    rejects ("more than {a} decimal places").
    """
    p = 10.0 ** accuracy
    with np.errstate(invalid="ignore", over="ignore"):
        scaled = values * p
        safe = np.isfinite(scaled) & (np.abs(scaled) < _SAFE_SCALED)
        ticks = np.rint(np.where(safe, scaled, 0.0))
        exact = safe & ((ticks / p) == values)
    return ticks.astype(np.int64), exact, ~safe


def _intern(strings: list):
    """Column of python strings -> (first-occurrence unique list, uint32
    index array) — the dictionary-encoding step of the GCO4 wire columns,
    done once per batch instead of once per order. A dict pass beats
    np.unique here (no U-dtype copy, no sort) at gateway batch sizes."""
    table: dict = {}
    setd = table.setdefault
    idx = [setd(s, len(table)) for s in strings]
    return list(table), np.asarray(idx, np.uint32)


def orders_from_columns(cols: dict):
    """Materialize internal Orders from a columnar admit block — the
    scalar-pool fallback when no bulk marker is wired, and the parity
    harness tests use it to compare paths row for row."""
    symbols = cols["symbols"]
    uuids = cols["uuids"]
    sym_idx = np.asarray(cols["symbol_idx"]).tolist()
    uuid_idx = np.asarray(cols["uuid_idx"]).tolist()
    oids = np.asarray(cols["oids"]).tolist()
    action = np.asarray(cols["action"]).tolist()
    side = np.asarray(cols["side"]).tolist()
    kind = np.asarray(cols["kind"]).tolist()
    price = np.asarray(cols["price"]).tolist()
    volume = np.asarray(cols["volume"]).tolist()
    return [
        Order(
            uuid=uuids[uuid_idx[i]],
            oid=oids[i].decode(),
            symbol=symbols[sym_idx[i]],
            side=Side(side[i]),
            price=price[i],
            volume=volume[i],
            action=Action(action[i]),
            order_type=OrderType(kind[i]),
        )
        for i in range(int(cols["n"]))
    ]


class OrderGateway:
    """The Order servicer (main.go:20,39-64)."""

    def __init__(
        self,
        bus: QueueBus,
        accuracy: int,
        mark=None,
        match_feed=None,
        max_volume: int | None = None,
        batcher=None,
        unmark=None,
        mark_frame=None,
        unmark_frame=None,
        columnar: bool = True,
        admission=None,
    ):
        """mark: callable(Order) recording the pre-pool entry — the
        MatchEngine.mark bound method in single-binary mode. match_feed:
        MatchFeed for SubscribeMatches (optional). max_volume: per-order lot
        ceiling enforced at the edge (int32 engines pass LOT_MAX32 so an
        oversized order is rejected with code 3 here, like volume<=0,
        instead of raising inside the consumer batch). batcher: a
        service.batcher.FrameBatcher — accepted orders then leave as
        columnar ORDER frames (size/deadline bounded) instead of one JSON
        document per request; admission/marking semantics are unchanged.
        unmark: callable(Order) undoing a pre-pool mark — used only on the
        shutdown race where the batcher closed between mark and emit, so a
        rejected order never leaves a dangling marker. mark_frame /
        unmark_frame: callables taking a decoded-ORDER-frame cols dict and
        bulk-(un)marking its ADD rows (MatchEngine.mark_frame /
        unmark_frame in single-binary mode) — the columnar admit path's
        batched pre-pool marker; when absent the columnar path falls back
        to per-order mark/unmark over materialized Orders. columnar: admit
        DoOrderBatch/DoOrderStream traffic through the array-native core
        (False pins the per-entry scalar loop, e.g. for parity tests).
        admission: a service.admission.AdmissionController — handlers
        consult it BEFORE marking/emitting; a shed returns the retryable
        status (code 14) with a retry-after hint, so backed-up consumers
        push backpressure all the way to the client."""
        self._bus = bus
        self._accuracy = accuracy
        self._mark = mark or (lambda order: None)
        self._unmark = unmark or (lambda order: None)
        self._mark_frame = mark_frame
        self._unmark_frame = unmark_frame
        self._columnar = columnar
        self._match_feed = match_feed
        self._max_volume = max_volume
        self._batcher = batcher
        self._admission = admission

    def _emit(self, order: Order) -> None:
        # Fault point "gateway.emit": exit = gateway-kill, call-handler
        # raising ConnectionError = bus-disconnect — both exercised by
        # scripts/fleet_chaos.py against the real degraded paths below.
        FAULTS.fire("gateway.emit")
        if self._batcher is not None:
            self._batcher.submit(order)
        elif order.trace is not None and self._bus.order_queue.supports_headers:
            # Per-order publish: the trace context also rides the AMQP
            # basic-properties headers (survives the broker hop even for
            # opaque bodies; the consumer adopts it when the body carries
            # none).
            self._bus.order_queue.publish(
                encode_order(order), headers={"x-trace": order.trace}
            )
        else:
            self._bus.order_queue.publish(encode_order(order))

    def _begin_trace(self):
        """(trace_id, t_ingress) for a new order journey, or (None, 0.0)
        while tracing is disabled (the zero-overhead path)."""
        tid = TRACER.new_trace()
        return tid, (TRACER.clock() if tid is not None else 0.0)

    def _traced_emit(self, order: Order, tid: str | None, t0: float) -> Order:
        """Close the ingress span, stamp the wire context, and emit under
        an enqueue span. Returns the (possibly re-stamped) order."""
        if tid is None:
            self._emit(order)
            return order
        TRACER.add_span(tid, "ingress", t0, TRACER.clock())
        with TRACER.bind(tid), TRACER.span("enqueue", tid):
            # The hop timestamp is stamped INSIDE the enqueue span: the
            # receiver-side span it seeds (batch_wait / bus_transit)
            # then starts after enqueue began — journeys stay monotone.
            order = dataclasses.replace(
                order, trace=TRACER.context(tid)
            )
            self._emit(order)
        return order

    def _validate_add(self, request: pb.OrderRequest) -> Order:
        """OrderRequest -> admitted ADD Order; raises ValueError with the
        edge-rejection reason (code 3) otherwise."""
        order = order_from_request(request, Action.ADD, self._accuracy)
        if order.volume <= 0:
            raise ValueError("volume must be positive")
        if self._max_volume is not None and order.volume > self._max_volume:
            raise ValueError(
                f"volume {order.volume} exceeds the engine's per-order "
                f"lot ceiling {self._max_volume}"
            )
        if order.order_type is OrderType.LIMIT and order.price <= 0:
            raise ValueError("limit price must be positive")
        return order

    def DoOrder(self, request: pb.OrderRequest, context) -> pb.OrderResponse:
        if self._admission is not None:
            d = self._admission.admit(1, _time_remaining(context))
            if not d.ok:
                return pb.OrderResponse(
                    code=CODE_RETRYABLE, message=d.message()
                )
        tid, t0 = self._begin_trace()
        try:
            order = self._validate_add(request)
        except ValueError as e:
            return pb.OrderResponse(code=3, message=f"rejected: {e}")
        self._mark(order)  # pre-pool before queueing (main.go:44-45)
        try:
            self._traced_emit(order, tid, t0)
        except (ConnectionError, OSError) as e:
            # Bus degraded (spill full / circuit open / reconnect budget
            # exhausted): the order was NOT accepted into the pipeline, so
            # the mark must not dangle — and the client hears an explicit
            # RETRYABLE status instead of a gRPC UNKNOWN or a silent drop.
            self._unmark(order)
            return pb.OrderResponse(
                code=CODE_RETRYABLE, message=f"degraded, retry: {e}"
            )
        except RuntimeError as e:
            # Batcher closed mid-shutdown: permanent for this process.
            self._unmark(order)
            return pb.OrderResponse(
                code=CODE_REJECT, message=f"rejected: {e}"
            )
        # main.go:49: unconditional success; matching outcome arrives async.
        HOSTPROF.note_admit()  # disabled: one attribute check, no allocs
        PLACEMENT.note_admit(order.symbol)  # same disabled contract
        return pb.OrderResponse(code=0, message="order accepted")

    def DeleteOrder(self, request: pb.OrderRequest, context) -> pb.OrderResponse:
        if self._admission is not None:
            d = self._admission.admit(1, _time_remaining(context))
            if not d.ok:
                return pb.OrderResponse(
                    code=CODE_RETRYABLE, message=d.message()
                )
        tid, t0 = self._begin_trace()
        try:
            order = order_from_request(request, Action.DEL, self._accuracy)
        except ValueError as e:
            return pb.OrderResponse(code=3, message=f"rejected: {e}")
        # No pre-pool mark (main.go:54-64); the consumer clears it so a
        # still-queued ADD dies (engine.go:88-90, SURVEY §2.3.3). Cancels
        # ride the same batcher so the DEL-after-ADD order is preserved.
        try:
            self._traced_emit(order, tid, t0)
        except (ConnectionError, OSError) as e:
            return pb.OrderResponse(
                code=CODE_RETRYABLE, message=f"degraded, retry: {e}"
            )
        except RuntimeError as e:
            # Batcher closed: reject, don't crash the handler.
            return pb.OrderResponse(
                code=CODE_REJECT, message=f"rejected: {e}"
            )
        HOSTPROF.note_admit()
        PLACEMENT.note_admit(order.symbol)  # cancels are symbol flow too
        return pb.OrderResponse(code=0, message="cancel accepted")

    def _apply_entries(self, entries) -> pb.OrderBatchResponse:
        """Shared core of the amortized-ingest RPCs: apply (request,
        is_cancel) pairs in order — per-entry validation rejects are
        collected (parallel reject_index/rejects arrays), accepted
        entries mark + emit exactly like their unary counterparts. An
        emit failure stops the batch: the response carries CODE_RETRYABLE
        when the bus is degraded (retry the remainder later) or
        CODE_REJECT when the batcher is closed, and `accepted` says how
        many entries made it into the pipeline before the failure
        (at-most-once for the remainder — the client resubmits them)."""
        resp = pb.OrderBatchResponse()
        accepted = 0
        for i, (request, is_cancel) in enumerate(entries):
            tid, t0 = self._begin_trace()  # per-entry order journey
            if is_cancel:
                try:
                    order = order_from_request(
                        request, Action.DEL, self._accuracy
                    )
                except ValueError as e:
                    resp.reject_index.append(i)
                    resp.rejects.add(code=3, message=f"rejected: {e}")
                    continue
                unmark_on_fail = False
            else:
                try:
                    order = self._validate_add(request)
                except ValueError as e:
                    resp.reject_index.append(i)
                    resp.rejects.add(code=3, message=f"rejected: {e}")
                    continue
                self._mark(order)
                unmark_on_fail = True
            try:
                self._traced_emit(order, tid, t0)
            except (RuntimeError, ConnectionError, OSError) as e:
                if unmark_on_fail:
                    self._unmark(order)
                resp.code = (
                    CODE_RETRYABLE
                    if isinstance(e, (ConnectionError, OSError))
                    else CODE_REJECT
                )
                resp.message = f"batch aborted at entry {i}: {e}"
                break
            accepted += 1
            PLACEMENT.note_admit(order.symbol)  # disabled: one attr check
        resp.accepted = accepted
        if accepted:
            HOSTPROF.note_admit(accepted)  # one locked add per batch
        return resp

    # -- columnar admit core (round 11) ----------------------------------
    #
    # The scalar loop above pays per-order python (order_build + per-order
    # JSON encode + per-order queue put) on every accepted order. The
    # columnar core touches each proto field
    # exactly once into numpy columns, validates with array masks, interns
    # symbols/uuids once per batch, bulk-marks the pre-pool, and hands the
    # batcher one GCO4 wire block — zero per-order python on the accept
    # path. Per-row semantics (reject codes, messages, precedence, pool
    # contents, decoded frame rows) are identical to the scalar loop:
    # every row the masks cannot *prove* accepted-with-identical-ticks is
    # re-run through the scalar validators, so reject messages come from
    # the same code and float->tick edge cases cannot diverge.

    def _recheck_rows(
        self, reqs, cancel, flagged, ok, price, volume, resp, base
    ):
        """Re-run flagged rows through the scalar validators: definite
        rejects get their byte-identical per-row status here; suspect rows
        (scale overflow range) are patched with fixed.scale's authoritative
        ticks or rejected. Rare path — flagged rows are malformed input or
        >2**51-tick magnitudes."""
        for i in np.nonzero(flagged)[0].tolist():
            try:
                if cancel[i]:
                    order = order_from_request(
                        reqs[i], Action.DEL, self._accuracy
                    )
                else:
                    order = self._validate_add(reqs[i])
                if (
                    abs(order.price) >= 1 << 63
                    or abs(order.volume) >= 1 << 63
                ):
                    # The scalar path admits arbitrary-precision ticks and
                    # would only crash later at struct.pack in the encoder;
                    # the columnar wire is honest about its i64 columns and
                    # rejects at the edge (MIGRATION.md round 11).
                    raise ValueError(
                        "scaled value exceeds the 64-bit wire range"
                    )
                price[i] = order.price
                volume[i] = order.volume
                ok[i] = True
            except ValueError as e:
                ok[i] = False
                resp.reject_index.append(base + i)
                resp.rejects.add(code=3, message=f"rejected: {e}")
        return ok

    def _mark_cols(self, cols: dict) -> None:
        if self._mark_frame is not None:
            self._mark_frame(cols)
            return
        for order in orders_from_columns(cols):
            if order.action is Action.ADD:
                self._mark(order)

    def _unmark_cols(self, cols: dict) -> None:
        if self._unmark_frame is not None:
            self._unmark_frame(cols)
            return
        for order in orders_from_columns(cols):
            if order.action is Action.ADD:
                self._unmark(order)

    def _emit_cols(self, cols: dict, m: int) -> None:  # gomelint: hotpath
        FAULTS.fire("gateway.emit")  # same point as the scalar funnel
        block = encode_order_block(
            m,
            cols["action"],
            cols["side"],
            cols["kind"],
            cols["price"],
            cols["volume"],
            cols["symbols"],
            cols["symbol_idx"],
            cols["uuids"],
            cols["uuid_idx"],
            cols["oids"],
        )
        if self._batcher is not None:
            self._batcher.submit_block(block, m)
        else:
            self._bus.order_queue.publish(
                encode_order_frame_blocks([block])
            )

    def _apply_columnar(
        self, reqs: list, cancel: np.ndarray, resp, base: int = 0
    ) -> int:  # gomelint: hotpath
        """Array-native admission of one batch: validates + interns +
        marks + emits the accepted rows as ONE wire block, appending
        per-row rejects to resp. Returns accepted count. Emission is
        all-or-nothing per block: on emit failure every mark is undone,
        zero rows are accepted, and resp carries the scalar loop's abort
        code/message anchored at the block's first accepted entry."""
        n = len(reqs)
        if n == 0:
            return 0
        # One pass over the cached proto wrappers per numeric field —
        # the caller materialized the repeated field ONCE (upb builds a
        # fresh wrapper per iteration, so repeated passes over the proto
        # itself would triple the extraction cost). Field access is the
        # irreducible protobuf cost.
        trans = np.fromiter(map(_GET_TRANSACTION, reqs), np.int64, n)
        kind = np.fromiter(map(_GET_KIND, reqs), np.int64, n)
        price_f = np.fromiter(map(_GET_PRICE, reqs), np.float64, n)
        vol_f = np.fromiter(map(_GET_VOLUME, reqs), np.float64, n)
        price, price_ok, price_sus = _vector_scale(price_f, self._accuracy)
        volume, vol_ok, vol_sus = _vector_scale(vol_f, self._accuracy)
        ok = (
            (trans >= 0) & (trans <= 1)
            & (kind >= 0) & (kind <= 1)
            & price_ok & vol_ok
        )
        add_ok = volume > 0
        if self._max_volume is not None:
            add_ok &= volume <= self._max_volume
        # MARKET adds skip the price check, like _validate_add.
        add_ok &= (kind != 0) | (price > 0)
        ok &= cancel | add_ok  # cancels skip the ADD-only checks
        flagged = ~ok | price_sus | vol_sus
        if flagged.any():
            ok = self._recheck_rows(
                reqs, cancel, flagged, ok, price, volume, resp, base
            )
        m = int(ok.sum())
        if m == 0:
            return 0
        if m == n:
            keep = None
            sym_src = list(map(_GET_SYMBOL, reqs))
            uid_src = list(map(_GET_UUID, reqs))
            oid_src = list(map(_GET_OID, reqs))
            sel = slice(None)
        else:
            keep = np.nonzero(ok)[0]
            rows = list(map(reqs.__getitem__, keep.tolist()))
            sym_src = list(map(_GET_SYMBOL, rows))
            uid_src = list(map(_GET_UUID, rows))
            oid_src = list(map(_GET_OID, rows))
            sel = keep
        symbols, symbol_idx = _intern(sym_src)
        uuids, uuid_idx = _intern(uid_src)
        try:
            oids = np.asarray(oid_src, dtype="S")
        except UnicodeEncodeError:
            oids = np.asarray([s.encode() for s in oid_src])
        if oids.dtype.itemsize == 0:  # all-empty oid column
            oids = oids.astype("S1")
        cols = {
            "n": m,
            "action": np.where(
                cancel[sel], np.uint8(Action.DEL), np.uint8(Action.ADD)
            ),
            "side": trans[sel].astype(np.uint8),
            "kind": kind[sel].astype(np.uint8),
            "price": price[sel],
            "volume": volume[sel],
            "symbols": symbols,
            "symbol_idx": symbol_idx,
            "uuids": uuids,
            "uuid_idx": uuid_idx,
            "oids": oids,
        }
        self._mark_cols(cols)  # pre-pool before queueing (main.go:44-45)
        try:
            self._emit_cols(cols, m)
        except (RuntimeError, ConnectionError, OSError) as e:
            self._unmark_cols(cols)
            resp.code = (
                CODE_RETRYABLE
                if isinstance(e, (ConnectionError, OSError))
                else CODE_REJECT
            )
            first = base if keep is None else base + int(keep[0])
            resp.message = f"batch aborted at entry {first}: {e}"
            return 0
        HOSTPROF.note_admit(m)  # one locked add per block
        # Symbol-flow sketch (obs.placement): the armed hook bincounts
        # the already-interned columns; disabled it is one attr check.
        PLACEMENT.note_admit_frame(cols["symbols"], cols["symbol_idx"])
        return m

    def DoOrderBatch(
        self, request: pb.OrderBatchRequest, context
    ) -> pb.OrderBatchResponse:
        """Amortized ingest: many reference-shaped OrderRequests in one
        RPC, applied in list order (same-batch ADD->DEL sequencing is
        preserved; `cancel[i]` selects DeleteOrder semantics)."""
        n = len(request.orders)
        if request.cancel and len(request.cancel) != n:
            return pb.OrderBatchResponse(
                code=3,
                message=(
                    f"cancel mask length {len(request.cancel)} != "
                    f"orders length {n}"
                ),
            )
        if self._admission is not None and n:
            # One verdict for the whole batch (all-or-nothing shed:
            # accepted=0, the client resubmits after the hint — the same
            # remainder contract as a batch abort at entry 0).
            d = self._admission.admit(n, _time_remaining(context))
            if not d.ok:
                return pb.OrderBatchResponse(
                    code=CODE_RETRYABLE, message=d.message()
                )
        if self._columnar and not TRACER.enabled and n:
            # Array-native core; per-order trace journeys need the scalar
            # loop (each entry gets its own trace id + wire context).
            resp = pb.OrderBatchResponse()
            if request.cancel:
                cancel = np.fromiter(request.cancel, np.bool_, n)
            else:
                cancel = np.zeros(n, np.bool_)
            resp.accepted = self._apply_columnar(
                list(request.orders), cancel, resp
            )
            return resp
        cancels = request.cancel or (False,) * n
        return self._apply_entries(zip(request.orders, cancels))

    def DoOrderStream(
        self, request_iterator, context
    ) -> pb.OrderBatchResponse:
        """Client-streaming ingest: ADD semantics per message (cancels go
        through DeleteOrder / DoOrderBatch); one summary response when
        the client half-closes."""
        if not (self._columnar and not TRACER.enabled):
            return self._apply_entries(
                (request, False) for request in request_iterator
            )
        # Columnar in STREAM_CHUNK windows: rejects stay per-row with
        # absolute indices; an emit failure aborts the stream with
        # accepted = rows admitted by earlier chunks (the scalar loop's
        # at-most-once remainder contract, at chunk granularity).
        resp = pb.OrderBatchResponse()
        accepted = 0
        base = 0
        chunk: list = []
        for request in request_iterator:
            chunk.append(request)
            if len(chunk) >= STREAM_CHUNK:
                if not self._admit_stream_chunk(resp, len(chunk), context):
                    resp.accepted = accepted
                    return resp
                accepted += self._apply_columnar(
                    chunk, np.zeros(len(chunk), np.bool_), resp, base=base
                )
                if resp.code:
                    resp.accepted = accepted
                    return resp
                base += len(chunk)
                chunk = []
        if chunk:
            if not self._admit_stream_chunk(resp, len(chunk), context):
                resp.accepted = accepted
                return resp
            accepted += self._apply_columnar(
                chunk, np.zeros(len(chunk), np.bool_), resp, base=base
            )
        resp.accepted = accepted
        return resp

    def _admit_stream_chunk(self, resp, n: int, context) -> bool:
        """Admission verdict per stream chunk — a shed aborts the stream
        with the retryable status and accepted = rows admitted by the
        chunks that made it (the established remainder contract)."""
        if self._admission is None:
            return True
        d = self._admission.admit(n, _time_remaining(context))
        if d.ok:
            return True
        resp.code = CODE_RETRYABLE
        resp.message = d.message()
        return False

    def SubscribeMatches(self, request: pb.SubscribeRequest, context):
        if self._match_feed is None:
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED, "no match feed attached"
            )
        yield from self._match_feed.subscribe(context)


def serve_gateway(
    gateway: OrderGateway, config: Config, max_workers: int = 16
) -> grpc.Server:
    """Build + start the gRPC server (main.go:28-36 / grpc.go:24-39's
    listener-from-config). Returns the started server; caller owns
    shutdown."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    add_order_servicer(server, gateway)
    # Server reflection, like the reference (main.go:33) — grpcurl works.
    from ..api.reflection import add_reflection_servicer

    add_reflection_servicer(server)
    addr = f"{config.grpc.host}:{config.grpc.port}"
    bound = server.add_insecure_port(addr)
    if bound == 0:
        raise RuntimeError(f"failed to bind gRPC listener on {addr}")
    # Port-0 callers (tests, the fleet drill's subprocess workers) need
    # the OS-assigned port; grpc.Server has no accessor for it.
    server.bound_port = bound
    server.start()
    log.info("gateway serving on %s:%d", config.grpc.host, bound)
    return server
