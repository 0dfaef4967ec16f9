"""The port's gateway admit core and frame batcher (gome_tpu_torch.service.
gateway / batcher) on the CPU against gome_tpu's: the flows of
tests/test_colgateway.py and test_service.py's FrameBatcher cases, run on
both packages with the same requests. Responses are byte-equal
(SerializeToString), pre-pools equal, and the doOrder bodies each
gateway publishes byte-equal — on the columnar core and on the scalar
loop, for seeded mixed batches, streams, the cancel-mask length reject,
the closed-batcher and degraded-bus aborts, the i64 wire-range reject, and
the batcher's flush order."""

from __future__ import annotations

import time

import numpy as np
import pytest

import gome_tpu.bus as jbus
import gome_tpu.engine.prepool as jprepool
import gome_tpu.service.admission as jadmission
import gome_tpu.service.batcher as jbatcher
import gome_tpu.service.gateway as jgateway
import gome_tpu_torch.bus as tbus
import gome_tpu_torch.engine.prepool as tprepool
import gome_tpu_torch.service.admission as tadmission
import gome_tpu_torch.service.batcher as tbatcher
import gome_tpu_torch.service.gateway as tgateway
from gome_tpu.api import order_pb2 as jpb
from gome_tpu.utils.metrics import Registry as JRegistry
from gome_tpu_torch.api import order_pb2 as tpb
from gome_tpu_torch.utils.metrics import Registry as TRegistry
from gome_tpu_torch.bus.colwire import decode_order_frame
from test_colgateway import FIXTURE, _FailingQueue, _req, _seeded_batches
from test_torch_bus import plain, port_order
from test_torch_service_parts import no_tracer  # noqa: F401 (autouse)

J, T = "gome_tpu", "port"
PKG = {
    J: dict(bus=jbus, prepool=jprepool, batcher=jbatcher, gateway=jgateway,
            admission=jadmission, registry=JRegistry, pb=jpb,
            order=lambda o: o),
    T: dict(bus=tbus, prepool=tprepool, batcher=tbatcher, gateway=tgateway,
            admission=tadmission, registry=TRegistry, pb=tpb,
            order=port_order),
}


def make_gateway(side, columnar, queue=None, batcher=None, max_volume=None):
    p = PKG[side]
    queue = queue if queue is not None else p["bus"].MemoryQueue("doOrder")
    bus = p["bus"].QueueBus(queue, p["bus"].MemoryQueue("matchOrder"))
    pool = p["prepool"].LocalPrePool()
    gw = p["gateway"].OrderGateway(
        bus,
        accuracy=8,
        mark=lambda o: pool.add((o.symbol, o.uuid, o.oid)),
        unmark=lambda o: pool.discard((o.symbol, o.uuid, o.oid)),
        mark_frame=pool.mark_frame if columnar else None,
        unmark_frame=pool.unmark_frame if columnar else None,
        max_volume=max_volume,
        batcher=batcher,
        columnar=columnar,
    )
    return gw, pool, bus


def bodies(bus):
    return [m.body for m in bus.order_queue.read_from(0, 10_000)]


def wire(resp):
    return resp.SerializeToString()


def run_batches(side, columnar, batches, **kw):
    gw, pool, bus = make_gateway(side, columnar, **kw)
    resps = [wire(gw.DoOrderBatch(
        PKG[side]["pb"].OrderBatchRequest(orders=reqs, cancel=cancel), None))
        for reqs, cancel in batches]
    return resps, set(pool), bodies(bus)


@pytest.mark.parametrize("columnar", [True, False])
def test_seeded_mixed_batches_match(columnar):
    batches = _seeded_batches(seed=1234, n_batches=6, rows=80)
    j = run_batches(J, columnar, batches, max_volume=10**12)
    t = run_batches(T, columnar, batches, max_volume=10**12)
    assert t == j
    resps = [jpb.OrderBatchResponse.FromString(r) for r in t[0]]
    assert sum(len(r.reject_index) for r in resps) > 50
    assert sum(r.accepted for r in resps) > 200


def test_columnar_and_scalar_publish_the_same_orders():
    """The port's two admit paths against each other: equal responses and
    pools, and the same decoded orders on the wire (GCO4 frames from the
    columnar core, JSON documents from the scalar loop)."""
    from gome_tpu_torch.bus.codec import decode_order
    from gome_tpu_torch.service.gateway import orders_from_columns

    batches = _seeded_batches(seed=99, n_batches=3, rows=60)
    c = run_batches(T, True, batches, max_volume=10**12)
    s = run_batches(T, False, batches, max_volume=10**12)
    assert c[:2] == s[:2]

    def decoded(bs):
        out = []
        for b in bs:
            out.extend(orders_from_columns(decode_order_frame(b))
                       if b[:1] == b"G" else [decode_order(b)])
        return out

    assert decoded(c[2]) == decoded(s[2])


def test_all_clean_batch_matches():
    reqs = [_req(f"u{i % 3}", f"o{i}", "s", i % 2, 1.25 + i, 2.0)
            for i in range(32)]
    out = {side: run_batches(side, True, [(reqs, [])]) for side in (J, T)}
    assert out[T] == out[J]
    assert len(out[T][1]) == 32


@pytest.mark.parametrize("columnar", [True, False])
def test_stream_matches(columnar):
    reqs = []
    for batch, _cancel in _seeded_batches(seed=77, n_batches=3, rows=50):
        reqs.extend(batch)
    out = {}
    for side in (J, T):
        gw, pool, bus = make_gateway(side, columnar, max_volume=10**12)
        out[side] = (wire(gw.DoOrderStream(iter(reqs), None)), set(pool),
                     bodies(bus))
    assert out[T] == out[J]


def test_stream_chunks_keep_absolute_reject_indices(monkeypatch):
    """DoOrderStream's columnar windows (STREAM_CHUNK) at a small chunk:
    reject indices stay absolute, bodies stay byte-equal."""
    reqs = []
    for batch, _cancel in _seeded_batches(seed=5, n_batches=2, rows=40):
        reqs.extend(batch)
    out = {}
    for side in (J, T):
        monkeypatch.setattr(PKG[side]["gateway"], "STREAM_CHUNK", 16)
        gw, pool, bus = make_gateway(side, True, max_volume=10**12)
        out[side] = (wire(gw.DoOrderStream(iter(reqs), None)), set(pool),
                     bodies(bus))
    assert out[T] == out[J]
    assert len(out[T][2]) > 2  # several chunks, one frame each


@pytest.mark.parametrize("columnar", [True, False])
def test_cancel_mask_length_reject_matches(columnar):
    out = {}
    for side in (J, T):
        gw, pool, bus = make_gateway(side, columnar)
        resp = gw.DoOrderBatch(PKG[side]["pb"].OrderBatchRequest(
            orders=[_req("u", "o", "s", 0, 1.0, 1.0)], cancel=[False, True]),
            None)
        out[side] = (wire(resp), set(pool), bodies(bus))
    assert out[T] == out[J]
    resp = tpb.OrderBatchResponse.FromString(out[T][0])
    assert resp.code == 3 and "cancel mask length 2 != orders length 1" in \
        resp.message


ABORT_ROWS = [_req("u1", "bad", "s", 7, 1.0, 1.0), _req("u1", "a", "s", 0,
              1.0, 1.0), _req("u2", "b", "s", 1, 1.0, 2.0)]


@pytest.mark.parametrize("columnar", [True, False])
def test_closed_batcher_abort_matches(columnar):
    out = {}
    for side in (J, T):
        p = PKG[side]
        batcher = p["batcher"].FrameBatcher(p["bus"].MemoryQueue("doOrder"),
                                            max_n=64, max_wait_s=60)
        batcher.close()
        gw, pool, _bus = make_gateway(side, columnar, batcher=batcher)
        resp = gw.DoOrderBatch(p["pb"].OrderBatchRequest(orders=ABORT_ROWS),
                               None)
        out[side] = (wire(resp), set(pool))
    assert out[T] == out[J]
    resp = tpb.OrderBatchResponse.FromString(out[T][0])
    assert resp.code == 3 and resp.accepted == 0
    assert "batch aborted at entry 1: FrameBatcher is closed" in resp.message
    assert out[T][1] == set()


@pytest.mark.parametrize("columnar", [True, False])
def test_degraded_bus_abort_matches(columnar):
    out = {}
    for side in (J, T):
        gw, pool, _bus = make_gateway(side, columnar, queue=_FailingQueue())
        resp = gw.DoOrderBatch(PKG[side]["pb"].OrderBatchRequest(
            orders=ABORT_ROWS[1:]), None)
        out[side] = (wire(resp), set(pool))
    assert out[T] == out[J]
    resp = tpb.OrderBatchResponse.FromString(out[T][0])
    assert resp.code == 14 and resp.accepted == 0
    assert "batch aborted at entry 0: broker down" in resp.message


def test_unary_degraded_and_closed_match():
    """DoOrder / DeleteOrder on a failing bus (retryable 14, mark undone)
    and on a closed batcher (reject 3)."""
    out = {}
    for side in (J, T):
        p = PKG[side]
        gw, pool, _ = make_gateway(side, True, queue=_FailingQueue())
        closed = p["batcher"].FrameBatcher(p["bus"].MemoryQueue("doOrder"),
                                           max_n=8, max_wait_s=60)
        closed.close()
        gw2, pool2, _ = make_gateway(side, True, batcher=closed)
        req = _req("u", "o", "s", 0, 1.0, 1.0)
        out[side] = ([wire(g.DoOrder(req, None)) for g in (gw, gw2)]
                     + [wire(g.DeleteOrder(req, None)) for g in (gw, gw2)],
                     set(pool), set(pool2))
    assert out[T] == out[J]
    codes = [tpb.OrderResponse.FromString(r).code for r in out[T][0]]
    assert codes == [14, 3, 14, 3]


def test_rejects_beyond_i64_wire_range_match():
    out = {}
    for side in (J, T):
        gw, pool, bus = make_gateway(side, True)
        resp = gw.DoOrderBatch(PKG[side]["pb"].OrderBatchRequest(
            orders=[_req("u", "o", "s", 0, 1e15, 1.0),
                    _req("u", "p", "s", 0, 1.0, 2e11)]), None)
        out[side] = (wire(resp), set(pool), bodies(bus))
    assert out[T] == out[J]
    resp = tpb.OrderBatchResponse.FromString(out[T][0])
    assert list(resp.reject_index) == [0, 1]
    assert "64-bit wire range" in resp.rejects[0].message
    assert out[T][1] == set() and out[T][2] == []


def test_admission_shed_matches():
    """A gateway with an AdmissionController at its ceiling sheds every RPC
    kind with the retryable status and the same retry-after message."""
    out = {}
    for side in (J, T):
        p = PKG[side]
        reg = p["registry"]()
        ctl = p["admission"].AdmissionController(lambda: 1000, max_depth=100,
                                                 registry=reg)
        gw, pool, bus = make_gateway(side, True)
        gw._admission = ctl
        req = _req("u", "o", "s", 0, 1.0, 1.0)
        out[side] = ([wire(gw.DoOrder(req, None)),
                      wire(gw.DeleteOrder(req, None)),
                      wire(gw.DoOrderBatch(p["pb"].OrderBatchRequest(
                          orders=[req, req]), None)),
                      wire(gw.DoOrderStream(iter([req]), None))],
                     set(pool), bodies(bus), reg.render())
    assert out[T] == out[J]
    assert [tpb.OrderResponse.FromString(r).code for r in out[T][0][:2]] \
        == [14, 14]
    assert [tpb.OrderBatchResponse.FromString(r).code
            for r in out[T][0][2:]] == [14, 14]
    assert out[T][1:3] == (set(), [])


# -- FrameBatcher ----------------------------------------------------------------

def fixture_orders(side, orders):
    return [PKG[side]["order"](o) for o in orders]


def block_of(side, orders):
    frame = PKG[side]["bus"].colwire.encode_orders(fixture_orders(side,
                                                                  orders))
    return frame[4:], len(orders)


def queue_bodies(q):
    return [m.body for m in q.read_from(0, 100)]


def test_size_bound_flush_and_remainder_match():
    out = {}
    for side in (J, T):
        p = PKG[side]
        q = p["bus"].MemoryQueue("doOrder")
        b = p["batcher"].FrameBatcher(q, max_n=16, max_wait_s=60)
        for o in fixture_orders(side, FIXTURE[:40]):
            b.submit(o)
        flushed = queue_bodies(q)
        n = b.flush()
        b.close()
        out[side] = (flushed, n, queue_bodies(q))
    assert out[T] == out[J]
    flushed, n, final = out[T]
    assert len(flushed) == 2 and n == 8 and len(final) == 3
    assert [o.decode() for o in decode_order_frame(final[0])["oids"]] == [
        f"o-{i}" for i in range(16)]


def test_deadline_flush_and_close_match():
    out = {}
    for side in (J, T):
        p = PKG[side]
        q = p["bus"].MemoryQueue("doOrder")
        b = p["batcher"].FrameBatcher(q, max_n=1 << 20, max_wait_s=0.05)
        try:
            for o in fixture_orders(side, FIXTURE[:5]):
                b.submit(o)
            deadline = time.monotonic() + 5
            while q.end_offset() == 0:
                assert time.monotonic() < deadline, "deadline never flushed"
                time.sleep(0.01)
        finally:
            b.close()
        q2 = p["bus"].MemoryQueue("doOrder")
        b2 = p["batcher"].FrameBatcher(q2, max_n=100, max_wait_s=60)
        for o in fixture_orders(side, FIXTURE[5:12]):
            b2.submit(o)
        b2.close()
        out[side] = (queue_bodies(q), queue_bodies(q2))
    assert out[T] == out[J]
    assert decode_order_frame(out[T][0][0])["n"] == 5
    assert len(out[T][1]) == 1


def test_submit_block_closed_and_backpressure_match():
    out = {}
    for side in (J, T):
        p = PKG[side]
        closed = p["batcher"].FrameBatcher(p["bus"].MemoryQueue("doOrder"),
                                           max_n=64, max_wait_s=60)
        closed.close()
        errors = []
        block, n = block_of(side, FIXTURE[:3])
        try:
            closed.submit_block(block, n)
        except RuntimeError as e:
            errors.append((type(e).__name__, str(e)))
        spill = p["batcher"].FrameBatcher(
            _FailingQueue(), max_n=1000, max_wait_s=60, spill_max_frames=1,
            retry_interval_s=60)
        try:
            spill.submit(fixture_orders(side, FIXTURE[:1])[0])
            spill.flush()
            stats = spill.stats()
            for call in (lambda: spill.submit_block(*block_of(
                    side, FIXTURE[:2])),
                    lambda: spill.submit(fixture_orders(side,
                                                        FIXTURE[1:2])[0])):
                try:
                    call()
                except ConnectionError as e:
                    errors.append((type(e).__name__, str(e)))
        finally:
            spill.close()
        out[side] = (errors, stats["spill_depth"], stats["degraded"])
    assert out[T] == out[J]
    assert [e[0] for e in out[T][0]] == ["RuntimeError", "Backpressure",
                                         "Backpressure"]
    assert out[T][1:] == (1, True)


def test_mixed_buffer_and_block_joins_match():
    out = {}
    for side in (J, T):
        p = PKG[side]
        q = p["bus"].MemoryQueue("doOrder")
        b = p["batcher"].FrameBatcher(q, max_n=10_000, max_wait_s=60)
        a1, a2, a3 = fixture_orders(side, FIXTURE[:3])
        b.submit(a1)
        b.submit(a2)
        b.submit_block(*block_of(side, FIXTURE[8:11]))
        buffered = b.stats()["buffered"]
        b.submit(a3)
        b.submit_block(*block_of(side, FIXTURE[11:13]))
        n = b.flush()
        b.submit_block(*block_of(side, FIXTURE[20:25]))
        b.submit_block(*block_of(side, FIXTURE[25:27]))
        b.flush()
        q2 = p["bus"].MemoryQueue("doOrder")
        b2 = p["batcher"].FrameBatcher(q2, max_n=4, max_wait_s=60)
        b2.submit_block(*block_of(side, FIXTURE[:5]))
        tripped = (queue_bodies(q2), b2.stats()["buffered"])
        b.close()
        b2.close()
        out[side] = (buffered, n, queue_bodies(q), tripped)
    assert out[T] == out[J]
    buffered, n, frames, (tripped, left) = out[T]
    assert (buffered, n) == (5, 8)
    assert [f[:4] for f in frames] == [b"GCO2", b"GCO4", b"GCO2", b"GCO4",
                                       b"GCO4"]
    assert len(tripped) == 1 and left == 0
    from gome_tpu_torch.service.gateway import orders_from_columns

    got = []
    for f in frames[:4]:
        got.extend(orders_from_columns(decode_order_frame(f)))
    want = fixture_orders(T, FIXTURE[:2] + FIXTURE[8:11] + FIXTURE[2:3]
                          + FIXTURE[11:13])
    assert plain(got) == plain(want)


def test_vector_scale_matches():
    rng = np.random.default_rng(3)
    values = np.concatenate([
        rng.integers(-10**6, 10**6, 200) / 100.0,
        rng.random(50), np.array([1.000000001, 0.1 + 0.2, 2.0**52, -0.0,
                                  np.inf, np.nan, 1e300, 5e-9]),
    ])
    for acc in (0, 2, 8, 12):
        j = jgateway._vector_scale(values, acc)
        t = tgateway._vector_scale(values, acc)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)
