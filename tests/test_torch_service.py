"""The port's EngineService end to end on the CPU against gome_tpu's: gRPC
gateway on 127.0.0.1 port 0 -> doOrder -> consumer -> engine -> matchOrder
-> feed -> SubscribeMatches, the flows of tests/test_service.py and a
seeded DoOrderBatch / DoOrderStream mix run on both packages. RPC
responses, matchOrder bodies and SubscribeMatches events are byte-equal;
each package's stub drives the other's server; the reflection answers are
the same; the threaded service (start/stop) streams the same events; and
`python -m gome_tpu_torch.clients.doorder` / `.delorder` drive the port's
server from a subprocess."""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import grpc
import pytest

import gome_tpu.api.reflection as jreflection
import gome_tpu.config as jconfig
import gome_tpu.service.gateway as jgateway
import gome_tpu_torch.api.reflection as treflection
import gome_tpu_torch.config as tconfig
import gome_tpu_torch.service.gateway as tgateway
from gome_tpu.api import order_pb2 as pb
from gome_tpu.api.service import OrderStub as JStub
from gome_tpu.bus import encode_order
from gome_tpu.service.app import EngineService as JService
from gome_tpu.utils.streams import mixed_stream
from gome_tpu_torch.api.service import OrderStub as TStub
from gome_tpu_torch.service.app import EngineService as TService
from test_colgateway import _seeded_batches
from test_pipeline import _oracle_lines
from test_torch_bus import port_order
from test_torch_service_parts import (  # noqa: F401 (autouse)
    limited, no_tracer, time_limit)

J, T = "gome_tpu", "port"
SIDES = {
    J: dict(config=jconfig, service=JService, serve=jgateway.serve_gateway,
            stub=JStub, reflection=jreflection, order=lambda o: o),
    T: dict(config=tconfig, service=TService, serve=tgateway.serve_gateway,
            stub=TStub, reflection=treflection, order=port_order),
}
RPC_S = 30  # per-call gRPC deadline


def make_service(side, **config_kw):
    c = SIDES[side]["config"]
    cfg = c.Config(grpc=c.GrpcConfig(host="127.0.0.1", port=0),
                   engine=c.EngineConfig(cap=32, n_slots=8, max_t=8),
                   **config_kw)
    kw = dict(device="cpu") if side == T else {}
    return SIDES[side]["service"](cfg, **kw)


@contextlib.contextmanager
def served(server_side, stub_side=None):
    """(service, stub): a service of one package behind its own
    serve_gateway (reflection included), and a stub of either package."""
    svc = make_service(server_side)
    server = SIDES[server_side]["serve"](svc.gateway, svc.config)
    channel = grpc.insecure_channel(f"127.0.0.1:{server.bound_port}")
    try:
        yield svc, SIDES[stub_side or server_side]["stub"](channel)
    finally:
        channel.close()
        server.stop(grace=None)


class Subscriber:
    """A SubscribeMatches stream, opened and registered with the feed
    before anything is sent."""

    def __init__(self, svc, stub):
        self.call = stub.SubscribeMatches(pb.SubscribeRequest(),
                                          timeout=RPC_S)
        self.it = iter(self.call)
        deadline = time.monotonic() + 10
        while not svc.feed._subs:
            assert time.monotonic() < deadline, "subscriber never registered"
            time.sleep(0.005)

    def take(self, n):
        return [next(self.it).SerializeToString() for _ in range(n)]

    def close(self):
        self.call.cancel()


def req(uuid, oid, side, price, volume, kind=0, symbol="eth2usdt"):
    return pb.OrderRequest(uuid=uuid, oid=oid, symbol=symbol,
                           transaction=side, price=price, volume=volume,
                           kind=kind)


def match_bodies(svc):
    mq = svc.bus.match_queue
    return [m.body for m in mq.read_from(0, mq.end_offset())]


def wire(resp):
    return resp.SerializeToString()


# -- the flows: each returns what the client and the match queue saw -----------

def flow_submit_match_cancel(svc, stub):
    out = [wire(stub.DoOrder(req("u1", "a1", pb.SALE, 1.00, 5.0),
                             timeout=RPC_S)),
           wire(stub.DoOrder(req("u2", "b1", pb.BUY, 1.00, 3.0),
                             timeout=RPC_S))]
    out.append(svc.pump())
    out.append(wire(stub.DeleteOrder(req("u1", "a1", pb.SALE, 1.00, 5.0),
                                     timeout=RPC_S)))
    out.append(svc.pump())
    return out


def flow_rejects(svc, stub):
    out = [wire(stub.DoOrder(r, timeout=RPC_S)) for r in (
        req("u", "x", pb.BUY, 1.0, 0.0), req("u", "x2", pb.BUY, 0.0, 1.0),
        req("u", "x3", pb.BUY, 1.000000001, 1.0),
        req("u", "x4", 7, 1.0, 1.0))]
    out.append(svc.pump())
    return out


def flow_market(svc, stub):
    out = [wire(stub.DoOrder(req("m1", "s1", pb.SALE, 1.00, 5.0),
                             timeout=RPC_S)),
           wire(stub.DoOrder(req("m2", "t1", pb.BUY, 0.0, 2.0,
                                 kind=pb.MARKET), timeout=RPC_S))]
    out.append(svc.pump())
    return out


def flow_cancel_race(svc, stub):
    out = [wire(stub.DoOrder(req("u1", "r1", pb.SALE, 1.00, 5.0),
                             timeout=RPC_S)),
           wire(stub.DeleteOrder(req("u1", "r1", pb.SALE, 1.00, 5.0),
                                 timeout=RPC_S))]
    out.append(svc.pump())
    books = svc.engine.batch.lane_books()
    out.append(int(books.count.sum()))
    return out


def flow_seeded_mix(svc, stub):
    """Seeded DoOrderBatch requests (rejects, cancels, suspect ranges)
    with their cancel masks, a DoOrderStream, and unary calls between."""
    out = []
    batches = _seeded_batches(seed=1234, n_batches=3, rows=40)
    for i, (reqs, cancel) in enumerate(batches):
        out.append(wire(stub.DoOrderBatch(
            pb.OrderBatchRequest(orders=reqs, cancel=cancel),
            timeout=RPC_S)))
        out.append(wire(stub.DoOrder(req("ux", f"x{i}", i % 2, 26.0, 3.0,
                                         symbol="s1"), timeout=RPC_S)))
        out.append(svc.pump())
    stream = _seeded_batches(seed=7, n_batches=1, rows=30)[0][0]
    out.append(wire(stub.DoOrderStream(iter(stream), timeout=RPC_S)))
    out.append(wire(stub.DeleteOrder(req("ux", "x1", 1, 26.0, 3.0,
                                         symbol="s1"), timeout=RPC_S)))
    out.append(svc.pump())
    return out


FLOWS = {f.__name__[5:]: f for f in (flow_submit_match_cancel, flow_rejects,
                                     flow_market, flow_cancel_race,
                                     flow_seeded_mix)}


def run_flow(flow, server_side, stub_side=None):
    with served(server_side, stub_side) as (svc, stub):
        sub = Subscriber(svc, stub)
        try:
            out = flow(svc, stub)
            bodies = match_bodies(svc)
            events = sub.take(len(bodies))
        finally:
            sub.close()
        if server_side == T:
            svc.engine.batch.verify_books()
        return dict(out=out, bodies=bodies, events=events,
                    pool=set(svc.engine.pre_pool),
                    orders=svc.engine.stats.orders)


@pytest.mark.parametrize("name", list(FLOWS))
@limited(120)
def test_flow_matches(name):
    got = {side: run_flow(FLOWS[name], side) for side in (J, T)}
    assert got[T] == got[J]
    if name in ("submit_match_cancel", "market", "seeded_mix"):
        assert got[T]["events"]
    if name == "rejects":
        assert not got[T]["bodies"]
    if name == "seeded_mix":
        assert len(got[T]["bodies"]) > 20


@limited(120)
def test_cross_wire():
    """The reference's OrderStub against the port's server and the port's
    stub against the reference's: the same responses, bodies and streams
    as each package's own pair."""
    flow = FLOWS["seeded_mix"]
    same = {side: run_flow(flow, side) for side in (J, T)}
    assert run_flow(flow, T, stub_side=J) == same[T]
    assert run_flow(flow, J, stub_side=T) == same[J]
    assert same[T] == same[J]


@limited(120)
def test_service_parity_vs_oracle():
    """The mixed stream published straight to doOrder (the gateway's work
    done by hand): both packages' match queues equal the oracle's lines."""
    orders = mixed_stream(n=300, seed=11, cancel_prob=0.25)
    got = {}
    for side in (J, T):
        svc = make_service(side)
        conv = SIDES[side]["order"]
        for o in orders:
            svc.engine.mark(conv(o))
        for o in orders:
            svc.bus.order_queue.publish(encode_order(o))
        svc.pump()
        got[side] = match_bodies(svc)
    assert got[T] == got[J] == _oracle_lines(orders)


def _reflect(channel, request: bytes) -> bytes:
    call = channel.stream_stream(
        f"/{jreflection.REFLECTION_SERVICE}/ServerReflectionInfo",
        request_serializer=None, response_deserializer=None)
    return next(iter(call(iter([request]), timeout=RPC_S)))


@limited(60)
def test_reflection_answers_match():
    f = jreflection._field
    asks = [f(7, b""), f(4, jreflection.SERVICE_NAME.encode()),
            f(3, b"gome_tpu/api/order.proto"), f(4, b"no.such.Service"),
            f(5, b"x")]
    got = {}
    for side in (J, T):
        svc = make_service(side)
        server = SIDES[side]["serve"](svc.gateway, svc.config)
        try:
            with grpc.insecure_channel(
                    f"127.0.0.1:{server.bound_port}") as ch:
                got[side] = [_reflect(ch, a) for a in asks]
        finally:
            server.stop(grace=None)
    assert got[T] == got[J]
    assert treflection.SERVICE_NAME == "gome_tpu.api.Order"
    fields = dict((n, v) for n, _w, v in treflection._parse_fields(got[T][0]))
    names = {v.decode() for n, _w, v in treflection._parse_fields(
        treflection._parse_fields(fields[6])[0][2]) if n == 1}
    assert names == {"gome_tpu.api.Order"}


@limited(120)
def test_started_services_stream_the_same_events():
    """start() (gRPC server, consumer and feed threads), a subscriber, the
    seeded batches over the wire; the stream is byte-equal across the
    packages; stop() ends every thread."""
    batches = _seeded_batches(seed=21, n_batches=3, rows=40)
    got, want = {}, None
    for side in (J, T):
        svc = make_service(side).start()
        try:
            with grpc.insecure_channel(
                    f"127.0.0.1:{svc._server.bound_port}") as ch:
                stub = SIDES[side]["stub"](ch)
                sub = Subscriber(svc, stub)
                resps = [wire(stub.DoOrderBatch(pb.OrderBatchRequest(
                    orders=r, cancel=c), timeout=RPC_S)) for r, c in batches]
                q = svc.bus.order_queue
                deadline = time.monotonic() + 60
                while q.committed() < q.end_offset() or (
                        svc.bus.match_queue.committed()
                        < svc.bus.match_queue.end_offset()):
                    assert time.monotonic() < deadline, "service stalled"
                    time.sleep(0.01)
                n = len(match_bodies(svc)) if want is None else len(want)
                got[side] = (resps, sub.take(n), match_bodies(svc))
                sub.close()
                if want is None:
                    want = got[side][1]
        finally:
            svc.stop()
        assert svc.consumer._thread is None and svc.feed._thread is None
    assert got[T] == got[J]
    assert len(want) > 10


@limited(120)
def test_clients_drive_the_port_server():
    """python -m gome_tpu_torch.clients.doorder / .delorder in
    subprocesses against the started port service, then load_client's
    DoOrderBatch mode in process."""
    from gome_tpu_torch.clients import load_client

    svc = make_service(T).start()
    try:
        target = f"127.0.0.1:{svc._server.bound_port}"
        proc = subprocess.run(
            [sys.executable, "-m", "gome_tpu_torch.clients.doorder", target,
             "300", "4"], capture_output=True, text=True, timeout=90)
        assert proc.returncode == 0, proc.stderr
        stats = json.loads(proc.stdout.strip().splitlines()[-1])
        assert (stats["sent"], stats["ok"], stats["rejected"]) == (299, 299, 0)
        proc = subprocess.run(
            [sys.executable, "-m", "gome_tpu_torch.clients.delorder", target],
            capture_output=True, text=True, timeout=90)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == "code=0 message=cancel accepted"
        with time_limit(60):
            r = load_client(target, n=513, concurrency=4, batch_n=64,
                            symbols=[f"sym{i}" for i in range(5)], seed=3,
                            price_lo=0.5, price_hi=0.6, decimals=2)
        assert (r["sent"], r["ok"], r["rejected"], r["aborted"]) == (
            512, 512, 0, 0)
        q = svc.bus.order_queue
        deadline = time.monotonic() + 60
        while q.committed() < q.end_offset():
            assert time.monotonic() < deadline, "consumer stalled"
            time.sleep(0.01)
        assert svc.engine.stats.orders == 299 + 1 + 512
    finally:
        svc.stop()
