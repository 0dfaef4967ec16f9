"""The port's AMQP 0-9-1 transport (gome_tpu_torch.bus.amqp and
bus.fakebroker) on the CPU against gome_tpu's: the queue contract of
tests/test_amqp.py on every pairing of the two packages' clients and
brokers, the client's send, reader and rpc hardening of
tests/test_advice_fixes.py, the supervised drills of tests/test_reconnect.py
and tests/test_chaos.py, the wire itself (each package's client sends the
same bytes, and each package's broker answers with the same bytes), a
deployment that mixes the packages on one broker, a reference-shaped
config.yaml booting EngineService with and without a broker, and
chip_smoke.py phase 12 (c)'s broker-fault drill at a small size."""

from __future__ import annotations

import socket
import threading
import time

import pytest

import gome_tpu.bus as jbus
import gome_tpu.bus.amqp as jamqp
import gome_tpu.bus.fakebroker as jfake
import gome_tpu_torch.bus as tbus
import gome_tpu_torch.bus.amqp as tamqp
import gome_tpu_torch.bus.fakebroker as tfake
from gome_tpu.types import Action as JAction
from gome_tpu.utils.streams import multi_symbol_stream
from gome_tpu_torch.config import BusConfig, load_config
from gome_tpu_torch.utils.resilience import BackoffPolicy
from test_torch_bus import port_order
from test_torch_service_parts import limited

J, T = "gome_tpu", "port"
AMQP = {J: jamqp, T: tamqp}
BROKER = {J: jfake, T: tfake}
PAIRS = [(c, b) for c in (J, T) for b in (J, T)]
PAIR_IDS = [f"{c}-client-{b}-broker" for c, b in PAIRS]
#: Fast schedule for drills: real reconnects, no test-visible latency.
FAST = BackoffPolicy(base_s=0.005, max_s=0.05, max_retries=60, budget_s=30)


@pytest.fixture
def broker():
    b = tfake.FakeBroker().start()
    yield b
    b.stop()


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def pair(request):
    """(client module, broker) for one pairing of the two packages."""
    client, side = request.param
    b = BROKER[side].FakeBroker().start()
    yield AMQP[client], b
    b.stop()


@pytest.fixture
def queue(pair):
    amqp, b = pair
    q = amqp.AmqpQueue("doOrder", port=b.port)
    yield q
    q.close()


# --- the bus contract (tests/test_amqp.py), every client x broker pairing ----


def test_publish_read_commit(queue):
    offs = [queue.publish(f"m{i}".encode()) for i in range(5)]
    assert offs == [0, 1, 2, 3, 4]
    assert queue.end_offset() == 5
    msgs = queue.read_from(0, 3)
    assert [m.body for m in msgs] == [b"m0", b"m1", b"m2"]
    assert queue.committed() == 0
    queue.commit(3)
    assert queue.committed() == 3
    assert queue.read_from(1, 1)[0].body == b"m1"
    with pytest.raises(ValueError):
        queue.commit(2)  # backwards
    with pytest.raises(ValueError):
        queue.commit(99)  # past end


def test_poll_batch_returns_early_when_full(queue):
    for i in range(4):
        queue.publish(f"m{i}".encode())
    t0 = time.monotonic()
    msgs = queue.poll_batch(4, max_wait_s=5.0)
    assert len(msgs) == 4
    assert time.monotonic() - t0 < 1.0


def test_poll_batch_times_out_partial(queue):
    queue.publish(b"only")
    msgs = queue.poll_batch(8, max_wait_s=0.2)
    assert [m.body for m in msgs] == [b"only"]


def test_poll_batch_wakes_on_publish(queue):
    queue.end_offset()  # start the consume loop first
    t = threading.Timer(0.05, lambda: queue.publish(b"late"))
    t.start()
    msgs = queue.poll_batch(1, max_wait_s=5.0)
    t.join()
    assert [m.body for m in msgs] == [b"late"]


def test_large_bodies_split_into_frames(queue):
    big = bytes(range(256)) * 2048  # 512 KB > frame_max
    queue.publish(big, headers={"x-trace": "t@1"})
    msgs = queue.poll_batch(1, max_wait_s=5.0)
    assert msgs[0].body == big
    assert msgs[0].headers == {"x-trace": "t@1"}


def test_publisher_never_steals_from_consumer(pair):
    """A publish-only AmqpQueue registers no consumer, so it never
    round-robin-steals deliveries from the real consumer."""
    amqp, b = pair
    producer = amqp.AmqpQueue("doOrder", port=b.port)
    consumer = amqp.AmqpQueue("doOrder", port=b.port)
    consumer.end_offset()  # starts consuming
    for i in range(10):
        producer.publish(f"m{i}".encode())
    deadline = time.monotonic() + 5
    while consumer.end_offset() < 10 and time.monotonic() < deadline:
        consumer.poll_batch(10, 0.05)
    msgs = consumer.read_from(0, 10)
    assert [m.body for m in msgs] == [f"m{i}".encode() for i in range(10)]
    producer.close()
    consumer.close()


def test_unacked_redelivery_on_reconnect(pair):
    """Messages consumed but never committed redeliver to the next
    consumer after the connection dies, flagged redelivered."""
    amqp, b = pair
    producer = amqp.AmqpQueue("doOrder", port=b.port)
    c1 = amqp.AmqpQueue("doOrder", port=b.port)
    for i in range(4):
        producer.publish(f"m{i}".encode())
    assert len(c1.poll_batch(4, max_wait_s=5.0)) == 4
    c1.commit(2)  # acks m0, m1; m2, m3 stay unacked
    c1.close()
    c2 = amqp.AmqpQueue("doOrder", port=b.port)
    msgs = c2.poll_batch(2, max_wait_s=5.0)
    assert [(m.offset, m.body) for m in msgs] == [(0, b"m2"), (1, b"m3")]
    assert c2._redelivered == [True, True]
    producer.close()
    c2.close()


# --- make_bus and the reference-shaped config ----------------------------------


def test_make_bus_amqp_with_broker(broker):
    bus = tbus.make_bus(
        BusConfig(backend="amqp", host="127.0.0.1", port=broker.port))
    assert isinstance(bus.order_queue, tamqp.SupervisedAmqpQueue)
    assert bus.order_queue.name == "doOrder"
    assert bus.match_queue.name == "matchOrder"
    bus.order_queue.publish(b"x")
    assert bus.order_queue.poll_batch(1, 5.0)[0].body == b"x"
    bus.order_queue.close()
    bus.match_queue.close()


def test_make_bus_amqp_falls_back_without_broker():
    with pytest.warns(RuntimeWarning, match="falling back"):
        bus = tbus.make_bus(BusConfig(backend="amqp", host="127.0.0.1",
                                      port=1))  # nothing there
    assert isinstance(bus.order_queue, tbus.MemoryQueue)
    bus.order_queue.publish(b"x")
    assert bus.order_queue.read_from(0, 1)[0].body == b"x"


#: tests/test_amqp.py's reference-shaped config.yaml without its redis:
#: section: a store client would register process-wide gauges that only
#: the port's metrics registry then holds (test_torch_service_parts
#: compares the two registries' names).
REFERENCE_YAML = """\
rabbitmq:
  host: 127.0.0.1
  port: {port}
  username: guest
  password: guest
grpc:
  host: 127.0.0.1
  port: 0
mysql:
  host: dead
gomengine:
  accuracy: 8
"""


def _write_ref_config(tmp_path, port):
    p = tmp_path / "config.yaml"
    p.write_text(REFERENCE_YAML.format(port=port))
    return str(p)


def _request(pb, uuid, oid, side, volume):
    return pb.OrderRequest(uuid=uuid, oid=oid, symbol="eth2usdt",
                           transaction=side, price=1.0, volume=volume)


def _wait(pred, limit_s: float) -> None:
    deadline = time.monotonic() + limit_s
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)


@limited(60)
def test_reference_config_boots_without_broker(tmp_path):
    """A reference-shaped config.yaml (its rabbitmq: section selects the
    amqp backend) boots and matches with no broker listening: the memory
    bus after the reference's warning, the engine on the CPU here."""
    from gome_tpu_torch.api import order_pb2 as pb
    from gome_tpu_torch.service import EngineService

    cfg = load_config(_write_ref_config(tmp_path, port=1))
    assert cfg.bus.backend == "amqp"
    with pytest.warns(RuntimeWarning, match="falling back"):
        svc = EngineService(cfg, device="cpu")
    svc.start()
    try:
        r = svc.gateway.DoOrder(_request(pb, "u", "1", pb.SALE, 2.0), None)
        assert r.code == 0
        _wait(lambda: svc.engine.stats.orders >= 1, 30)
        assert svc.engine.stats.orders == 1
    finally:
        svc.stop()


@limited(60)
def test_reference_config_full_amqp_service(tmp_path, broker):
    """The reference topology over real AMQP framing: the gateway publishes
    to doOrder through the broker, the consumer matches, the fill lands on
    matchOrder and the feed reads it; /healthz's connections list both
    supervised queues with their breakers closed."""
    from gome_tpu_torch.api import order_pb2 as pb
    from gome_tpu_torch.service import EngineService
    from gome_tpu_torch.service.health import HealthMonitor

    cfg = load_config(_write_ref_config(tmp_path, port=broker.port))
    svc = EngineService(cfg, device="cpu")
    svc.start()
    try:
        assert isinstance(svc.bus.order_queue, tamqp.SupervisedAmqpQueue)
        assert isinstance(svc.bus.match_queue, tamqp.SupervisedAmqpQueue)
        r1 = svc.gateway.DoOrder(_request(pb, "u1", "a", pb.SALE, 5.0), None)
        r2 = svc.gateway.DoOrder(_request(pb, "u2", "b", pb.BUY, 3.0), None)
        assert r1.code == 0 and r2.code == 0
        _wait(lambda: svc.engine.stats.fills >= 1, 30)
        assert svc.engine.stats.fills == 1
        _wait(lambda: svc.feed.events_seen >= 1, 10)
        assert svc.feed.events_seen == 1
        health = HealthMonitor(svc).check()
        assert health.healthy and not health.detail["degraded"]
        conns = health.detail["connections"]
        for name in ("amqp:doOrder", "amqp:matchOrder"):
            assert conns[name]["breaker"] == "closed", conns
    finally:
        svc.stop()


# --- the client's hardening (tests/test_advice_fixes.py), both packages -------


class _SlowSock:
    """send() times out `stall_windows` times, then accepts bytes in small
    chunks; gettimeout() reports a tiny window so the aggregate deadline
    math runs."""

    def __init__(self, stall_windows, timeout=0.05, chunk=3):
        self.sent = bytearray()
        self._stalls = stall_windows
        self._timeout = timeout
        self._chunk = chunk

    def gettimeout(self):
        return self._timeout

    def send(self, mv):
        if self._stalls > 0:
            self._stalls -= 1
            raise socket.timeout("stalled window")
        n = min(self._chunk, len(mv))
        self.sent.extend(bytes(mv[:n]))
        return n

    def close(self):
        pass


@pytest.mark.parametrize("pkg", [J, T])
def test_amqp_send_survives_one_stalled_window(pkg):
    """One zero-progress send window on a slow-but-alive link does not
    kill the connection; two consecutive stalled windows do."""
    AmqpQueue = AMQP[pkg].AmqpQueue
    q = AmqpQueue.__new__(AmqpQueue)
    q._closed = False
    q._sock = _SlowSock(stall_windows=1)
    q._send(b"hello world payload")
    assert bytes(q._sock.sent) == b"hello world payload"
    assert not q._closed

    q2 = AmqpQueue.__new__(AmqpQueue)
    q2._closed = False
    q2._sock = _SlowSock(stall_windows=2)
    with pytest.raises(ConnectionError):
        q2._send(b"hello world payload")
    assert q2._closed


@pytest.mark.parametrize("pkg", [J, T])
def test_amqp_send_trickle_hits_aggregate_deadline(pkg):
    """A peer accepting one byte per window resets the stall counter every
    time, but the per-frame aggregate deadline still fails the
    connection instead of wedging the write lock."""

    class _TrickleSock:
        def gettimeout(self):
            return 0.01

        def send(self, mv):
            time.sleep(0.005)
            return 1

        def close(self):
            pass

    AmqpQueue = AMQP[pkg].AmqpQueue
    q = AmqpQueue.__new__(AmqpQueue)
    q._closed = False
    q._sock = _TrickleSock()
    start = time.monotonic()
    with pytest.raises(ConnectionError, match="floor rate"):
        q._send(b"x" * 4096)
    assert time.monotonic() - start < 5.0
    assert q._closed


@pytest.mark.parametrize("pkg", [J, T])
def test_amqp_reader_death_preserves_delivered_reply(pkg):
    """A reply stored just before the reader dies survives: the real
    _read_loop over a socketpair gets a ConsumeOk and then EOF."""
    amqp = AMQP[pkg]
    broker_side, client_side = socket.socketpair()
    q = amqp.AmqpQueue.__new__(amqp.AmqpQueue)
    q._init_wait()
    q._closed = False
    q._sock = client_side
    q._heartbeat = 0
    q._pending_deliver = None
    q._buffer, q._tags = [], []
    q._lock = threading.RLock()
    q._rpc_lock = threading.Lock()
    q._rpc_event = threading.Event()
    q._rpc_expect = ((60, 21), 7)  # an rpc (token 7) awaits ConsumeOk
    q._rpc_reply = None
    reader = threading.Thread(target=q._read_loop, daemon=True)
    reader.start()
    broker_side.sendall(amqp.frame(amqp.FRAME_METHOD, 1, amqp.method(60, 21)))
    broker_side.close()
    reader.join(timeout=5)
    assert not reader.is_alive()
    assert q._rpc_event.is_set()
    token, reply = q._rpc_reply
    assert token == 7 and reply[:2] == (60, 21)
    assert q._closed
    client_side.close()


@pytest.mark.parametrize("pkg", [J, T])
def test_amqp_stale_reply_never_crosses_rpcs(pkg):
    """A late reply from a timed-out RPC is never handed to the next rpc:
    the timeout fails the connection, and a reply carrying an earlier
    rpc's token fails the token check."""

    class _NullSock:
        def gettimeout(self):
            return None

        def send(self, mv):
            return len(mv)

        def close(self):
            pass

    AmqpQueue = AMQP[pkg].AmqpQueue
    q = AmqpQueue.__new__(AmqpQueue)
    q._closed = False
    q._sock = _NullSock()
    q._lock = threading.RLock()
    q._rpc_lock = threading.Lock()
    q._rpc_event = threading.Event()
    q._rpc_expect = None
    q._rpc_reply = None
    q._rpc_seq = 0
    q.SYNC_WAIT_S = 0.05
    with pytest.raises(ConnectionError, match="timeout"):
        q._rpc((60, 21), b"")
    assert q._rpc_expect is None
    assert q._closed
    with pytest.raises(ConnectionError, match="closed"):
        q._rpc((60, 21), b"")

    q._closed = False

    def _late_reply():
        q._rpc_reply = (1, (60, 21, b"stale"))
        q._rpc_event.set()

    threading.Timer(0.01, _late_reply).start()
    with pytest.raises(ConnectionError, match="stale"):
        q._rpc((60, 21), b"")


# --- the wire, byte for byte ---------------------------------------------------


class Relay:
    """A TCP relay in front of a broker that records every byte each way
    of one connection: (client -> broker, broker -> client)."""

    def __init__(self, broker_port: int):
        self._server = socket.create_server(("127.0.0.1", 0))
        self.port = self._server.getsockname()[1]
        self.up, self.down = bytearray(), bytearray()
        self._broker_port = broker_port
        self._threads = []
        self._accept = threading.Thread(target=self._run, daemon=True)
        self._accept.start()

    def _run(self):
        client, _ = self._server.accept()
        upstream = socket.create_connection(("127.0.0.1", self._broker_port))
        for src, dst, log in ((client, upstream, self.up),
                              (upstream, client, self.down)):
            t = threading.Thread(target=self._pipe, args=(src, dst, log),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _pipe(src, dst, log):
        while True:
            try:
                chunk = src.recv(65536)
            except OSError:
                chunk = b""
            if not chunk:
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            log.extend(chunk)
            try:
                dst.sendall(chunk)
            except OSError:
                pass

    def finish(self, limit_s: float = 5.0):
        self._accept.join(limit_s)
        for t in self._threads:
            t.join(limit_s)
        self._server.close()
        return bytes(self.up), bytes(self.down)


def wire_session(client: str, side: str) -> tuple[bytes, bytes]:
    """One scripted session of `client`'s AmqpQueue against `side`'s broker
    through a Relay: declare, three publishes (one with headers, one
    empty, one spanning frames), consume, commit, truncate, close."""
    b = BROKER[side].FakeBroker(frame_max=4096).start()
    try:
        relay = Relay(b.port)
        q = AMQP[client].AmqpQueue("doOrder", port=relay.port)
        q.publish(b"first", headers={"x-trace": "abc@1"})
        q.publish(b"")
        q.publish(bytes(range(256)) * 40)
        assert [m.offset for m in q.poll_batch(3, 5.0)] == [0, 1, 2]
        q.commit(1)
        q.truncate_to(2)
        q.close()
        return relay.finish()
    finally:
        b.stop()


def test_wire_bytes_equal_across_packages():
    """The port's client sends gome_tpu's client's bytes, and the port's
    broker answers with gome_tpu's broker's bytes, over a whole session
    (handshake, declare, publish with headers and split bodies, consume,
    deliveries, multiple and single acks, close)."""
    sessions = {(c, s): wire_session(c, s) for c, s in PAIRS}
    for side in (J, T):
        assert sessions[(T, side)][0] == sessions[(J, side)][0]
        assert sessions[(T, side)][1] == sessions[(J, side)][1]
    for client in (J, T):
        assert sessions[(client, T)] == sessions[(client, J)]
    up, down = sessions[(T, T)]
    assert up.startswith(tamqp.PROTOCOL_HEADER) and len(down) > 10 * 1024


def test_wire_helpers_equal_across_packages():
    body = bytes(range(256)) * 9
    for headers in (None, {"x-trace": "id@1", "n": 7}):
        assert (tamqp.content_frames(1, body, 1024, headers=headers)
                == jamqp.content_frames(1, body, 1024, headers=headers))
    table = jamqp.encode_table({"a": "b", "c": 3})
    assert tamqp.encode_table({"a": "b", "c": 3}) == table
    assert (tamqp.read_table(memoryview(table), 0)
            == jamqp.read_table(memoryview(table), 0))
    for name in ("PROTOCOL_HEADER", "FLAG_HEADERS", "MAX_FRAME_SIZE",
                 "EMPTY_TABLE", "FRAME_END"):
        assert getattr(tamqp, name) == getattr(jamqp, name), name


# --- supervised drills (tests/test_reconnect.py, tests/test_chaos.py) ---------


def supervised(name, b, pkg=T):
    return AMQP[pkg].SupervisedAmqpQueue(name, port=b.port, policy=FAST)


@pytest.mark.parametrize("side", [J, T])
def test_exact_stream_across_repeated_publish_kills(side):
    """close_abruptly_on_publish=5: every connection dies at its 5th
    publish (dropped before the enqueue); 23 messages force ~5 reconnects
    and the consumer sees all 23 once, in order."""
    b = BROKER[side].FakeBroker(close_abruptly_on_publish=5).start()
    try:
        producer = supervised("doOrder", b)
        consumer = supervised("doOrder", b)
        bodies = [f"m{i}".encode() for i in range(23)]
        for body in bodies:
            producer.publish(body)
        got = []
        deadline = time.monotonic() + 20
        while len(got) < len(bodies) and time.monotonic() < deadline:
            got = [m.body for m in consumer.poll_batch(64, 0.2)]
        assert got == bodies
        assert producer.supervisor().snapshot()["connects_total"] >= 4
        producer.close()
        consumer.close()
    finally:
        b.stop()


@pytest.mark.parametrize("side", [J, T])
def test_redelivery_resumes_exact_offsets_after_consume_kill(side):
    """A consumer connection killed mid-stream: the committed messages do
    not redeliver, the rest redeliver at the same wrapper offsets."""
    b = BROKER[side].FakeBroker().start()
    try:
        producer = supervised("doOrder", b)
        consumer = supervised("doOrder", b)
        for i in range(10):
            producer.publish(f"m{i}".encode())
        assert len(consumer.poll_batch(10, 5.0)) == 10
        consumer.commit(4)
        assert b.kill_connections(consuming="doOrder") == 1
        deadline = time.monotonic() + 20
        tail = []
        while len(tail) < 6 and time.monotonic() < deadline:
            tail = consumer.poll_batch(16, 0.2)
        assert [(m.offset, m.body) for m in tail] == [
            (i, f"m{i}".encode()) for i in range(4, 10)]
        consumer.commit(10)
        producer.publish(b"late")
        late = consumer.poll_batch(1, 5.0)
        assert [(m.offset, m.body) for m in late] == [(10, b"late")]
        assert consumer.supervisor().snapshot()["connects_total"] >= 2
        producer.close()
        consumer.close()
    finally:
        b.stop()


def test_channel_close_fault_reconnects_and_retries():
    """A server-initiated Channel.Close instead of a dead socket: the
    supervised queue recovers from the protocol-level failure too."""
    b = tfake.FakeBroker(channel_close_on_publish=3).start()
    try:
        q = supervised("doOrder", b)
        for i in range(8):
            q.publish(f"m{i}".encode())
        msgs = q.poll_batch(8, 10.0)
        assert [m.body for m in msgs] == [f"m{i}".encode() for i in range(8)]
        assert q.supervisor().snapshot()["connects_total"] >= 2
        q.close()
    finally:
        b.stop()


def test_call_mode_broker_kill_handler():
    """tests/test_chaos.py's schedule against the port's broker: a counted
    fault point kills the live connections through a FAULTS handler, the
    supervised queue reconnects and the next publish lands."""
    from gome_tpu_torch.utils.faults import FAULTS, FaultPlan, FaultSpec

    b = tfake.FakeBroker().start()
    try:
        bus = tbus.make_bus(BusConfig(backend="amqp", port=b.port))
        bus.order_queue.publish(b"before")
        FAULTS.handler("broker.kill", b.kill_connections)
        FAULTS.install(FaultPlan(faults=(
            FaultSpec("bus.step", mode="call", at=(1,),
                      handler="broker.kill"),)))
        FAULTS.fire("bus.step")
        assert FAULTS.report()["fired"]
        bus.order_queue.publish(b"after")
        msgs = bus.order_queue.read_from(0, 10)
        assert [m.body for m in msgs] == [b"before", b"after"]
        bus.order_queue.close()
        bus.match_queue.close()
    finally:
        FAULTS.disable()
        b.stop()


def port_engine():
    import torch

    from gome_tpu_torch.engine import BookConfig, MatchEngine

    return MatchEngine(BookConfig(cap=32, max_fills=8, dtype=torch.int64),
                       n_slots=16, max_t=8, device="cpu")


def run_flow(engine, bus, orders, mid_kill=None) -> list[bytes]:
    """tests/test_reconnect.py's _run_flow on the port: mark each ADD and
    publish each order as JSON, then step the consumer until every order
    is committed, calling mid_kill(committed) between steps; returns the
    matchOrder bodies."""
    from gome_tpu_torch.service.consumer import OrderConsumer
    from gome_tpu_torch.types import Action

    for o in orders:
        if o.action is Action.ADD:
            engine.mark(o)
        bus.order_queue.publish(tbus.encode_order(o))
    consumer = OrderConsumer(engine, bus, batch_n=16, batch_wait_s=0.01)
    deadline = time.monotonic() + 60
    q = bus.order_queue
    while q.committed() < q.end_offset() and time.monotonic() < deadline:
        consumer.step_with_policy()
        if mid_kill is not None:
            mid_kill(q.committed())
    assert q.committed() == q.end_offset()
    mq = bus.match_queue
    return [m.body for m in mq.read_from(0, mq.end_offset())]


def test_fault_schedule_match_stream_is_oracle_exact():
    """The acceptance drill of tests/test_reconnect.py on the port: every
    connection dies at its 9th publish (order feed and event publishes)
    and one consumer connection is killed mid-drain; the matchOrder
    stream equals the port's fault-free memory-bus run, and gome_tpu's
    on the same orders, byte for byte."""
    from test_reconnect import _mk_engine, _run_flow

    orders = multi_symbol_stream(n=120, n_symbols=4, seed=11,
                                 cancel_prob=0.2)
    reference = _run_flow(_mk_engine(), jbus.QueueBus(
        jbus.MemoryQueue("doOrder"), jbus.MemoryQueue("matchOrder")), orders)
    tor = [port_order(o) for o in orders]
    oracle = run_flow(port_engine(), tbus.QueueBus(
        tbus.MemoryQueue("doOrder"), tbus.MemoryQueue("matchOrder")), tor)
    assert oracle == reference and oracle

    b = tfake.FakeBroker(close_abruptly_on_publish=9).start()
    try:
        bus = tbus.QueueBus(supervised("doOrder", b),
                            supervised("matchOrder", b))
        kills = {"consume": 0}

        def mid_kill(committed):
            if committed >= 40 and not kills["consume"]:
                kills["consume"] = b.kill_connections(consuming="doOrder")

        got = run_flow(port_engine(), bus, tor, mid_kill=mid_kill)
        assert got == oracle
        assert kills["consume"] == 1
        reconnects = sum(q.supervisor().snapshot()["connects_total"]
                         for q in (bus.order_queue, bus.match_queue))
        assert reconnects >= 5
        bus.order_queue.close()
        bus.match_queue.close()
    finally:
        b.stop()


# --- a deployment that mixes the packages --------------------------------------


@pytest.mark.parametrize("side", [J, T])
def test_reference_producer_port_consumer_share_a_broker(side):
    """A deployment migrating from gome_tpu to the port: gome_tpu's
    supervised producer publishes the orders (JSON, as its gateway does),
    the port's consumer on the CPU matches them off the same broker and
    publishes the events, and gome_tpu's reader of matchOrder decodes the
    oracle's events from them."""
    from gome_tpu.oracle import OracleEngine
    from gome_tpu_torch.service.consumer import OrderConsumer

    orders = multi_symbol_stream(n=150, n_symbols=5, seed=21,
                                 cancel_prob=0.2)
    oracle = OracleEngine()
    for o in orders:
        oracle.submit(o)
    want = oracle.drain()
    b = BROKER[side].FakeBroker().start()
    try:
        producer = supervised("doOrder", b, pkg=J)
        engine = port_engine()
        for o in orders:
            if o.action is JAction.ADD:
                engine.mark(port_order(o))
            producer.publish(jbus.encode_order(o))
        bus = tbus.QueueBus(supervised("doOrder", b),
                            supervised("matchOrder", b))
        consumer = OrderConsumer(engine, bus, batch_n=32, batch_wait_s=0.01)
        deadline = time.monotonic() + 30
        while (bus.order_queue.committed() < len(orders)
               and time.monotonic() < deadline):
            consumer.run_once()
        assert bus.order_queue.committed() == len(orders)
        reader = supervised("matchOrder", b, pkg=J)
        got = []
        deadline = time.monotonic() + 10
        while len(got) < len(want) and time.monotonic() < deadline:
            got = reader.poll_batch(len(want), 0.2)
        events = [jbus.decode_match_result(m.body) for m in got]
        assert events == want
        engine.batch.verify_books()
        for q in (producer, bus.order_queue, bus.match_queue, reader):
            q.close()
    finally:
        b.stop()


def test_chip_smoke_broker_faults_on_the_cpu():
    """chip_smoke.py phase 12 (c) on the CPU at a small size: the stream
    through a broker that kills every connection at its 9th publish, and
    one consuming connection mid-drain, equals the memory bus's byte for
    byte, with the reconnects counted."""
    import torch

    import chip_smoke
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    orders = multi_symbol_stream(n=3000, n_symbols=64, zipf_a=1.2,
                                 cancel_prob=0.3, seed=7)
    fc = chip_smoke.broker_fault_check(torch.device("cpu"), 64, orders,
                                       frame_n=100)
    assert fc["frames"] == 30 and fc["bodies"] == 30
    assert min(fc["connects"].values()) >= 4
