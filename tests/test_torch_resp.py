"""The port's RESP2 wire layer (persist.resp + persist.respserver) and its
RESP-backed pre-pool (engine.prepool.RespPrePool) on the CPU against
gome_tpu's: the flows of tests/test_resp.py, the supervised client's
restart drill of tests/test_reconnect.py, and the wire across packages —
each package's client against each package's server, with the same
replies and the same keyspace."""

from __future__ import annotations

import threading

import numpy as np
import pytest

import gome_tpu.persist.resp as jresp
import gome_tpu.persist.respserver as jserver
import gome_tpu_torch.persist.resp as tresp
import gome_tpu_torch.persist.respserver as tserver
from gome_tpu.engine import BookConfig as JBookConfig
from gome_tpu.engine import MatchEngine as JEngine
from gome_tpu.engine.prepool import RespPrePool as JRespPrePool
from gome_tpu.oracle import OracleEngine
from gome_tpu.persist import restore_from_redis as jrestore
from gome_tpu.persist.redis_schema import export_to_redis as jexport
from gome_tpu.types import Action, Order, Side
from gome_tpu.utils.streams import multi_symbol_stream
from gome_tpu_torch.bus import colwire
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.engine.prepool import RespPrePool, make_marker
from gome_tpu_torch.persist import restore_from_redis
from gome_tpu_torch.persist.redis_schema import export_to_redis
from gome_tpu_torch.utils.resilience import BackoffPolicy
from test_redis_restore import _books_semantically_equal
from test_torch_bus import plain, port_order
from test_torch_service_parts import limited

J, T = "gome_tpu", "port"
CLIENT = {J: jresp.RespClient, T: tresp.RespClient}
SERVER = {J: jserver.FakeRedisServer, T: tserver.FakeRedisServer}
#: Fast schedule for drills: real reconnects, no test-visible latency.
FAST = BackoffPolicy(base_s=0.005, max_s=0.05, max_retries=60, budget_s=30)


@pytest.fixture()
def server():
    with tserver.FakeRedisServer() as srv:
        yield srv


@pytest.fixture()
def client(server):
    with tresp.RespClient(port=server.port) as c:
        yield c


def protocol_script(client) -> list:
    """tests/test_resp.py's protocol round trips; returns every reply."""
    out = [client.ping(),
           client.execute_command("ECHO", "héllo"),
           client.hset("h", "f1", "v1"), client.hset("h", "f1", "v2"),
           client.execute_command("HGET", "h", "f1"),
           client.hexists("h", "f1"), client.hexists("h", "nope"),
           client.hgetall("h"), client.hdel("h", "f1", "zzz"),
           client.hgetall("h"), client.execute_command("HGET", "h", "f1"),
           client.execute_command("ZADD", "z", 2.5, "b", 1, "a", 10, "c"),
           client.zrange("z", 0, -1),
           client.execute_command("ZRANGE", "z", 0, -1, "WITHSCORES"),
           client.execute_command("ZRANGEBYSCORE", "z", "-inf", 2.5),
           client.execute_command("ZREVRANGEBYSCORE", "z", "+inf", 2),
           client.execute_command("ZREM", "z", "b"),
           sorted(client.keys("*")),
           client.execute_command("HINCRBYFLOAT", "d", "x", "1.5"),
           client.execute_command("HINCRBYFLOAT", "d", "x", "1.5"),
           client.execute_command("DEL", "z")]
    with pytest.raises((jresp.RespError, tresp.RespError)) as err:
        client.execute_command("NOSUCHCMD")
    out.append(str(err.value))
    return out


@pytest.mark.parametrize("server_side", [J, T])
@pytest.mark.parametrize("client_side", [J, T])
@limited(30)
def test_protocol_basics(client_side, server_side):
    """tests/test_resp.py's round trips for every pairing of client and
    server package: the replies and the server's keyspace after them are
    the same as gome_tpu's client against gome_tpu's server."""
    results = {}
    for c_side, s_side in {(J, J), (client_side, server_side)}:
        with SERVER[s_side]() as srv, CLIENT[c_side](port=srv.port) as c:
            replies = protocol_script(c)
            keyspace = (srv.store.hashes.copy(), srv.store.zsets.copy())
            c.flushdb()
            assert c.keys("*") == []
        results[c_side, s_side] = (replies, keyspace)
    replies, (hashes, zsets) = results[client_side, server_side]
    assert results[client_side, server_side] == results[J, J]
    assert replies[0] is True and replies[1] == "héllo".encode()
    assert replies[2:5] == [1, 0, b"v2"]
    assert replies[12] == ["a", "b", "c"]
    assert replies[13] == [b"a", b"1", b"b", b"2.5", b"c", b"10"]
    assert replies[14:16] == [[b"a", b"b"], [b"c", b"b"]]
    assert replies[18:20] == [b"1.5", b"3"]
    assert hashes == {"d": {"x": "3"}} and zsets == {}


@limited(60)
def test_large_values_and_pipelining(client):
    big = "x" * 300_000
    client.hset("big", "f", big)
    assert client.hgetall("big")["f"] == big
    cmds = [("HSET", "p", f"f{i}", str(i)) for i in range(5_000)]
    cmds.insert(2500, ("BADCMD",))  # error must come back in-place
    replies = client.pipeline(cmds)
    assert len(replies) == 5_001
    assert isinstance(replies[2500], tresp.RespError)
    assert sum(r == 1 for r in replies if isinstance(r, int)) == 5_000
    assert len(client.hgetall("p")) == 5_000


@limited(30)
def test_resp_prepool_schema_and_semantics(client):
    pool = RespPrePool(client)
    k1 = ("eth2usdt", "u1", "o1")
    k2 = ("eth2usdt", "u1", "o2")
    k3 = ("btc2usdt", "u2", "o1")
    pool.add(k1)
    pool.add(k3)
    assert client.hgetall("eth2usdt:comparison") == {"eth2usdt:u1:o1": "1"}
    assert client.hgetall("btc2usdt:comparison") == {"btc2usdt:u2:o1": "1"}
    assert k1 in pool and k3 in pool and k2 not in pool
    pool |= {k2}
    assert sorted(pool) == sorted([k1, k2, k3])
    assert len(pool) == 3
    assert pool.consume_batch([k1, k1, k2]) == [True, False, True]
    assert k1 not in pool
    pool.discard(k3)
    assert len(pool) == 0
    pool.update([k1, k2])
    pool.clear()
    assert len(pool) == 0


def port_engine(**kw):
    return MatchEngine(kw.pop("config", BookConfig(cap=32, max_fills=8)),
                       n_slots=kw.pop("n_slots", 8), max_t=8, device="cpu",
                       **kw)


def run_marked(engine, orders):
    out = []
    for o in orders:
        engine.mark(o)
        out.extend(engine.process([o]))
    return out


@limited(120)
def test_remote_prepool_admission_matches_local(server):
    """The port's engine with its pre-pool in the RESP store admits as its
    in-process pool does and as gome_tpu's engine over the same store
    kind does: events equal to the oracle's, books and drops equal."""
    orders = multi_symbol_stream(n=200, n_symbols=4, seed=23,
                                 cancel_prob=0.2)
    oracle = OracleEngine()
    want = [r for o in orders for r in oracle.process(o)]
    local = port_engine()
    got_local = run_marked(local, [port_order(o) for o in orders])
    remote = port_engine()
    remote.pre_pool = RespPrePool(tresp.RespClient(port=server.port))
    got_remote = run_marked(remote, [port_order(o) for o in orders])
    assert plain(got_remote) == plain(got_local) == plain(want)
    _books_semantically_equal(remote, local)
    assert remote.stats.dropped_no_prepool == \
        local.stats.dropped_no_prepool

    with jserver.FakeRedisServer() as jsrv:
        ref = JEngine(config=JBookConfig(cap=32, max_fills=8), n_slots=8,
                      max_t=8)
        ref.pre_pool = JRespPrePool(jresp.RespClient(port=jsrv.port))
        run_marked(ref, orders)
        assert remote.stats.dropped_no_prepool == \
            ref.stats.dropped_no_prepool
        assert jsrv.store.hashes == server.store.hashes


@limited(120)
def test_remote_prepool_frame_admission(server):
    """A decoded ORDER frame on an engine whose pool is a RespPrePool:
    admit_frame takes the batched consume (one pipelined HDEL round trip
    per frame; the pool has no fused consume_frame), and the frame's
    events, books and drops equal the in-process pool's."""
    orders = [port_order(o) for o in multi_symbol_stream(
        n=300, n_symbols=6, seed=29, cancel_prob=0.25)]
    frames = [colwire.decode_order_frame(colwire.encode_orders(
        orders[i:i + 100])) for i in range(0, len(orders), 100)]

    class Counting(RespPrePool):
        batches = 0

        def consume_batch(self, keys):
            Counting.batches += 1
            return super().consume_batch(keys)

    results = []
    for pool in (None, Counting(tresp.RespClient(port=server.port))):
        eng = port_engine()
        if pool is not None:
            eng.pre_pool = pool
            assert not hasattr(pool, "consume_frame")
        events = []
        for cols in frames:
            eng.mark_frame(cols)
            events += eng.process_frame(cols).to_results()
        results.append((plain(events), eng.stats.dropped_no_prepool,
                        sorted(eng.pre_pool)))
        last = eng
    assert Counting.batches == len(frames)
    assert results[1] == results[0]
    assert server.store.hashes == {}  # every mark consumed
    last.batch.verify_books()


@limited(30)
def test_remote_prepool_cancel_before_consume_drop(server):
    engine = port_engine()
    engine.pre_pool = RespPrePool(tresp.RespClient(port=server.port))
    add = port_order(Order(uuid="u", oid="x", symbol="s", side=Side.BUY,
                           price=100, volume=5))
    engine.mark(add)
    delete = port_order(Order(uuid="u", oid="x", symbol="s", side=Side.BUY,
                              price=100, volume=0, action=Action.DEL))
    assert engine.process([delete]) == []
    assert engine.process([add]) == []
    assert engine.stats.dropped_no_prepool == 1
    books = engine.batch.lane_books()
    assert int(np.asarray(books.count).sum()) == 0


@limited(120)
def test_wire_level_export_import_round_trip(server):
    """The port's export and import both over the socket: the books
    round-trip, the marks too, and the restored engine continues with
    oracle parity; gome_tpu's export of the same flow gives the same
    keyspace on its own server."""
    flow = multi_symbol_stream(n=400, n_symbols=5, seed=31,
                               cancel_prob=0.15)
    head, tail = flow[:300], flow[300:]
    src = port_engine()
    oracle = OracleEngine()
    run_marked(src, [port_order(o) for o in head])
    for o in head:
        oracle.process(o)
    with tresp.RespClient(port=server.port) as c:
        n_cmds = export_to_redis(src, client=c)
    assert n_cmds > 0
    dst = port_engine()
    with tresp.RespClient(port=server.port) as c2:
        imported = restore_from_redis(dst, c2)
    assert imported == int(np.asarray(src.batch.lane_books().count).sum())
    _books_semantically_equal(dst, src)
    assert set(dst.pre_pool) == set(src.pre_pool)
    got = run_marked(dst, [port_order(o) for o in tail])
    assert plain(got) == plain([r for o in tail for r in oracle.process(o)])

    with jserver.FakeRedisServer() as jsrv:
        ref = JEngine(config=JBookConfig(cap=32, max_fills=8), n_slots=8,
                      max_t=8)
        run_marked(ref, head)
        with jresp.RespClient(port=jsrv.port) as c3:
            assert jexport(ref, client=c3) == n_cmds
        assert jsrv.store.zsets == server.store.zsets
        # the port's import reads gome_tpu's server, and the reverse
        cross = port_engine()
        with tresp.RespClient(port=jsrv.port) as c4:
            assert restore_from_redis(cross, c4) == imported
        _books_semantically_equal(cross, src)
        jdst = JEngine(config=JBookConfig(cap=32, max_fills=8), n_slots=8,
                       max_t=8)
        with jresp.RespClient(port=server.port) as c5:
            assert jrestore(jdst, c5) == imported
        _books_semantically_equal(jdst, src)


def test_resp_prepool_raises_on_store_errors():
    class ErrClient:
        def pipeline(self, cmds):
            return [tresp.RespError("LOADING Redis is loading the dataset")
                    ] * len(cmds)

    pool = RespPrePool(ErrClient())
    with pytest.raises(tresp.RespError):
        pool.consume_batch([("s", "u", "1")])
    with pytest.raises(tresp.RespError):
        pool.update([("s", "u", "1")])


@limited(30)
def test_make_marker_marks_only_adds(server):
    pool = RespPrePool(tresp.RespClient(port=server.port))
    mark = make_marker(pool)
    mark(port_order(Order(uuid="u", oid="1", symbol="s", side=Side.BUY,
                          price=1, volume=1)))
    mark(port_order(Order(uuid="u", oid="2", symbol="s", side=Side.BUY,
                          price=1, volume=0, action=Action.DEL)))
    assert ("s", "u", "1") in pool
    assert ("s", "u", "2") not in pool


def accept_threads(port: int) -> list:
    return [t for t in threading.enumerate()
            if t.name == f"fakeredis-accept-{port}" and t.is_alive()]


@limited(60)
def test_resp_store_restarts_mid_mark():
    """tests/test_reconnect.py's drill on the port: three server restarts
    interleaved with marking; the supervised client reconnects and
    retries, and the consume pass sees every mark exactly once. Each
    restart comes back on the same port with exactly one accept thread
    alive (stop() joins the old one, so no accept can hold the port)."""
    srv = tserver.FakeRedisServer()
    port = srv.start()
    try:
        client = tresp.SupervisedRespClient(port=port, policy=FAST,
                                            name="resp:drill")
        pool = RespPrePool(client)
        keys = [("eth2usdt", "u", f"oid{i}") for i in range(12)]
        for i, k in enumerate(keys):
            if i in (3, 6, 9):
                assert srv.restart() == port
                assert len(accept_threads(port)) == 1
            pool.add(k)
        assert pool.resilience()["connects_total"] >= 4
        assert pool.consume_batch(keys) == [True] * len(keys)
        assert pool.consume_batch(keys) == [False] * len(keys)
        client.close()
    finally:
        srv.stop()
    assert accept_threads(port) == []


@limited(60)
def test_restart_rebinds_with_a_client_reconnecting():
    """Eight restarts in a row, each while a client connection is open
    and reconnects through the supervisor: every restart returns the same
    port, leaves one accept thread, and the keyspace survives."""
    with tserver.FakeRedisServer() as srv:
        client = tresp.SupervisedRespClient(port=srv.port, policy=FAST,
                                            name="resp:rebind")
        try:
            for i in range(8):
                client.hset("k", f"f{i}", "1")
                assert srv.restart() == srv.port
                assert len(accept_threads(srv.port)) == 1
            assert len(client.hgetall("k")) == 8
        finally:
            client.close()


@limited(60)
def test_respserver_runs_as_a_module():
    """`python -m gome_tpu_torch.persist.respserver --port 0` prints READY
    with its port, serves both packages' clients, and exits 0 on SIGINT."""
    import signal
    import subprocess
    import sys

    proc = subprocess.Popen(
        [sys.executable, "-m", "gome_tpu_torch.persist.respserver",
         "--port", "0"], stdout=subprocess.PIPE, text=True)
    try:
        word, port = proc.stdout.readline().split()
        assert word == "READY"
        with tresp.RespClient(port=int(port)) as c:
            assert c.hset("h", "f", "1") == 1
        with jresp.RespClient(port=int(port)) as c:
            assert c.hgetall("h") == {"f": "1"}
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=20) == 0
    finally:
        proc.kill()
        proc.wait()
