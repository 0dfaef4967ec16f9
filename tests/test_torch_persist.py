"""The port's durability on the CPU against gome_tpu's: the flows of
tests/test_persist.py (snapshot/restore, crash replay with an exactly-once
match stream, the mark rebuild's two cases, store atomicity and pruning,
the Redis-schema export, the queue guards) and the persistence flows of
tests/test_chaos.py (seq rebasing, a Redis import composed with crash
recovery, the /durability payload and the gauges), each run on both
packages with the same inputs: match-queue bodies byte-equal, exported
state equal leaf by leaf. Beyond them: a snapshot written by either
package restores in the other (int32 and int64), a torn snapshot.rename
falls back to the previous snapshot in both, and a real kill drill runs
chip_smoke.py's durability worker in subprocesses on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest

import gome_tpu.bus as jbus
import gome_tpu.config as jconfig
import gome_tpu.persist as jpersist
import gome_tpu.persist.redis_schema as jschema
import gome_tpu.utils.faults as jfaults
import gome_tpu_torch.bus as tbus
import gome_tpu_torch.config as tconfig
import gome_tpu_torch.persist as tpersist
import gome_tpu_torch.persist.redis_schema as tschema
import gome_tpu_torch.utils.faults as tfaults
from gome_tpu.engine import BookConfig as JBookConfig
from gome_tpu.engine import MatchEngine as JEngine
from gome_tpu.fixed import scale
from gome_tpu.service.app import EngineService as JService
from gome_tpu.service.ops import OpsServer as JOps
from gome_tpu.types import Action, Order, Side
from gome_tpu.utils.metrics import Registry as JRegistry
from gome_tpu.utils.streams import mixed_stream
from gome_tpu_torch.engine import BookConfig as TBookConfig
from gome_tpu_torch.engine import MatchEngine as TEngine
from gome_tpu_torch.service.app import EngineService as TService
from gome_tpu_torch.service.ops import OpsServer as TOps
from gome_tpu_torch.utils.metrics import Registry as TRegistry
from test_torch_bus import port_order
from test_torch_service_parts import no_tracer, time_limit  # noqa: F401

J, T = "gome_tpu", "port"
SIDES = {
    J: dict(config=jconfig, service=JService, persist=jpersist, bus=jbus,
            schema=jschema, faults=jfaults, ops=JOps, registry=JRegistry,
            order=lambda o: o, kw={}),
    T: dict(config=tconfig, service=TService, persist=tpersist, bus=tbus,
            schema=tschema, faults=tfaults, ops=TOps, registry=TRegistry,
            order=port_order, kw=dict(device="cpu")),
}
GAUGES = ("gome_snapshot_age_seconds", "gome_snapshot_bytes",
          "gome_snapshots_taken_total", "gome_recovery_seconds",
          "gome_wal_replay_frames")


@pytest.fixture(autouse=True)
def _disarm_faults():
    """Neither package's FAULTS may leak an armed plan across tests."""
    yield
    for side in SIDES.values():
        side["faults"].FAULTS.disable()


def make_svc(side, tmp_path, persist=True, every_n=1, bus="file",
             **eng):
    c = SIDES[side]["config"]
    eng = dict(dict(cap=32, n_slots=8, max_t=8), **eng)
    cfg = c.Config(
        bus=c.BusConfig(backend=bus, dir=str(tmp_path / "bus")),
        engine=c.EngineConfig(**eng),
        persist=c.PersistConfig(dir=str(tmp_path / "snaps"),
                                every_n_batches=every_n),
    )
    p = SIDES[side]["persist"].Persister(cfg.persist) if persist else None
    return SIDES[side]["service"](cfg, persist=p, **SIDES[side]["kw"])


def ref_svc(side, **eng):
    """An uninterrupted run's service: memory bus, no Persister."""
    c = SIDES[side]["config"]
    eng = dict(dict(cap=32, n_slots=8, max_t=8), **eng)
    return SIDES[side]["service"](c.Config(engine=c.EngineConfig(**eng)),
                                  **SIDES[side]["kw"])


def feed(side, svc, orders):
    """The gateway's side: mark each ADD's key, publish its JSON body."""
    for o in map(SIDES[side]["order"], orders):
        svc.engine.mark(o)
        svc.bus.order_queue.publish(SIDES[side]["bus"].encode_order(o))


def bodies(svc) -> list[bytes]:
    mq = svc.bus.match_queue
    return [m.body for m in mq.read_from(0, mq.end_offset())]


def state(svc) -> dict:
    return svc.engine.batch.export_state()


def assert_states_equal(a: dict, b: dict) -> None:
    """export_state dicts equal: every book leaf (dtype, shape, values)
    and every other key."""
    assert set(a) == set(b)
    for k in a:
        if k == "books":
            assert set(a[k]) == set(b[k])
            for leaf in a[k]:
                x, y = np.asarray(a[k][leaf]), np.asarray(b[k][leaf])
                assert x.dtype == y.dtype and x.shape == y.shape, leaf
                np.testing.assert_array_equal(x, y, err_msg=leaf)
        else:
            assert a[k] == b[k], k


def both(fn, tmp_path):
    """Run a flow on both packages (each in its own directory); the port's
    result must equal gome_tpu's."""
    j = fn(J, tmp_path / "j")
    t = fn(T, tmp_path / "t")
    assert t == j
    return t


# -- tests/test_persist.py ---------------------------------------------------


def test_crash_recovery_exactly_once(tmp_path):
    """Half the stream, snapshot, the rest, then a crash (a new service
    over the same dirs) without a newer snapshot: the restore rewinds to
    the cut and the replay regenerates the match tail byte for byte."""
    orders = mixed_stream(n=200, seed=3, cancel_prob=0.25)

    def flow(side, path):
        ref = ref_svc(side)
        feed(side, ref, orders)
        ref.pump()
        svc = make_svc(side, path, every_n=10**9)
        svc.persist.restore_latest()
        feed(side, svc, orders[:100])
        svc.consumer.drain()
        svc.persist.snapshot()
        cut = svc.bus.order_queue.committed()
        match_end = svc.bus.match_queue.end_offset()
        feed(side, svc, orders[100:])
        svc.consumer.drain()
        assert svc.bus.match_queue.end_offset() > match_end

        svc2 = make_svc(side, path, every_n=10**9)
        assert svc2.persist.restore_latest()
        assert svc2.bus.order_queue.committed() == cut
        assert svc2.bus.order_queue.end_offset() > cut
        assert svc2.bus.match_queue.end_offset() == match_end
        assert svc2.consumer.drain() == len(orders) - 100
        assert bodies(svc2) == bodies(ref)
        a, b = state(ref), state(svc2)
        assert a["symbols"] == b["symbols"]
        for leaf in ("lots", "count"):
            np.testing.assert_array_equal(a["books"][leaf], b["books"][leaf])
        return bodies(svc2), svc2.persist.probe()["last_restore"]

    assert both(flow, tmp_path)[1] == "restored"


def test_recovery_without_any_snapshot_replays_all(tmp_path):
    orders = mixed_stream(n=60, seed=5, cancel_prob=0.2)

    def flow(side, path):
        svc = make_svc(side, path, persist=False)
        feed(side, svc, orders)
        svc.consumer.drain()
        svc2 = make_svc(side, path)
        assert not svc2.persist.restore_latest()
        assert svc2.bus.order_queue.committed() == 0
        svc2.consumer.drain()
        assert bodies(svc2) == bodies(svc)
        assert_states_equal(state(svc2), state(svc))
        return bodies(svc2), svc2.persist.last_restore

    assert both(flow, tmp_path)[1] == "replayed"


def key_orders():
    add = Order(uuid="u", oid="x", symbol="s", side=Side.BUY,
                price=scale(1.0), volume=scale(1.0))
    dele = Order(uuid="u", oid="x", symbol="s", side=Side.BUY,
                 price=scale(1.0), volume=scale(1.0), action=Action.DEL)
    return add, dele


def publish(side, svc, order):
    o = SIDES[side]["order"](order)
    svc.bus.order_queue.publish(SIDES[side]["bus"].encode_order(o))


def test_recovery_does_not_resurrect_cancelled_order(tmp_path):
    """A DEL consumed below the cut suppresses the mark rebuild of a
    same-key ADD queued after it and never consumed."""
    add, dele = key_orders()
    probe = Order(uuid="v", oid="probe", symbol="s", side=Side.SALE,
                  price=scale(1.0), volume=scale(1.0))

    def flow(side, path):
        svc = make_svc(side, path)
        publish(side, svc, dele)
        svc.consumer.drain()
        svc.persist.snapshot()
        publish(side, svc, add)
        svc2 = make_svc(side, path)
        assert svc2.persist.restore_latest()
        svc2.consumer.drain()
        feed(side, svc2, [probe])
        svc2.consumer.drain()
        assert bodies(svc2) == []
        books = svc2.engine.batch.lane_books()
        assert int(np.asarray(books.count).sum()) == 1
        return state(svc2)["oids"], sorted(svc2.engine.pre_pool)

    both(flow, tmp_path)


def test_uncommitted_tail_replays_after_crash(tmp_path):
    orders = mixed_stream(n=40, seed=7)

    def flow(side, path):
        svc = make_svc(side, path)
        feed(side, svc, orders)
        svc2 = make_svc(side, path)
        svc2.persist.restore_latest()
        assert svc2.consumer.drain() == len(orders)
        ref = ref_svc(side)
        feed(side, ref, orders)
        ref.pump()
        assert bodies(svc2) == bodies(ref)
        return bodies(svc2), svc2.persist.wal_replay_frames

    assert both(flow, tmp_path)[1] == len(orders)


def test_recovery_readmits_consumed_add_after_old_del(tmp_path):
    """An ADD the crashed process admitted after the cut replays as
    admitted although an old DEL of its key sits below the cut."""
    key_add, key_del = key_orders()
    ask = Order(uuid="v", oid="a", symbol="s", side=Side.SALE,
                price=scale(1.0), volume=scale(1.0))

    def flow(side, path):
        svc = make_svc(side, path, every_n=10**9)
        publish(side, svc, key_del)
        svc.consumer.drain()
        svc.persist.snapshot()
        feed(side, svc, [ask, key_add])
        svc.consumer.drain()
        pre_crash = bodies(svc)
        assert len(pre_crash) == 1
        svc2 = make_svc(side, path, every_n=10**9)
        assert svc2.persist.restore_latest()
        svc2.consumer.drain()
        assert bodies(svc2) == pre_crash
        return pre_crash

    both(flow, tmp_path)


@pytest.mark.parametrize("side", [J, T])
def test_snapshot_store_atomicity_and_pruning(tmp_path, side):
    store = SIDES[side]["persist"].SnapshotStore(str(tmp_path / "s"), keep=2)
    for i in range(4):
        store.save({"i": i}, {"a": np.arange(i + 1)})
    assert len(store._ids()) == 2
    manifest, books = store.load_latest()
    assert manifest["i"] == 3 and len(books["a"]) == 4
    torn = tmp_path / "s" / "snap-99"
    torn.mkdir()
    (torn / "books.npz").write_bytes(b"garbage")
    manifest, _ = store.load_latest()
    assert manifest["i"] == 3


class FakeRedis:
    """Minimal execute_command target for the gated export."""

    def __init__(self):
        self.zsets: dict[str, dict[str, float]] = {}
        self.hashes: dict[str, dict[str, str]] = {}
        self.commands: list[tuple] = []

    def execute_command(self, *args):
        self.commands.append(args)
        cmd = args[0]
        if cmd == "ZADD":
            self.zsets.setdefault(args[1], {})[args[3]] = args[2]
        elif cmd == "HSET":
            self.hashes.setdefault(args[1], {})[args[2]] = args[3]
        elif cmd == "FLUSHDB":
            self.zsets.clear()
            self.hashes.clear()
        else:
            raise AssertionError(f"unexpected {cmd}")


def test_redis_schema_export(tmp_path):
    orders = [
        Order(uuid="7", oid="a", symbol="eth2usdt", side=Side.SALE,
              price=scale(1.0), volume=scale(5.0)),
        Order(uuid="8", oid="b", symbol="eth2usdt", side=Side.SALE,
              price=scale(1.0), volume=scale(2.0)),
        Order(uuid="9", oid="c", symbol="eth2usdt", side=Side.BUY,
              price=scale(0.5), volume=scale(1.0)),
    ]

    def flow(side, _):
        svc = ref_svc(side, n_slots=4)
        feed(side, svc, orders)
        svc.pump()
        fake = FakeRedis()
        assert SIDES[side]["schema"].export_to_redis(svc.engine,
                                                     client=fake) > 0
        assert fake.zsets["eth2usdt:SALE"] == {"100000000": 100000000.0}
        assert fake.zsets["eth2usdt:BUY"] == {"50000000": 50000000.0}
        assert fake.hashes["eth2usdt:depth"]["eth2usdt:depth:100000000"] \
            == str(scale(7.0))
        link = fake.hashes["eth2usdt:link:100000000"]
        assert link["f"] == "eth2usdt:node:a"
        assert link["l"] == "eth2usdt:node:b"
        node_a = json.loads(link["eth2usdt:node:a"])
        node_b = json.loads(link["eth2usdt:node:b"])
        assert node_a["IsFirst"] and not node_a["IsLast"]
        assert node_a["NextNode"] == "eth2usdt:node:b"
        assert node_b["PrevNode"] == "eth2usdt:node:a" and node_b["IsLast"]
        assert node_a["Volume"] == scale(5.0)
        svc.engine.pre_pool.add(("eth2usdt", "7", "zz"))
        fake2 = FakeRedis()
        SIDES[side]["schema"].export_to_redis(svc.engine, client=fake2)
        assert fake2.hashes["eth2usdt:comparison"]["eth2usdt:7:zz"] == "1"
        return fake.commands, fake2.commands

    both(flow, tmp_path)


@pytest.mark.parametrize("side", [J, T])
def test_export_without_client_requires_redis(side):
    svc = ref_svc(side, n_slots=4)
    with pytest.raises(RuntimeError, match="redis-py is not installed"):
        SIDES[side]["schema"].export_to_redis(svc.engine)


def test_queue_rollback_truncate_guards(tmp_path):
    """The file queue's rewind guards the restore relies on; a log
    truncated by one package reopens the same in the other."""
    c = tconfig
    bus = tbus.make_bus(c.BusConfig(backend="file", dir=str(tmp_path / "b")))
    q = bus.order_queue
    for i in range(5):
        q.publish(b"%d" % i)
    q.commit(4)
    with pytest.raises(ValueError, match="forwards"):
        q.rollback(5)
    q.rollback(2)
    assert q.committed() == 2
    with pytest.raises(ValueError, match="below committed"):
        q.truncate_to(1)
    q.truncate_to(3)
    assert q.end_offset() == 3
    q.close()
    for queue in (tbus.FileQueue, jbus.FileQueue):
        q2 = queue("doOrder", str(tmp_path / "b" / "doOrder"))
        assert (q2.end_offset(), q2.committed()) == (3, 2)
        assert [m.body for m in q2.read_from(0, 3)] == [b"0", b"1", b"2"]
        q2.close()


# -- tests/test_chaos.py -----------------------------------------------------


def test_recovery_rebases_and_regenerates_seqs(tmp_path):
    orders = mixed_stream(n=160, seed=9, cancel_prob=0.25)

    def flow(side, path):
        decode = SIDES[side]["bus"].decode_match_result
        ref = ref_svc(side)
        feed(side, ref, orders)
        ref.pump()
        svc = make_svc(side, path, every_n=10**9)
        svc.persist.restore_latest()
        feed(side, svc, orders[:80])
        svc.consumer.drain()
        svc.persist.snapshot()
        seq_at_cut = svc.consumer.match_seq
        feed(side, svc, orders[80:])
        svc.consumer.drain()
        svc2 = make_svc(side, path, every_n=10**9)
        assert svc2.persist.restore_latest()
        assert svc2.consumer.match_seq == seq_at_cut
        svc2.consumer.drain()
        got = bodies(svc2)
        assert got == bodies(ref)
        seqs = [decode(b).seq for b in got]
        assert seqs == list(range(len(got)))
        return got

    both(flow, tmp_path)


def stream(rng, n, oid0):
    return [Order(uuid=f"u{int(rng.integers(0, 3))}", oid=str(oid0 + i),
                  symbol=f"sym{int(rng.integers(0, 4))}",
                  side=Side(int(rng.integers(0, 2))),
                  price=100_000_000 + int(rng.integers(-500, 500)),
                  volume=int(rng.integers(1, 20)))
            for i in range(n)]


def test_redis_import_composes_with_crash_recovery(tmp_path):
    """The same Redis book imported into two services; one crashes mid
    tail and recovers to the other's exact stream and books."""
    rng = np.random.default_rng(23)
    seed_orders, tail = stream(rng, 80, 0), stream(rng, 90, 1000)

    def flow(side, path):
        if side == J:
            seeded = JEngine(config=JBookConfig(cap=32, max_fills=8),
                             n_slots=8, max_t=8)
        else:
            seeded = TEngine(TBookConfig(cap=32, max_fills=8), n_slots=8,
                             max_t=8, device="cpu")
        for o in map(SIDES[side]["order"], seed_orders):
            seeded.mark(o)
            seeded.process([o])
        store = SIDES[side]["persist"].DictRedis()
        SIDES[side]["schema"].export_to_redis(seeded, client=store)

        def boot(name):
            svc = make_svc(side, path / name, every_n=10**9)
            SIDES[side]["persist"].restore_from_redis(svc.engine, store)
            svc.persist.snapshot()
            return svc

        ref = boot("ref")
        feed(side, ref, tail)
        ref.consumer.drain()
        crashed = boot("crash")
        feed(side, crashed, tail)
        crashed.consumer.run_once()
        assert crashed.bus.order_queue.committed() > 0
        recovered = make_svc(side, path / "crash", every_n=10**9)
        assert recovered.persist.restore_latest()
        recovered.consumer.drain()
        assert bodies(recovered) == bodies(ref)
        assert_states_equal(state(recovered), state(ref))
        return bodies(recovered), store.hashes, store.zsets

    both(flow, tmp_path)


def test_durability_payload_and_persist_telemetry(tmp_path):
    def flow(side, path):
        svc = make_svc(side, path, every_n=1)
        svc.persist.restore_latest()
        feed(side, svc, mixed_stream(n=40, seed=4, cancel_prob=0.2))
        svc.pump()
        taken = svc.persist.snapshots_taken
        assert taken > 0
        payload = SIDES[side]["ops"](svc).durability_payload()
        assert payload["faults"]["enabled"] is False
        assert payload["persist"]["snapshots_taken"] == taken
        assert payload["persist"]["last_restore"] == "none"
        assert 0 <= payload["persist"]["snapshot_age_s"]
        assert payload["matchfeed"]["gaps"] == 0
        assert payload["consumer"]["match_seq"] == svc.consumer.match_seq
        q = payload["queues"]["order_queue"]
        assert q["end"] == q["committed"] > 0
        reg = SIDES[side]["registry"]()
        svc.persist.export_metrics(registry=reg)
        text = reg.render()
        assert all(name in text for name in GAUGES)
        assert set(svc.persist.probe()) == {
            "snapshots_taken", "snapshot_age_s", "snapshot_bytes",
            "last_restore", "recovery_s", "wal_replay_frames"}
        return taken, payload["queues"], svc.persist.last_snapshot_bytes

    both(flow, tmp_path)


# -- across the two packages -------------------------------------------------


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("writer", [J, T])
def test_snapshot_restores_across_packages(tmp_path, writer, dtype):
    """A snapshot and file bus written by one package, the crash recovered
    by the other: the replay's match stream is byte-equal to the writer's
    uninterrupted run and the books equal it leaf by leaf."""
    reader = T if writer == J else J
    orders = mixed_stream(n=240, seed=13, cancel_prob=0.25)
    eng = dict(dtype=dtype)
    ref = ref_svc(writer, **eng)
    feed(writer, ref, orders)
    ref.pump()
    svc = make_svc(writer, tmp_path, every_n=10**9, **eng)
    svc.persist.restore_latest()
    feed(writer, svc, orders[:120])
    svc.consumer.drain()
    svc.persist.snapshot()
    feed(writer, svc, orders[120:])
    svc.consumer.drain()  # the tail the crash throws away
    assert bodies(svc) == bodies(ref)

    other = make_svc(reader, tmp_path, every_n=10**9, **eng)
    assert other.persist.restore_latest()
    assert other.consumer.drain() == len(orders) - 120
    assert bodies(other) == bodies(ref)
    assert_states_equal(state(other), state(ref))
    assert sorted(other.engine.pre_pool) == sorted(ref.engine.pre_pool)
    assert np.asarray(state(other)["books"]["price"]).dtype == np.dtype(dtype)


class Died(BaseException):
    """FAULTS.hard_exit, caught in-process."""


@pytest.mark.parametrize("side", [J, T])
def test_torn_snapshot_rename_falls_back(tmp_path, side, monkeypatch):
    """snapshot.rename torn on the second snapshot: the manifest is cut
    inside the published directory and the process dies; the restore
    skips the torn snapshot and recovers from the first, to the stream of
    an uninterrupted run."""
    faults = SIDES[side]["faults"]
    orders = mixed_stream(n=160, seed=21, cancel_prob=0.25)

    def die(code):
        raise Died(code)

    monkeypatch.setattr(faults.FAULTS, "_exit", die)
    ref = ref_svc(side)
    feed(side, ref, orders)
    ref.pump()
    svc = make_svc(side, tmp_path, every_n=10**9)
    svc.persist.restore_latest()
    feed(side, svc, orders[:60])
    svc.consumer.drain()
    svc.persist.snapshot()
    feed(side, svc, orders[60:120])
    svc.consumer.drain()
    faults.FAULTS.install(faults.FaultPlan(faults=(
        faults.FaultSpec("snapshot.rename", mode="torn", at=(1,)),)))
    with pytest.raises(Died) as died:
        svc.persist.snapshot()
    assert died.value.args == (faults.EXIT_CODE,)
    faults.FAULTS.disable()
    assert svc.persist.store._ids() == [0, 1]  # the torn one is published
    feed(side, svc, orders[120:])

    svc2 = make_svc(side, tmp_path, every_n=10**9)
    assert svc2.persist.restore_latest()  # from snap-0
    assert svc2.bus.order_queue.committed() == 60
    svc2.consumer.drain()
    assert bodies(svc2) == bodies(ref)
    assert_states_equal(state(svc2), state(ref))


def test_kill_drill_in_subprocesses(tmp_path):
    """Two real process deaths (os._exit through FAULTS) and a clean final
    run of chip_smoke.py's durability worker on the CPU, the storage cap
    escalating from 16. persist_drill fails unless the recovered
    match-queue bodies are byte-equal to an uninterrupted worker's, the
    book digests (padding included) are equal, the events equal the
    oracle's and the seqs run 0..n-1 once each."""
    import chip_smoke

    with time_limit(120):
        drill = chip_smoke.persist_drill(
            str(tmp_path), device="cpu", n_orders=2_000, n_symbols=16,
            frame_n=128, cycles=2, timeout_s=60, cap=16, max_fills=4)
    assert [c["rc"] for c in drill["cycles"]] == [tfaults.EXIT_CODE] * 2
    final, clean = drill["final"], drill["clean"]
    assert final["completed"] and final["book_digest"] == clean["book_digest"]
    assert final["restore"]["last_restore"] == "restored"
    assert final["cap"] > 16
    assert final["feed"]["gaps"] == final["feed"]["dupes"] == 0
    assert final["delivered"] == drill["n_events"] > 0
