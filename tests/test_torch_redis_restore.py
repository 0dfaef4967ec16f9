"""The port's Redis import (persist.redis_restore) and export
(persist.redis_schema) on the CPU against gome_tpu's: the cases of
tests/test_redis_restore.py on the port's engine (export -> import round
trips, continued matching with oracle parity, marks, a reference-style
store with its quirks, geometry growth), and book_redis_commands giving
the same command list from both packages on the same state."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gome_tpu.persist as jpersist
import gome_tpu_torch.persist as tpersist
from gome_tpu.engine import BookConfig as JBookConfig
from gome_tpu.engine import MatchEngine as JEngine
from gome_tpu.oracle import OracleEngine
from gome_tpu.persist.redis_schema import export_to_redis as jexport
from gome_tpu.types import Action, Order, Side
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.persist import DictRedis, restore_from_redis
from gome_tpu_torch.persist.redis_schema import (
    book_redis_commands,
    export_to_redis,
)
from test_redis_restore import _books_semantically_equal
from test_torch_bus import plain, port_order

DTYPES = {"int32": (torch.int32, jnp.int32), "int64": (torch.int64, jnp.int64)}


def engine(dtype="int64", cap=32, max_fills=8, n_slots=8):
    return MatchEngine(BookConfig(cap=cap, max_fills=max_fills,
                                  dtype=DTYPES[dtype][0]),
                       n_slots=n_slots, max_t=8, device="cpu")


def run_marked(engine, orders):
    out = []
    for o in orders:
        engine.mark(o)
        out.extend(engine.process([o]))
    return out


def stream_fn(rng, base):
    def stream(n, oid0):
        out = []
        for i in range(n):
            is_del = i > 10 and rng.random() < 0.15
            out.append(Order(
                uuid=f"u{int(rng.integers(0, 3))}",
                oid=str(int(rng.integers(oid0, oid0 + i)) if is_del
                        else oid0 + i),
                symbol=f"sym{int(rng.integers(0, 4))}",
                side=Side(int(rng.integers(0, 2))),
                price=base + int(rng.integers(-500, 500)),
                volume=int(rng.integers(1, 20)),
                action=Action.DEL if is_del else Action.ADD,
            ))
        return out
    return stream


@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_export_import_round_trip_and_continued_matching(dtype):
    """A stream, an export to the reference schema, a restore into a
    fresh engine, then one continuation on both engines and the oracle:
    books equal after the restore, events identical after."""
    base = 10_000_000_000_000 if dtype == "int32" else 100_000_000
    stream = stream_fn(np.random.default_rng(17), base)
    a = engine(dtype)
    head = stream(150, 0)
    oracle = OracleEngine()
    for o in head:
        oracle.process(o)
    run_marked(a, [port_order(o) for o in head])
    store = DictRedis()
    export_to_redis(a, client=store)
    b = engine(dtype)
    n = restore_from_redis(b, store)
    assert n == int(np.asarray(a.batch.lane_books().count).sum())
    _books_semantically_equal(a, b)
    b.batch.verify_books()
    assert b.batch.books.price.dtype == DTYPES[dtype][0]

    tail = stream(120, 1000)
    expected = [r for o in tail for r in oracle.process(o)]
    ev_a = run_marked(a, [port_order(o) for o in tail])
    ev_b = run_marked(b, [port_order(o) for o in tail])
    assert plain(ev_a) == plain(ev_b) == plain(expected)
    _books_semantically_equal(a, b)


def test_pre_pool_marks_restore():
    a = engine(cap=16, max_fills=4)
    queued = port_order(Order(uuid="u9", oid="queued", symbol="sym0",
                              side=Side.BUY, price=100, volume=5))
    a.mark(queued)
    store = DictRedis()
    export_to_redis(a, client=store)
    b = engine(cap=16, max_fills=4)
    restore_from_redis(b, store)
    assert ("sym0", "u9", "queued") in b.pre_pool
    assert b.process([queued]) == []
    assert b.stats.dropped_no_prepool == 0


def test_reference_style_store_with_quirks():
    """A hand-built store the way a real gome Redis looks: float-formatted
    numerics, a leaked unreachable link entry, depth residue — the
    restore trusts the FIFO walk and warns on the depth mismatch."""
    store = DictRedis()
    sym = "eth2usdt"
    store.execute_command("ZADD", f"{sym}:SALE", 1e8, "100000000")
    link_key = f"{sym}:link:100000000"

    def node(oid, vol, prev, nxt):
        return json.dumps({
            "Uuid": "u1", "Oid": oid, "Symbol": sym, "Transaction": 1,
            "Price": 1e8, "Volume": float(vol),
            "NodeName": f"{sym}:node:{oid}",
            "IsFirst": prev is None, "IsLast": nxt is None,
            "PrevNode": f"{sym}:node:{prev}" if prev else "",
            "NextNode": f"{sym}:node:{nxt}" if nxt else "",
        })

    store.execute_command("HSET", link_key, "f", f"{sym}:node:a")
    store.execute_command("HSET", link_key, "l", f"{sym}:node:b")
    store.execute_command("HSET", link_key, f"{sym}:node:a",
                          node("a", 5e8, None, "b"))
    store.execute_command("HSET", link_key, f"{sym}:node:b",
                          node("b", 3e8, "a", None))
    store.execute_command("HSET", link_key, f"{sym}:node:leak",
                          node("leak", 7e8, "a", "b"))
    store.execute_command("HSET", f"{sym}:depth", f"{sym}:depth:100000000",
                          "800000001")

    eng = engine(cap=16, max_fills=4)
    with pytest.warns(RuntimeWarning, match="depth hash"):
        assert restore_from_redis(eng, store) == 2
    eng.batch.verify_books()
    taker = port_order(Order(uuid="t", oid="t1", symbol=sym, side=Side.BUY,
                             price=100000000, volume=800000000))
    eng.mark(taker)
    events = eng.process([taker])
    assert [e.match_node.oid for e in events] == ["a", "b"]
    assert [e.match_volume for e in events] == [500000000, 300000000]


def test_restore_grows_geometry():
    a = engine(cap=64, n_slots=32)
    orders = [port_order(Order(uuid="u", oid=str(i), symbol=f"s{i % 20}",
                               side=Side.SALE, price=100 + i, volume=1))
              for i in range(400)]
    run_marked(a, orders)
    store = DictRedis()
    export_to_redis(a, client=store)
    b = engine(cap=8, n_slots=4)
    restore_from_redis(b, store)
    assert b.batch.config.cap >= 20
    assert b.batch.n_slots >= 20
    _books_semantically_equal(a, b)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_book_redis_commands_equal_across_packages(dtype):
    """The same flow on both packages' engines (marks left queued
    included): book_redis_commands gives the same command list, and each
    package's restore of the other's store gives the same books."""
    base = 10_000_000_000_000 if dtype == "int32" else 100_000_000
    flow = stream_fn(np.random.default_rng(41), base)(200, 0)
    queued = [Order(uuid="q", oid=f"q{i}", symbol=f"sym{i}", side=Side.BUY,
                    price=base, volume=1) for i in range(3)]
    j = JEngine(config=JBookConfig(cap=32, max_fills=8,
                                   dtype=DTYPES[dtype][1]),
                n_slots=8, max_t=8)
    t = engine(dtype)
    run_marked(j, flow)
    run_marked(t, [port_order(o) for o in flow])
    for o in queued:
        j.mark(o)
        t.mark(port_order(o))
    cmds = book_redis_commands(t)
    assert cmds == jpersist.book_redis_commands(j)
    assert any(c[1].endswith(":comparison") for c in cmds)

    jstore, tstore = jpersist.DictRedis(), DictRedis()
    jexport(j, client=jstore)
    export_to_redis(t, client=tstore)
    assert (tstore.zsets, tstore.hashes) == (jstore.zsets, jstore.hashes)
    t2 = engine(dtype)
    j2 = JEngine(config=JBookConfig(cap=32, max_fills=8,
                                    dtype=DTYPES[dtype][1]),
                 n_slots=8, max_t=8)
    assert restore_from_redis(t2, jstore) == \
        tpersist.restore_from_redis(engine(dtype), tstore)
    jpersist.restore_from_redis(j2, tstore)
    _books_semantically_equal(t2, j2)
    assert sorted(t2.pre_pool) == sorted(j2.pre_pool)
