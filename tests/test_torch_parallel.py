"""The port's multi-card mesh (gome_tpu_torch.parallel, BatchEngine's
per-shard lane blocks) on CPU shards against gome_tpu's mesh on conftest's
virtual CPU devices, on the same seeded inputs: the cases of
tests/test_sharding.py, test_router.py, the mesh cases of test_dense.py,
test_cap_classes.py, test_frames.py, test_persist.py, test_service.py and
test_profiler.py, re-run on both packages. Exact equality, tolerance 0:
events (and the oracle's), every book leaf (export_state), every grid's
shape and cap class, and the port's mesh against its unsharded engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gome_tpu.engine import BatchEngine as JBatch
from gome_tpu.engine import BookConfig as JConfig
from gome_tpu.engine import frames as jframes
from gome_tpu.engine import init_books as jinit_books
from gome_tpu.engine.orchestrator import MatchEngine as JEngine
from gome_tpu.parallel import mesh as jmesh_mod
from gome_tpu.parallel import make_mesh as jmake_mesh
from gome_tpu.parallel import router as jrouter
from gome_tpu.types import Action, Order, OrderType, Side
from gome_tpu.utils.streams import multi_symbol_stream
from gome_tpu_torch import parallel as tpar
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.engine import frames as tframes
from gome_tpu_torch.engine.batch import BatchEngine, CapacityError
from gome_tpu_torch.engine.book import init_books
from gome_tpu_torch.ops.match_step import batch_step
from test_cap_classes import _hot_tail_orders
from test_frames import orders_to_frame
from test_sharding import CFG, _grid_from_stream, _skewed_stream
from test_torch_bridge import (
    assert_leaves_equal,
    event_keys,
    oracle_keys,
    to_torch_orders,
    torch_dtype,
    torch_ops,
)
from test_torch_engine import assert_states_equal

CPU = torch.device("cpu")


def tmesh(d):
    """The port's mesh of d shards on the CPU."""
    return tpar.make_mesh(d, devices=[CPU] * d)


# gome_tpu's mesh steppers (jitted shard_map steps), one dict per mesh
# size and kind shared by every gome_tpu engine here: an engine keeps its
# own, keyed by BookConfig, so without this each case would compile again
# the steps an earlier case compiled. A stepper closes over its config and
# an equal mesh (the same devices), so a shared one computes the same.
_JSTEPPERS: dict = {}


def share_steppers(j):
    """gome_tpu BatchEngine j with its mesh steppers shared (_JSTEPPERS)."""
    d = j.mesh.devices.size
    j._sharded_steppers = _JSTEPPERS.setdefault(("full", d), {})
    j._sharded_dense_steppers = _JSTEPPERS.setdefault(("dense", d), {})
    return j


def pair(d, cap, k, n_slots, max_t, dtype="int64", **kw):
    """gome_tpu's BatchEngine on a d-device mesh and the port's on d CPU
    shards, same geometry."""
    j = share_steppers(JBatch(
        JConfig(cap=cap, max_fills=k, dtype=jnp.dtype(dtype)),
        n_slots=n_slots, max_t=max_t, mesh=jmake_mesh(d), **kw))
    t = BatchEngine(BookConfig(cap=cap, max_fills=k, dtype=torch_dtype(dtype)),
                    n_slots=n_slots, max_t=max_t, mesh=tmesh(d), **kw)
    return j, t


def record(eng) -> list:
    """Every grid eng._step dispatches, as ((rows, T), cap class, dense),
    on either package (the port's mesh grids are Sharded)."""
    calls = []
    inner = eng._step

    def step(books, ops, lane_ids=None, cap_g=None):
        if isinstance(ops, tpar.Sharded):
            shape = (ops.rows, int(ops.blocks[0].action.shape[1]))
        else:
            shape = tuple(ops.action.shape)
        calls.append((shape, cap_g, lane_ids is not None))
        return inner(books, ops, lane_ids, cap_g)

    eng._step = step
    return calls


def run(eng, orders, mode, chunk):
    """Feed `orders` (gome_tpu's types; converted for the port) to a
    BatchEngine of either package in chunks; returns event keys."""
    port = isinstance(eng, BatchEngine)
    frames = tframes if port else jframes
    got = []
    for i in range(0, len(orders), chunk):
        part = orders[i:i + chunk]
        if mode == "process":
            got += eng.process(to_torch_orders(part) if port else part)
        elif mode == "columnar":
            got += eng.process_columnar(
                to_torch_orders(part) if port else part).to_results()
        else:
            from gome_tpu.bus import colwire

            cols = colwire.decode_order_frame(orders_to_frame(part))
            fn = (frames.apply_frame_fast if mode == "fast"
                  else frames.process_frame)
            got += fn(eng, cols).to_results()
    return event_keys(got)


def both(j, t, orders, mode, chunk=64, oracle=True):
    """Run both engines; events, grids, stats and states must be equal
    (and equal to the oracle's)."""
    jc, tc = record(j), record(t)
    want = run(j, orders, mode, chunk)
    got = run(t, orders, mode, chunk)
    assert got == want
    if oracle:
        assert got == oracle_keys(orders)
    assert tc == jc
    for f in ("device_calls", "cap_escalations", "grid_cap_escalations",
              "fill_record_escalations", "lane_growths", "frame_fallbacks"):
        assert getattr(t.stats, f) == getattr(j.stats, f), f
    assert_states_equal(t.export_state(), j.export_state())
    t.verify_books()
    return tc


def assert_blocks(books, mesh, local, cap):
    """A Sharded book stack: one block per shard, on its device, each
    [local, 2, cap]."""
    assert isinstance(books, tpar.Sharded) and books.mesh is mesh
    assert len(books.blocks) == mesh.size
    for blk, dev in zip(books.blocks, mesh.devices):
        assert blk.price.device == dev
        assert tuple(blk.price.shape) == (local, 2, cap)
        assert tuple(blk.count.shape) == (local, 2)


def jhost(tree):
    return jax.tree.map(lambda a: np.asarray(jax.device_get(a)), tree)


# -- make_mesh -----------------------------------------------------------------


def test_make_mesh_counts_cards_and_names_devices():
    """Without a card make_mesh(n) raises (no CPU fallback, no smaller
    mesh: the counterpart of test_frames.py:444's make_mesh(64)); named
    devices build that many shards."""
    assert len(jax.devices()) == 8
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="devices"):
            tpar.make_mesh(2)
        with pytest.raises(ValueError, match="devices"):
            tpar.multihost_mesh()
    with pytest.raises(ValueError, match="devices"):
        tpar.make_mesh(64)
    m = tmesh(8)
    assert m.size == 8 and m.home == CPU and m.axis_names == ("sym",)
    with pytest.raises(ValueError, match="devices"):
        tpar.make_mesh(4, devices=[CPU] * 2)
    rule = tpar.symbol_sharding(tmesh(4))
    assert [rule.bounds(16, d) for d in range(4)] == [
        (0, 4), (4, 8), (8, 12), (12, 16)]
    with pytest.raises(ValueError, match="mesh size"):
        rule.local(10)


# -- tests/test_sharding.py ------------------------------------------------


def _port_step(cfg, mesh, books, ops):
    return tpar.sharded_batch_step(cfg, mesh)(
        tpar.shard_batch(mesh, books), tpar.shard_batch(mesh, ops))


def test_sharded_step_matches_single_device():
    n_slots, max_t = 16, 4
    orders = multi_symbol_stream(n=48, n_symbols=16, seed=1)
    ops = _grid_from_stream(None, orders, n_slots, max_t)
    cfg = BookConfig(cap=CFG.cap, max_fills=CFG.max_fills)
    mesh = tmesh(8)
    tb = init_books(cfg, n_slots, CPU)
    got_books, got_outs = _port_step(cfg, mesh, tb, torch_ops(ops._asdict()))
    ref_books, ref_outs = batch_step(cfg, tb, torch_ops(ops._asdict()))
    assert_leaves_equal(got_books.host(), ref_books)
    assert_leaves_equal(got_outs.host(), ref_outs)
    jm = jmake_mesh(8)
    jb, jo = jmesh_mod.sharded_batch_step(CFG, jm)(
        jmesh_mod.shard_batch(jm, jinit_books(CFG, n_slots)),
        jmesh_mod.shard_batch(jm, ops))
    assert_leaves_equal(got_books.host(), jhost(jb))
    assert_leaves_equal(got_outs.host(), jhost(jo))


def test_sharded_kernel_step_matches_gome_tpu_pallas_and_keeps_blocks():
    """The per-shard K1 step (its plain version here) against gome_tpu's
    per-chip Pallas kernel under shard_map (interpret mode); the result
    stays in per-shard blocks on their devices (test_sharding.py's
    sharding check)."""
    cfg32 = JConfig(cap=32, max_fills=8, dtype=jnp.int32)
    n_slots, max_t = 16, 4
    orders = multi_symbol_stream(n=48, n_symbols=16, seed=3, cancel_prob=0.1)
    from gome_tpu.engine.batch import _nop_grid
    from gome_tpu.engine.book import DeviceOp as JOp
    from gome_tpu.engine.host import Interner, encode_op

    grid = _nop_grid(cfg32, n_slots, max_t)
    oids, uids, syms = Interner(), Interner(), Interner()
    level = {}
    for order in orders:
        lane = syms.intern(order.symbol) - 1
        t = level.get(lane, 0)
        if t >= max_t:
            continue
        op = encode_op(order, oids, uids, dtype=np.int32)
        for name, arr in grid.items():
            arr[lane, t] = getattr(op, name)
        level[lane] = t + 1
    jm = jmake_mesh(8)
    jb, jo = jmesh_mod.sharded_batch_step(
        cfg32, jm, kernel="pallas", pallas_interpret=True
    )(jmesh_mod.shard_batch(jm, jinit_books(cfg32, n_slots)),
      jmesh_mod.shard_batch(jm, JOp(**grid)))
    cfg = BookConfig(cap=32, max_fills=8, dtype=torch.int32)
    mesh = tmesh(8)
    tb, to = _port_step(cfg, mesh, init_books(cfg, n_slots, CPU),
                        torch_ops(grid))
    assert_leaves_equal(tb.host(), jhost(jb))
    assert_leaves_equal(to.host(), jhost(jo))
    assert_blocks(tb, mesh, 2, 32)
    assert all(o.n_fills.device == CPU and o.n_fills.shape[0] == 2
               for o in to.blocks)


def test_mesh_sizes_1_2_4_8():
    orders = multi_symbol_stream(n=32, n_symbols=8, seed=3)
    ops = torch_ops(_grid_from_stream(None, orders, 8, 8)._asdict())
    cfg = BookConfig(cap=CFG.cap, max_fills=CFG.max_fills)
    ref = batch_step(cfg, init_books(cfg, 8, CPU), ops)
    for n in (1, 2, 4, 8):
        mesh = tmesh(n)
        books, outs = _port_step(cfg, mesh, init_books(cfg, 8, CPU), ops)
        assert_blocks(books, mesh, 8 // n, cfg.cap)
        assert_leaves_equal(books.host(), ref[0])
        assert_leaves_equal(outs.gather(), ref[1])
    jm = jmake_mesh(4)
    jb, jo = jmesh_mod.sharded_batch_step(CFG, jm)(
        jmesh_mod.shard_batch(jm, jinit_books(CFG, 8)),
        jmesh_mod.shard_batch(jm, _grid_from_stream(None, orders, 8, 8)))
    assert_leaves_equal(books.host(), jhost(jb))
    assert_leaves_equal(outs.host(), jhost(jo))


def test_sharded_dense_step_matches_unsharded_and_gome_tpu():
    """sharded_dense_step on a per-shard row layout (live rows a prefix of
    each shard's block, sentinel after) against the unsharded dense step
    and gome_tpu's shard_map step."""
    rng = np.random.default_rng(7)
    j, t = pair(4, 64, 16, 128, 8)
    orders = to_torch_orders(_skewed_stream(60, 30, seed=5))
    t.process_columnar(orders)  # resting books, also on gome_tpu's side
    j.import_state(t.export_state())
    live = np.unique(rng.choice(128, 20, replace=False))
    _, n_rows, lane_ids, _ = t._grid_geometry(live)
    from test_torch_bridge import random_grid

    grid = random_grid(rng, n_rows, 8, "int64")
    grid["action"][lane_ids >= 128] = 0
    cfg = t.config
    ids_local = tpar.mesh.localize_ids(lane_ids, 128, t.mesh)
    books, outs = tpar.sharded_dense_step(cfg, t.mesh)(
        t.books, ids_local, tpar.shard_batch(t.mesh, torch_ops(grid)))
    # The unsharded full grid with each live row at its lane: the same
    # books, and the same outputs at the live rows (zeros on padding rows,
    # which carry only NOPs).
    live_rows = np.nonzero(lane_ids < 128)[0]
    full = {k: np.zeros((128, 8), v.dtype) for k, v in grid.items()}
    for k in full:
        full[k][lane_ids[live_rows]] = grid[k][live_rows]
    ub, uo = batch_step(cfg, t.books.gather(), torch_ops(full))
    assert_leaves_equal(books.host(), ub)
    got = outs.host()
    for f in got._fields:
        g, w = getattr(got, f), getattr(uo, f).numpy()
        np.testing.assert_array_equal(g[live_rows], w[lane_ids[live_rows]])
        assert not g[lane_ids >= 128].any(), f
    from gome_tpu.engine.book import DeviceOp as JOp

    jb, jo = jmesh_mod.sharded_dense_step(j.config, j.mesh)(
        j.books, jmesh_mod.shard_batch(j.mesh, jnp.asarray(
            ids_local.astype(np.int32))),
        jmesh_mod.shard_batch(j.mesh, JOp(**grid)))
    assert_leaves_equal(books.host(), jhost(jb), check_dtype=False)
    assert_leaves_equal(outs.gather(), jhost(jo), check_dtype=False)
    with pytest.raises(ValueError, match="prefix"):
        bad = ids_local.copy()
        bad[0], bad[1] = bad[1], 32  # a sentinel ahead of a live row
        tpar.sharded_dense_step(cfg, t.mesh)(
            t.books, bad, tpar.shard_batch(t.mesh, torch_ops(grid)))


@pytest.mark.parametrize("d, n_slots, n, n_symbols, seed, chunk, mode", [
    # test_batch_engine_end_to_end_parity_on_8_devices
    (8, 32, 400, 32, 5, 400, "process"),
    # test_batch_engine_mesh_param_matches_oracle (lanes grow 8 -> 24)
    (8, 8, 300, 20, 9, 64, "process"),
    # test_batch_engine_mesh_pallas_end_to_end's flow, int32
    (8, 16, 200, 8, 12, 64, "process"),
])
def test_batch_engine_on_a_mesh_matches(d, n_slots, n, n_symbols, seed,
                                        chunk, mode):
    dtype = "int32" if seed == 12 else "int64"
    cap, k = (32, 8) if seed == 12 else (64, 16)
    orders = multi_symbol_stream(n=n, n_symbols=n_symbols, seed=seed,
                                 cancel_prob=0.2 if seed == 12 else 0.1)
    j, t = pair(d, cap, k, n_slots, 8, dtype)
    both(j, t, orders, mode, chunk)
    assert t.n_slots % d == 0 and t.n_slots >= n_symbols
    assert_blocks(t.books, t.mesh, t.n_slots // d, cap)


@pytest.mark.parametrize("mode", ["columnar", "fast"])
def test_dense_grids_under_mesh_match(mode):
    """Skewed flow, n_slots 128 on 8 shards: per-shard dense grids run
    (test_dense_grids_under_mesh_match_oracle, and the frame fast path,
    test_dense_frame_path_under_mesh_matches_oracle)."""
    j, t = pair(8, CFG.cap, CFG.max_fills, 128, 8)
    grids = both(j, t, _skewed_stream(400, 40, seed=21 if mode != "fast"
                                      else 22), mode, chunk=100)
    assert any(dense for _, _, dense in grids), "no dense mesh grid ran"


def test_cap_escalation_under_mesh_dense():
    j, t = pair(8, 8, 4, 128, 8)
    orders = [
        Order(uuid="u", oid=f"r{i}", symbol="hot", side=Side.SALE,
              price=1000 + i, volume=1, action=Action.ADD,
              order_type=OrderType.LIMIT)
        for i in range(20)
    ] + [
        Order(uuid="u", oid=f"c{i}", symbol=f"cold{i}", side=Side.BUY,
              price=500, volume=1, action=Action.ADD,
              order_type=OrderType.LIMIT)
        for i in range(10)
    ]
    grids = both(j, t, orders, "columnar", chunk=len(orders))
    assert t.stats.cap_escalations >= 1 and t.config.cap >= 20
    assert any(dense for _, _, dense in grids)
    assert_blocks(t.books, t.mesh, 16, t.config.cap)


def test_fill_record_escalation_under_mesh_dense():
    j, t = pair(8, 32, 4, 128, 16)
    orders = [
        Order(uuid="u", oid=f"r{i}", symbol="hot", side=Side.SALE,
              price=1000, volume=1, action=Action.ADD,
              order_type=OrderType.LIMIT)
        for i in range(12)
    ] + [
        Order(uuid="u", oid="sweep", symbol="hot", side=Side.BUY,
              price=1000, volume=12, action=Action.ADD,
              order_type=OrderType.LIMIT),
        Order(uuid="u", oid="x1", symbol="cold1", side=Side.BUY, price=500,
              volume=1, action=Action.ADD, order_type=OrderType.LIMIT),
    ]
    both(j, t, orders, "columnar", chunk=len(orders))
    assert t.stats.fill_record_escalations >= 1


def test_small_mesh_falls_back_to_full_grid():
    """test_dense.py:132: n_slots 8 over 4 shards makes r_s * d >= n_slots,
    so every grid is a full sharded grid."""
    j, t = pair(4, 16, 4, 8, 8)
    orders = multi_symbol_stream(n=60, n_symbols=3, seed=2, cancel_prob=0.1)
    grids = both(j, t, orders, "columnar", chunk=60)
    assert not any(dense for _, _, dense in grids)


def test_classes_under_mesh_parity():
    """test_cap_classes.py:200: per-grid cap classes on per-shard blocks."""
    j, t = pair(4, 128, 16, 64, 8)
    grids = both(j, t, _hot_tail_orders(hot_depth=70, n_tail=10), "fast",
                 chunk=120)
    assert len({cap for _, cap, _ in grids}) > 1


@pytest.mark.parametrize("d", [1, 2, 4])
def test_mesh_engine_equals_unsharded_engine(d):
    """Exact paths and the fast frame path at D = 1, 2, 4 against the
    port's unsharded engine: events and every leaf."""
    orders = _skewed_stream(300, 30, seed=31, cancel_prob=0.25)
    for mode in ("exact", "fast"):
        u = BatchEngine(BookConfig(cap=16, max_fills=4), n_slots=64,
                        max_t=8, device="cpu")
        t = BatchEngine(BookConfig(cap=16, max_fills=4), n_slots=64,
                        max_t=8, device="cpu", mesh=tmesh(d))
        uc, tc = record(u), record(t)
        assert run(t, orders, mode, 75) == run(u, orders, mode, 75)
        assert_states_equal(t.export_state(), u.export_state())
        for f in ("orders", "fills", "cancels", "cancels_missed"):
            assert getattr(t.stats, f) == getattr(u.stats, f), f
        if d == 1:  # one shard: the unsharded geometry, grid for grid
            assert tc == uc and t.stats == u.stats


def test_shift_lane_prices_and_growth_per_block():
    """int32 recentering on a lane of a later shard, and lane growth that
    re-lays lanes over the blocks, against gome_tpu."""
    j, t = pair(4, 16, 4, 8, 8, "int32")
    orders = []
    for i in range(8):
        base = 1000 if i < 4 else 1000 + (1 << 30) + 5
        orders += [
            Order(uuid="u", oid=f"a{i}-{k}", symbol=f"s{k}", side=Side.BUY,
                  price=base + k, volume=1, action=Action.ADD,
                  order_type=OrderType.LIMIT)
            for k in range(12)
        ]
    both(j, t, orders, "columnar", chunk=24)
    assert t.stats.lane_growths >= 1


def test_mesh_engine_checks_geometry():
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        BatchEngine(BookConfig(cap=16, max_fills=4), n_slots=6, max_t=8,
                    mesh=tmesh(4))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        BatchEngine(BookConfig(cap=16, max_fills=4), n_slots=8, max_t=8,
                    max_slots=10, mesh=tmesh(4))
    eng = BatchEngine(BookConfig(cap=16, max_fills=4), n_slots=8, max_t=8,
                      max_slots=8, mesh=tmesh(4))
    for i in range(8):
        eng._lane(f"s{i}")
    with pytest.raises(CapacityError):
        eng._lane("one-too-many")


# -- tests/test_router.py ----------------------------------------------------


def test_routing_is_stable_and_total():
    r = tpar.ShardRouter(8)
    for sym in ("eth2usdt", "btc2usdt", "sym123", ""):
        assert 0 <= r.route(sym) < 8
        assert r.route(sym) == jrouter.ShardRouter(8).route(sym)
        assert tpar.fnv1a(sym) == jrouter.fnv1a(sym)
    with pytest.raises(ValueError):
        tpar.ShardRouter(0)


def _sharded_pair(n, **kw):
    from gome_tpu.engine import BookConfig as JC

    j = jrouter.ShardedEngine(n, config=JC(cap=32, max_fills=8), **kw)
    t = tpar.ShardedEngine(n, config=BookConfig(cap=32, max_fills=8),
                           device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("n, seed, n_symbols, chunk, cancel", [
    (4, 4, 12, 400, 0.2),   # test_sharded_engine_matches_oracle
    (3, 6, 9, 300, 0.15),   # ..._batched_exact_global_order
    (4, 11, 12, 97, 0.2),   # ..._default_process_matches_oracle
])
def test_sharded_engine_matches(n, seed, n_symbols, chunk, cancel):
    orders = multi_symbol_stream(n=chunk if chunk > 100 else 400,
                                 n_symbols=n_symbols, seed=seed,
                                 cancel_prob=cancel)
    j, t = _sharded_pair(n, n_slots=8, max_t=16)
    tor = to_torch_orders(orders)
    for a, b in zip(orders, tor):
        j.mark(a)
        t.mark(b)
    got, want = [], []
    for i in range(0, len(orders), chunk):
        got += event_keys(t.process(tor[i:i + chunk]))
        want += event_keys(j.process(orders[i:i + chunk]))
    assert got == want == oracle_keys(orders)
    single = MatchEngine(BookConfig(cap=32, max_fills=8), n_slots=16,
                         device="cpu")
    for o in tor:
        single.mark(o)
    assert event_keys(single.process(tor)) == got


def test_shards_isolated():
    from gome_tpu_torch.fixed import scale
    from gome_tpu_torch.types import Order as TOrder
    from gome_tpu_torch.types import Side as TSide

    eng = tpar.ShardedEngine(4, config=BookConfig(cap=16, max_fills=4),
                             n_slots=4, device="cpu")
    o = TOrder(uuid="u", oid="1", symbol="onlysym", side=TSide.BUY,
               price=scale(1.0), volume=scale(1.0))
    eng.mark(o)
    eng.process([o])
    owner = eng.router.route("onlysym")
    assert owner == jrouter.ShardRouter(4).route("onlysym")
    for i, shard in enumerate(eng.shards):
        count = int(shard.batch.lane_books().count.sum())
        assert count == (1 if i == owner else 0)
    assert [s.batch.device for s in eng.shards] == [CPU] * 4


# -- tests/test_persist.py ---------------------------------------------------


def _persist_pair(d, **kw):
    from gome_tpu.engine import BookConfig as JC

    j = JEngine(config=JC(cap=kw.get("cap", 32), max_fills=kw.get("k", 8)),
                n_slots=kw.get("n_slots", 8), max_t=8,
                mesh=jmake_mesh(d) if d else None,
                **({"max_slots": kw["max_slots"]} if "max_slots" in kw
                   else {}))
    if d:
        share_steppers(j.batch)
    t = MatchEngine(config=BookConfig(cap=kw.get("cap", 32),
                                      max_fills=kw.get("k", 8)),
                    n_slots=kw.get("n_slots", 8), max_t=8, device="cpu",
                    mesh=tmesh(d) if d else None,
                    **({"max_slots": kw["max_slots"]} if "max_slots" in kw
                       else {}))
    return j, t


def _feed(eng, orders):
    for o in orders:
        eng.mark(o)
    return event_keys(eng.process(orders))


def test_snapshot_while_sharded_restores_into_same_and_smaller_mesh():
    """test_persist.py:315, and on into D = 1 and no mesh."""
    orders = multi_symbol_stream(n=240, n_symbols=8, seed=9, zipf_a=1.3,
                                 cancel_prob=0.25)
    head, tail = orders[:120], orders[120:]
    ref = MatchEngine(config=BookConfig(cap=32, max_fills=8), n_slots=8,
                      max_t=8, device="cpu")
    ev_ref = _feed(ref, to_torch_orders(head)) + _feed(
        ref, to_torch_orders(tail))
    j, t = _persist_pair(4)
    ev_head = _feed(t, to_torch_orders(head))
    assert ev_head == _feed(j, head)
    state = t.batch.export_state()
    assert_states_equal(state, j.batch.export_state())
    for n_dev in (4, 2, 1, None):
        fresh = MatchEngine(config=BookConfig(cap=32, max_fills=8),
                            n_slots=8, max_t=8, device="cpu",
                            mesh=tmesh(n_dev) if n_dev else None)
        fresh.batch.import_state(state)
        assert_states_equal(fresh.batch.export_state(), state)
        assert ev_head + _feed(fresh, to_torch_orders(tail)) == ev_ref
        fresh.batch.verify_books()
        assert_states_equal(fresh.batch.export_state(),
                            ref.batch.export_state())
        if n_dev:
            assert_blocks(fresh.books, fresh.batch.mesh, 8 // n_dev, 32)


def test_restore_into_non_divisible_mesh_raises_documented_error():
    """test_persist.py:364; the port refuses before changing anything."""
    src = MatchEngine(config=BookConfig(cap=16, max_fills=4), n_slots=8,
                      max_t=8, device="cpu")
    orders = to_torch_orders(multi_symbol_stream(n=40, n_symbols=4, seed=3))
    _feed(src, orders)
    state = src.batch.export_state()
    tgt = MatchEngine(config=BookConfig(cap=16, max_fills=4), n_slots=9,
                      max_t=8, mesh=tmesh(3), max_slots=12, device="cpu")
    before = tgt.batch.export_state()
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tgt.batch.import_state(state)
    assert_states_equal(tgt.batch.export_state(), before)


def test_cap_escalated_snapshot_restores_into_mesh():
    """test_persist.py:392, both packages."""
    rest = [
        Order(uuid="u", oid=f"r{i}", symbol="hot", side=Side.SALE,
              price=1000 + i, volume=1, action=Action.ADD,
              order_type=OrderType.LIMIT)
        for i in range(20)
    ]
    taker = [Order(uuid="u", oid="t", symbol="hot", side=Side.BUY,
                   price=1030, volume=25, action=Action.ADD,
                   order_type=OrderType.LIMIT)]
    src = MatchEngine(config=BookConfig(cap=8, max_fills=4), n_slots=8,
                      max_t=8, device="cpu")
    assert _feed(src, to_torch_orders(rest)) == []
    assert src.batch.stats.cap_escalations >= 1
    state = src.batch.export_state()
    j, t = _persist_pair(4, cap=8, k=4)
    j.batch.import_state(state)
    t.batch.import_state(state)
    assert t.config.cap == j.config.cap == src.config.cap > 8
    got = [e for e in _feed(t, to_torch_orders(taker)) if e[2] > 0]
    want = [e for e in _feed(j, taker) if e[2] > 0]
    assert got == want == [e for e in oracle_keys(rest + taker) if e[2] > 0]
    t.batch.verify_books()
    assert_states_equal(t.batch.export_state(), j.batch.export_state())


@pytest.mark.parametrize("writer", ["gome_tpu", "port"])
def test_mesh_snapshot_restores_across_packages(tmp_path, writer):
    """A snapshot written by one package's D=4 mesh engine (snap-<n>/ on
    disk) restored into the other package's D=2 mesh: books equal, and
    the continued stream equal on both."""
    from gome_tpu.persist import snapshot as jsnap
    from gome_tpu_torch.persist import snapshot as tsnap

    orders = multi_symbol_stream(n=200, n_symbols=12, seed=17,
                                 cancel_prob=0.25)
    head, tail = orders[:120], orders[120:]
    j4, t4 = _persist_pair(4, n_slots=16)
    if writer == "port":
        _feed(t4, to_torch_orders(head))
        w, w_snap, r_snap = t4, tsnap, jsnap
    else:
        _feed(j4, head)
        w, w_snap, r_snap = j4, jsnap, tsnap
    st = w.batch.export_state()
    w_snap.SnapshotStore(str(tmp_path)).save(
        {k: v for k, v in st.items() if k != "books"}, st["books"])
    j2, t2 = _persist_pair(2, n_slots=16)
    r = t2 if writer == "gome_tpu" else j2
    manifest, books = r_snap.SnapshotStore(str(tmp_path)).load_latest()
    r.batch.import_state({**manifest, "books": books})
    assert_states_equal(r.batch.export_state(), st)
    tor = to_torch_orders(tail)
    got = _feed(r, tor if r is t2 else tail)
    want = _feed(w, tor if w is t4 else tail)
    assert got == want


def test_restore_from_redis_rounds_n_slots_to_the_mesh():
    """redis_restore rounds n_slots up to the mesh size, as gome_tpu's
    does (5 symbols over a 3-shard mesh of 3 lanes: 8 lanes -> 9)."""
    from gome_tpu.persist import redis_restore as jrr
    from gome_tpu.persist import redis_schema as jrs
    from gome_tpu_torch.persist import redis_restore as trr

    orders = multi_symbol_stream(n=120, n_symbols=5, seed=2)
    src = JEngine(config=JConfig(cap=16, max_fills=4), n_slots=8, max_t=8)
    _feed(src, orders)
    store = jrr.DictRedis()
    jrs.export_to_redis(src, client=store)
    j, t = _persist_pair(3, cap=16, k=4, n_slots=3, max_slots=48)
    n_j = jrr.restore_from_redis(j, store)
    n_t = trr.restore_from_redis(t, store)
    assert n_t == n_j > 0
    assert t.batch.n_slots == j.batch.n_slots == 9
    assert_states_equal(t.batch.export_state(), j.batch.export_state())
    assert_blocks(t.books, t.batch.mesh, 3, t.config.cap)


# -- tests/test_service.py:333 -------------------------------------------------


def test_engine_service_mesh_devices_config():
    from gome_tpu.api import order_pb2 as jpb
    from gome_tpu.config import Config as JCfg
    from gome_tpu.config import EngineConfig as JEc
    from gome_tpu.config import GrpcConfig as JGc
    from gome_tpu.service.app import EngineService as JService
    from gome_tpu_torch.api import order_pb2 as tpb
    from gome_tpu_torch.config import Config, EngineConfig, GrpcConfig
    from gome_tpu_torch.service.app import EngineService

    t = EngineService(Config(grpc=GrpcConfig(port=0), engine=EngineConfig(
        cap=16, n_slots=8, max_t=8, mesh_devices=4)), device="cpu")
    j = JService(JCfg(grpc=JGc(port=0), engine=JEc(
        cap=16, n_slots=8, max_t=8, mesh_devices=4)))
    mesh = t.engine.batch.mesh
    assert mesh is not None and mesh.size == 4
    assert mesh.devices == (CPU,) * 4
    bodies = []
    for svc, pb in ((t, tpb), (j, jpb)):
        for oid, side in (("a", pb.SALE), ("b", pb.BUY)):
            r = svc.gateway.DoOrder(pb.OrderRequest(
                uuid="u", oid=oid, symbol="eth2usdt", transaction=side,
                price=2.0, volume=1.0), None)
            assert r.code == 0
        svc.pump()
        bodies.append([m.body for m in svc.bus.match_queue.read_from(0, 100)])
    assert len(bodies[0]) == 1 and bodies[0] == bodies[1]
    assert_blocks(t.engine.books, mesh, 2, 16)


# -- tests/test_profiler.py:282 (the mesh part) ------------------------------


def test_shard_execution_report_on_two_shards():
    from gome_tpu.engine.batch import _nop_grid

    cfg = BookConfig(cap=8, max_fills=4)
    mesh = tmesh(2)
    eng = BatchEngine(cfg, n_slots=64, max_t=4, mesh=mesh)
    j = JBatch(JConfig(cap=8, max_fills=4), n_slots=64, max_t=4,
               mesh=jmake_mesh(2))
    live = np.array([0, 1, 2, 35], dtype=np.int64)
    got = eng._grid_geometry(live)
    want = j._grid_geometry(live)
    assert got[0] and got[1] == want[1] == 16
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3][live], want[3][live])
    ops = torch_ops(_nop_grid(JConfig(cap=8, max_fills=4), 16, 4))
    rep = tpar.shard_execution_report(cfg, mesh, eng.books, got[2], ops,
                                      repeats=1)
    jrep = jmesh_mod.shard_execution_report(
        JConfig(cap=8, max_fills=4), j.mesh, j.books, want[2],
        jax.tree.map(np.asarray, jframes_ops(16)), repeats=1)
    for key in ("n_shards", "rows_per_shard", "dispatched_rows",
                "live_lanes"):
        assert rep[key] == jrep[key], key
    assert [s["live_lanes"] for s in rep["shards"]] == [3, 1]
    assert all(s["rows"] == 8 and s["exec_ms"] > 0 for s in rep["shards"])
    assert rep["live_skew"] == pytest.approx(1.5)
    assert rep["rows_per_live_lane"] == pytest.approx(4.0)
    assert rep["exec_ms_max"] >= rep["exec_ms_mean"]
    assert int(tpar.global_fill_rate(
        tpar.sharded_batch_step(cfg, mesh)(
            eng.books, tpar.shard_batch(mesh, torch_ops(
                _nop_grid(JConfig(cap=8, max_fills=4), 64, 4))))[1])) == 0


def jframes_ops(rows):
    from gome_tpu.engine.batch import _nop_grid
    from gome_tpu.engine.book import DeviceOp as JOp

    return JOp(**_nop_grid(JConfig(cap=8, max_fills=4), rows, 4))
