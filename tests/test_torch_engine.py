"""The port's MatchEngine (process / process_columnar) on the CPU against
gome_tpu's MatchEngine and the oracle: mixed streams with markets, a Zipf
multi-symbol flow (dense grids), cap and fill-record escalation, int32
recentering on drifting prices, lane growth, and rollback of a batch that
raises. Events, EventBatch columns and export_state() must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gome_tpu.engine import BookConfig as JConfig
from gome_tpu.engine import MatchEngine as JEngine
from gome_tpu.types import Action as JAction
from gome_tpu.types import Order as JOrder
from gome_tpu.types import Side as JSide
from gome_tpu.utils import streams as jstreams
from gome_tpu_torch.engine import BookConfig, CapacityError, MatchEngine
from gome_tpu_torch.engine.batch import BatchEngine, BookInvariantError
from gome_tpu_torch.types import Action, Order, Side
from test_torch_bridge import (
    DTYPES,
    event_keys,
    oracle_keys,
    to_torch_orders,
    torch_dtype,
)

STAT_FIELDS = ("orders", "fills", "cancels", "cancels_missed",
               "dropped_no_prepool", "device_calls", "cap_escalations",
               "fill_record_escalations", "lane_growths")


def engines(dtype, cap, k, n_slots, max_t, **kw):
    j = JEngine(JConfig(cap=cap, max_fills=k, dtype=jnp.dtype(dtype)),
                n_slots=n_slots, max_t=max_t, **kw)
    t = MatchEngine(BookConfig(cap=cap, max_fills=k, dtype=torch_dtype(dtype)),
                    n_slots=n_slots, max_t=max_t, device="cpu", **kw)
    return j, t


def assert_states_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name, w in want["books"].items():
        g = got["books"][name]
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        assert g.dtype == np.asarray(w).dtype, name
    for key in want:
        if key != "books":
            assert got[key] == want[key], key


def assert_stats_equal(t, j):
    for f in STAT_FIELDS:
        assert getattr(t.stats, f) == getattr(j.stats, f), f


def run_pair(j, t, orders, batch, columnar):
    """Mark every ADD, feed both engines the same micro-batches; returns
    (port events, JAX events) as comparable keys."""
    tor = to_torch_orders(orders)
    for a, b in zip(orders, tor):
        j.mark(a)
        t.mark(b)
    got, want = [], []
    for i in range(0, len(orders), batch):
        if columnar:
            tb = t.process_columnar(tor[i:i + batch])
            jb = j.process_columnar(orders[i:i + batch])
            assert tb.columns.keys() == jb.columns.keys()
            for name in jb.columns:
                np.testing.assert_array_equal(tb.columns[name],
                                              jb.columns[name], err_msg=name)
                assert tb.columns[name].dtype == jb.columns[name].dtype
            got += event_keys(tb.to_results())
            want += event_keys(jb.to_results())
        else:
            got += event_keys(t.process(tor[i:i + batch]))
            want += event_keys(j.process(orders[i:i + batch]))
    return got, want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("columnar", [False, True])
def test_mixed_stream_with_markets_matches(dtype, columnar):
    orders = jstreams.mixed_stream(n=160, seed=4, cancel_prob=0.3,
                                   market_prob=0.2)
    j, t = engines(dtype, cap=8, k=2, n_slots=4, max_t=8)
    got, want = run_pair(j, t, orders, 80, columnar)
    assert got == want == oracle_keys(orders)
    assert_states_equal(t.batch.export_state(), j.batch.export_state())
    assert_stats_equal(t, j)
    # Both escalations ran: cap 8 and K 2 are too small for this flow.
    assert t.stats.cap_escalations > 0 and t.stats.fill_record_escalations > 0
    assert t.config.cap == j.config.cap > 8
    t.batch.verify_books()


@pytest.mark.parametrize("dtype", DTYPES)
def test_zipf_multi_symbol_flow_on_dense_grids_matches(dtype):
    orders = jstreams.multi_symbol_stream(n=500, n_symbols=40, seed=2,
                                          zipf_a=1.2, cancel_prob=0.3)
    j, t = engines(dtype, cap=16, k=4, n_slots=64, max_t=8)
    got, want = run_pair(j, t, orders, 250, columnar=True)
    assert got == want == oracle_keys(orders)
    assert t.batch._dense_rows_floor  # dense grids were used
    assert_states_equal(t.batch.export_state(), j.batch.export_state())
    assert_stats_equal(t, j)


def test_int32_recenter_on_drifting_prices_matches():
    """Prices drift by more than REBASE_LIMIT ticks: the lane's base is
    recentred and its resting prices shifted on the device."""
    btc = 10_000_000_000_000
    step = BatchEngine.REBASE_LIMIT // 3
    rng = np.random.default_rng(8)
    orders = []
    for i in range(90):
        if i > 5 and rng.random() < 0.2:
            ref = orders[int(rng.integers(0, len(orders)))]
            orders.append(JOrder(uuid=ref.uuid, oid=ref.oid, symbol="btc",
                                 side=ref.side, price=ref.price, volume=0,
                                 action=JAction.DEL))
            continue
        orders.append(JOrder(
            uuid="u", oid=f"d{i}", symbol="btc",
            side=JSide(int(rng.integers(0, 2))),
            price=btc + (i // 10) * step + int(rng.integers(-1000, 1000)),
            volume=int(rng.integers(1, 20))))
    j, t = engines("int32", cap=16, k=4, n_slots=2, max_t=16)
    first_base = None
    got, want = [], []
    for i in range(0, len(orders), 30):
        g, w = run_pair(j, t, orders[i:i + 30], 30, columnar=False)
        got, want = got + g, want + w
        first_base = first_base or int(t.batch.price_base[0])
    assert got == want == oracle_keys(orders)
    assert int(t.batch.price_base[0]) != first_base  # the base was recentred
    assert_states_equal(t.batch.export_state(), j.batch.export_state())
    np.testing.assert_array_equal(t.batch.lane_books().price,
                                  np.asarray(j.batch.lane_books().price))


def test_lane_growth_matches():
    orders = jstreams.multi_symbol_stream(n=120, n_symbols=11, seed=6,
                                          cancel_prob=0.2)
    j, t = engines("int64", cap=16, k=4, n_slots=2, max_t=8)
    got, want = run_pair(j, t, orders, 50, columnar=True)
    assert got == want == oracle_keys(orders)
    assert t.stats.lane_growths == j.stats.lane_growths > 0
    assert_states_equal(t.batch.export_state(), j.batch.export_state())


def test_unrepresentable_cancel_price_is_a_missed_cancel():
    j, t = engines("int32", cap=8, k=2, n_slots=2, max_t=8)
    rest = jstreams.mixed_stream(n=6, seed=1, cancel_prob=0.0)
    far = JOrder(uuid=rest[0].uuid, oid=rest[0].oid, symbol=rest[0].symbol,
                 side=rest[0].side, price=rest[0].price + (1 << 40),
                 volume=1, action=JAction.DEL)
    for columnar in (False, True):
        got, want = run_pair(j, t, rest + [far], 10, columnar)
        assert got == want
    assert_stats_equal(t, j)
    assert t.stats.cancels_missed == 2


def _deep_orders(symbol, n, start=0):
    """n BUY limit orders that never cross: the side only grows."""
    return [Order(uuid="u", oid=f"{symbol}{start + i}", symbol=symbol,
                  side=Side.BUY, price=1000 - i, volume=5)
            for i in range(n)]


def _cancels(orders):
    return [Order(uuid=o.uuid, oid=o.oid, symbol=o.symbol, side=o.side,
                  price=o.price, volume=0, action=Action.DEL) for o in orders]


@pytest.mark.parametrize("columnar", [False, True])
def test_capacity_error_mid_batch_rolls_back(columnar):
    """A batch whose second grid needs more than max_cap raises
    CapacityError after the first grid committed; the engine rolls back, so
    export_state() equals the state before the batch, and the consumed
    pre-pool marks are restored. (The batch reuses interned ids: interner
    growth is grow-only by design and is not part of the rollback.)"""
    eng = MatchEngine(BookConfig(cap=4, max_fills=2, dtype=torch.int32),
                      n_slots=2, max_t=4, max_cap=4, device="cpu", dense=False)
    a, b = _deep_orders("a", 6), _deep_orders("b", 2)
    for chunk in (a[:4] + b, _cancels(a[:4]), a[4:], _cancels(a[4:])):
        for o in chunk:
            eng.mark(o)
        eng.process(chunk)
    eng.process(b[:1])  # b0 dropped (unmarked): books unchanged
    before = eng.batch.export_state()
    books_before = eng.books
    calls_before = eng.stats.device_calls
    for o in a:
        eng.mark(o)
    marks = set(eng.pre_pool)
    run = eng.process_columnar if columnar else eng.process
    with pytest.raises(CapacityError, match="max_cap"):
        run(a)  # grid 1 rests a0..a3 (side full), grid 2 overflows
    assert_states_equal(eng.batch.export_state(), before)
    assert eng.books is books_before
    assert set(eng.pre_pool) == marks
    # Grid 1 ran and committed, grid 2 ran and overflowed.
    assert eng.stats.device_calls - calls_before == 2


def test_verify_books_reports_corruption():
    eng = MatchEngine(BookConfig(cap=8, max_fills=2), n_slots=2, device="cpu")
    orders = _deep_orders("a", 3)
    for o in orders:
        eng.mark(o)
    eng.process(orders)
    eng.batch.verify_books()
    price = eng.books.price.clone()
    price[0, 0, 1] = price[0, 0, 0] + 5  # bids must not rise
    eng.batch.books = eng.books._replace(price=price)
    with pytest.raises(BookInvariantError, match="priority order"):
        eng.batch.verify_books()


def test_unmarked_add_is_dropped_and_nops_never_reach_the_device():
    eng = MatchEngine(BookConfig(cap=8, max_fills=2), n_slots=2, device="cpu")
    a, b = _deep_orders("a", 2)
    eng.mark(a)
    nop = Order(uuid="u", oid="n", symbol="a", side=Side.BUY, price=1,
                volume=1, action=Action.NOP)
    assert eng.process([a, b, nop]) == []
    assert eng.stats.dropped_no_prepool == 1
    assert int(eng.books.count[0, 0]) == 1


def _cap_below_max_fills_streams():
    """(a) 3 resting SALEs then 1 BUY crossing all of them; (b) the stream
    of tests/test_frames.py::test_fast_path_cap_below_max_fills (a sweep
    across 12 resting SALEs, more than the cap, then a second symbol)."""
    rest = [JOrder(uuid="u", oid=f"r{i}", symbol="s", side=JSide.SALE,
                   price=100 + i, volume=2) for i in range(3)]
    small = rest + [JOrder(uuid="u", oid="b", symbol="s", side=JSide.BUY,
                           price=200, volume=5)]
    sweep = [JOrder(uuid="u", oid=f"r{i}", symbol="s", side=JSide.SALE,
                    price=100 + i, volume=2) for i in range(12)]
    sweep.append(JOrder(uuid="u", oid="sweep", symbol="s", side=JSide.BUY,
                        price=200, volume=11))
    sweep += [JOrder(uuid="u", oid=f"p{i}", symbol="s2", side=JSide(i % 2),
                     price=150 + (i % 2), volume=3) for i in range(8)]
    return {"small": (small, 4), "sweep": (sweep, 7)}


@pytest.mark.parametrize("stream", ["small", "sweep"])
@pytest.mark.parametrize("columnar", [False, True])
def test_cap_below_max_fills_matches(stream, columnar):
    """A book whose cap is below max_fills: every launch runs with
    K = min(max_fills, cap), as gome_tpu's step clamps its record slice
    (the port raised ValueError here before)."""
    orders, batch = _cap_below_max_fills_streams()[stream]
    j, t = engines("int32", cap=4, k=8, n_slots=2, max_t=8)
    got, want = run_pair(j, t, orders, batch, columnar)
    assert got == want == oracle_keys(orders)
    assert len(got) > 0
    assert_states_equal(t.batch.export_state(), j.batch.export_state())
    assert_stats_equal(t, j)
    t.batch.verify_books()


@pytest.mark.parametrize("dtype", DTYPES)
def test_pre_rebasing_snapshot_restores(dtype):
    """A snapshot written before price rebasing (no price_base / base_set /
    env_lo / env_hi; prices absolute) restores into both packages alike:
    gome_tpu's state with the four keys dropped and its resting prices made
    absolute is imported into a fresh engine of each, and the same second
    half of the flow gives equal events (and the oracle's) and equal state,
    the rebasing arrays included."""
    orders = jstreams.multi_symbol_stream(n=240, n_symbols=24, seed=13,
                                          zipf_a=1.2, cancel_prob=0.3)
    first, second = orders[:120], orders[120:]
    src, _ = engines(dtype, cap=8, k=2, n_slots=32, max_t=8)
    for o in first:
        src.mark(o)
    head = event_keys(src.process(first))
    state = src.batch.export_state()
    base = np.asarray(state.pop("price_base"), np.int64)
    for key in ("base_set", "env_lo", "env_hi"):
        del state[key]
    books = {k: np.asarray(v) for k, v in state["books"].items()}
    resting = (np.arange(books["price"].shape[-1])[None, None, :]
               < books["count"][:, :, None])
    if dtype == "int32":
        assert base.any()  # the flow rebased: the books hold offsets
    books["price"] = np.where(
        resting, books["price"].astype(np.int64) + base[:, None, None],
        books["price"]).astype(books["price"].dtype)
    state["books"] = books
    j, t = engines(dtype, cap=8, k=2, n_slots=32, max_t=8)
    j.batch.import_state(dict(state))
    t.batch.import_state(dict(state))
    assert_states_equal(t.batch.export_state(), j.batch.export_state())
    got, want = run_pair(j, t, second, batch=40, columnar=False)
    assert got == want
    assert head + got == oracle_keys(orders)
    assert_states_equal(t.batch.export_state(), j.batch.export_state())
    t.batch.verify_books()


def reference_calls():
    """The five signatures of both packages that take the reference's
    kernel= argument, each with its reference arguments by position and
    by keyword (gome_tpu's defaults, kernel "pallas"): (name, gome_tpu's
    callable, the port's, [(args, kwargs), ...])."""
    import gome_tpu.engine.batch as jbatch
    import gome_tpu.parallel.mesh as jmesh
    import gome_tpu.parallel.router as jrouter
    import gome_tpu_torch.parallel.mesh as tmesh
    import gome_tpu_torch.parallel.router as trouter

    cfg, mesh = object(), object()
    return [
        ("MatchEngine", JEngine, MatchEngine, [
            ((cfg, 8, 16, True, "pallas"), {}),
            ((cfg,), dict(n_slots=8, max_t=16, auto_grow=True,
                          kernel="pallas", pallas_interpret=True))]),
        ("BatchEngine", jbatch.BatchEngine, BatchEngine, [
            ((cfg, 8, 16, True, 1 << 16, 1 << 14, "pallas", True, None,
              True, 1024), {}),
            ((cfg, 8), dict(kernel="pallas", pallas_interpret=True,
                            dense=False))]),
        ("ShardedEngine", jrouter.ShardedEngine, trouter.ShardedEngine, [
            ((2, cfg, 8, 16, "pallas", None), {}),
            ((2,), dict(config=cfg, kernel="pallas"))]),
        ("sharded_batch_step", jmesh.sharded_batch_step,
         tmesh.sharded_batch_step, [((cfg, mesh, "pallas", True), {}),
                                    ((cfg, mesh), dict(kernel="pallas"))]),
        ("sharded_dense_step", jmesh.sharded_dense_step,
         tmesh.sharded_dense_step, [((cfg, mesh, "pallas", True), {}),
                                    ((cfg, mesh), dict(kernel="pallas"))]),
    ]


@pytest.mark.parametrize("name", ["MatchEngine", "BatchEngine",
                                  "ShardedEngine", "sharded_batch_step",
                                  "sharded_dense_step"])
def test_reference_kernel_arguments_bind(name):
    """The reference's kernel= (and pallas_interpret=) arguments, by
    position and by keyword, bind to the same parameters of the port's
    signature as of gome_tpu's; the port's own `device` comes after them,
    and the sharded steps add nothing (without the kernel parameter, a
    positional "pallas" lands on `device` or `engine_factory`)."""
    import inspect

    (_, jfn, tfn, calls), = [c for c in reference_calls() if c[0] == name]
    jsig, tsig = inspect.signature(jfn), inspect.signature(tfn)
    for args, kwargs in calls:
        want = jsig.bind(*args, **kwargs).arguments
        got = tsig.bind(*args, **kwargs).arguments
        assert got == want, (args, kwargs)
        assert got.get("kernel", want.get("kernel")) == "pallas"
    tnames = list(tsig.parameters)
    jnames = [n for n in jsig.parameters if n != "batch_kw"]
    assert tnames[:len(jnames)] == jnames
    assert tnames[len(jnames):] == {
        "MatchEngine": ["device", "batch_kw"], "BatchEngine": ["device"],
        "ShardedEngine": ["device"]}.get(name, [])


@pytest.mark.parametrize("kernel", ["scan", "pallas"])
def test_reference_kernel_positional_runs(kernel):
    """MatchEngine(cfg, 8, 16, True, kernel, device="cpu") runs the one
    step whatever the reference's kernel value and gives the oracle's
    events, as gome_tpu's MatchEngine does with the same arguments; a
    ShardedEngine built the reference's way matches too; an unknown
    kernel raises in both packages."""
    import gome_tpu.parallel.router as jrouter
    import gome_tpu_torch.parallel.router as trouter

    orders = jstreams.multi_symbol_stream(n=160, n_symbols=6, seed=5,
                                          zipf_a=1.2, cancel_prob=0.25)
    j = JEngine(JConfig(cap=8, max_fills=4), 8, 16, True, kernel)
    t = MatchEngine(BookConfig(cap=8, max_fills=4), 8, 16, True, kernel,
                    device="cpu")
    assert t.batch.kernel == kernel
    got, want = run_pair(j, t, orders, batch=40, columnar=False)
    assert got == want == oracle_keys(orders)
    t.batch.verify_books()
    sharded = trouter.ShardedEngine(2, BookConfig(cap=8, max_fills=4), 8,
                                    16, kernel, device="cpu")
    for o in to_torch_orders(orders):
        sharded.mark(o)
    got = [e for i in range(0, len(orders), 40)
           for e in sharded.process(to_torch_orders(orders[i:i + 40]))]
    assert event_keys(got) == oracle_keys(orders)
    for make in (lambda: JEngine(JConfig(cap=8), 8, 16, True, "triton"),
                 lambda: MatchEngine(BookConfig(cap=8), 8, 16, True,
                                     "triton", device="cpu"),
                 lambda: trouter.ShardedEngine(2, BookConfig(cap=8), 8, 16,
                                               "triton", device="cpu"),
                 lambda: jrouter.ShardedEngine(2, JConfig(cap=8), 8, 16,
                                               "triton")):
        with pytest.raises(ValueError, match="kernel must be one of"):
            make()
