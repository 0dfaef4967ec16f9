"""The port's frame path (engine/frames.py: process_frame, apply_frame_fast,
compact_accum; MatchEngine.process_frame) on the CPU against gome_tpu's, on
the same decoded ORDER frames (gome_tpu.bus.colwire): the differential
cases of tests/test_frames.py re-run on both packages. Exact equality,
tolerance 0: EventBatch columns, the oracle's events, every book leaf
(export_state), stats, and the shape and cap class of every grid
dispatched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gome_tpu.bus import colwire
from gome_tpu.engine import BatchEngine as JBatch
from gome_tpu.engine import BookConfig as JConfig
from gome_tpu.engine import batch_step as jax_batch_step
from gome_tpu.engine import frames as jframes
from gome_tpu.engine import init_books as jax_init_books
from gome_tpu.engine.book import DeviceOp as JOp
from gome_tpu.engine.orchestrator import MatchEngine as JEngine
from gome_tpu.types import Action, Order, OrderType, Side
from gome_tpu.utils.streams import multi_symbol_stream
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.engine import frames as tframes
from gome_tpu_torch.engine.batch import BatchEngine
from gome_tpu_torch.engine.book import StepOutput
from test_frames import _oracle
from test_torch_bridge import (
    HOSTS,
    assert_host,
    event_keys,
    oracle_keys,
    random_grid,
    to_torch_orders,
    torch_dtype,
    use_host,
)
from test_torch_engine import assert_states_equal

STAT_FIELDS = ("orders", "fills", "cancels", "cancels_missed",
               "dropped_no_prepool", "device_calls", "cap_escalations",
               "grid_cap_escalations", "fill_record_escalations",
               "frame_fallbacks", "lane_growths")


def batch_pair(cap, k, n_slots, max_t, dtype="int64", **kw):
    """gome_tpu's BatchEngine and the port's (on the CPU), same geometry."""
    j = JBatch(JConfig(cap=cap, max_fills=k, dtype=jnp.dtype(dtype)),
               n_slots=n_slots, max_t=max_t, **kw)
    t = BatchEngine(BookConfig(cap=cap, max_fills=k, dtype=torch_dtype(dtype)),
                    n_slots=n_slots, max_t=max_t, device="cpu", **kw)
    return j, t


def record_steps(eng) -> list:
    """Wrap eng._step (either package) to record every grid it dispatches
    as ((rows, T), cap class, dense)."""
    calls = []
    inner = eng._step

    def step(books, ops, lane_ids=None, cap_g=None):
        calls.append((tuple(ops.action.shape), cap_g, lane_ids is not None))
        return inner(books, ops, lane_ids, cap_g)

    eng._step = step
    return calls


def frame_of(orders) -> dict:
    """gome_tpu Orders -> one decoded ORDER frame (the consumer's input)."""
    return colwire.decode_order_frame(colwire.encode_orders(orders))


def assert_batches_equal(got, want):
    assert got.columns.keys() == want.columns.keys()
    for name, w in want.columns.items():
        np.testing.assert_array_equal(got.columns[name], w, err_msg=name)
        assert got.columns[name].dtype == w.dtype, name
    assert list(got.symbols) == list(want.symbols)
    assert list(got.oid_table) == list(want.oid_table)
    assert list(got.uid_table) == list(want.uid_table)


def assert_engines_equal(t, j):
    """Every book leaf and host array (export_state) and every stat."""
    assert_states_equal(t.export_state(), j.export_state())
    for f in STAT_FIELDS:
        assert getattr(t.stats, f) == getattr(j.stats, f), f


def run_frame_pair(j, t, orders, chunk, fast):
    """Feed both BatchEngines the same frames through apply_frame_fast
    (fast) or process_frame; every EventBatch and the grids dispatched
    must be equal. Returns the events as comparable keys."""
    jsteps, tsteps = record_steps(j), record_steps(t)
    jrun = jframes.apply_frame_fast if fast else jframes.process_frame
    trun = tframes.apply_frame_fast if fast else tframes.process_frame
    got = []
    for i in range(0, len(orders), chunk):
        cols = frame_of(orders[i:i + chunk])
        want = jrun(j, cols)
        batch = trun(t, cols)
        assert_batches_equal(batch, want)
        got += event_keys(batch.to_results())
    assert tsteps == jsteps
    return got


def oracle(orders):
    return event_keys(_oracle(orders))


@pytest.mark.parametrize(
    "n_slots,chunk,fast",
    [(64, 97, False), (8, 50, False), (64, 97, True), (8, 50, True)],
)
def test_frame_path_matches_object_path_and_oracle(n_slots, chunk, fast):
    orders = multi_symbol_stream(n=400, n_symbols=6, seed=21, cancel_prob=0.2)
    j, t = batch_pair(32, 8, n_slots, 8)
    got_f = run_frame_pair(j, t, orders, chunk, fast)
    obj = BatchEngine(BookConfig(cap=32, max_fills=8), n_slots=n_slots,
                      max_t=8, device="cpu")
    tor = to_torch_orders(orders)
    got_o = []
    for i in range(0, len(tor), chunk):
        got_o += event_keys(obj.process_columnar(tor[i:i + chunk]).to_results())
    assert got_f == got_o == oracle(orders)
    t.verify_books()
    assert_engines_equal(t, j)
    bf, bo = t.lane_books(), obj.lane_books()
    for name in ("price", "lots", "seq", "count", "next_seq"):
        np.testing.assert_array_equal(getattr(bf, name), getattr(bo, name))


@pytest.mark.parametrize("fast", [False, True])
def test_frame_path_int32_rebasing_and_dropped_dels(fast):
    btc = 10_000_000_000_000
    rng = np.random.default_rng(5)
    orders = []
    for i in range(250):
        is_del = i > 20 and rng.random() < 0.2
        orders.append(Order(
            uuid=f"u{int(rng.integers(0, 3))}",
            oid=str(int(rng.integers(1, i)) if is_del else i),
            symbol=f"sym{int(rng.integers(0, 4))}",
            side=Side(int(rng.integers(0, 2))),
            price=btc + int(rng.integers(-2000, 2000)),
            volume=int(rng.integers(1, 30)),
            action=Action.DEL if is_del else Action.ADD))
    # One in-contract wrong-price cancel (the poison scenario).
    orders.append(Order(uuid="u0", oid="0", symbol="sym0", side=Side.BUY,
                        price=50_000_000, volume=0, action=Action.DEL))
    j, t = batch_pair(64, 8, 64, 8, dtype="int32")
    got = run_frame_pair(j, t, orders, 80, fast)
    assert got == oracle(orders)
    assert t.stats.cancels_missed >= 1
    t.verify_books()
    assert_engines_equal(t, j)


def test_fast_path_falls_back_on_escalation():
    """Tripped budgets (book overflow, record truncation) show in the
    compaction totals; the frame re-runs exactly."""
    orders = [Order(uuid="u", oid=str(i), symbol="s", side=Side.SALE,
                    price=100 + i, volume=1) for i in range(40)]  # cap 8
    orders.append(Order(uuid="u", oid="sweep", symbol="s", side=Side.BUY,
                        price=300, volume=1000))  # 40 fills > max_fills 4
    j, t = batch_pair(8, 4, 16, 4)
    got = run_frame_pair(j, t, orders, len(orders), fast=True)
    assert got == oracle(orders)
    assert t.stats.cap_escalations >= 1 and t.stats.frame_fallbacks == 1
    t.verify_books()
    assert_engines_equal(t, j)


@pytest.mark.parametrize("fast", [False, True])
def test_frame_path_deep_single_symbol_and_escalations(fast):
    rng = np.random.default_rng(9)
    orders = [Order(uuid="u", oid=str(i), symbol="hot",
                    side=Side(int(rng.integers(0, 2))),
                    price=100 + int(rng.integers(-3, 4)),
                    volume=int(rng.integers(1, 8))) for i in range(500)]
    # A sweep crossing far more than max_fills resting orders.
    orders.append(Order(uuid="u", oid="sweep", symbol="hot", side=Side.BUY,
                        price=200, volume=100000))
    j, t = batch_pair(16, 4, 64, 4)
    got = run_frame_pair(j, t, orders, len(orders), fast)
    assert got == oracle(orders)
    assert t.stats.cap_escalations >= 1
    t.verify_books()
    assert_engines_equal(t, j)


@pytest.mark.parametrize("fast", [False, True])
def test_frame_market_orders(fast):
    orders = [
        Order(uuid="m", oid="r1", symbol="s", side=Side.SALE, price=105,
              volume=10),
        Order(uuid="m", oid="r2", symbol="s", side=Side.SALE, price=110,
              volume=10),
        Order(uuid="t", oid="mkt", symbol="s", side=Side.BUY, price=0,
              volume=15, order_type=OrderType.MARKET),
    ]
    j, t = batch_pair(16, 8, 16, 8)
    got = run_frame_pair(j, t, orders, 3, fast)
    assert got == oracle(orders)
    assert [e[2] for e in got] == [10, 5]
    assert_engines_equal(t, j)


@pytest.mark.parametrize("fast", [False, True])
def test_frame_admission_cancel_race(fast):
    """An ADD whose mark an earlier cancel cleared drops at frame
    admission, through MatchEngine.process_frame on both packages."""
    j = JEngine(config=JConfig(cap=16, max_fills=4), n_slots=16, max_t=8)
    t = MatchEngine(BookConfig(cap=16, max_fills=4), n_slots=16, max_t=8,
                    device="cpu")
    add = Order(uuid="u", oid="1", symbol="s", side=Side.BUY, price=100,
                volume=5)
    kill = Order(uuid="u", oid="1", symbol="s", side=Side.BUY, price=100,
                 volume=0, action=Action.DEL)
    j.mark(add)
    t.mark(to_torch_orders([add])[0])
    cols = frame_of([kill, add])
    want = j.process_frame(cols, fast=fast)
    batch = t.process_frame(cols, fast=fast)
    assert len(batch) == len(want) == 0
    assert t.stats.dropped_no_prepool == j.stats.dropped_no_prepool == 1
    assert int(t.books.count.sum()) == 0
    assert_engines_equal(t.batch, j.batch)


@pytest.mark.parametrize("host", HOSTS)
def test_process_frame_marks_and_matches_a_flow(host, monkeypatch):
    """MatchEngine.process_frame with mark_frame on a Zipf flow with
    cancels, on the port's native host layer and on its Python branches:
    equal to gome_tpu's MatchEngine and to the oracle (every ADD marked at
    submit); unmark_frame clears what mark_frame set."""
    use_host(monkeypatch, host)
    orders = multi_symbol_stream(n=600, n_symbols=24, seed=5, zipf_a=1.2,
                                 cancel_prob=0.3)
    j = JEngine(config=JConfig(cap=32, max_fills=8), n_slots=64, max_t=8)
    t = MatchEngine(BookConfig(cap=32, max_fills=8), n_slots=64, max_t=8,
                    device="cpu")
    assert_host(t, host)
    got, frames = [], [frame_of(orders[i:i + 150])
                       for i in range(0, len(orders), 150)]
    for cols in frames:
        j.mark_frame(cols)
        t.mark_frame(cols)
    assert set(t.pre_pool) == set(j.pre_pool)
    for cols in frames:
        want = j.process_frame(cols)
        batch = t.process_frame(cols)
        assert_batches_equal(batch, want)
        got += event_keys(batch.to_results())
    assert got == oracle_keys(orders)
    assert_engines_equal(t.batch, j.batch)
    t.mark_frame(frames[0])
    t.unmark_frame(frames[0])
    assert not t.pre_pool


def test_fast_path_cap_below_max_fills():
    """cap < max_fills clamps the record axis K to the cap: the fast path
    decodes with the ARRAY's K and escalates when an op's fills exceed
    it."""
    orders = [Order(uuid="u", oid=f"r{i}", symbol="s", side=Side.SALE,
                    price=100 + i, volume=2) for i in range(12)]
    orders.append(Order(uuid="u", oid="sweep", symbol="s", side=Side.BUY,
                        price=200, volume=11))
    orders += [Order(uuid="u", oid=f"p{i}", symbol="s2", side=Side(i % 2),
                     price=150 + (i % 2), volume=3) for i in range(8)]
    j, t = batch_pair(4, 8, 2, 8, dtype="int32")
    got = run_frame_pair(j, t, orders, 7, fast=True)
    assert got == oracle(orders)
    t.verify_books()
    assert_engines_equal(t, j)


def test_lane_growth_survives_rollback_retry():
    """A frame that auto-grows the lane axis AND trips the fills buffer
    succeeds through the exact fallback: the rollback shrinks n_slots, and
    the retry's lane map re-grows instead of reusing cached lane ids."""
    j, t = batch_pair(256, 256, 2, 512)
    rest = [Order(uuid="u", oid=f"a{i}", symbol="s0", side=Side.SALE,
                  price=1000, volume=1) for i in range(200)]
    sweep = [Order(uuid="u", oid="big", symbol="s0", side=Side.BUY,
                   price=1000, volume=200)] + [
        Order(uuid="u", oid=f"n{i}", symbol=f"new{i}", side=Side.BUY,
              price=1000, volume=1) for i in range(3)]
    jsteps, tsteps = record_steps(j), record_steps(t)
    for orders in (rest, sweep):
        cols = frame_of(orders)
        want = jframes.apply_frame_fast(j, cols)
        batch = tframes.apply_frame_fast(t, cols)
        assert_batches_equal(batch, want)
    assert tsteps == jsteps
    assert sum(1 for e in batch.to_results() if not e.is_cancel) == 200
    assert t.n_slots >= 4 and t.stats.frame_fallbacks == 1
    assert t.stats.fills == 200
    # The sweep frame's op class (64) ratcheted its fills floor past 200.
    assert t._fills_buf_floor == j.geometry_floors()["fills_buf"]
    assert t._fills_buf_floor[64] == 256
    assert_engines_equal(t, j)


def test_orders_from_frame_matches():
    orders = multi_symbol_stream(n=80, n_symbols=5, seed=3, cancel_prob=0.3)
    cols = frame_of(orders)
    got = tframes.orders_from_frame(cols)
    assert got == to_torch_orders(jframes.orders_from_frame(cols))


# -- compact_accum against gome_tpu's on one grid's StepOutput ---------------

def _grid_outputs(seed, s=8, t=6, cap=16, k=4):
    """One grid's StepOutput (gome_tpu's scan step, after a warm-up grid)
    as JAX arrays and as the port's CPU tensors."""
    jc = JConfig(cap=cap, max_fills=k, dtype=jnp.int64)
    rng = np.random.default_rng(seed)
    books = jax_init_books(jc, s)
    books, _ = jax_batch_step(jc, books, JOp(**random_grid(
        rng, s, t, "int64", vol_hi=8)))
    _, outs = jax_batch_step(jc, books, JOp(**random_grid(
        rng, s, t, "int64", vol_hi=40)))
    touts = StepOutput(*(torch.from_numpy(np.array(a)) for a in outs))
    return jc, outs, touts


def _compact_both(jc, grids, e_fills, e_cancels):
    wide = jnp.int64
    jf = jnp.zeros((7, e_fills), wide)
    jcn = jnp.zeros((2, e_cancels), wide)
    jt = jnp.zeros((8, 4), jnp.int32)
    tf = torch.zeros((7, e_fills + 1), dtype=torch.int64)
    tcn = torch.zeros((2, e_cancels + 1), dtype=torch.int64)
    tt = torch.zeros((8, 4), dtype=torch.int32)
    for g, (jo, to) in enumerate(grids):
        jf, jcn, jt = jframes.compact_accum(jc, jo, jf, jcn, jt, np.int32(g))
        tframes.compact_accum(to, tf, tcn, tt, g)
    return (np.asarray(jf), np.asarray(jcn), np.asarray(jt)), (tf, tcn, tt)


@pytest.mark.parametrize("e_fills", [256, 8])
def test_compact_accum_matches(e_fills):
    """Two grids appended to one frame's buffers: equal event buffers (the
    [:, :e] prefix; column e is the port's sentinel) and totals. With a
    buffer smaller than the first grid's fills (e_fills=8), the appends
    past it drop and the totals still count every fill."""
    jc, jo0, to0 = _grid_outputs(1)
    _, jo1, to1 = _grid_outputs(2)
    (jf, jcn, jt), (tf, tcn, tt) = _compact_both(
        jc, [(jo0, to0), (jo1, to1)], e_fills, 64)
    np.testing.assert_array_equal(tf[:, :e_fills].numpy(), jf)
    np.testing.assert_array_equal(tcn[:, :64].numpy(), jcn)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert tf.dtype == torch.int64 and tt.dtype == torch.int32
    fills = [int((o.fill_qty > 0).sum()) for o in (to0, to1)]
    cancels = [int((o.cancel_found != 0).sum()) for o in (to0, to1)]
    assert tt[:2, 0].tolist() == fills and tt[:2, 1].tolist() == cancels
    assert tt[:2, 3].tolist() == [int(o.n_fills.max()) for o in (to0, to1)]
    assert (e_fills < fills[0]) == (e_fills == 8)
