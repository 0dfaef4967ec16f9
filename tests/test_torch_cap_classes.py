"""Per-grid cap classes in the port (engine/batch.py, engine/frames.py) on
the CPU against gome_tpu's: the cases of tests/test_cap_classes.py (all but
the mesh case) re-run on both packages. Dense and full grids run at their
own pow4 cap class, a re-slice of the shared storage; a wrong host-side
depth estimate costs a confined re-run or a frame fallback, never a
truncated book; count_ub is an upper bound re-anchored at each fetch.
Exact equality: events, book leaves, stats, count_ub and the cap class and
shape of every grid."""

import numpy as np
import pytest
import torch

from gome_tpu.engine import frames as jframes
from gome_tpu.engine.batch import CAP_CLASS_MIN as J_CAP_CLASS_MIN
from gome_tpu.engine.batch import _cap_ladder as j_cap_ladder
from gome_tpu.oracle import OracleEngine
from gome_tpu.types import Action, Order, Side
from gome_tpu_torch.engine import frames as tframes
from gome_tpu_torch.engine.batch import CAP_CLASS_MIN, _cap_ladder
from test_cap_classes import _hot_tail_orders
from test_torch_bridge import event_keys, to_torch_orders
from test_torch_frames import (
    assert_batches_equal,
    assert_engines_equal,
    batch_pair,
    frame_of,
    oracle,
    record_steps,
    run_frame_pair,
)


def test_cap_ladder():
    assert CAP_CLASS_MIN == J_CAP_CLASS_MIN == 64
    assert _cap_ladder(16) == [16]
    assert _cap_ladder(64) == [64]
    assert _cap_ladder(128) == [64, 128]
    assert _cap_ladder(256) == [64, 256]
    assert _cap_ladder(1024) == [64, 256, 1024]
    assert _cap_ladder(2048) == [64, 256, 1024, 2048]
    for cap in (1, 8, 63, 65, 100, 512, 4096, 1 << 14):
        assert _cap_ladder(cap) == j_cap_ladder(cap)


def _probe(symbols, oid, price):
    return [Order(uuid="u", oid=f"{oid}{s}", symbol=s, side=Side.BUY,
                  price=price, volume=1, action=Action.ADD) for s in symbols]


def test_heterogeneous_classes_parity_and_partition():
    """A hot lane (>64 resting) and shallow tail lanes land in different
    cap classes on both packages, and the events match the oracle."""
    j, t = batch_pair(256, 16, 64, 8)
    orders = _hot_tail_orders()
    got = run_frame_pair(j, t, orders, 90, fast=True)
    assert got == oracle(orders)
    t.verify_books()
    assert_engines_equal(t, j)
    cols = frame_of(_probe(["hot"] + [f"tail{s}" for s in range(12)], "p",
                           600))
    ta, ja = tframes._frame_arrays(t, cols), jframes._frame_arrays(j, cols)
    tparts = tframes._class_partitions(t, ta, np.nonzero(ta["keep"])[0])
    jparts = jframes._class_partitions(j, ja, np.nonzero(ja["keep"])[0])
    assert [c for c, _ in tparts] == [CAP_CLASS_MIN, 256]
    for (tc, ti), (jc, ji) in zip(tparts, jparts, strict=True):
        assert tc == jc
        np.testing.assert_array_equal(ti, ji)
    assert set(ta["lanes"][dict(tparts)[256]]) == {t.symbol_lane("hot")}


def test_grids_carry_cap_class():
    j, t = batch_pair(256, 16, 64, 8)
    orders = _hot_tail_orders(hot_depth=100)
    run_frame_pair(j, t, orders, 90, fast=False)  # seed via the exact path
    cols = frame_of(_probe(["hot", "tail0", "tail1", "tail2"], "q", 700))
    tcp, jcp = t._checkpoint(), j._checkpoint()
    tgrids = tframes.pack_frame_grids(t, tframes._frame_arrays(t, cols))
    jgrids = jframes.pack_frame_grids(j, jframes._frame_arrays(j, cols))
    t._restore(tcp)
    j._restore(jcp)
    assert sorted({g[3] for g in tgrids}) == [64, 256]
    assert len(tgrids) == len(jgrids)
    for (tops, tmeta, tids, tcap), (jops, jmeta, jids, jcap) in zip(
            tgrids, jgrids):
        assert tcap == jcap
        assert (tids is None) == (jids is None)
        if tids is not None:
            np.testing.assert_array_equal(tids, jids)
        for name in tops._fields:
            np.testing.assert_array_equal(
                getattr(tops, name).numpy(), np.asarray(getattr(jops, name)),
                err_msg=name)
        for name in jmeta:
            if not name.startswith("_"):
                np.testing.assert_array_equal(tmeta[name], jmeta[name])
    assert_engines_equal(t, j)


def _stale_ub_case(fast):
    """Both engines hold a 120-deep hot lane; then count_ub is corrupted to
    zero on both (any host-side accounting bug) and a frame hits the hot
    lane."""
    j, t = batch_pair(256, 16, 64, 8)
    orders = _hot_tail_orders(hot_depth=120)
    chunk = len(orders) if fast else len(orders) - 20
    got = run_frame_pair(j, t, orders, chunk, fast)
    for e in (j, t):
        e._ub_base[:] = 0
        e._ub_extra[:] = 0
    more = [Order(uuid="u", oid=f"z{i}", symbol="hot", side=Side.SALE,
                  price=1, volume=3, action=Action.ADD) for i in range(6)]
    got += run_frame_pair(j, t, more, len(more), fast)
    want = OracleEngine()
    return j, t, got, [e for o in orders + more for e in want.process(o)]


def test_guard_catches_stale_count_ub():
    """On the exact path the guard flags book_overflow and the grid's
    class deepens CONFINED (no storage growth); events stay exact."""
    j, t, got, want = _stale_ub_case(fast=False)
    assert got == event_keys(want)
    assert t.stats.grid_cap_escalations >= 1
    assert t.config.cap == 256  # storage untouched: confined
    t.verify_books()
    assert_engines_equal(t, j)


def test_fast_path_guard_falls_back_transactionally():
    """The same lie on the FAST path: the frame rolls back and re-runs
    exactly (frame_fallbacks), still oracle-exact."""
    j, t, got, want = _stale_ub_case(fast=True)
    assert got == event_keys(want)
    assert t.stats.frame_fallbacks >= 1
    t.verify_books()
    assert_engines_equal(t, j)


def test_count_ub_reanchors_on_resolve():
    """After a fast frame resolves, _ub_base equals the true per-lane
    max-side counts and _ub_extra is back to zero (nothing in flight)."""
    j, t = batch_pair(256, 16, 64, 8)
    orders = _hot_tail_orders(hot_depth=80)
    run_frame_pair(j, t, orders, len(orders), fast=True)
    true_counts = t.books.count.numpy().max(axis=1)
    np.testing.assert_array_equal(t._ub_base, true_counts)
    np.testing.assert_array_equal(t._ub_base, j._ub_base)
    assert int(t._ub_extra.sum()) == 0
    assert (t.count_ub() >= true_counts).all()


@pytest.mark.parametrize("columnar", [False, True])
def test_count_ub_upkeep_on_object_and_columnar_paths(columnar):
    """The object and columnar packers add every packed limit ADD to
    _ub_extra, as gome_tpu's do; a rollback restores the bound."""
    j, t = batch_pair(256, 16, 16, 8)
    orders = _hot_tail_orders(n_tail=4, hot_depth=20)
    tor = to_torch_orders(orders)
    for i in range(0, len(orders), 25):
        if columnar:
            assert_batches_equal(t.process_columnar(tor[i:i + 25]),
                                 j.process_columnar(orders[i:i + 25]))
        else:
            assert (event_keys(t.process(tor[i:i + 25]))
                    == event_keys(j.process(orders[i:i + 25])))
        np.testing.assert_array_equal(t._ub_extra, j._ub_extra)
    assert int(t._ub_extra.sum()) > 0
    cp = t._checkpoint()
    t.note_packed_adds(np.ones(t.n_slots, np.int64))
    t._restore(cp)
    np.testing.assert_array_equal(t.count_ub(), j.count_ub())


def test_cancel_of_deep_lane_after_class_runs():
    """Cancels against a deep lane see the full book after shallow-class
    grids ran on other lanes (the slice never leaks)."""
    j, t = batch_pair(256, 16, 64, 8)
    orders = _hot_tail_orders(hot_depth=120)
    run_frame_pair(j, t, orders, len(orders), fast=True)
    dels = [
        Order(uuid="u", oid="h119", symbol="hot", side=Side.BUY,
              price=1000 - 119, volume=0, action=Action.DEL),
        Order(uuid="u", oid="t0-0", symbol="tail0", side=Side.BUY,
              price=500, volume=0, action=Action.DEL),
    ]
    missed0 = t.stats.cancels_missed
    steps = record_steps(t)
    batch = tframes.apply_frame_fast(t, frame_of(dels))
    assert_batches_equal(batch, jframes.apply_frame_fast(j, frame_of(dels)))
    results = batch.to_results()
    assert len(results) == 1 and results[0].is_cancel
    assert results[0].node.oid == "h119"
    assert t.stats.cancels_missed == missed0 + 1
    assert sorted({cap for _, cap, _ in steps}) == [64, 256]
    t.verify_books()
    assert_engines_equal(t, j)
    assert int(torch.as_tensor(t.books.count).sum()) == int(
        np.asarray(j.books.count).sum())
