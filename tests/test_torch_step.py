"""The port's step (engine/step.py::step_rows, batched over rows) against
gome_tpu.engine.step.step_impl (vmapped over rows): seeded random op
streams for both dtypes, and one case for each semantic edge the match-step
kernel must reproduce (saturation, records past n_fills, cancel sums,
overflow and next_seq, the record budget). Exact equality, tolerance 0."""

import functools

import jax
import numpy as np
import pytest
import torch

from gome_tpu.engine import book as jbook
from gome_tpu.engine.step import step_impl
from gome_tpu_torch.engine import book as tbook
from gome_tpu_torch.engine.step import LOT_MAX32, SAT32_MAX, step
from gome_tpu_torch.ops.match_step import batch_step
from test_torch_bridge import (
    DTYPES,
    assert_leaves_equal,
    jnp_dtype,
    random_grid,
    torch_books,
    torch_dtype,
)


@functools.partial(jax.jit, static_argnums=0)
def _jax_step_rows(config, books, op):
    return jax.vmap(functools.partial(step_impl, config))(books, op)


def _op(dtype, **cols):
    """One op per row from equal-length lists; missing fields are 0."""
    n = len(next(iter(cols.values())))
    d = np.dtype(dtype)
    out = {}
    for f in tbook.DeviceOp._fields:
        v = np.asarray(cols.get(f, [0] * n))
        out[f] = v.astype(np.int32 if f in tbook.GRID_I32_FIELDS else d)
    return out


def _expected_out_dtypes(tc):
    return {f: (torch.int32 if f in tbook.OUT_I32_FIELDS else tc.dtype)
            for f in tbook.StepOutput._fields}


def run_both(dtype, cap, k, ops, rows):
    """Apply each op dict ([rows] per field) in turn to empty books in both
    packages; every book leaf and every output value must agree after every
    op. Returns the port's (books, outs) after each op."""
    jc = jbook.BookConfig(cap=cap, max_fills=k, dtype=jnp_dtype(dtype))
    tc = tbook.BookConfig(cap=cap, max_fills=k, dtype=torch_dtype(dtype))
    jb = jbook.init_books(jc, rows)
    tb = tbook.init_books(tc, rows, "cpu")
    trace = []
    for op in ops:
        jb, jo = _jax_step_rows(jc, jb, jbook.DeviceOp(**op))
        tb, to = step(tc, tb, tbook.DeviceOp(
            **{f: torch.from_numpy(v) for f, v in op.items()}))
        assert_leaves_equal(tb, jb)
        # Values exactly equal; the reference's x64 sums widen two int32
        # scalar leaves to int64, so dtypes are held to the kernel's.
        assert_leaves_equal(to, jo, check_dtype=False)
        for f, dt in _expected_out_dtypes(tc).items():
            assert getattr(to, f).dtype == dt, f
        trace.append((tb, to))
    return trace


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_streams_match(dtype, seed):
    rng = np.random.default_rng(seed)
    rows, steps = 8, 24
    grid = random_grid(rng, rows, steps, dtype, oid_mod=4, vol_hi=25,
                       prices=(98, 103))
    grid["volume"] *= np.where(grid["is_market"] != 0, 4, 1).astype(
        grid["volume"].dtype)
    ops = [{f: np.ascontiguousarray(v[:, t]) for f, v in grid.items()}
           for t in range(steps)]
    trace = run_both(dtype, cap=6, k=2, ops=ops, rows=rows)
    outs = [o for _, o in trace]
    # The stream exercised every path.
    assert sum(int(o.n_fills.sum()) for o in outs) > 0
    assert sum(int(o.cancel_found.sum()) for o in outs) > 0
    assert sum(int(o.fill_overflow.sum()) for o in outs) > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_saturating_depth_keeps_fills_exact(dtype):
    """Resting lots near LOT_MAX32 on every slot: the 32-bit exclusive
    prefix saturates at SAT32_MAX; fills, records and books still match
    the reference, and the int32 fills equal the int64 fills."""
    cap = 16
    big = [LOT_MAX32 - 5 * i for i in range(cap)]
    ops = [_op(dtype, action=[1, 1], side=[1, 1], price=[100 + i, 100 + i],
               volume=[big[i], big[i]], oid=[i + 1, i + 1], uid=[1, 2])
           for i in range(cap)]
    assert sum(big) > SAT32_MAX
    ops.append(_op(dtype, action=[1, 1], side=[0, 0], is_market=[1, 0],
                   price=[0, 100 + cap], volume=[LOT_MAX32, LOT_MAX32],
                   oid=[99, 98], uid=[3, 3]))
    ops.append(_op(dtype, action=[1, 1], side=[0, 0], price=[200, 200],
                   volume=[LOT_MAX32, 7], oid=[97, 96], uid=[4, 4]))
    trace = run_both(dtype, cap=cap, k=4, ops=ops, rows=2)
    last = trace[-1][1]
    assert int(last.n_fills[0]) == 2 and int(last.n_fills[1]) == 1


def test_saturated_int32_fills_equal_int64_fills():
    cap = 16
    vols = [LOT_MAX32 - 3 * i for i in range(cap)]
    outs = {}
    for dtype in DTYPES:
        ops = [_op(dtype, action=[1], side=[1], price=[100 + i],
                   volume=[vols[i]], oid=[i + 1], uid=[1]) for i in range(cap)]
        ops += [_op(dtype, action=[1], side=[0], price=[200],
                    volume=[LOT_MAX32], oid=[77], uid=[2])] * 3
        outs[dtype] = run_both(dtype, cap=cap, k=4, ops=ops, rows=1)
    for (b32, o32), (b64, o64) in zip(outs["int32"], outs["int64"]):
        for f in tbook.StepOutput._fields:
            assert torch.equal(getattr(o32, f).to(torch.int64),
                               getattr(o64, f).to(torch.int64)), f
        assert torch.equal(b32.lots.to(torch.int64), b64.lots)


def test_records_past_n_fills_echo_the_book():
    """An ADD's records j < K with no fill echo the opposing side's slots:
    one fill at 100 leaves fill_price [100, 101, 101, 0]."""
    ops = [_op("int64", action=[1], side=[1], price=[p], volume=[v],
               oid=[i + 1], uid=[i + 10])
           for i, (p, v) in enumerate([(100, 5), (101, 4), (101, 6)])]
    ops.append(_op("int64", action=[1], side=[0], price=[100], volume=[3],
                   oid=[9], uid=[9]))
    ops.append(_op("int64", action=[2], side=[1], price=[101], oid=[2]))
    trace = run_both("int64", cap=8, k=4, ops=ops, rows=1)
    out = trace[3][1]
    assert int(out.n_fills[0]) == 1
    assert out.fill_price[0].tolist() == [100, 101, 101, 0]
    assert out.fill_qty[0].tolist() == [3, 0, 0, 0]
    assert out.maker_oid[0].tolist() == [1, 2, 3, 0]
    assert out.maker_uid[0].tolist() == [10, 11, 12, 0]
    assert out.maker_prefill[0].tolist() == [5, 4, 6, 0]
    assert out.maker_remaining[0].tolist() == [2, 4, 6, 0]
    assert out.taker_after[0].tolist() == [0, 0, 0, 0]
    # A DEL zeroes every record.
    cancel = trace[4][1]
    assert int(cancel.cancel_found[0]) == 1 and int(cancel.cancel_volume[0]) == 4
    assert not cancel.fill_price.any() and not cancel.maker_prefill.any()


def test_duplicate_oid_cancel_uses_sums():
    """Hits are active & oid & exact price (uid ignored); pos and volume are
    sums over the hits, as the reference computes them."""
    rows = [(100, 5, 7), (99, 4, 3), (99, 6, 7), (98, 2, 7), (99, 1, 7)]
    ops = [_op("int32", action=[1], side=[0], price=[p], volume=[v],
               oid=[o], uid=[i + 1]) for i, (p, v, o) in enumerate(rows)]
    ops.append(_op("int32", action=[2], side=[0], price=[99], oid=[7],
                   uid=[42]))
    ops.append(_op("int32", action=[2], side=[0], price=[97], oid=[7]))
    trace = run_both("int32", cap=8, k=2, ops=ops, rows=1)
    out = trace[5][1]
    assert int(out.cancel_found[0]) == 1
    assert int(out.cancel_volume[0]) == 7  # 6 + 1: both same-price hits
    assert int(trace[6][1].cancel_found[0]) == 0  # wrong price misses


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_side_overflow_and_next_seq(dtype):
    """A rest into a full side leaves the book unchanged, flags
    book_overflow and still advances next_seq; a market remainder never
    rests and does not advance it."""
    cap = 4
    ops = [_op(dtype, action=[1], side=[0], price=[100 - i], volume=[2],
               oid=[i + 1], uid=[1]) for i in range(cap + 1)]
    ops.append(_op(dtype, action=[1], side=[1], is_market=[1], price=[0],
                   volume=[100], oid=[50], uid=[2]))
    ops.append(_op(dtype, action=[1], side=[1], is_market=[1], price=[0],
                   volume=[5], oid=[51], uid=[2]))
    trace = run_both(dtype, cap=cap, k=2, ops=ops, rows=1)
    full, over = trace[cap - 1][0], trace[cap]
    assert int(over[1].book_overflow[0]) == 1 and int(over[1].rested[0]) == 0
    assert torch.equal(over[0].price, full.price)
    assert int(over[0].next_seq[0]) == int(full.next_seq[0]) + 1
    sweep = trace[cap + 1]
    assert int(sweep[1].taker_remaining[0]) == 100 - 2 * cap
    assert int(sweep[1].rested[0]) == 0
    assert int(sweep[0].count[0, 1]) == 0  # market remainder never rests
    assert int(sweep[0].next_seq[0]) == int(over[0].next_seq[0])
    empty = trace[cap + 2][1]
    assert int(empty.taker_remaining[0]) == 5 and int(empty.n_fills[0]) == 0


def test_record_budget_larger_than_cap_is_refused():
    tc = tbook.BookConfig(cap=8, max_fills=16, dtype=torch.int32)
    books = tbook.init_books(tc, 2, "cpu")
    ops = tbook.DeviceOp(**{f: torch.from_numpy(v) for f, v in random_grid(
        np.random.default_rng(0), 2, 3, "int32").items()})
    with pytest.raises(ValueError, match="max_fills"):
        batch_step(tc, books, ops)


def test_step_leaves_inputs_unchanged():
    rng = np.random.default_rng(4)
    tc = tbook.BookConfig(cap=8, max_fills=3)
    books = torch_books(jbook.init_books(
        jbook.BookConfig(cap=8, max_fills=3), 4))
    for t in range(10):
        op = tbook.DeviceOp(**{f: torch.from_numpy(np.ascontiguousarray(v[:, 0]))
                               for f, v in random_grid(rng, 4, 1, "int64").items()})
        before = [a.clone() for a in books]
        new, _ = step(tc, books, op)
        for a, b in zip(books, before):
            assert torch.equal(a, b)
        books = new
