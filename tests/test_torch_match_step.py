"""The port's batched match step (ops/match_step.py) on the CPU, where it
runs its plain version batch_step_reference, against gome_tpu's Pallas
kernel in interpret mode and its scan x vmap batch_step, on chained grids
of both dtypes with markets, cancels (duplicate oids included) and NOPs;
plus the port's dense gather/scatter step and the no-silent-fallback rules.
Exact equality, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bench import build_grids
from gome_tpu.engine import BookConfig as JConfig
from gome_tpu.engine import batch_step as jax_batch_step
from gome_tpu.engine import init_books as jax_init_books
from gome_tpu.engine.batch import dense_batch_step
from gome_tpu.engine.book import BookState as JBooks
from gome_tpu.engine.book import DeviceOp as JOp
from gome_tpu.ops import pallas_batch_step
from gome_tpu_torch.engine import BatchEngine, BookConfig, MatchEngine
from gome_tpu_torch.engine.book import init_books
from gome_tpu_torch.ops import match_step
from gome_tpu_torch.ops.match_step import batch_step, batch_step_reference
from test_torch_bridge import (
    DTYPES,
    assert_leaves_equal,
    host,
    jnp_dtype,
    random_grid,
    torch_books,
    torch_dtype,
    torch_ops,
)


def _configs(dtype, cap, k):
    return (JConfig(cap=cap, max_fills=k, dtype=jnp_dtype(dtype)),
            BookConfig(cap=cap, max_fills=k, dtype=torch_dtype(dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_chained_grids_match_pallas_interpret_and_scan(dtype):
    jc, tc = _configs(dtype, cap=16, k=4)
    s, t = 8, 6
    rng = np.random.default_rng(11)
    jb = pb = jax_init_books(jc, s)
    tb = init_books(tc, s, "cpu")
    for _ in range(3):
        g = random_grid(rng, s, t, dtype, oid_mod=7, vol_hi=12)
        jb, jo = jax_batch_step(jc, jb, JOp(**g))
        pb, po = pallas_batch_step(jc, pb, JOp(**g), block_s=8,
                                   interpret=True)
        tb, to = batch_step(tc, tb, torch_ops(g))
        assert_leaves_equal(to, po)  # values and dtypes of the TPU kernel
        assert_leaves_equal(to, jo, check_dtype=False)
        assert_leaves_equal(tb, pb)
        assert_leaves_equal(tb, jb)
    assert int(to.n_fills.sum()) > 0


def test_crossing_flow_matches_pallas_interpret():
    """bench.py's crossing flow (every slot a live limit order)."""
    jc, tc = _configs("int64", cap=32, k=8)
    s, t = 16, 8
    jb = jax_init_books(jc, s)
    tb = init_books(tc, s, "cpu")
    for g in build_grids(s, t, 3, seed=5):
        jb, jo = pallas_batch_step(jc, jb, JOp(**g), block_s=8,
                                   interpret=True)
        tb, to = batch_step(tc, tb, torch_ops(g))
        assert_leaves_equal(to, jo)
        assert_leaves_equal(tb, jb)


@pytest.mark.parametrize("dtype", DTYPES)
def test_deep_grid_with_overflows_matches_scan(dtype):
    """Tiny cap and K: every op kind, full sides and truncated records."""
    jc, tc = _configs(dtype, cap=4, k=2)
    s, t = 4, 16
    rng = np.random.default_rng(3)
    g = random_grid(rng, s, t, dtype, oid_mod=3, vol_hi=6, market=0.15)
    # Mostly ADDs; limit sides never cross (books fill up); markets sweep.
    g["action"][rng.random((s, t)) < 0.6] = 1
    g["price"] = np.where(g["side"] == 0, 95, 100).astype(g["price"].dtype) \
        + (g["price"] % 3)
    g["volume"] *= np.where(g["is_market"] != 0, 8, 1).astype(g["volume"].dtype)
    jb, jo = jax_batch_step(jc, jax_init_books(jc, s), JOp(**g))
    tb, to = batch_step(tc, init_books(tc, s, "cpu"), torch_ops(g))
    assert_leaves_equal(to, jo, check_dtype=False)
    assert_leaves_equal(tb, jb)
    assert int(to.book_overflow.sum()) > 0 and int(to.fill_overflow.sum()) > 0


def test_batch_step_leaves_inputs_unchanged():
    jc, tc = _configs("int32", cap=8, k=4)
    rng = np.random.default_rng(2)
    books = init_books(tc, 4, "cpu")
    books, _ = batch_step(tc, books, torch_ops(random_grid(rng, 4, 8, "int32")))
    ops = torch_ops(random_grid(rng, 4, 8, "int32"))
    before = [a.clone() for a in (*books, *ops)]
    batch_step(tc, books, ops)
    for a, b in zip((*books, *ops), before):
        assert torch.equal(a, b)


def test_dense_step_matches_dense_batch_step():
    """The engine's dense grid: gather the rows' lanes (sentinel ids gather
    zero books), step, scatter back (sentinel rows dropped)."""
    jc, tc = _configs("int64", cap=8, k=4)
    n_slots, rows, t = 12, 8, 5
    rng = np.random.default_rng(7)
    # Non-empty starting books.
    jb = jax_init_books(jc, n_slots)
    warm = random_grid(rng, n_slots, 6, "int64", vol_hi=8)
    jb, _ = jax_batch_step(jc, jb, JOp(**warm))
    lane_ids = np.array([3, 0, 11, 7, n_slots, n_slots, n_slots, n_slots])
    g = random_grid(rng, rows, t, "int64", vol_hi=8)
    for f in g:
        g[f][lane_ids >= n_slots] = 0  # sentinel rows carry NOPs
    want_books, want = dense_batch_step(
        jc, jb, jnp.asarray(lane_ids, jnp.int32), JOp(**g))

    eng = BatchEngine(tc, n_slots=n_slots, device="cpu")
    eng.books = torch_books(jb)
    got_books, got = eng._step(eng.books, torch_ops(g),
                               torch.as_tensor(lane_ids))
    assert_leaves_equal(got, want, check_dtype=False)
    assert_leaves_equal(got_books, want_books)
    # Sentinel rows stepped zero books.
    assert not got.n_fills[4:].any() and not got.cancel_found[4:].any()


def test_cpu_tensors_take_the_plain_version():
    tc = BookConfig(cap=8, max_fills=4, dtype=torch.int32)
    rng = np.random.default_rng(0)
    books = init_books(tc, 4, "cpu")
    ops = torch_ops(random_grid(rng, 4, 6, "int32"))
    before = match_step.batch_step.launches
    b1, o1 = batch_step(tc, books, ops)
    b2, o2 = batch_step_reference(tc, books, ops)
    assert match_step.batch_step.launches == before == 0
    assert_leaves_equal(o1, o2)
    assert_leaves_equal(b1, b2)


def test_match_engine_needs_a_device_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MatchEngine(BookConfig(cap=8, max_fills=4), n_slots=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_books(BookConfig(cap=8), 2)
    assert MatchEngine(BookConfig(cap=8), n_slots=4,
                       device="cpu").books.price.device.type == "cpu"


@pytest.mark.parametrize(
    "bad, match",
    [
        (lambda b, o: (b._replace(price=b.price.to(torch.int64)), o), "dtype"),
        (lambda b, o: (b, o._replace(side=o.side.to(torch.int64))), "dtype"),
        (lambda b, o: (b._replace(lots=b.lots.transpose(1, 2).contiguous()
                                  .transpose(1, 2)), o), "contiguous"),
        (lambda b, o: (b, o._replace(uid=o.uid[:, :2])), "shape"),
    ],
)
def test_batch_step_checks_its_inputs(bad, match):
    tc = BookConfig(cap=8, max_fills=4, dtype=torch.int32)
    books = init_books(tc, 4, "cpu")
    ops = torch_ops(random_grid(np.random.default_rng(1), 4, 3, "int32"))
    with pytest.raises(ValueError, match=match):
        batch_step(tc, *bad(books, ops))


def test_outputs_are_fresh_tensors():
    tc = BookConfig(cap=8, max_fills=4)
    books = init_books(tc, 2, "cpu")
    ops = torch_ops(random_grid(np.random.default_rng(5), 2, 3, "int64"))
    new, out = batch_step(tc, books, ops)
    ptrs = {a.data_ptr() for a in (*books, *ops)}
    assert not ptrs & {a.data_ptr() for a in new}
    assert host(out.fill_qty).shape == (2, 3, 4)


# (case, rows, T, cap, K, dtype): chip_smoke.edge_case inputs at small
# size, aimed at the kernel's shortcuts (early exits, rings, the insert
# search, cancel sums). The plain version is the kernel's yardstick on the
# card, so it is held to gome_tpu on exactly these inputs.
EDGE_CASES = [
    ("deep", 1, 128, 64, 16, "int32"),
    ("deep", 1, 128, 16, 4, "int64"),
    ("full", 3, 40, 16, 4, "int32"),
    ("full", 2, 40, 32, 32, "int64"),
    ("wipe", 3, 24, 32, 8, "int64"),
    ("wipe", 2, 24, 16, 16, "int32"),
    ("del_ends", 2, 40, 16, 4, "int32"),
    ("dup_oids", 3, 32, 32, 8, "int64"),
    ("heavy", 3, 32, 16, 4, "int32"),
    ("stale_tails", 3, 32, 24, 6, "int32"),
]


@pytest.mark.parametrize("name, s, t, cap, k, dtype", EDGE_CASES)
def test_plain_version_matches_gome_tpu_on_edge_cases(name, s, t, cap, k,
                                                      dtype):
    jc, tc = _configs(dtype, cap=cap, k=k)
    rng = np.random.default_rng(cap * 1000 + t + s)
    books, ops = chip_smoke.edge_case(rng, tc, name, s, t, "cpu")
    jbooks = JBooks(*(jnp.asarray(host(a)) for a in books))
    jops = JOp(*(jnp.asarray(host(a)) for a in ops))
    tb, to = batch_step(tc, books, ops)
    jb, jo = jax_batch_step(jc, jbooks, jops)
    pb, po = pallas_batch_step(jc, jbooks, jops, block_s=s, interpret=True)
    assert_leaves_equal(to, po)
    assert_leaves_equal(to, jo, check_dtype=False)
    assert_leaves_equal(tb, pb)
    assert_leaves_equal(tb, jb)
    # Each case exercises what it is named for.
    count = host(books.count)
    if name == "deep":
        assert (host(ops.action) != 0).all() and int(to.n_fills.sum()) > 0
    if name == "full":
        assert (count == cap).all() and int(to.book_overflow.sum()) > 0
        assert int(to.rested.sum()) > 0
    if name == "wipe":
        assert (host(to.n_fills)[:, 0] == count[:, 1]).all()
        assert (host(to.n_fills)[:, 1] == count[:, 0] + 1).all()
    if name == "del_ends":
        assert int(to.cancel_found.sum()) == int((host(ops.action) == 2).sum())
    if name == "dup_oids":
        vol = host(to.cancel_volume).astype(np.int64)
        assert (vol > 100).any()  # a cancel summed several resting orders
    if name == "heavy":
        assert (host(to.n_fills) > 1).any()
    if name == "stale_tails":
        price = host(books.price)
        assert (price[:, :, -1] != 0).all()
