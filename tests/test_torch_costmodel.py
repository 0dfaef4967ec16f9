"""The port's analytic cost model (gome_tpu_torch/obs/costmodel.py) against
gome_tpu's compiled entries, on the CPU. The reference's own cost model
cannot run on this JAX (its x64 switch is gone), but its executables can:
each entry is lowered here under ``jax.enable_x64`` at the canonical
geometry (cap 8, K 4, S 2, T 4), and the port's leaf sums must equal XLA's
argument bytes, and its output bytes less XLA's 8-byte pointer per output
leaf. Plus the operation counts (static and data), the one count
chip_smoke.bound_ms shares, and the report surface /cost serves."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gome_tpu.engine import batch as jbatch
from gome_tpu.engine.book import BookConfig as JConfig
from gome_tpu.engine.book import DeviceOp as JOp
from gome_tpu.engine.book import init_books as jinit
from gome_tpu_torch.engine.book import BookConfig, DeviceOp, init_books
from gome_tpu_torch.obs import costmodel

CAP, K, S, T = costmodel.CANONICAL


def reference_args(entry, dtype):
    """The reference envelope's canonical arguments for one entry
    (analysis/envelope.py), built under the dtype's x64 mode."""
    cfg = JConfig(cap=CAP, max_fills=K, dtype=jnp.dtype(dtype))
    dt = jnp.dtype(dtype)
    books = jinit(cfg, S)
    ops = JOp(**{f: jnp.zeros((S, T), jnp.int32 if f in (
        "action", "side", "is_market") else dt) for f in JOp._fields})
    if entry == "batch_step":
        return jbatch.batch_step, (cfg, books, ops)
    if entry == "dense_batch_step":
        return jbatch.dense_batch_step, (cfg, books,
                                         jnp.zeros((S,), jnp.int32), ops)
    one = jax.tree.map(lambda a: a[0], books)
    return jbatch.lane_scan, (cfg, one, jax.tree.map(lambda a: a[0], ops))


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("entry", ["batch_step", "dense_batch_step",
                                   "lane_scan"])
def test_bytes_equal_the_reference_executables(entry, dtype):
    with jax.enable_x64(dtype == "int64"):
        fn, args = reference_args(entry, dtype)
        ma = fn.lower(*args).compile().memory_analysis()
        n_out = len(jax.tree.leaves(fn(*args)))
    row = {r["entry"]: r for r in costmodel.entry_report(dtype, "cpu")}[entry]
    assert row["argument_bytes"] == ma.argument_size_in_bytes
    # XLA's output tuple carries one 8-byte pointer per leaf (21 leaves:
    # the 7 book leaves and the 14 StepOutput leaves).
    assert n_out == 21
    assert row["output_bytes"] == ma.output_size_in_bytes - 8 * n_out
    assert row["bytes_accessed"] == row["argument_bytes"] + row["output_bytes"]
    assert (row["temp_bytes"], row["generated_code_bytes"]) == (0, None)


def test_canonical_byte_counts():
    """The int32 numbers: books 664 + ops 224 in; books 664 + StepOutput
    1,120 out (the figure chip_smoke.bound_ms's formula gives)."""
    rows = {r["entry"]: r for r in costmodel.entry_report("int32", "cpu")}
    b = rows["batch_step"]
    assert (b["argument_bytes"], b["output_bytes"]) == (888, 1784)
    assert rows["dense_batch_step"]["argument_bytes"] == 888 + 4 * S
    # compact_accum appends into its buffers: every output byte aliases.
    ca = rows["compact_accum"]
    assert ca["alias_bytes"] == ca["output_bytes"] > 0
    assert ca["peak_hbm_bytes"] == ca["argument_bytes"]


def test_report_keys_memo_and_counts():
    rows = costmodel.entry_report("int32", "cpu")
    assert rows is costmodel.entry_report("int32", "cpu")
    assert [r["entry"] for r in rows] == list(costmodel.RATCHET_ENTRIES)
    for r in rows:
        for key in ("flops", "bytes_accessed", "arithmetic_intensity",
                    "argument_bytes", "output_bytes", "temp_bytes",
                    "alias_bytes", "peak_hbm_bytes", "jaxpr_eqns", "context",
                    "n_ops", "flops_per_order", "bytes_per_order"):
            assert key in r, (r["entry"], key)
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        assert r["jaxpr_eqns"] > 1
        assert r["flops_per_order"] == pytest.approx(r["flops"] / r["n_ops"])
        assert r["peak_hbm_bytes"] == (r["argument_bytes"] + r["output_bytes"]
                                       - r["alias_bytes"])
    k1 = costmodel.k1_slot_operations(CAP)
    assert k1 == CAP * (math.log2(CAP) + 20)
    flops = {r["entry"]: r["flops"] for r in rows}
    assert flops["batch_step"] == flops["dense_batch_step"] == S * T * k1
    assert flops["lane_scan"] == T * k1


def test_ratchet_analytics_and_donation():
    m1 = costmodel.ratchet_metrics("int32", "cpu")
    assert m1 and all(isinstance(v, (int, float)) and v >= 0
                      for v in m1.values())
    assert costmodel.ratchet_metrics("int32", "cpu") == m1
    assert set(m1) == {f"{e}.{m}" for e in costmodel.RATCHET_ENTRIES
                       for m in ("flops_per_order", "bytes_per_order",
                                 "peak_hbm_bytes")}
    block = costmodel.bench_analytics("int32", "cpu")
    assert block["dtype"] == "int32" and "batch_step" in block["entries"]
    json.dumps(block)
    don = costmodel.donation_report("int32", "cpu")
    assert don is costmodel.donation_report("int32", "cpu")
    assert [d["entry"] for d in don] == ["batch_step", "dense_batch_step",
                                         "lane_scan"]
    for d in don:
        assert d["geometry"] == {"cap": 64, "s": 8, "t": 32}
        assert d["donating_peak_hbm_bytes"] == d["public_peak_hbm_bytes"] > 0
        assert d["peak_hbm_saved_bytes"] == 0
        assert d["donation_effective"] is False
    assert block["donation"] == {d["entry"]: 0 for d in don}


def random_grid(seed, s, t, cap, k, dtype):
    rng = np.random.default_rng(seed)
    cfg = BookConfig(cap=cap, max_fills=k, dtype=dtype)
    books = init_books(cfg, s, "cpu")
    cols = {f: torch.zeros((s, t), dtype=torch.int32 if f in (
        "action", "side", "is_market") else cfg.dtype) for f in DeviceOp._fields}
    cols["action"] = torch.from_numpy(
        rng.integers(0, 3, (s, t)).astype(np.int32))
    return cfg, books, DeviceOp(**cols)


@pytest.mark.parametrize("s, t, cap, k, dtype", [
    (2, 4, 8, 4, "int32"), (64, 32, 256, 16, "int32"),
    (16, 8, 2048, 16, "int64"), (8, 32, 32, 32, "int64")])
def test_k1_work_modes_and_bound(s, t, cap, k, dtype):
    cfg, books, ops = random_grid(s + t, s, t, cap, k, dtype)
    item = books.price.element_size()
    # The bytes formula chip_smoke.bound_ms made before the cost model
    # owned it: every bound in PERF.md's table stays as it was.
    book_bytes = s * 2 * cap * (4 * item + 4) + s * 2 * 4 + s * 4
    formula = 2 * book_bytes + s * t * (3 * 4 + 4 * item) + s * t * (
        7 * k * item + 5 * 4 + 2 * item)
    nbytes, data = costmodel.k1_work(cfg, books, ops, "data")
    static_bytes, static = costmodel.k1_work(cfg, books, ops, "static")
    assert nbytes == static_bytes == formula
    n_add = int((ops.action == 1).sum())
    n_del = int((ops.action == 2).sum())
    assert data == n_add * cap * (math.log2(cap) + 20) + n_del * cap * 10
    assert static == s * t * cap * (math.log2(cap) + 20) >= data
    by_bytes = nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
    by_ops = data / chip_smoke.PEAK_INT_OPS_PER_S * 1e3
    assert chip_smoke.bound_ms(cfg, books, ops) == (
        (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations"))
    with pytest.raises(ValueError, match="mode"):
        costmodel.k1_work(cfg, books, ops, "peak")


def test_all_nop_grid_counts_static_not_data():
    """XLA charges every op slot: on the canonical all-NOP grid the static
    count is positive and the data count 0."""
    cfg = BookConfig(cap=CAP, max_fills=K, dtype="int32")
    books = init_books(cfg, S, "cpu")
    ops = DeviceOp(*(torch.zeros((S, T), dtype=torch.int32)
                     for _ in DeviceOp._fields))
    assert costmodel.k1_work(cfg, books, ops, "static")[1] > 0
    assert costmodel.k1_work(cfg, books, ops, "data")[1] == 0
