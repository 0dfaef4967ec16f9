"""The port's GL2xx dtype envelope (gome_tpu_torch.analysis.envelope)
against gome_tpu's (gome_tpu.analysis.envelope): tests/test_analysis.py's
envelope cases twinned on PyTorch fixtures, each giving the rules the
reference's check_jaxpr gives on its JAX fixture; the value taint that
tells book values from PyTorch's int64 indexes; the engine's entries on
crossing grids (every entry audits ops, K1 and K5 at their boundary) and
clean beyond the committed baseline at int32 and int64; the suppressions;
the CLI's --traced."""

import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gome_tpu.analysis.core import Finding as JFinding
from gome_tpu.analysis.core import apply_file_suppressions as japply
from gome_tpu.analysis.envelope import check_jaxpr
from gome_tpu.analysis.sarif import validate_sarif
from gome_tpu_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    fingerprint_findings,
    load_baseline,
    partition,
)
from gome_tpu_torch.analysis.core import Finding, apply_file_suppressions
from gome_tpu_torch.analysis.envelope import (
    check_engine_envelope,
    check_values,
    live_grids,
    record_call,
    traced_entries,
)
from gome_tpu_torch.engine.book import BookConfig, StepOutput
from gome_tpu_torch.obs import costmodel
from gome_tpu_torch.ops.match_step import batch_step_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.relpath(os.path.abspath(__file__), ROOT)


def rules_of(findings):
    return sorted({f.rule for f in findings})


def audit(fn, *args, seeds=(), dtype="int32", allow_floats=False):
    _, records = record_call(fn, args, seeds)
    return check_values(records, dtype, "fixture", allow_floats=allow_floats)


def line_of(fn, text):
    """The file line of the first line of ``fn`` holding ``text``."""
    lines, first = inspect.getsourcelines(fn)
    return first + next(i for i, s in enumerate(lines) if text in s)


def i32(n=4):
    return torch.from_numpy(np.arange(1, n + 1, dtype=np.int32))


# --- tests/test_analysis.py's envelope cases, twinned -----------------------


def test_envelope_flags_float_and_width_creep():
    x = jnp.zeros((4,), jnp.int32)
    ref = {
        "f32": check_jaxpr(jax.make_jaxpr(
            lambda v: v.astype(jnp.float32) * 2.5)(x), "int32", "fixture"),
        "i64": check_jaxpr(jax.make_jaxpr(
            lambda v: v.astype(jnp.int64) + 1)(x), "int32", "fixture"),
        "f64": check_jaxpr(jax.make_jaxpr(lambda v: v * 2.5)(
            jnp.zeros((4,), jnp.float64)), "int32", "fixture"),
    }
    price = i32()
    port = {
        "f32": audit(lambda v: v.to(torch.float32) * 2.5, price),
        "i64": audit(lambda v: v.to(torch.int64) + 1, price, seeds=[price]),
        "f64": audit(lambda v: v * 2.5, torch.zeros(4, dtype=torch.float64)),
    }
    assert rules_of(port["f32"]) == rules_of(ref["f32"]) == ["GL202"]
    assert rules_of(port["i64"]) == rules_of(ref["i64"]) == ["GL203"]
    assert "GL201" in rules_of(port["f64"]) and "GL201" in rules_of(ref["f64"])


def test_envelope_sees_nested_calls():
    """The reference walks nested jaxprs (a scan body); the recorder sees
    every op a nested Python call dispatches, attributed to its line."""

    def body(v):
        return v.to(torch.float32) * 0.5  # the creep

    def outer(xs):
        return [body(x) for x in xs.unbind(0)]

    def jbody(c, x):
        return c, x.astype(jnp.float32) * 0.5

    ref = check_jaxpr(jax.make_jaxpr(
        lambda xs: jax.lax.scan(jbody, jnp.int32(0), xs)
    )(jnp.zeros((4,), jnp.int32)), "int32", "nested")
    port = audit(outer, torch.zeros((4, 2), dtype=torch.int32))
    assert "GL202" in rules_of(port) and "GL202" in rules_of(ref)
    assert {(f.path, f.line) for f in port} == {
        (HERE, line_of(body, "the creep"))}


def test_envelope_int64_engine_allows_int64():
    ref = check_jaxpr(jax.make_jaxpr(lambda v: v + 1)(
        jnp.zeros((4,), jnp.int64)), "int64", "fixture")
    price = torch.zeros(4, dtype=torch.int64)
    assert audit(lambda v: v + 1, price, seeds=[price], dtype="int64") \
        == ref == []


def test_envelope_allow_floats_still_flags_strong_f64():
    strong = check_jaxpr(jax.make_jaxpr(lambda v: v * 2.0)(
        jnp.zeros((4,), jnp.float64)), "int64", "fixture", allow_floats=True)
    assert "GL201" in rules_of(strong)
    port = audit(lambda v: v * 2.0, torch.zeros(4, dtype=torch.float64),
                 dtype="int64", allow_floats=True)
    assert "GL201" in rules_of(port)
    # float32 values in a float-tolerant entry pass, as the reference's
    # weak scalars inside jax.random do
    weak = check_jaxpr(jax.make_jaxpr(
        lambda k: jax.random.uniform(k, (), jnp.float32)
    )(jax.random.PRNGKey(0)), "int64", "fixture", allow_floats=True)
    gen = torch.Generator().manual_seed(0)
    f32 = audit(lambda: torch.rand((), dtype=torch.float32, generator=gen),
                dtype="int64", allow_floats=True)
    assert f32 == weak == []


# --- the value taint --------------------------------------------------------


def gather_by_arange(price):
    idx = torch.arange(price.shape[0])
    return price[idx], torch.gather(price, 0, idx)


def count_live(lots):
    return (lots > 0).sum()


def best_slot(price):
    return price.max(dim=0).indices + 1


def search_level(price):
    return torch.searchsorted(price, price) + torch.nonzero(price)[:, 0]


@pytest.mark.parametrize("fn", [gather_by_arange, count_live, best_slot,
                                search_level],
                         ids=lambda f: f.__name__)
def test_indexes_and_counts_are_not_values(fn):
    """int64 indexes and bool-mask counts of int32 book values: no
    GL203 (the reference's width rule would flag each)."""
    price = i32()
    _, records = record_call(fn, (price,), [price])
    assert any(d == "int64" for r in records for d in r.dtypes)
    assert check_values(records, "int32", "fixture") == []


def widen_price(price):
    wide = price.to(torch.int64)  # widened
    return wide


def sum_lots(lots):
    total = lots.sum()  # summed
    return total


@pytest.mark.parametrize("fn, text", [(widen_price, "# widened"),
                                      (sum_lots, "# summed")],
                         ids=["to_int64", "sum"])
def test_widened_value_is_gl203_at_its_line(fn, text):
    value = i32()
    found = audit(fn, value, seeds=[value])
    assert [(f.rule, f.path, f.line) for f in found] == [
        ("GL203", HERE, line_of(fn, text))]
    # the same code on an untainted tensor (an index) is no finding
    assert audit(fn, i32()) == []


def write_widened(lots):
    acc = torch.zeros(4, dtype=torch.int64)
    acc[:] = lots.to(torch.int64)
    return acc * 2  # read back


def write_index(lots):
    acc = torch.zeros(4, dtype=torch.int64)
    acc[:] = torch.arange(4) + lots.shape[0]
    return acc * 2  # read back


def test_in_place_write_taints_its_destination():
    lots = i32()
    found = audit(write_widened, lots, seeds=[lots])
    assert (HERE, line_of(write_widened, "# read back")) in {
        (f.path, f.line) for f in found if f.rule == "GL203"}
    assert audit(write_index, lots, seeds=[lots]) == []


def test_view_shares_its_base_taint():
    price = i32(8)

    def fn(p):
        return p.view(2, 4)[0].to(torch.int64)  # through a view

    found = audit(fn, price, seeds=[price[2:]])
    assert rules_of(found) == ["GL203"]


# --- the engine's entries ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_live_grids_cross(dtype):
    """The audited grid rests, crosses partially, sweeps and cancels (a
    hit and a miss) in every row: the cost model's all-NOP grids would
    audit nothing of the match path."""
    config = BookConfig(cap=8, max_fills=4, dtype=dtype)
    books, grid = live_grids(config, 2, 4, "cpu")
    assert (books.count == 2).all()
    _, out = batch_step_reference(config, books, grid)
    assert (grid.action != 0).all()
    assert (out.n_fills.sum(1) > 0).all() and (out.rested.sum(1) > 0).all()
    assert out.n_fills[:, 2].tolist() == [3, 3]  # the market sweep
    assert out.cancel_found[:, 3].tolist() == [1, 0]  # hit, miss


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_every_entry_audits_ops(dtype):
    entries = traced_entries(dtype, "cpu")
    names = [e["entry"] for e in entries]
    assert names == [r["entry"] for r in costmodel.canonical_entries(
        dtype, "cpu")] + ["gen_ops"]
    for e in entries:
        ops = {r.op for r in e["records"] if r.where != "input"}
        assert ops, e["entry"]
        assert e["n_ops"] > 0
    by = {e["entry"]: e for e in entries}
    for name in ("batch_step", "dense_batch_step", "lane_scan"):
        kernel = [r for r in by[name]["records"]
                  if r.op == "kernel:match_step"]
        assert [r.where for r in kernel] == ["kernel input", "kernel output"]
        outs = dict(zip(("price", "lots", "seq", "oid", "uid", "count",
                         "next_seq", *StepOutput._fields), kernel[1].dtypes))
        assert outs["fill_price"] == outs["price"] == dtype
        assert outs["n_fills"] == outs["seq"] == "int32"
    # K1's plain body is not descended into: one row through K1 is its
    # inputs and its boundary
    assert {r.op for r in by["lane_scan"]["records"]} == {
        "input", "kernel:match_step"}
    k5 = [r for r in by["gen_ops"]["records"] if r.op == "kernel:hawkes_scan"]
    assert len(k5) == 2 and "float32" in k5[1].dtypes
    assert by["gen_ops"]["allow_floats"]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_engine_envelope_clean_beyond_baseline(dtype):
    found = check_engine_envelope(dtype, "cpu")
    base = load_baseline(os.path.join(ROOT, DEFAULT_BASELINE))
    new, known = partition(fingerprint_findings(found, root=ROOT), base)
    assert new == [], "\n".join(f.format() for f, _ in new)
    # the ratchet: every GL2 baseline entry still stands and says why
    gl2 = {fp: e for fp, e in base.items() if e["rule"].startswith("GL2")}
    assert {fp for _, fp in known} == set(gl2)
    assert all(e.get("why") for e in gl2.values())
    assert {f.path for f, _ in known} == {"gome_tpu_torch/sim/flow.py"}


def test_apply_file_suppressions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("a = 1\nb = 2  # gomelint: disable=GL203 — index\n"
                   "c = 3  # gomelint: disable=all\n")
    quiet = tmp_path / "q.py"
    quiet.write_text("# gomelint: disable-file=GL201\nx = 1\n")
    cases = [("GL203", str(src), 1), ("GL203", str(src), 2),
             ("GL202", str(src), 2), ("GL201", str(src), 3),
             ("GL201", str(quiet), 2), ("GL203", str(quiet), 2),
             ("GL203", "<entry:fixture>", 0)]
    port = apply_file_suppressions([Finding(r, p, n, 0, "m")
                                    for r, p, n in cases])
    ref = japply([JFinding(r, p, n, 0, "m") for r, p, n in cases])
    kept = [(f.rule, f.path, f.line) for f in port]
    assert kept == [(f.rule, f.path, f.line) for f in ref] == [
        cases[0], cases[2], cases[5], cases[6]]
    # relative paths resolve against root
    rel = apply_file_suppressions([Finding("GL203", "m.py", 2, 0, "m")],
                                  root=str(tmp_path))
    assert rel == []


# --- the CLI ----------------------------------------------------------------


def cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "gome_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=ROOT)


def test_cli_traced_on_the_cpu(tmp_path):
    sarif, report = tmp_path / "out.sarif", tmp_path / "report.json"
    r = cli("gome_tpu_torch", "--traced", "--device", "cpu", "--sarif",
            str(sarif), "--report", str(report))
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(report.read_text())
    assert doc["new"] == 0 and doc["count"] == doc["baselined"]
    assert {f["rule"] for f in doc["findings"]} >= {"GL201"}
    s = json.loads(sarif.read_text())
    assert validate_sarif(s) == []
    results = s["runs"][0]["results"]
    assert {x["ruleId"] for x in results if x["ruleId"].startswith("GL2")} \
        == {"GL201"}
    r64 = cli("gome_tpu_torch", "--traced", "--device", "cpu", "--dtype",
              "int64", "--select", "GL2")
    assert r64.returncode == 0, r64.stdout + r64.stderr
    assert "0 new" in r64.stdout


def test_cli_traced_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    r = cli("gome_tpu_torch", "--traced", "--select", "GL2")
    assert r.returncode == 2
    assert "--traced" in r.stderr and "cpu" in r.stderr
