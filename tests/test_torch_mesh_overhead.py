"""The port's mesh-overhead driver (gome_tpu_torch/scripts/
mesh_overhead.py) against gome_tpu on the CPU: the curve's geometry at
D = 1, 2, 4, 8 (live_per_shard, dispatched_rows, shard_skew) equal to
what the reference's engine packer gives on the same live set, part B's
rows equal to the reference's part B on the same generator, part A's
unsharded and D=1 outputs equal, and the committed artifact's D=8 row
the reference's."""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from gome_tpu.engine import BatchEngine as JBatchEngine
from gome_tpu.engine import BookConfig as JConfig
from gome_tpu.parallel import make_mesh as jmake_mesh
from gome_tpu_torch.scripts import mesh_overhead as mo

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: The reference's MULTICHIP_r06 D=8 row: the geometry is host arithmetic.
D8_LIVE = [187, 52, 31, 27, 32, 31, 27, 24]


@pytest.fixture(scope="module")
def port_curve():
    """The curve at t 4 (its geometry does not depend on t), on one torch
    thread: the plain step's many small ops spin a thread pool that other
    test workers on the same cores slow by an order of magnitude."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return mo.curve("cpu", reps=1, t=4, profile=False, shard_repeats=1)
    finally:
        torch.set_num_threads(threads)


def reference_geometry(live, d: int) -> dict:
    """The reference engine's packer (_grid_geometry) on a D-device
    mesh of conftest's virtual CPU devices, and the curve's per-shard
    counts."""
    eng = JBatchEngine(JConfig(cap=mo.C_CAP, max_fills=8, dtype=jnp.int32),
                       n_slots=mo.C_SYMBOLS, max_t=mo.C_T, kernel="scan",
                       mesh=jmake_mesh(d))
    use_dense, n_rows, _, _ = eng._grid_geometry(live)
    assert use_dense
    counts = np.bincount(live // (mo.C_SYMBOLS // d), minlength=d)
    return dict(live_per_shard=[int(c) for c in counts],
                dispatched_rows=int(n_rows),
                shard_skew=round(int(counts.max()) * d / len(live), 4))


@pytest.mark.parametrize("d", mo.CURVE_D)
def test_curve_geometry_equals_the_reference(d, port_curve):
    _, live = mo.curve_live_set()
    point = next(p for p in port_curve["curve"] if p["devices"] == d)
    got = {k: point[k] for k in ("live_per_shard", "dispatched_rows",
                                 "shard_skew")}
    assert got == reference_geometry(live, d)
    assert got == mo.dense_geometry(live, mo.C_SYMBOLS, d)
    assert point["max_abs_err_vs_unsharded"] == 0
    assert point["live_lanes"] == len(live) == 411


def test_curve_d8_is_the_reference_row(port_curve):
    last = port_curve["curve"][-1]
    assert last["live_per_shard"] == D8_LIVE
    assert last["shard_skew"] == 3.6399
    assert last["per_shard"]["n_shards"] == 8
    assert [s["live_lanes"] for s in last["per_shard"]["shards"]] == D8_LIVE


def _ref_mesh_overhead():
    path = ROOT / "scripts" / "mesh_overhead.py"
    spec = importlib.util.spec_from_file_location("_ref_mesh_overhead", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_part_b_equals_the_reference(capsys):
    _ref_mesh_overhead().part_b()
    want = json.loads(capsys.readouterr().out)["mesh_dense_row_padding_zipf"]
    assert mo.part_b() == want


def test_part_a_paths_agree_on_the_cpu():
    a = mo.part_a("cpu", symbols=128, t=8, cap=32, reps=1, dense_rows=32,
                  trace_reps=1)
    assert a["full_max_abs_err"] == 0 and a["dense_max_abs_err"] == 0
    assert a["orders_per_step"] == 128 * 8
    # The traced chains: both paths run the one full_grid_step, so the
    # same device work by name and count.
    tr = a["full_trace"]
    assert tr["same_launches"] and tr["reps"] == 1
    for path in ("unsharded", "mesh1"):
        assert tr[path]["launches_per_step"] > 0
        assert tr[path]["busy_ms_per_step"] > 0
        assert tr[path]["wall_ms_per_step"] >= tr[path]["busy_ms_per_step"]


def test_committed_artifact_geometry():
    doc = json.loads((ROOT / "MULTICHIP_CUDA_r01.json").read_text())
    _, live = mo.curve_live_set()
    assert doc["artifact"] == "MULTICHIP_CUDA_r01"
    assert [p["devices"] for p in doc["curve"]] == list(mo.CURVE_D)
    for p in doc["curve"]:
        geo = mo.dense_geometry(live, mo.C_SYMBOLS, p["devices"])
        assert {k: p[k] for k in geo} == geo
        assert p["max_abs_err_vs_unsharded"] == 0
    assert doc["curve"][-1]["live_per_shard"] == D8_LIVE
    assert "NVIDIA" in doc["provenance"]["card"]


def legacy_zipf(rng, a: float, size: int) -> list:
    """numpy 2.0's random_zipf, one trial at a time: U = 1 - u, V = u'."""
    import math

    am1, b, out = a - 1.0, 2.0 ** (a - 1.0), []
    while len(out) < size:
        u, v = 1.0 - rng.random(), rng.random()
        x = math.floor(math.pow(u, -1.0 / am1))
        if x < 1:
            continue
        t = math.pow(1.0 + 1.0 / x, am1)
        if v * x * (t - 1.0) / (b - 1.0) <= t / b:
            out.append(x)
    return out


@pytest.mark.parametrize("seed, a, size", [(17, 1.2, 1024), (11, 1.2, 8192),
                                           (3, 1.5, 100), (0, 2.0, 7)])
def test_zipf_draws_are_the_reference_draw(seed, a, size):
    """The drivers' Zipf draw is the one the reference's committed
    workloads were drawn with under any numpy (numpy 2.1 moved
    Generator.zipf's uniform), and leaves the generator where it does."""
    from gome_tpu_torch.scripts.common import zipf_draws

    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    assert zipf_draws(r1, a, size).tolist() == legacy_zipf(r2, a, size)
    assert r1.random(4).tolist() == r2.random(4).tolist()


def test_curve_live_set_is_the_reference_one():
    ref = json.loads((ROOT / "MULTICHIP_r06.json").read_text())
    _, live = mo.curve_live_set()
    assert len(live) == ref["curve"][0]["live_lanes"] == 411
    for p in ref["curve"]:
        geo = mo.dense_geometry(live, mo.C_SYMBOLS, p["devices"])
        assert {k: p[k] for k in geo} == geo
