"""The port's mesh across processes (parallel.multihost_mesh over an
initialized torch.distributed group) on the CPU: two ranks as fresh
interpreters (chip_smoke.py --mesh-rank), gloo on a free TCP port, two
CPU shards a rank (D = 4), against gome_tpu's mesh on four of conftest's
virtual devices and the oracle. Exact equality, tolerance 0: every
rank's events, stats and gathered books (export_state), and one grid
through sharded_batch_step. The single-process mesh's rules (one
process, a named backend that cannot serve its layout) are held here
too."""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from gome_tpu.engine import BookConfig as JConfig
from gome_tpu.engine import init_books as jinit_books
from gome_tpu.engine.orchestrator import MatchEngine as JEngine
from gome_tpu.parallel import make_mesh as jmake_mesh
from gome_tpu.parallel import mesh as jmesh_mod
from gome_tpu.utils.streams import multi_symbol_stream
from gome_tpu_torch import parallel as tpar
from gome_tpu_torch.engine.book import BookState
from test_sharding import _grid_from_stream
from test_torch_bridge import assert_leaves_equal, event_keys, oracle_keys
from test_torch_engine import assert_states_equal
from test_torch_frames import frame_of

N_ORDERS, N_SYMBOLS, CAP, K, MAX_T, FRAME_N = 2000, 64, 16, 4, 8, 256
STAT_FIELDS = ("orders", "fills", "cancels", "cancels_missed",
               "dropped_no_prepool", "device_calls", "cap_escalations",
               "grid_cap_escalations", "fill_record_escalations",
               "frame_fallbacks", "lane_growths")


def jhost(tree):
    return jax.tree.map(lambda a: np.asarray(jax.device_get(a)), tree)


@pytest.fixture(scope="module")
def flow():
    return multi_symbol_stream(n=N_ORDERS, n_symbols=N_SYMBOLS, zipf_a=1.2,
                               cancel_prob=0.3, seed=7)


@pytest.fixture(scope="module")
def grid():
    """One grid (gome_tpu's packer) and the books it steps from."""
    orders = multi_symbol_stream(n=400, n_symbols=N_SYMBOLS, seed=3)
    ops = _grid_from_stream(None, orders, N_SYMBOLS, MAX_T)
    cfg = JConfig(cap=CAP, max_fills=K)
    return cfg, jinit_books(cfg, N_SYMBOLS), ops


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory, grid, flow):
    """Both ranks' results (the flow through process_frame(fast), then the
    grid through sharded_batch_step), and gome_tpu's MatchEngine on a
    4-device mesh over the same frames, every ADD marked first: the ranks
    run while gome_tpu's engine compiles and runs here."""
    work = tmp_path_factory.mktemp("mesh")
    _, books, ops = grid
    path = work / "grid.npz"
    np.savez(path, **{f"books_{f}": np.asarray(a)
                      for f, a in zip(BookState._fields, books)},
             **{f"ops_{f}": np.asarray(a) for f, a in ops._asdict().items()})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            chip_smoke.mesh_ranks, str(work), ["cpu", "cpu"], timeout_s=120,
            symbols=N_SYMBOLS, orders=N_ORDERS, frame_n=FRAME_N, cap=CAP,
            max_fills=K, max_t=MAX_T, dtype="int64", keep=1, grid=str(path))
        j = JEngine(config=JConfig(cap=CAP, max_fills=K), n_slots=N_SYMBOLS,
                    max_t=MAX_T, mesh=jmake_mesh(4))
        frames = [frame_of(flow[i:i + FRAME_N])
                  for i in range(0, len(flow), FRAME_N)]
        for cols in frames:
            j.mark_frame(cols)
        got = []
        for cols in frames:
            got += event_keys(j.process_frame(cols, fast=True).to_results())
        return ranks.result(), (j, got)


@pytest.fixture(scope="module")
def ranks(both_runs):
    return both_runs[0]


@pytest.fixture(scope="module")
def reference(both_runs):
    return both_runs[1]


def test_each_rank_holds_its_shards_and_joins_the_same_events(ranks, flow):
    want = oracle_keys(flow)
    for r in ranks:
        assert r["backend"] == "gloo"
        assert f"rank {r['rank']}, gloo" in r["mesh"]
        assert event_keys(r["events"]) == want
        assert r["n_events"] == len(want)
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_ranks_equal_gome_tpu_on_four_devices(ranks, reference):
    j, want = reference
    for r in ranks:
        assert event_keys(r["events"]) == want
        assert_states_equal(r["state"], j.batch.export_state())
        for f in STAT_FIELDS:
            assert r["stats"][f] == getattr(j.stats, f), f


def test_sharded_step_across_processes_matches_gome_tpu(ranks, grid):
    cfg, books, ops = grid
    jm = jmake_mesh(4)
    jb, jo = jmesh_mod.sharded_batch_step(cfg, jm)(
        jmesh_mod.shard_batch(jm, books), jmesh_mod.shard_batch(jm, ops))
    for r in ranks:
        assert_leaves_equal(r["grid_books"], jhost(jb))
        assert_leaves_equal(r["grid_outs"], jhost(jo))


def test_multihost_mesh_without_a_group_is_the_local_mesh():
    cpu = torch.device("cpu")
    mesh = tpar.multihost_mesh(2, devices=[cpu, cpu])
    assert not mesh.multiprocess and mesh.ranks == (0, 0)
    assert mesh.local == (0, 1) and mesh.home == cpu
    with pytest.raises(ValueError, match="devices"):
        tpar.multihost_mesh()  # no card here, and no fallback to the CPU


@pytest.mark.parametrize("devices, shared, want", [
    (["cpu", "cpu"], False, "gloo"),
    (["cuda:0", "cuda:0"], True, "gloo"),
    (["cuda:1"], False, "nccl"),
])
def test_mesh_backend_follows_the_layout(devices, shared, want):
    assert tpar.mesh_backend(devices, shared_card=shared) == want


@pytest.mark.parametrize("backend, layouts, match", [
    ("nccl", [("h", ["cuda:0"]), ("h", ["cuda:0"])], "share cuda:0"),
    ("nccl", [("h", ["cpu"]), ("h", ["cpu"])], "cannot serve"),
    ("mpi", [("h", ["cpu"]), ("h", ["cpu"])], "cannot serve"),
    ("gloo", [("h", ["cpu"]), ("h", ["cuda:0"])], "every shard"),
])
def test_unservable_layouts_raise(backend, layouts, match):
    from gome_tpu_torch.parallel.mesh import _check_layout

    with pytest.raises(ValueError, match=match):
        _check_layout(backend, layouts)
    # the same hosts' cards, one each: NCCL serves it
    _check_layout("nccl", [("h", ["cuda:0"]), ("h", ["cuda:1"])])


def _random_outs(rng, r, t, k):
    """A StepOutput-shaped tree of random records: about a third of the
    record slots filled, a fifth of the ops cancels."""
    from gome_tpu_torch.engine.book import StepOutput

    fq = torch.from_numpy(
        rng.integers(1, 9, (r, t, k)) * (rng.random((r, t, k)) < 0.3)
        .astype(np.int64))
    rec = lambda: torch.from_numpy(rng.integers(0, 1000, (r, t, k)))
    op = lambda hi: torch.from_numpy(rng.integers(0, hi, (r, t)))
    fields = dict(fill_qty=fq, fill_price=rec(), maker_oid=rec(),
                  maker_uid=rec(), maker_remaining=rec() % 3,
                  maker_prefill=rec(), taker_after=rec() % 50,
                  cancel_found=op(2) * torch.from_numpy(
                      rng.random((r, t)) < 0.2),
                  cancel_volume=op(50), book_overflow=op(2) * 0,
                  n_fills=torch.from_numpy(
                      (fq.numpy() > 0).sum(-1)).to(torch.int32))
    return StepOutput(**{f: fields.get(f, op(5)) for f in StepOutput._fields})


@pytest.mark.parametrize("ranks, cap", [(2, 4096), (4, 4096), (2, 64)])
def test_rank_compaction_joins_to_the_one_process_buffers(ranks, cap):
    """Each rank compacts its own rows (compact_accum with its row0) and
    the join (_merge_rank_events, the merge of join_rank_events) gives the
    buffers one process makes from the whole grids: the same events in
    the same order, the same per-grid totals; past the capacity (cap 64)
    the true totals still trip the frame."""
    from gome_tpu_torch.engine.frames import (
        _CANCEL_FIELDS, _FILL_FIELDS, _merge_rank_events, compact_accum)

    rng = np.random.default_rng(5)
    grids = [_random_outs(rng, 16, t, 4) for t in (8, 4, 8)]

    def buffers():
        return (torch.zeros((len(_FILL_FIELDS), cap + 1), dtype=torch.int64),
                torch.zeros((len(_CANCEL_FIELDS), cap + 1),
                            dtype=torch.int64),
                torch.zeros((8, 4), dtype=torch.int32))

    whole = buffers()
    for g, outs in enumerate(grids):
        compact_accum(outs, *whole, g)
    per_rank = []
    for r in range(ranks):
        bufs = buffers()
        rows = 16 // ranks
        for g, outs in enumerate(grids):
            part = type(outs)(*(a[r * rows:(r + 1) * rows] for a in outs))
            compact_accum(part, *bufs, g, r * rows)
        per_rank.append(bufs)
    tot = torch.stack([b[2] for b in per_rank]).to(torch.int64)
    assert torch.equal(tot[:, :, 0].sum(0), whole[2][:, 0].to(torch.int64))
    assert torch.equal(tot[:, :, 1].sum(0), whole[2][:, 1].to(torch.int64))
    fills = _merge_rank_events(tot[:, :, 0], [b[0] for b in per_rank], cap)
    cancels = _merge_rank_events(tot[:, :, 1], [b[1] for b in per_rank], cap)
    nf, nc = int(whole[2][:, 0].sum()), int(whole[2][:, 1].sum())
    assert nc > 0
    if nf > cap:  # the frame trips on the true totals; no events read
        assert cap == 64
        return
    assert torch.equal(fills[:, :nf], whole[0][:, :nf])
    assert torch.equal(cancels[:, :nc], whole[1][:, :nc])
