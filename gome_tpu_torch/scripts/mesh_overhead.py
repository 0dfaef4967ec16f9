"""What the mesh costs, in three parts (the port of
scripts/mesh_overhead.py).

Part A (on the card): the mesh=1 dispatch overhead. The same full grid at
the headline service shape (10,240 lanes x T 32, int32) steps through (a)
the unsharded engine path (BatchEngine._step) and (b) sharded_batch_step
over a one-block mesh — the same K1, the same bytes; the delta is what the
sharded wrapper adds a dispatch. A dense variant (1,024 live lanes)
through sharded_dense_step too. The outputs of (a) and (b) are held
equal (max |err| 0 on every book and StepOutput leaf).

Part B (host only): per-shard row padding under Zipf skew. The dense
packer buckets each shard's row block to the MAX per-shard live count
(engine.batch._grid_geometry), so skew concentrates rows on one shard and
every other shard pads to match. For D in {1,2,4,8} over the service
flow's Zipf at 10,240 symbols: dispatched rows / live lanes, p50 and p95.

Part C (``--curve``): the measured D=1/2/4/8 curve over one fixed Zipf
live set (rng 17, zipf(1.2, S/4) % S over 4,096 symbols, t 16, cap 64,
int32), D blocks on one card (the one-process mesh), or one card a shard
with ``--devices`` where there are cards: the engine's dense mesh path
(_grid_geometry layout -> BatchEngine._step -> sharded_dense_step) timed
as a serial chain, each shard's block replayed alone
(parallel.mesh.shard_execution_report), every D's books and outputs held
equal to the unsharded dense step on the same rows, and the measured
roofline block (obs.profiler.bench_measured) embedded. Written to
``MULTICHIP_CUDA_r01.json`` (read by obs.placement.shard_skew_baseline);
the geometry is host arithmetic, so D=8's live_per_shard must be the
reference's [187, 52, 31, 27, 32, 31, 27, 24] (skew 3.6399).

    python -m gome_tpu_torch.scripts.mesh_overhead           # part A
    python -m gome_tpu_torch.scripts.mesh_overhead --skew    # part B
    python -m gome_tpu_torch.scripts.mesh_overhead --curve [--out F] [--devices]

One JSON line a part; --device cpu runs on the CPU (part C's numbers are
then the CPU's, never a card's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .common import provenance, require_device, write_json, zipf_draws

ARTIFACT = "MULTICHIP_CUDA_r01"
#: Part A's headline shape.
A_SYMBOLS, A_T, A_CAP = 10_240, 32, 256
#: Part C's live set and geometry (the reference's MULTICHIP_r06).
C_SEED, C_SYMBOLS, C_T, C_CAP = 17, 4096, 16, 64
CURVE_D = (1, 2, 4, 8)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def dense_geometry(live: np.ndarray, n_slots: int, d: int) -> dict:
    """The dense packer's mesh layout of a first dispatch (no floors):
    contiguous per-shard lane blocks, R_s = max(8, pow2(max per-shard
    live)), every shard dispatching R_s rows."""
    counts = np.bincount(live // (n_slots // d), minlength=d)
    r_s = max(8, _next_pow2(int(counts.max())))
    return dict(live_per_shard=[int(c) for c in counts],
                dispatched_rows=r_s * d,
                shard_skew=round(int(counts.max()) * d / len(live), 4))


def curve_live_set(symbols: int = C_SYMBOLS, seed: int = C_SEED):
    """The curve's generator and its one Zipf live set (the draw's
    generator continues into the grids). zipf_draws: the reference's
    draw under any numpy."""
    rng = np.random.default_rng(seed)
    return rng, np.unique(zipf_draws(rng, 1.2, symbols // 4) % symbols)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over every leaf of two trees of tensors."""
    import torch

    worst = 0
    for name, x, y in zip(a._fields, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{name}: {x.dtype}{tuple(x.shape)} vs "
                                 f"{y.dtype}{tuple(y.shape)}")
        if x.numel():
            worst = max(worst, int((x.to(torch.int64).cpu()
                                    - y.to(torch.int64).cpu()).abs().max()))
    return worst


def _grid(rng, rows: int, t: int, dtype, action=None):
    """A [rows, t] DeviceOp of ADDs on the host (the reference's mk_grid:
    the same draws in the same order)."""
    from ..engine.book import GRID_I32_FIELDS, DeviceOp, numpy_dtype

    shape = (rows, t)
    f = dict(
        action=(np.ones(shape, np.int64) if action is None
                else rng.integers(1, 2, shape)),
        side=rng.integers(0, 2, shape),
        is_market=np.zeros(shape, np.int64),
        price=rng.integers(90, 110, shape),
        volume=rng.integers(1, 50, shape),
        oid=np.arange(rows * t).reshape(shape) + 1,
        uid=np.ones(shape, np.int64),
    )
    return DeviceOp(**{
        k: np.ascontiguousarray(v, np.int32 if k in GRID_I32_FIELDS
                                else numpy_dtype(dtype))
        for k, v in f.items()})


def _time_chain(fn, books0, args, reps: int, device) -> float:
    """Seconds a step over a serial chain of reps steps (the books of one
    step feed the next), after one warm step; synchronized around."""
    fn(books0, *args)
    _sync(device)
    books = books0
    t0 = time.perf_counter()
    for _ in range(reps):
        books, _ = fn(books, *args)
    _sync(device)
    return (time.perf_counter() - t0) / reps


def _trace_chain(fn, books0, args, reps: int, device) -> dict:
    """One serial chain under torch.profiler: per step, what ran on the
    device (the card's kernels and copies; on the CPU the top-level aten
    ops) by name and count, the device's busy time, and the chain's
    wall. Two paths that launch the same work show the same names and
    busy time; a wall delta beside an equal busy time is host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    fn(books0, *args)
    _sync(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        books = books0
        t0 = time.perf_counter()
        for _ in range(reps):
            books, _ = fn(books, *args)
        _sync(device)
        wall = time.perf_counter() - t0
    want = DeviceType.CUDA if cuda else DeviceType.CPU
    names: dict = {}
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type != want or (not cuda and ev.cpu_parent is not None):
            continue
        names[ev.name] = names.get(ev.name, 0) + 1
        busy_us += ev.time_range.elapsed_us()
    return {"launches_per_step": round(sum(names.values()) / reps, 3),
            "busy_ms_per_step": round(busy_us / reps / 1e3, 4),
            "wall_ms_per_step": round(wall / reps * 1e3, 4),
            "names": dict(sorted(names.items()))}


def _in_turns(a, b, turns: list) -> tuple[float, float]:
    """Two timings taken in turns (a, b, b, a), each the mean of its two
    runs, after one untimed run of each: the first chain of a process
    pays the caching allocator's first blocks and the card's clock ramp
    (on the H100 the first timed chain ran 0.025-0.048 ms a step slower
    than the three after it, with the same device work), which the turns,
    cancelling only a linear drift, would charge to whichever path runs
    first. The four timed runs' ms are appended to `turns`."""
    a(), b()
    a1, b1, b2, a2 = a(), b(), b(), a()
    turns.extend(round(x * 1e3, 4) for x in (a1, b1, b2, a2))
    return (a1 + a2) / 2, (b1 + b2) / 2


def part_a(device: str = "cuda", symbols: int = A_SYMBOLS, t: int = A_T,
           cap: int = A_CAP, reps: int = 100, dense_rows: int = 1024,
           trace_reps: int = 20) -> dict:
    """Unsharded vs one-block mesh, full and dense grids: per-step times,
    the overhead, and max |err| between the two paths' books and
    outputs (must be 0). The full grid's two chains are also traced
    (`full_trace`, trace_reps steps each): the overhead's device share
    is the busy-time delta, and the launch lists say whether the two
    paths ran the same device work."""
    import torch

    from ..engine import BookConfig, init_books
    from ..engine.batch import BatchEngine
    from ..parallel import (make_mesh, shard_batch, sharded_batch_step,
                            sharded_dense_step)

    dev = torch.device(device)
    config = BookConfig(cap=cap, max_fills=16, dtype=torch.int32)
    rng = np.random.default_rng(3)
    out: dict = {}
    mesh = make_mesh(1, devices=[dev])

    eng = BatchEngine(config, n_slots=symbols, max_t=t, device=dev)
    grid = _grid(rng, symbols, t, config.dtype, action="draw")
    ops = eng._upload_tree(grid)
    books0 = init_books(config, symbols, dev)
    stepper = sharded_batch_step(config, mesh)
    books_m, ops_m = shard_batch(mesh, books0), shard_batch(mesh, ops)
    ub, uo = eng._step(books0, ops)
    mb, mo = stepper(books_m, ops_m)
    _sync(dev)
    out["full_max_abs_err"] = max(max_abs_err(ub, mb.gather()),
                                  max_abs_err(uo, mo.gather()))
    t_un, t_m1 = _in_turns(
        lambda: _time_chain(lambda b, o: eng._step(b, o), books0, (ops,),
                            reps, dev),
        lambda: _time_chain(lambda b, o: stepper(b, o), books_m, (ops_m,),
                            reps, dev), out.setdefault("full_turns_ms", []))
    out["full_unsharded_ms"] = round(t_un * 1e3, 4)
    out["full_mesh1_ms"] = round(t_m1 * 1e3, 4)
    out["full_mesh1_overhead_pct"] = round((t_m1 / t_un - 1) * 100, 1)
    out["full_mesh1_overhead_ms"] = round((t_m1 - t_un) * 1e3, 4)
    tr_un = _trace_chain(lambda b, o: eng._step(b, o), books0, (ops,),
                         trace_reps, dev)
    tr_m1 = _trace_chain(lambda b, o: stepper(b, o), books_m, (ops_m,),
                         trace_reps, dev)
    out["full_trace"] = dict(
        reps=trace_reps, unsharded=tr_un, mesh1=tr_m1,
        same_launches=tr_un["names"] == tr_m1["names"],
        busy_delta_ms=round(tr_m1["busy_ms_per_step"]
                            - tr_un["busy_ms_per_step"], 4),
        wall_delta_ms=round(tr_m1["wall_ms_per_step"]
                            - tr_un["wall_ms_per_step"], 4))

    dgrid = _grid(rng, dense_rows, t, config.dtype, action="draw")
    dops = eng._upload_tree(dgrid)
    ids = np.arange(dense_rows, dtype=np.int64)
    dstepper = sharded_dense_step(config, mesh)
    dops_m = shard_batch(mesh, dops)
    ub, uo = eng._step(books0, dops, ids)
    mb, mo = dstepper(books_m, ids, dops_m)
    _sync(dev)
    out["dense_max_abs_err"] = max(max_abs_err(ub, mb.gather()),
                                   max_abs_err(uo, mo.gather()))
    t_d, t_dm = _in_turns(
        lambda: _time_chain(lambda b, o: eng._step(b, o, ids), books0,
                            (dops,), reps, dev),
        lambda: _time_chain(lambda b, o: dstepper(b, ids, o), books_m,
                            (dops_m,), reps, dev),
        out.setdefault("dense_turns_ms", []))
    out["dense_unsharded_ms"] = round(t_d * 1e3, 4)
    out["dense_mesh1_ms"] = round(t_dm * 1e3, 4)
    out["dense_mesh1_overhead_pct"] = round((t_dm / t_d - 1) * 100, 1)
    out["orders_per_step"] = symbols * t
    out["geometry"] = dict(symbols=symbols, t=t, cap=cap, dtype="int32",
                           dense_rows=dense_rows, reps=reps,
                           timing="chains in turns (A, B, B, A), mean")
    out["device"] = str(dev)
    return out


def part_b(symbols: int = A_SYMBOLS, frames: int = 64,
           frame_n: int = 8192) -> dict:
    """Row-padding overhead of per-shard max bucketing under Zipf skew —
    the packer's own arithmetic on the host (dense_geometry)."""
    rng = np.random.default_rng(11)
    rows = {}
    for d in CURVE_D:
        ratios = []
        for _ in range(frames):
            live = np.unique(zipf_draws(rng, 1.2, frame_n) % symbols)
            ratios.append(dense_geometry(live, symbols, d)["dispatched_rows"]
                          / len(live))
        ratios = np.asarray(ratios)
        rows[f"D{d}"] = dict(
            p50_rows_per_live_lane=round(float(np.median(ratios)), 2),
            p95_rows_per_live_lane=round(float(np.percentile(ratios, 95)), 2),
        )
    return rows


def curve_devices(device: str, d: int, per_card: bool) -> list:
    """d shard devices: all `device` (one card), or with per_card one
    card a shard where there are cards (cuda:i mod the card count)."""
    import torch

    dev = torch.device(device)
    if per_card and dev.type == "cuda":
        n = torch.cuda.device_count()
        return [torch.device("cuda", i % n) for i in range(d)]
    return [dev] * d


def curve(device: str = "cuda", reps: int = 20, symbols: int = C_SYMBOLS,
          t: int = C_T, cap: int = C_CAP, per_card: bool = False,
          profile: bool = True, shard_repeats: int = 3) -> dict:
    """The D=1/2/4/8 dense curve (the MULTICHIP_CUDA_r01 document, less
    its provenance). Raises if the packer declines a dense grid or a D's
    books or outputs differ from the unsharded step's."""
    import torch

    from ..engine import BookConfig, DeviceOp
    from ..engine.batch import BatchEngine
    from ..parallel import make_mesh, shard_batch, shard_execution_report

    config = BookConfig(cap=cap, max_fills=8, dtype=torch.int32)
    rng, live = curve_live_set(symbols)
    home = torch.device(device)
    points = []
    for d in CURVE_D:
        mesh = make_mesh(d, devices=curve_devices(device, d, per_card))
        eng = BatchEngine(config, n_slots=symbols, max_t=t, mesh=mesh)
        use_dense, n_rows, lane_ids, _ = eng._grid_geometry(live)
        if not use_dense:
            raise RuntimeError(f"dense packer declined at D={d}")
        grid = _grid(rng, n_rows, t, config.dtype)
        ops = shard_batch(mesh, grid)
        kb, ko = eng._step(eng.books, ops, lane_ids)
        # The unsharded dense step on the same rows, live rows first.
        perm = np.argsort(lane_ids >= symbols, kind="stable")
        u = BatchEngine(config, n_slots=symbols, max_t=t, device=home)
        ub, uo = u._step(u.books, u._upload_tree(DeviceOp(
            *(a[perm] for a in grid))), lane_ids[perm])
        at = torch.from_numpy(perm).to(home)
        err = max(max_abs_err(kb.gather(home), ub),
                  max_abs_err(type(ko)(*(a[at] for a in ko)), uo))
        if err:
            raise RuntimeError(f"D={d}: books or outputs differ from the "
                               f"unsharded dense step (max |err| {err})")
        per_step = _time_chain(lambda b, o: eng._step(b, o, lane_ids),
                               eng.books, (ops,), reps, home)
        geo = dense_geometry(live, symbols, d)
        point = dict(
            devices=d,
            dispatched_rows=int(n_rows),
            live_lanes=int(len(live)),
            rows_per_live_lane=round(n_rows / len(live), 4),
            live_per_shard=geo["live_per_shard"],
            shard_skew=geo["shard_skew"],
            step_ms=round(per_step * 1e3, 4),
            live_orders_per_sec=round(len(live) * t / per_step),
            dispatched_orders_per_sec=round(n_rows * t / per_step),
            max_abs_err_vs_unsharded=err,
            shard_devices=sorted({str(x) for x in mesh.devices}),
        )
        if d > 1:
            point["per_shard"] = shard_execution_report(
                config, mesh, eng.books, lane_ids, ops,
                repeats=shard_repeats)
        points.append(point)
        print(json.dumps({"multichip_point": point}), flush=True)
        del eng, u
    doc = dict(
        artifact=ARTIFACT,
        method=(
            "measured D=1/2/4/8 dense mesh dispatch over one fixed Zipf(1.2) "
            "live set; the engine's _grid_geometry layout through "
            "BatchEngine._step -> parallel.sharded_dense_step, a serial "
            f"chain, mean of {reps} reps after one warm step; each shard's "
            f"block replayed alone (shard_execution_report, best of "
            f"{shard_repeats}); every "
            "D's books and outputs equal to the unsharded dense step on the "
            "same rows"
        ),
        device=str(home),
        n_devices_available=(torch.cuda.device_count()
                             if home.type == "cuda" else 1),
        torch=torch.__version__,
        geometry=dict(symbols=symbols, t=t, cap=cap, reps=reps,
                      dtype="int32", seed=C_SEED, per_card=per_card),
        curve=points,
    )
    if profile:
        from ..obs import profiler

        doc["profile"] = profiler.bench_measured("int32", repeats=4,
                                                 device=home)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skew", action="store_true", help="part B (host only)")
    ap.add_argument("--curve", action="store_true", help="part C")
    ap.add_argument("--out", default=f"{ARTIFACT}.json",
                    help="--curve: the artifact's path")
    ap.add_argument("--devices", action="store_true",
                    help="--curve: one card a shard where there are cards")
    ap.add_argument("--reps", type=int, default=0,
                    help="steps timed a point (default: A 100, C 20)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    if args.skew:
        print(json.dumps({"mesh_dense_row_padding_zipf": part_b()}))
        return 0
    if args.curve:
        doc = curve(device, reps=args.reps or 20, per_card=args.devices)
        doc["provenance"] = provenance(device)
        write_json(args.out, doc, sort_keys=False)
        print(f"wrote {args.out}")
        return 0
    print(json.dumps({"mesh_overhead_mesh1": part_a(
        device, reps=args.reps or 100)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
