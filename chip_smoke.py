#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any mismatch or fault ends the run with a non-zero exit:

  1. device and build: requires CUDA, prints the card's name and power
     limit, builds the match-step kernel from gome_tpu_torch/ops/csrc;
  2. the kernel against its plain PyTorch version on the card, equal on
     every book and StepOutput leaf: (a) S=10,240 x T=32, cap 256, K 16,
     int32, three chained grids; (b) the same flow at int64, S=1,024;
     (c) cap 8,192 int64 (the device-memory instantiation); (d) K = cap;
  3. the port's main path against the port's oracle: MatchEngine
     .process_columnar on a 200,000-order Zipf flow over 10,240 symbols
     (cap 256, K 16, int32), then .process on a hot-symbol mixed stream at
     cap 64, K 4 (cap and fill-record escalation); events equal, books
     verified; the kernel's launch count must account for every device
     call of both engines;
  4. times: the kernel and its plain version on the (a) grid (CUDA events,
     median), the columnar run's orders/s, each beside the card's name and
     power limit.

The last two lines are the kernel table (JSON) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_ROWS = dict(
    match_step=dict(
        route="cuda",
        source="gome_tpu_torch/ops/csrc/match_step.cu",
        replaces="gome_tpu/ops/pallas_match.py:306 (pallas_batch_step)",
    ),
)

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bandwidth,
# and INT32 issue rate = 132 SMs x 64 INT32 lanes x 1.98 GHz boost.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 132 * 64 * 1.98e9

MID = 1_000_000
LOT_MAX32 = (1 << 30) - 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 2 inputs ----------------------------------------------------------

def deep_books(rng, config, s: int, fill: float, device):
    """Random books that satisfy every invariant: side 0 descending, side 1
    ascending prices in runs of 4 (FIFO seq within a level), count up to
    fill * cap, unique oids, zero tails."""
    from gome_tpu_torch.engine.book import BookState, numpy_dtype

    cap = config.cap
    dt = numpy_dtype(config.dtype)
    count = rng.integers(0, int(fill * cap) + 1, size=(s, 2)).astype(np.int32)
    slot = np.arange(cap)
    active = slot[None, None, :] < count[:, :, None]
    level = slot // 4
    price = np.stack(
        [np.broadcast_to(MID - 1 - level, (s, cap)),
         np.broadcast_to(MID + 1 + level, (s, cap))], axis=1)
    lots = rng.integers(1, 101, size=(s, 2, cap))
    seq = np.broadcast_to(slot + 1, (s, 2, cap))
    oid = (np.arange(s * 2 * cap).reshape(s, 2, cap) + 1)
    uid = rng.integers(1, 9, size=(s, 2, cap))
    z = lambda a, d: torch.from_numpy(
        np.where(active, a, 0).astype(d)).to(device)
    return BookState(
        price=z(price, dt), lots=z(lots, dt), seq=z(seq, np.int32),
        oid=z(oid, dt), uid=z(uid, dt),
        count=torch.from_numpy(count).to(device),
        next_seq=torch.from_numpy(
            count.max(axis=1).astype(np.int32)).to(device),
    ), (price, oid, count)


def flow_grids(rng, config, s: int, t: int, g: int, seeded, device,
               heavy_frac: float = 0.05, build_frac: float = 0.25):
    """g chained [s, t] grids: limit ADDs around MID (crossing lanes) or on
    their own side (building lanes, which fill up and overflow), ~20%
    market ADDs, DELs of earlier ADDs and of seeded resting orders at their
    exact price, DELs that miss, NOPs. Heavy lanes carry lots near the
    int32 lot ceiling so depth sums saturate."""
    from gome_tpu_torch.engine.book import DeviceOp, numpy_dtype

    dt = numpy_dtype(config.dtype)
    seed_price, seed_oid, seed_count = seeded
    lane = np.arange(s)
    building = rng.random(s) < build_frac
    heavy = rng.random(s) < heavy_frac
    h = g * t
    hist_oid = np.zeros((s, h), np.int64)
    hist_price = np.zeros((s, h), np.int64)
    hist_side = np.zeros((s, h), np.int64)
    hist_n = np.zeros(s, np.int64)
    next_oid = 10**9
    grids = []
    for _ in range(g):
        cols = {f: np.zeros((s, t), np.int64) for f in DeviceOp._fields}
        for k in range(t):
            u = rng.random(s)
            side = rng.integers(0, 2, size=s)
            add = u < 0.6
            market = add & (rng.random(s) < 0.2)
            del_prior = (u >= 0.6) & (u < 0.8)
            del_miss = (u >= 0.8) & (u < 0.9)
            off = np.where(building, 3, -8)
            tick = rng.integers(0, 20, size=s)
            price = np.where(side == 0, MID - off - tick, MID + off + tick)
            vol = np.where(
                heavy, rng.integers(LOT_MAX32 // 2, LOT_MAX32, size=s),
                rng.integers(1, 120, size=s))
            oid = next_oid + lane * (g * t) + len(grids) * t + k
            # DEL of an earlier ADD (may have filled) or of a seeded order.
            pick = (rng.random(s) * np.maximum(hist_n, 1)).astype(np.int64)
            use_hist = (hist_n > 0) & (rng.random(s) < 0.6)
            seed_side = rng.integers(0, 2, size=s)
            seed_slot = (rng.random(s) * np.maximum(
                seed_count[lane, seed_side], 1)).astype(np.int64)
            d_oid = np.where(use_hist, hist_oid[lane, pick],
                             seed_oid[lane, seed_side, seed_slot])
            d_price = np.where(use_hist, hist_price[lane, pick],
                               seed_price[lane, seed_side, seed_slot])
            d_side = np.where(use_hist, hist_side[lane, pick], seed_side)
            c = cols
            c["action"][:, k] = np.where(add, 1, np.where(
                del_prior | del_miss, 2, 0))
            c["side"][:, k] = np.where(del_prior, d_side, side)
            c["is_market"][:, k] = market
            c["price"][:, k] = np.where(
                market, 0, np.where(del_prior, d_price, np.where(
                    del_miss, price + 1, price)))
            c["volume"][:, k] = vol
            c["oid"][:, k] = np.where(del_prior, d_oid, np.where(
                del_miss, oid + 7, oid))
            c["uid"][:, k] = 1 + (lane + k) % 8
            rest = add & ~market
            hist_oid[lane[rest], hist_n[rest]] = oid[rest]
            hist_price[lane[rest], hist_n[rest]] = price[rest]
            hist_side[lane[rest], hist_n[rest]] = side[rest]
            hist_n += rest
        grids.append(DeviceOp(**{
            f: torch.from_numpy(
                v.astype(np.int32 if f in ("action", "side", "is_market")
                         else dt)).to(device)
            for f, v in cols.items()
        }))
    return grids


def max_abs_err(a, b) -> int:
    """Largest |a - b| over every leaf of two NamedTuples of tensors;
    raises on a shape or dtype mismatch."""
    worst = 0
    for name, x, y in zip(a._fields, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(
                f"{name}: {x.dtype}{tuple(x.shape)} vs {y.dtype}{tuple(y.shape)}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = int(d.max()) if d.numel() else 0
        if err:
            at = np.unravel_index(int(d.argmax()), tuple(d.shape))
            print(f"  mismatch in {name} at {at}: kernel {int(x[at])} "
                  f"plain {int(y[at])}", file=sys.stderr)
        worst = max(worst, err)
    return worst


def check_kernel_case(label, config, books, grids) -> int:
    """Chain the grids through the kernel and the plain version from the
    same books; every leaf must be equal. Returns the worst |error|."""
    from gome_tpu_torch.ops.match_step import batch_step, batch_step_reference

    bk, bp = books, books
    worst, fills, cancels, overflows = 0, 0, 0, 0
    for i, ops in enumerate(grids):
        bk, ok_ = batch_step(config, bk, ops)
        bp, op_ = batch_step_reference(config, bp, ops)
        if bk.price.is_cuda:
            torch.cuda.synchronize()
        err = max(max_abs_err(ok_, op_), max_abs_err(bk, bp))
        if err:
            raise SystemExit(f"phase 2 {label}: grid {i} differs (max |err| {err})")
        worst = max(worst, err)
        fills += int(ok_.n_fills.sum())
        cancels += int(ok_.cancel_found.sum())
        overflows += int(ok_.book_overflow.sum())
    s, t = grids[0].action.shape
    print(f"phase 2 {label}: S={s} T={t} cap={config.cap} "
          f"K={config.max_fills} {str(config.dtype)[6:]} x{len(grids)} grids: "
          f"equal on every leaf ({fills} fills, {cancels} cancels, "
          f"{overflows} overflows)")
    return worst


def phase2(device, sizes) -> tuple[int, tuple]:
    from gome_tpu_torch.engine.book import BookConfig
    from gome_tpu_torch.ops.match_step import uses_shared_memory

    rng = np.random.default_rng(20261017)
    worst = 0
    cases = [
        ("(a)", BookConfig(cap=256, max_fills=16, dtype=torch.int32),
         sizes["a"], 32, 0.6),
        ("(b)", BookConfig(cap=256, max_fills=16, dtype=torch.int64),
         sizes["b"], 32, 0.6),
        ("(c)", BookConfig(cap=8192, max_fills=16, dtype=torch.int64),
         sizes["c"], 32, 0.9),
        ("(d)", BookConfig(cap=32, max_fills=32, dtype=torch.int32),
         sizes["d"], 32, 0.9),
    ]
    timing_input = None
    for label, config, s, t, fill in cases:
        if label == "(c)" and device.type == "cuda" and uses_shared_memory(
                config.cap, config.dtype):
            raise SystemExit("phase 2 (c): expected the device-memory path")
        books, seeded = deep_books(rng, config, s, fill, device)
        grids = flow_grids(rng, config, s, t, 3, seeded, device)
        worst = max(worst, check_kernel_case(label, config, books, grids))
        if label == "(a)":
            timing_input = (config, books, grids[0])
    return worst, timing_input


# -- phase 3 -----------------------------------------------------------------

def run_engine(engine, orders, batch: int, columnar: bool):
    """Mark every ADD (as the gateway would), then feed micro-batches.
    Returns (events, seconds spent inside the engine calls)."""
    for o in orders:
        engine.mark(o)
    events, spent = [], 0.0
    batches = []
    for i in range(0, len(orders), batch):
        chunk = orders[i:i + batch]
        t0 = time.perf_counter()
        out = (engine.process_columnar(chunk) if columnar
               else engine.process(chunk))
        spent += time.perf_counter() - t0
        batches.append(out)
    for out in batches:
        events.extend(out.to_results() if columnar else out)
    return events, spent


@contextlib.contextmanager
def step_timer(engine):
    """Bracket every device step of ``engine`` (dense gather, match-step
    kernel, scatter) with CUDA events; yields the list of (start, end)
    event pairs, read after the block (empty off the card)."""
    batch = engine.batch
    inner = batch._step
    spans = []

    def timed(*args):
        if batch.device.type != "cuda":
            return inner(*args)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args)
        b.record()
        spans.append((a, b))
        return out

    batch._step = timed
    try:
        yield spans
    finally:
        del batch._step
    if spans:
        torch.cuda.synchronize()


def oracle_events(orders):
    from gome_tpu_torch.oracle import OracleEngine

    oracle = OracleEngine()
    for o in orders:
        oracle.submit(o)
    return oracle.drain()


def phase3(device, sizes):
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.utils.streams import mixed_stream, multi_symbol_stream

    zipf = multi_symbol_stream(
        n=sizes["zipf_n"], n_symbols=sizes["symbols"], zipf_a=1.2,
        cancel_prob=0.3, seed=7)
    hot = mixed_stream(n=sizes["hot_n"], cancel_prob=0.3, market_prob=0.2,
                       seed=11)
    want_zipf, want_hot = oracle_events(zipf), oracle_events(hot)

    e1 = MatchEngine(BookConfig(cap=256, max_fills=16, dtype=torch.int32),
                     n_slots=sizes["symbols"], max_t=32, device=device)
    e2 = MatchEngine(BookConfig(cap=64, max_fills=4, dtype=torch.int32),
                     n_slots=8, max_t=32, device=device)
    batch_step.launches = 0
    with step_timer(e1) as spans:
        got_zipf, secs = run_engine(e1, zipf, sizes["batch"], columnar=True)
    got_hot, _ = run_engine(e2, hot, 2000, columnar=False)
    launches = batch_step.launches

    for name, got, want in (("columnar Zipf", got_zipf, want_zipf),
                            ("object hot-symbol", got_hot, want_hot)):
        if got != want:
            bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
                if len(got) == len(want) else min(len(got), len(want))
            raise SystemExit(
                f"phase 3 {name}: {len(got)} events vs oracle {len(want)}, "
                f"first difference at {bad}")
    e1.batch.verify_books()
    e2.batch.verify_books()
    calls = e1.stats.device_calls + e2.stats.device_calls
    if launches <= 0 or launches != calls:
        raise SystemExit(
            f"phase 3: {launches} kernel launches for {calls} device calls")
    if e2.stats.cap_escalations == 0 or e2.stats.fill_record_escalations == 0:
        raise SystemExit(f"phase 3: escalations not exercised: {e2.stats}")
    print(f"phase 3: columnar {len(zipf)} orders over {sizes['symbols']} "
          f"symbols -> {len(got_zipf)} events equal to the oracle "
          f"({e1.stats.device_calls} device calls, cap {e1.config.cap}); "
          f"object {len(hot)} hot-symbol orders -> {len(got_hot)} events equal "
          f"({e2.stats.cap_escalations} cap and "
          f"{e2.stats.fill_record_escalations} fill-record escalations, "
          f"cap {e2.config.cap}); books verified; {launches} kernel launches")
    step_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    return launches, len(zipf) / secs, step_s, secs


# -- phase 4 -----------------------------------------------------------------

def time_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median per-call milliseconds with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(config, books, ops) -> tuple[float, str]:
    """Least time for the grid on this card: bytes (each input read once,
    each output written once) over HBM bandwidth, or integer operations
    over the INT32 rate, whichever is larger. Operations follow the data:
    an ADD does a log-depth scan plus ~20 elementwise passes over cap
    slots, a DEL ~10, a NOP none."""
    s, t = ops.action.shape
    cap, k = config.cap, config.max_fills
    item = books.price.element_size()
    book_bytes = s * 2 * cap * (4 * item + 4) + s * 2 * 4 + s * 4
    op_bytes = s * t * (3 * 4 + 4 * item)
    out_bytes = s * t * (7 * k * item + 5 * 4 + 2 * item)
    nbytes = 2 * book_bytes + op_bytes + out_bytes
    n_add = int((ops.action == 1).sum())
    n_del = int((ops.action == 2).sum())
    n_ops = n_add * cap * (math.log2(cap) + 20) + n_del * cap * 10
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    from gome_tpu_torch.ops import build
    from gome_tpu_torch.ops.match_step import batch_step, batch_step_reference

    device = torch.device("cuda")
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    build.load("match_step")
    info = build.build_info.get("match_step")
    print(f"phase 1: match_step kernel ready in {time.perf_counter() - t0:.1f} s"
          + (" (built by nvcc)" if info else " (cached build)"))
    if info:
        for line in info[1].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas: {line.strip()}", file=sys.stderr)

    sizes = dict(a=10240, b=1024, c=64, d=512, zipf_n=200_000,
                 symbols=10240, hot_n=20_000, batch=8192)
    worst, (config, books, ops) = phase2(device, sizes)
    launches, orders_per_s, step_s, engine_s = phase3(device, sizes)

    ms = time_ms(lambda: batch_step(config, books, ops), runs=30)
    plain_ms = time_ms(lambda: batch_step_reference(config, books, ops),
                       runs=5, warmup=1)
    bound, bound_by = bound_ms(config, books, ops)
    print(f"phase 4 [{card}]: match_step kernel {ms:.4f} ms per "
          f"{ops.action.shape[0]}x{ops.action.shape[1]} grid (cap "
          f"{config.cap}, K {config.max_fills}, int32; median of 30); plain "
          f"PyTorch version {plain_ms:.3f} ms (median of 5); bound "
          f"{bound:.4f} ms ({bound_by})")
    print(f"phase 4 [{card}]: MatchEngine.process_columnar "
          f"{orders_per_s:,.0f} orders/s end to end ({sizes['zipf_n']} orders,"
          f" {sizes['symbols']} symbols, micro-batches of {sizes['batch']});"
          f" device step time (gather, kernel, scatter) {step_s:.3f} s of "
          f"{engine_s:.3f} s ({100 * step_s / engine_s:.1f}%)")
    row = dict(name="match_step", **KERNEL_ROWS["match_step"],
               launches=launches, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=bound_by, library_ms=None,
               checked=True)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
