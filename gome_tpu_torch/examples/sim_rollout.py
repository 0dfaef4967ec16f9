"""Market-simulator rollout — the gome_tpu_torch.sim demo.

The port of the reference's ``examples/sim_rollout.py``. Runs a rollout of
the gym-style environment (Hawkes/Zipf background flow over stacked books,
everything on the device: K5, the Hawkes bin scan, and K1, the match
kernel, on the card), then prints one JSON report with the reference's
keys: throughput (env steps/sec after a warm-up), activity (events and
trades per step, overflow counters), and the statistical diagnostics that
validate the flow model against its configuration (Zipf exponent fit,
empirical vs configured Hawkes branching ratio, inter-window dispersion).

    python -m gome_tpu_torch.examples.sim_rollout --steps 200 --lanes 64 \\
        --out SIM.json [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..engine.book import BookConfig, _host
from ..scripts.common import require_device
from ..sim import EnvConfig, FlowConfig, env_reset, make_manifest, rollout
from ..sim import stats as sim_stats

#: Grids of the flow sampled for the report's statistics.
SAMPLE_GRIDS = 400


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200, help="rollout length")
    ap.add_argument("--lanes", type=int, default=64, help="stacked books")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    config = EnvConfig(
        flow=FlowConfig(n_lanes=args.lanes),
        book=BookConfig(cap=32, max_fills=8, dtype=torch.int32),
    )

    # Warm up off the clock (the kernels' first load, the allocator), then
    # time the same rollout from a fresh reset.
    state, _ = env_reset(config, args.seed, device)
    final, (rewards, info) = rollout(config, state, args.steps)
    sync()
    state, _ = env_reset(config, args.seed, device)
    t0 = time.perf_counter()
    final, (rewards, info) = rollout(config, state, args.steps)
    sync()
    elapsed = time.perf_counter() - t0

    events, trades, b_over, f_over = (
        _host(a) for a in (info.events, info.trades, info.book_overflow,
                           info.fill_overflow))

    # Flow diagnostics on a fresh seeded sample (empty-book pricing —
    # occurrence/type/lane statistics are book-independent).
    n_grids = SAMPLE_GRIDS
    sample = sim_stats.sample_grids(config.flow, args.seed, n_grids,
                                    device=device)
    counts = sim_stats.symbol_counts(sample)
    per_grid = sim_stats.events_per_grid(sample)
    report = {
        "metric": (
            f"sim env rollout, {args.lanes} lanes x {args.steps} steps "
            f"(eager rollout on {device}, background Hawkes/Zipf flow)"
        ),
        "manifest": make_manifest(config, args.seed, args.steps),
        "steps_per_sec": round(args.steps / elapsed, 2),
        "orders_per_sec": round(int(events.sum()) / elapsed),
        "events_per_step": round(float(events.mean()), 3),
        "trades_per_step": round(float(trades.mean()), 3),
        "book_overflow": int(b_over.sum()),
        "fill_overflow": int(f_over.sum()),
        "stats": {
            "n_sample_grids": n_grids,
            "zipf_a_configured": config.flow.zipf_a,
            "zipf_a_fit": round(sim_stats.zipf_exponent(counts), 4),
            "branching_configured": round(
                config.flow.branching_ratio(), 4
            ),
            "branching_empirical": round(
                sim_stats.empirical_branching_ratio(
                    config.flow, int(per_grid.sum()), n_grids
                ), 4
            ),
            "dispersion_index": round(
                sim_stats.dispersion_index(per_grid), 4
            ),
        },
    }
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
