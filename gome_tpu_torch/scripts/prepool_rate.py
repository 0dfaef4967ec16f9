"""The in-process marker store's admission path at frame rate (the port
of scripts/prepool_rate.py).

The single-binary topology keeps pre-pool markers in process (the C++
open-addressing pool, engine.prepool.NativePrePool): the gateway marks on
accept, the consumer consumes at admission, no network hop. This probe
times both halves on frame-shaped columns of the service bench's mixed
flow (common.MixedFlow: dictionary-encoded symbols and uuids, fresh oids,
~45% cancels) at 10,240 symbols, and prints one JSON line of orders/s per
core (process CPU time). It launches nothing on a card: it measures the
host the engine runs on.

For split deployments (gateway and consumer in different processes) the
markers live in a RESP server instead; marker_bench measures that path.

    python -m gome_tpu_torch.scripts.prepool_rate
    python -m gome_tpu_torch.scripts.prepool_rate --orders 16384 --frames 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .common import MIXED_UUIDS, MixedFlow

SYMBOLS = 10_240


def measure(n: int = 262_144, n_frames: int = 8) -> dict:
    """Mark then consume n_frames frames of n mixed-flow orders in the
    engine's pre-pool (make_prepool); the reference's result keys."""
    from ..engine.prepool import NativePrePool, make_prepool

    flow = MixedFlow(np.random.default_rng(11), SYMBOLS)
    names = [f"sym{i}" for i in range(SYMBOLS)]
    frames = [dict(flow.frame(n), symbols=names, uuids=MIXED_UUIDS)
              for _ in range(n_frames)]
    pool = make_prepool()
    if not isinstance(pool, NativePrePool):
        # No native pool on this host (no C++ toolchain): the probe
        # measures the production admission path, which is the native
        # pool — report instead of timing the Python set.
        return {"backend": "unavailable (no native prepool)"}

    # Warm (hash growth, interning) off the clock.
    pool.mark_frame(frames[0])
    pool.consume_frame(frames[0])

    t0 = time.process_time()
    for cols in frames:
        pool.mark_frame(cols)
    mark_cpu = time.process_time() - t0

    t0 = time.process_time()
    total = 0
    for cols in frames:
        pool.consume_frame(cols)
        total += int(cols["n"])
    consume_cpu = time.process_time() - t0
    return {
        "metric": "in-process pre-pool admission (mixed-flow frames, "
        f"{n}-order, {SYMBOLS} symbols)",
        "backend": "native-cc",
        "mark_orders_per_sec_per_core": round(
            n * n_frames / max(mark_cpu, 1e-9)),
        "consume_orders_per_sec_per_core": round(
            total / max(consume_cpu, 1e-9)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--orders", type=int, default=262_144,
                    help="orders a frame")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.orders, args.frames)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
