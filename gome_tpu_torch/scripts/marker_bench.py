"""The RESP marker store's throughput on the split topology's admission
path (the port of scripts/marker_bench.py): a thread-per-connection
Python server sits on every partition's admission path, and this bounds
it.

Against a fresh ``python -m gome_tpu_torch.persist.respserver`` process
over a real socket it measures:

  * mark_frame-style marking: grouped variadic HSETs, one pipelined round
    trip a frame (the gateway's side);
  * admission-style consumption: one pipelined round trip of per-key
    HDELs a frame (the consumer's side).

It prints one JSON line: the two directions' orders/s (wall clock),
each as the reference's line under ``directions``. It launches nothing
on a card: it measures the host's marker server.

    python -m gome_tpu_torch.scripts.marker_bench
    python -m gome_tpu_torch.scripts.marker_bench --orders 65536 --frame 8192
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .fleet_drill import start_respserver


def frames_of(n: int, frame: int, n_symbols: int, seed: int = 5) -> tuple:
    """ADD-only ORDER frame columns over n_symbols symbols, one uuid,
    fresh oids; returns (frames, symbols)."""
    rng = np.random.default_rng(seed)
    symbols = [f"sym{i}" for i in range(n_symbols)]
    frames = []
    oid0 = 0
    for start in range(0, n, frame):
        k = min(frame, n - start)
        frames.append(dict(
            n=k,
            action=np.ones(k, np.uint8),
            symbols=symbols,
            symbol_idx=rng.integers(0, n_symbols, k).astype(np.uint32),
            uuids=["u"],
            uuid_idx=np.zeros(k, np.uint32),
            oids=np.char.add(
                "o", np.arange(oid0, oid0 + k).astype("U12")).astype("S"),
        ))
        oid0 += k
    return frames, symbols


def measure(n: int = 1 << 20, frame: int = 1 << 15,
            n_symbols: int = 1024) -> list[dict]:
    """Both directions against a fresh marker server; the reference's
    two result lines. Raises unless every marked key is consumed once."""
    from ..engine.prepool import RespPrePool
    from ..persist.resp import RespClient

    procs: dict = {}
    try:
        pool = RespPrePool(RespClient(port=start_respserver(procs)))
        frames, symbols = frames_of(n, frame, n_symbols)

        # Warm-up (connection, the server's first dispatch).
        pool.mark_frame(frames[0])
        t0 = time.perf_counter()
        for cols in frames[1:]:
            pool.mark_frame(cols)
        mark_s = time.perf_counter() - t0
        n_marked = sum(int(c["n"]) for c in frames[1:])

        def consume(cols):
            keys = [(symbols[k], "u", o.decode()) for k, o in zip(
                cols["symbol_idx"].tolist(), cols["oids"].tolist())]
            return pool.consume_batch(keys)

        consume(frames[0])
        t0 = time.perf_counter()
        hits = 0
        for cols in frames[1:]:
            hits += sum(consume(cols))
        del_s = time.perf_counter() - t0
        if hits != n_marked:
            raise RuntimeError(f"consumed {hits} marks of {n_marked}")
    finally:
        if "respserver" in procs:
            procs["respserver"].kill()
    return [
        {"metric": f"marker-server mark_frame (grouped variadic HSET, "
                   f"{frame}-order frames, real RESP socket)",
         "value": round(n_marked / mark_s), "unit": "orders/sec"},
        {"metric": f"marker-server consume (pipelined HDEL, "
                   f"{frame}-order frames, real RESP socket)",
         "value": round(n_marked / del_s), "unit": "orders/sec"},
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--orders", type=int, default=1 << 20)
    ap.add_argument("--frame", type=int, default=1 << 15)
    ap.add_argument("--symbols", type=int, default=1024)
    args = ap.parse_args(argv)
    mark, consume = measure(args.orders, args.frame, args.symbols)
    print(json.dumps({"metric": "marker-server admission path",
                      "mark_orders_per_sec": mark["value"],
                      "consume_orders_per_sec": consume["value"],
                      "directions": [mark, consume]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
