"""Profile the service's host CPU (the port of scripts/profile_consumer.py,
over obs.hostprof).

Two drills:

  consumer (default)   bench.py service_main's setup on the port (the
      engine on the card at 10,240 symbols, cap 256, K 16, int32; an
      OrderConsumer on the frame wire at pipeline depth 2; frames of
      262,144 orders of the mixed flow, 524,288 orders; warmed until the
      geometry holds), then profile the timed consumer drain. Sampling
      (obs.hostprof's in-process sampler: per-stage ns/order and
      collapsed stacks) by default; ``--deterministic`` runs cProfile
      (exact call counts, uniform ~2x inflation).

  --gateway            the admit loop alone: the deterministic host-only
      gateway drill (no engine) under the sampler — measured admit
      ns/order, orders/sec/core, the stage split and the host roofline.
      ``--out HOSTPROF_CUDA_r01.json`` writes the scalar artifact;
      ``--columnar --out HOSTPROF_CUDA_r02.json`` the columnar one (the
      same seeded flow through DoOrderBatch). Each records the card, the
      commit and the command line beside the drill.

    python -m gome_tpu_torch.scripts.profile_consumer
    python -m gome_tpu_torch.scripts.profile_consumer --deterministic
    python -m gome_tpu_torch.scripts.profile_consumer --gateway --out HOSTPROF_CUDA_r01.json
    python -m gome_tpu_torch.scripts.profile_consumer --gateway --columnar --out HOSTPROF_CUDA_r02.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .common import (MIXED_UUIDS, MixedFlow, gateway_step, provenance,
                     require_device, svc_warmup)

N = 524_288
FRAME = 262_144
S = 10_240
CAP = 256
PIPE = 2


def gateway_main(args) -> int:
    """The admit-loop drill: host only, deterministic request stream,
    sampled. Writes the HOSTPROF_CUDA_r01 payload (scalar) or, with
    --columnar, HOSTPROF_CUDA_r02 (the columnar admit core)."""
    from ..obs import hostprof

    doc = hostprof.hostprof_artifact(
        n_orders=args.orders or 30_000,
        seed=args.seed,
        min_samples=args.min_samples,
        # Columnar rounds are ~100x shorter: the sample budget needs far
        # more of them.
        max_rounds=48 if args.columnar else 8,
        artifact="HOSTPROF_CUDA_r02" if args.columnar else "HOSTPROF_CUDA_r01",
        path="columnar" if args.columnar else "scalar",
        batch_n=args.batch_n,
    )
    doc["provenance"] = provenance(args.device)
    drill = doc["drill"]
    print(f"gateway admit: {drill['orders']} orders in {drill['wall_s']}s "
          f"-> {drill['admit_ns_per_order']} ns/order "
          f"({drill['admit_orders_per_sec_per_core']} orders/sec/core), "
          f"{drill['sampler']['samples']} samples "
          f"({drill['sampler']['mode']} mode), "
          f"coverage {drill['coverage_pct']}%", file=sys.stderr)
    for st, row in drill["stages"].items():
        print(f"  {st:<14} {row['pct']:>6.2f}%  "
              f"{row['ns_per_order']:>9.1f} ns/order "
              f"({row['samples']} samples)", file=sys.stderr)
    body = json.dumps(doc, indent=1, default=str)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(body + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(body)
    return 0


def consumer_setup(device: str, orders: int = N, frame: int = FRAME,
                   symbols: int = S, cap: int = CAP, pipeline: int = PIPE,
                   seed: int = 7):
    """bench.py service_main's setup on the port: the engine, a memory bus,
    the consumer, the mixed flow warmed off the record (svc_warmup), then
    every timed frame published (gateway steps). Returns the consumer."""
    import numpy as np
    import torch

    from ..bus import MemoryQueue, QueueBus
    from ..engine import BookConfig, MatchEngine
    from ..service import OrderConsumer

    engine = MatchEngine(BookConfig(cap=cap, max_fills=16,
                                    dtype=torch.int32),
                         n_slots=symbols, max_t=32, device=device)
    bus = QueueBus(MemoryQueue("doOrder"), MemoryQueue("matchOrder"))
    consumer = OrderConsumer(engine, bus, batch_n=1, batch_wait_s=0,
                             match_wire="frame", pipeline_depth=pipeline)
    flow = MixedFlow(np.random.default_rng(seed), symbols)
    names = [f"sym{i}" for i in range(symbols)]
    frame_n = min(frame, orders)

    def make_frame():
        return dict(flow.frame(frame_n), symbols=names, uuids=MIXED_UUIDS)

    n_warm = svc_warmup(engine, consumer, bus, make_frame)
    print(f"warm_frames={n_warm}", file=sys.stderr)
    for _ in range(-(-orders // frame_n)):
        gateway_step(engine, bus.order_queue, make_frame())
    return consumer


def consumer_main(args) -> int:
    from ..engine import frames as engine_frames
    from ..obs import hostprof

    consumer = consumer_setup(args.device, orders=args.orders or N,
                              frame=args.frame, symbols=args.symbols)
    engine_frames.FETCH_SECONDS = 0.0
    prof = sampler = None
    if args.deterministic:
        import cProfile

        prof = cProfile.Profile()
    else:
        sampler = hostprof.HostSampler(hz=args.hz)
    t0 = time.perf_counter()
    c0 = time.process_time()
    if prof is not None:
        prof.enable()
    else:
        sampler.start()
    n_done = consumer.drain()
    if prof is not None:
        prof.disable()
    else:
        sampler.stop()
    cpu = time.process_time() - c0
    wall = time.perf_counter() - t0
    print(f"orders={n_done} wall={wall:.3f}s cpu={cpu:.3f}s "
          f"fetch={engine_frames.FETCH_SECONDS:.3f}s "
          f"-> {n_done / cpu / 1e6:.2f}M orders/sec/core "
          f"({cpu / n_done * 1e6:.3f} us/order) on {args.device}",
          file=sys.stderr)
    if prof is not None:
        import pstats

        st = pstats.Stats(prof, stream=sys.stderr)
        st.sort_stats("cumulative").print_stats(30)
        st.sort_stats("tottime").print_stats(30)
        return 0
    join = hostprof.stage_join(sampler.counts(), n_orders=n_done,
                               window_ns=wall * 1e9)
    print(f"sampled {sampler.samples} stacks ({sampler.mode_used} mode, "
          f"{args.hz} Hz), stage coverage {join['coverage_pct']}%",
          file=sys.stderr)
    for stage, row in join["stages"].items():
        print(f"  {stage:<14} {row['pct']:>6.2f}%  "
              f"{row.get('ns_per_order', 0):>9.1f} ns/order "
              f"({row['samples']} samples)", file=sys.stderr)
    print("# top collapsed stacks:", file=sys.stderr)
    for line in sampler.collapsed(max_lines=20).splitlines():
        print(f"  {line}", file=sys.stderr)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(sampler.collapsed())
        print(f"wrote collapsed stacks -> {args.out}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_consumer",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--gateway", action="store_true",
                    help="profile the gateway admit loop (host-only drill) "
                         "instead of the consumer drain")
    ap.add_argument("--columnar", action="store_true",
                    help="--gateway: the columnar batch admit core "
                         "(HOSTPROF_CUDA_r02)")
    ap.add_argument("--batch-n", type=int, default=1024,
                    help="--gateway --columnar: orders a batch request")
    ap.add_argument("--deterministic", action="store_true",
                    help="consumer drill: cProfile instead of sampling")
    ap.add_argument("--out", default="",
                    help="--gateway: the artifact's path; consumer "
                         "sampling: collapsed stacks")
    ap.add_argument("--orders", type=int, default=0,
                    help="drill size (default: gateway 30,000, consumer "
                         "524,288)")
    ap.add_argument("--frame", type=int, default=FRAME,
                    help="consumer: orders an ORDER frame")
    ap.add_argument("--symbols", type=int, default=S)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--min-samples", type=int, default=800,
                    help="--gateway: re-run rounds until the sampler holds "
                         "this many stacks")
    ap.add_argument("--hz", type=float, default=997.0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    args.device = require_device(args.device)
    if args.gateway:
        return gateway_main(args)
    return consumer_main(args)


if __name__ == "__main__":
    sys.exit(main())
