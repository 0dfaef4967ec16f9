#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any mismatch or fault ends the run with a non-zero exit:

  1. device and build: requires CUDA, prints the card's name and power
     limit, builds the match-step kernel from gome_tpu_torch/ops/csrc
     (nvcc) and, at the same time, the port's native host library from
     gome_tpu_torch/native/csrc (g++); a failed build of either, or no
     g++, fails the run;
  2. the kernel against its plain PyTorch version on the card, equal on
     every book and StepOutput leaf: (a) S=10,240 x T=32, cap 256, K 16,
     int32, three chained grids; (b) the same flow at int64, S=1,024;
     (c) cap 8,192 int64 (the device-memory instantiation); (d) K = cap;
     (e) a main-path dense grid, 2,048 rows x T=512, cap 2,048, K 16,
     int32, one hot row of 512 live ops, one of 256, the rest <= 8;
  3. the port's main path against the port's oracle: MatchEngine
     .process_columnar on a 200,000-order Zipf flow over 10,240 symbols
     (cap 256, K 16, int32), then .process on a hot-symbol mixed stream at
     cap 64, K 4 (cap and fill-record escalation); events equal, books
     verified; the kernel's launch count must account for every device
     call of both engines;
  4. times: the kernel on the (a) and (e) grids (ms: the median of CUDA
     events around one call each, the wrapper's host work included;
     device_ms: CUDA events around launches queued behind a GPU spin, the
     card's time alone) with each grid's bound, the plain version's times,
     the columnar run's orders/s and its device steps split into dense
     gather, kernel and scatter (CUDA events), each beside the card's name
     and power limit;
  5. the frame path: (a) phase 3's Zipf flow through
     MatchEngine.process_frame(fast=True) in frames of 8,192 orders (ADDs
     pre-marked with mark_frame), per-grid cap classes, device-side event
     compaction and the two-phase fetch; events equal to the oracle, books
     verified, launches equal to device calls, at least one grid below the
     storage cap and at least one exact-path fallback (the hot lane's
     storage escalation), and no host sync in any submit_frame
     (torch.cuda.set_sync_debug_mode("error")); (b) a frame whose fills
     overflow the compaction buffer falls back once and raises its
     class's fills floor, and the next such frame does not fall back;
     then orders/s, the device steps' share, the split into gather,
     kernel, scatter, compaction and grid builds, the two fetch phases'
     seconds, and phase 3's orders/s from the same run;
  6. the order consumer: (a) phase 3's flow as ORDER frames through
     OrderConsumer(pipeline_depth=2, match_wire="frame") in bench.py
     --latency's closed loop (per frame a gateway step, encode +
     mark_frame + publish to doOrder, then one run_once), a MatchFeed
     drained over matchOrder: events equal to the oracle, seqs 0..n-1
     once each, every offset committed, books verified, no host sync in
     any submit_frame; (b) the same at depth 0: match-queue bodies
     byte-equal to (a)'s, books equal; (c) a fills-buffer trip with frames
     in flight (rewind, exact re-run, resubmission), and a failed
     consumer.commit (FaultPlan) with frames in flight, replayed through
     step_with_policy; (d) the threaded consumer (start/stop); the kernel
     held against its plain version at the inputs (a)-(c) gave it; then
     orders/s, order->publish p50/p99 and the two fetch phases per depth.
     Phases 5 and 6 run on the port's native host layer (C++ interner,
     pre-pool, grid pack and compact decode) and fail the run without it;
  7. the host layer: (a) phase 6's flow through the consumer at depths 2
     and 0, on the native host layer and on the Python branches (selected
     by patching the port's nativehost.available before the engine is
     built), in the order native, Python, Python, native per depth: every
     run's match-queue bodies byte-equal to phase 6 (a)'s and its books
     equal; orders/s, p50/p99 and the host split of each run; (b) 4
     frames through a bus of two NativeFileQueues (fsync on) in a
     temporary directory: events equal to the oracle, and both logs,
     reopened with the Python FileQueue, give the same records and
     committed offsets; (c) the 200,000 orders as JSON bodies through
     decode_orders_batch (the native parser, which must accept every
     body) against [decode_order(b) ...], in the order native, json,
     json, native: equal, every time printed;
  8. the service: EngineService, built from a Config written in code
     (gRPC on port 0, the ops endpoint on, the engine at 10,240 lanes,
     cap 256, K 16, max_t 32, int64, the json match wire), started on the
     card, three runs: (b) depth 0 and (a) depth 2 with a SubscribeMatches
     stream opened first through the port's OrderStub, (c) depth 0 with
     no subscriber. Phase 3's 200,000 orders ((b), (a): their first
     53,248) go over the wire as DoOrderBatch requests of 4,096 (cancels
     in the mask), one at a time, then two DoOrder and one DeleteOrder;
     the stream must deliver the oracle's events through
     match_result_to_pb, byte for byte, in order ((c): the match queue's
     documents must decode to them); /healthz answers 200 and /metrics
     counts the requests, the orders and the events sent; in (c)
     clients.doorder.load_client (concurrency 8, DoOrderBatch of 1,024)
     sends 200,000 more orders over the 10,240 symbols, every one
     accepted; books verified; K1 held against its
     plain version at the inputs the service gave it. Printed per run:
     orders/s over the wire beside phase 6's in this run, the
     DoOrderBatch round trip p50/p99, K1's launches, the split between
     gateway admission, consumer (and its parts) and feed, and (c)'s
     load_client orders/s;
  9. durability: (a) the crash drill: the flow's first 102,400 orders as
     13 ORDER frames of 8,192 in a file queue, consumed by workers that
     are fresh interpreters (`python3 chip_smoke.py --persist-worker
     ...`: the engine on the card, int32, a Persister every 4 batches,
     OrderConsumer(batch_n=1, match_wire="frame") at depths alternating
     2 and 0, restore_latest()
     before the cycle's FaultPlan is armed): four kills (consumer.commit
     at offset 0, consumer.frame, a torn filelog.offset, a torn
     snapshot.rename) each exiting with EXIT_CODE, then a clean final
     worker; its match-queue bodies byte-equal to an uninterrupted
     worker's, its events equal to the oracle's with seqs 0..n-1 once
     each in the feed, its book digest (every leaf, padding included)
     equal, and K1 equal to its plain version at the inputs its replay
     gave it; per cycle the restore and recovery seconds, the order-log
     messages rewound and the snapshots' bytes and seconds; (b) in the
     final worker, one snapshot of its engine split into export_state,
     np.savez and the fsyncs, one restore into a fresh engine split into
     the load, import_state and the mark rebuild, the restored state
     equal leaf by leaf; (c) phase 8 (c)'s service with a persist:
     section (every 4 batches, one request per consumer batch, file
     bus) and a redis: section naming a FakeRedisServer (marks through
     RespPrePool): the flow's first 20,480 orders over the wire, stopped,
     and a second service over the same directories and store whose
     start() restores: books equal, /durability reports the
     restore, the match queue's documents equal the oracle's with seqs
     0..n-1; orders/s beside phase 8 (c)'s; (d) that engine through
     book_redis_commands into a DictRedis and restore_from_redis into a
     fresh int64 engine: resting orders and marks equal, and 10,000 more
     orders give the oracle's events on both;
 10. the market simulator (gome_tpu_torch.sim): (a) the Hawkes bin scan
     (K5) against its plain version on draws made on the card, T = 32 and
     1,024 from mu and from the stationary intensity, 65,536 (one long
     chain) from the stationary one, and at every edge input
     (hawkes_edge_case: an event in every bin, none, u_ev equal to
     p_event, tied maxima, an intensity at 0, a cut last round, T around
     a warp and a grid): occur, etype, oid and next_oid equal, lam
     bit-equal; ms, device_ms, cycles a bin, the plain version's ms, the
     bound (an event-free bin's update of lam, which no design removes)
     and the chain without speculation beside it, both from a one-warp
     clock64 probe (hawkes_scan.cu) of the add, logf, expf,
     compare-select, shuffle, ballot, shared-load and update latencies;
     (b) the environment at 256 lanes (cap 32, K 8, int32): a 1,000-step
     rollout under set_sync_debug_mode("error") with more than 1,000
     events, more than 100 trades and no overflow, one K1 and one K5
     launch a step; env_step twice on one state equal; run_from_manifest
     twice in the process and once in a fresh `python3 chip_smoke.py
     --sim-worker <manifest>` process, one digest; 50 steps with a
     scripted agent on the card equal to the CPU's with the same draws
     (books, Obs, StepInfo equal; reward, cash and mark to market within
     2**-18 of scale); K1 and K5 equal to their plain versions at the
     rollout's kept inputs (every 250th step and the last); steps/s there
     and at 64 lanes x 200 steps;
     (c) the same at 10,240 lanes, bar the second process, with the CPU
     comparison cut to 10 steps (the CPU's K1 costs ~0.3 s a step at this
     width), and one step split into
     the draws, K5, the resolve and scatter, K1 and the rest; (d) the
     simulator as the service's traffic source: bench.py's _SimFlow pump
     (10,240 lanes x 1,024 bins, sim-side books cap 64 K 8) generates
     25,000 orders, which go through phase 6's consumer at depth 0 in
     ORDER frames of 8,192: events equal to the oracle's, books verified;
     K1 and K5 equal to their plain versions at the inputs of every 128th
     pump and the last, and K1 at the consumer's; the generator's orders/s
     with its split (step_split around flow._gen's parts) and the
     consumer's;
     (e) tests/test_sim.py's statistical bounds on the card's generator,
     and the Zipf fit at 10,240 lanes;
 11. the mesh (gome_tpu_torch.parallel): (a) sharded_batch_step on grid
     (a) and sharded_dense_step on a dense grid of the Zipf flow (a
     quarter frame packed on the books of the first five), at D = 1, 2, 4 on
     cuda:0 blocks: books and every StepOutput leaf equal to the unsharded
     K1 call and to the plain version per shard, one K1 launch per shard;
     (b) phase 3's flow through process_frame(fast) on a D=4 mesh of
     cuda:0 blocks, and on min(4, cards) distinct cards where there are
     two or more: events equal to the oracle, books verified, export_state
     equal to an unsharded engine's, no host sync in any submit_frame, K1
     equal to its plain version at the run's inputs, K1 launches one per
     shard per grid; orders/s beside the unsharded engine's and phase 5's,
     the CUDA-event span of the output gathers onto the home device, and
     shard_execution_report's per-shard ms and skew on the run's widest
     dense grid; (c) ShardedEngine (4 shards) on the flow's first 20,000
     orders: events equal to the oracle; (d) EngineService with
     engine.mesh_devices = the card count serving phase 8 (c)'s flow with
     no subscriber: match-queue bodies byte-equal to phase 8 (c)'s,
     orders/s beside it, then load_client; (e) a snapshot of (b)'s D=4
     engine restored into D = 4, 2, 1 and a non-mesh engine: books equal
     leaf by leaf, 10,000 more orders equal to the oracle on each;
     restore_from_redis into meshes of 4 and 3 shards rounds n_slots to
     the mesh size. (b) to (e) each hold K1 against its plain version at
     the inputs their run gave it, on every card the run used;
 12. the RabbitMQ transport (gome_tpu_torch.bus.amqp, the port's
     FakeBroker in this process): (a) phase 8 (c)'s service (depth 0,
     json wire, no subscriber) booted from a config whose rabbitmq:
     section names the broker, over the flow's first 40,960 orders and
     the unary tail: matchOrder bodies, read back through the service's
     AMQP match queue, the oracle's, the flow's byte-equal to phase 8
     (c)'s, /healthz
     listing both supervised queues with closed breakers, K1 at the
     service's inputs; orders/s beside phase 8 (c)'s and the consumer's
     thread split; (b) the reference's split topology across processes:
     the port's marker server (`python -m
     gome_tpu_torch.persist.respserver`), a consumer process on the card
     (`python3 chip_smoke.py --amqp-consumer ...`: RespPrePool, never
     marks, OrderConsumer at depth 2 on AmqpQueues, no host sync, K1 held
     against its plain version at its own inputs, books verified), then a
     gateway process (`--amqp-gateway`: the race's DEL and marked ADD as
     JSON, then a 102,400-order draw of phase 3's Zipf flow (the same
     generator and seed) in ORDER frames of 8,192 through
     gateway_step into the marker server and doOrder); this process reads
     matchOrder: events equal to the oracle's under the race, one dropped
     ADD in the consumer and the oracle; each process's orders/s and the
     end-to-end rate; (c) the flow's first 20,000 orders through a depth-0
     consumer over SupervisedAmqpQueues of a broker that kills every
     connection at its 9th publish, plus one kill of the consuming
     connection mid-drain: bodies byte-equal to the memory bus's, the
     reconnects counted;
 13. the host-side observability plane (gome_tpu_torch.obs): (a) phase 8
     (c)'s service run twice, with every obs/ flag off and with timeline
     (sampling every 0.25 s), hostprof and placement armed: matchOrder
     bodies byte-equal between the two and to phase 8 (c)'s, no host sync
     in any of the armed run's submit_frame calls, K1 held against its
     plain version at the armed run's deepest and widest grids, both
     orders/s and their ratio (the armed run also installs
     the compile journal by hand and prints its first-seen dispatch
     combos; phase 14 arms it with ops.cost); (b) the armed service with
     ops.trace on
     over the flow's first 20,000 orders (the gateway's scalar loop):
     events equal to the oracle's and
     nonzero gome_stage_seconds counts for pad_pack, device_execute,
     decode and publish, each stage's summed seconds printed; (c) the
     armed run's /timeline (at least 4 samples, cuda:0's live bytes at
     least the books' bytes, one geometry hash on the last two samples),
     /placement (ledger dispatches equal to the dense grids the engine
     ran, their rows per live lane p50, the flow's most frequent symbol on
     top), /capacity (no verdict) and /hostprof (samples and a stage
     table; ?drill=1 and ?format=collapsed), every route with the
     reference's keys and no TPU artifact's value (the placement verdict
     and baselines are the port's own artifacts); (d) the columnar
     gateway admit drill (obs.hostprof.gateway_drill), which must mark
     through the native pre-pool;
 14. the cost model, the profiler, the fleet aggregator and the geometry
     warm-up: (a) phase 8 (c)'s service with ops cost and profile on
     (Config's defaults for both; every other obs flag off): matchOrder
     bodies byte-equal to phase 8 (c)'s, /cost and /profile?refresh=1
     read once mid-flow (from a thread, a quarter of the requests sent) and
     once after: every cost-model entry (batch_step, dense_batch_step,
     lane_scan, compact_accum, scatter_grid) in both, each /profile row
     timed from CUDA kernels (> 0 us a call, at most 105% of its roofline
     ceiling), K1 in batch_step's window once a call (the capture counts
     only its own stream's device events; the consumer's K1 kernels in
     the same trace are counted apart), K1 held against its plain
     version at the run's inputs; the calibrated peaks, the
     armed/disarmed orders/s, and where each /cost read's wall time went
     (StallProbe: the handler's and the consumer's threads); (b) a fleet
     of two partitions (scripts/fleet_drill.py's shape): the port's marker server, per
     partition a gateway process (`python3 chip_smoke.py --fleet-gateway
     ...`: traced scalar loop, file bus, placement) and a consumer process
     on the card (`--fleet-consumer`: EngineService with a redis: store,
     ops.trace on; K1 launches = device calls, K1 at its inputs), the
     flow's first 10,000 orders routed by fleet.partition_of, this
     process's obs.fleet.FLEET polling the four ops servers: merged
     /metrics family totals equal to the members' sums, no unhealthy,
     degraded or failed poll, an exact fleet-wide seq audit, journeys
     stitched across each gateway -> consumer pair, each partition's
     events equal to its oracle's; (c) save_geometry after phase 6's flow,
     then four fresh engines (cold, after load_geometry, after
     load_geometry, cold): the first 8 frames' events equal to each
     other's and the oracle's, their seconds printed;
 15. race drill, mesh across processes, gomelint: (a) an EngineService
     built with GOME_RACECHECK=1 (the lockset detector of
     gome_tpu_torch.analysis.racecheck armed over the feed, its
     SeqTracker and the consumer), four gateway threads through the real
     DoOrder/DeleteOrder handlers, the consumer and feed live, one
     SubscribeMatches drain: orders flowed, no race reported, events equal
     to the oracle's over the order queue; (b) phase 11 (b)'s flow on a
     mesh of two processes (`python3 chip_smoke.py --mesh-rank r ...`,
     fresh interpreters, parallel.multihost_mesh with two shards a rank,
     D = 4): on cuda:0 both (gloo, host staging), and on a card each
     (NCCL) when there are two or more; every rank's events equal to the
     oracle's, its books equal to phase 11 (b)'s single-process D = 4
     engine's, K1 launches = one per local shard per grid, K1 equal to
     its plain version at the rank's inputs; orders/s and the cross-rank
     joins' seconds beside 11 (b)'s; (c) `python -m
     gome_tpu_torch.analysis gome_tpu_torch` exits 0;
 16. fuzz, soak and the compile surface: (a) scripts/fuzz.py's run_case
     (seeds 1000..1099) and run_sim_case (seeds 7000..7003) on the port
     (fuzz_case, fuzz_sim_case: the same rng draws, so a seed gives the
     reference's geometry, mode, orders and chunking; the sim cases'
     flow comes from the port's simulator on the card), every case's
     events equal to the port's oracle's, books verified, K1 launched in
     every case; cases by mode and dtype, escalations, K1 and K5
     launches; (b) scripts/soak.py's run_soak (soak_drill): bench.py's
     mixed flow (MixedFlow) through gateway steps and an OrderConsumer
     at depth 2 (frame wire, memory bus) on an engine of 10,240 symbols,
     cap 256, K 16, int32, frames of 8,192, warmed off the record, then
     settled until the geometry has held for 1,024 frames (at most 3,072),
     then 30 s of wall clock with the timeline and the compile journal
     armed; verdicts live_buffers_flat, rss_bounded, geometry_stable (no
     combo minted in the timed window) and zero_breaker_trips, the
     journal's export inside the committed combo universe (GL906), and
     K1 held against its plain version at the inputs the soak gave it;
     (c) GL906 over phases 13 (a) and 14 (a)'s
     journal exports; (d) `python -m gome_tpu_torch.analysis
     gome_tpu_torch --select GL9 --journal <(b)'s export>` exits 0;
 17. the operator artifacts' drivers (gome_tpu_torch/scripts) and the
     committed artifacts they wrote: (a) obs_snapshot into a temporary
     directory, its capacity smoke ladder (capacity.run_single_sweep)
     at 10,240 symbols, cap 256, K 16, int32, memory bus, frame wire, 4
     points over 3 s of ladder: the ladder's events equal to the oracle's
     for exactly the orders sent, zero seq dupes and gaps, attribution
     within 5% at every point, offered rates strictly increasing, K1 at
     the run's kept inputs; (b) mesh_overhead's part A at 10,240 x 32
     (unsharded and D=1 outputs equal) and its curve at D = 1, 2, 4, 8 on
     cuda:0 blocks (books and outputs equal to the unsharded step's;
     live_per_shard and dispatched_rows equal to MULTICHIP_CUDA_r01.json's
     and to part B's arithmetic); (c) the six *_CUDA_r0N.json artifacts
     load with their schemas and (but the host-deterministic placement
     verdict) name an NVIDIA card, build_verdict() is byte-equal to
     PLACEMENT_CUDA_r01.json, and (a)'s /placement serves it with
     baselines citing MULTICHIP_CUDA_r01 and FLEET_CUDA_r01; (d)
     hostprof.bench_admit() and hostprof_artifact(path="columnar") at
     small round counts, stage coverage >= 80%.

The last two lines are the kernel table (JSON) and
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --k5-times <checkout>

builds K5 of that checkout's package, holds it against that package's
plain version at phase 10 (a)'s draws (T 32 and 1,024) and edge inputs,
times it at T 32, 1,024 and 65,536 and times phase 10 (d)'s generator on
it, and prints one JSON line. Run it on two checkouts in turns (A, B, B,
A, ...) to compare them on one card.

    python3 chip_smoke.py --phase15

runs phase 11 (b)'s one-process D=4 run and then phase 15 alone (about two
minutes on one card; under four cards (b) runs a card a rank too).

    python3 chip_smoke.py --phase17

runs phase 17 alone.

    python3 chip_smoke.py --soak SECONDS
    python3 chip_smoke.py --fuzz N [SEED0]

run phase 16 (b)'s soak for SECONDS, or phase 16 (a)'s fuzz over N
run_case seeds from SEED0 (1000 by default) and the four sim seeds (a
line a case, as scripts/fuzz.py prints them), alone on the card.

    python3 chip_smoke.py --obs-ab

runs phase 8 (c)'s service and flow with every obs/ flag off, with
timeline, hostprof and placement each armed alone, and with all three
(phase 13 (a)'s armed run), in the order off, all, timeline, hostprof,
placement, placement, hostprof, timeline, all, off: bodies byte-equal
in every run; prints one JSON line of each run's orders/s and split.

    python3 chip_smoke.py --prefix-warm-ab

times phase 14 (c)'s warm first frames with and without the reference's
prefix-slice warm-up after load_geometry (three rounds of plain, slices,
slices, plain; events equal across engines).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from gome_tpu_torch.scripts.common import (MIXED_UUIDS, MixedFlow,
                                           card_line, encode_frame,
                                           expected_launches, gateway_step,
                                           host_line, svc_warmup, tail_of,
                                           wire_request)
from gome_tpu_torch.scripts.fleet_drill import fleet_members

KERNEL_ROWS = dict(
    match_step=dict(
        route="cuda",
        source="gome_tpu_torch/ops/csrc/match_step.cu",
        replaces="gome_tpu/ops/pallas_match.py:306 (pallas_batch_step)",
    ),
    hawkes_scan=dict(
        route="cuda",
        source="gome_tpu_torch/ops/csrc/hawkes_scan.cu",
        replaces="gome_tpu/sim/flow.py:228 (_bin_events' lax.scan, XLA)",
    ),
)

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bandwidth,
# and INT32 issue rate = 132 SMs x 64 INT32 lanes x 1.98 GHz boost.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 132 * 64 * 1.98e9

MID = 1_000_000
LOT_MAX32 = (1 << 30) - 1

#: Every ops: flag that arms an obs/ surface (the service runs of phases
#: 8-12 turn them all off; phase 13 arms timeline, hostprof, placement).
ALL_OBS_FLAGS = ("cost", "timeline", "profile", "hostprof", "placement")


def require_host(engine, label: str, host: str = "native") -> str:
    """Fail the run unless the engine runs the selected host branches:
    "native" (nativehost.available(), a NativePrePool, a NativeInterner
    for oids) or "python" (LocalPrePool, Interner). Returns the tag its
    report line carries."""
    from gome_tpu_torch.engine import nativehost

    names = (nativehost.available(), type(engine.pre_pool).__name__,
             type(engine.batch.oids).__name__)
    want = {"native": (True, "NativePrePool", "NativeInterner"),
            "python": (False, "LocalPrePool", "Interner")}[host]
    if names != want:
        raise SystemExit(f"{label}: host layer (available, pre-pool, oid "
                         f"interner) {names}, expected {want}")
    return f"host={host}" + (f" ({host_line()})" if host == "native" else "")


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


def _device_ops(config, cols: dict, device):
    from gome_tpu_torch.engine.book import GRID_I32_FIELDS, DeviceOp, numpy_dtype

    dt = numpy_dtype(config.dtype)
    return DeviceOp(**{
        f: torch.from_numpy(np.ascontiguousarray(
            cols[f], np.int32 if f in GRID_I32_FIELDS else dt)).to(device)
        for f in DeviceOp._fields})


def _edge_books(config, count, lots, oid, device, tail_price: bool = False):
    """Books with deep_books' price levels (runs of 4 around MID), the
    given [s, 2] counts and [s, 2, cap] lots and oids; slots past count are
    zero, except the price leaf when ``tail_price`` (a recentred lane keeps
    stale prices there)."""
    from gome_tpu_torch.engine.book import BookState, numpy_dtype

    s, cap = count.shape[0], config.cap
    dt = numpy_dtype(config.dtype)
    slot = np.arange(cap)
    active = slot[None, None, :] < count[:, :, None]
    level = slot // 4
    price = np.stack([np.broadcast_to(MID - 1 - level, (s, cap)),
                      np.broadcast_to(MID + 1 + level, (s, cap))], axis=1)
    z = lambda a, d: torch.from_numpy(np.where(active, a, 0).astype(d)).to(device)
    return BookState(
        price=(torch.from_numpy(np.ascontiguousarray(price, dt)).to(device)
               if tail_price
               else z(price, dt)),
        lots=z(lots, dt), seq=z(np.broadcast_to(slot + 1, (s, 2, cap)), np.int32),
        oid=z(oid, dt), uid=z(1 + oid % 8, dt),
        count=torch.from_numpy(count.astype(np.int32)).to(device),
        next_seq=torch.from_numpy(
            count.max(axis=1).astype(np.int32)).to(device),
    ), (price, oid, count)


def _mixed_ops(rng, s: int, t: int, seeded, vol_lo: int, vol_hi: int,
               oid_mod: int = 0) -> dict:
    """A random [s, t] grid against seeded books: 70% ADDs (10% of them
    market) from up to 4 levels through the opposite side to cap/4 levels
    deep in their own, 25% DELs of seeded orders (gone or not), 5% NOPs.
    ADD oids are fresh, or drawn from 1..oid_mod to repeat."""
    price, oid, count = seeded
    cap = price.shape[-1]
    lane = np.arange(s)[:, None]
    action = rng.choice([0, 1, 2], p=[0.05, 0.7, 0.25], size=(s, t))
    side = rng.integers(0, 2, size=(s, t))
    market = (action == 1) & (rng.random((s, t)) < 0.1)
    off = rng.integers(-4, max(cap // 4, 2), size=(s, t))
    limit = np.where(side == 0, MID - 1 - off, MID + 1 + off)
    d_side = rng.integers(0, 2, size=(s, t))
    d_slot = (rng.random((s, t)) * np.maximum(count[lane, d_side], 1)).astype(
        np.int64)
    is_del = action == 2
    add_oid = (rng.integers(1, oid_mod + 1, size=(s, t)) if oid_mod
               else 10**9 + np.arange(s * t).reshape(s, t))
    return dict(
        action=action, side=np.where(is_del, d_side, side), is_market=market,
        price=np.where(is_del, price[lane, d_side, d_slot],
                       np.where(market, 0, limit)),
        volume=rng.integers(vol_lo, vol_hi, size=(s, t)),
        oid=np.where(is_del, oid[lane, d_side, d_slot], add_oid),
        uid=rng.integers(1, 9, size=(s, t)),
    )


#: Inputs aimed at the kernel's shortcuts (early exits, rings, searches).
EDGE_CASES = ("deep", "full", "wipe", "del_ends", "dup_oids", "heavy",
              "stale_tails")


def edge_case(rng, config, name: str, s: int, t: int, device):
    """Books and one [s, t] op grid for an edge case of EDGE_CASES:

    deep        flow_grids' mix, every op live (one deep row when s == 1);
    full        both sides at count == cap: inserts overflow, crossings
                free slots at the front, so rings wrap both ways;
    wipe        a limit taker empties the whole opposite side and rests,
                then a market taker empties the other side, then a mix;
    del_ends    DELs of the first and the last live slot, both sides;
    dup_oids    oids repeat within a price level; DELs hit several slots;
    heavy       lots and volumes near LOT_MAX32 (int32 prefixes saturate);
    stale_tails slots past count keep stale prices (as after recentring).
    """
    cap = config.cap
    shape = (s, 2, cap)
    uniq = np.arange(s * 2 * cap).reshape(shape) + 1
    small = lambda: rng.integers(1, 101, size=shape)
    if name == "deep":
        books, seeded = deep_books(rng, config, s, 0.6, device)
        grid = flow_grids(rng, config, s, t, 1, seeded, device,
                          heavy_frac=0.0)[0]
        return books, grid._replace(action=torch.where(
            grid.action == 0, torch.ones_like(grid.action), grid.action))
    if name in ("full", "wipe", "dup_oids", "heavy", "stale_tails"):
        fill = dict(full=1.0, wipe=0.5).get(name, 0.6)
        count = np.full((s, 2), max(1, int(fill * cap)))
        if name in ("dup_oids", "stale_tails"):
            count = rng.integers(1, count + 1)
        lots = (rng.integers(LOT_MAX32 // 2, LOT_MAX32 + 1, size=shape)
                if name == "heavy" else small())
        oid = 1 + np.arange(cap) % 3 if name == "dup_oids" else uniq
        books, seeded = _edge_books(config, count, lots, np.broadcast_to(
            oid, shape), device, tail_price=name == "stale_tails")
        vol = ((LOT_MAX32 // 2, LOT_MAX32) if name == "heavy" else (1, 300))
        cols = _mixed_ops(rng, s, t, seeded, *vol,
                          oid_mod=3 if name == "dup_oids" else 0)
        if name == "wipe":
            live = np.arange(cap)[None, :] < count[:, 1:]
            asks = (lots[:, 1] * live).sum(axis=1)
            bids = (lots[:, 0] * live).sum(axis=1)
            # A BUY limit through every ask level rests 5 lots at the top of
            # the bids; a market SELL then takes every bid.
            for f, a, b in (("action", 1, 1), ("side", 0, 1),
                            ("is_market", 0, 1), ("price", MID + cap, 0),
                            ("volume", asks + 5, bids + 5)):
                cols[f][:, 0], cols[f][:, 1] = a, b
        return books, _device_ops(config, cols, device)
    if name == "del_ends":
        count = np.full((s, 2), max(2, int(0.75 * cap)))
        books, (price, oid, _) = _edge_books(config, count, small(), uniq,
                                             device)
        cols = {f: np.zeros((s, t), np.int64) for f in
                ("action", "side", "is_market", "price", "volume", "oid",
                 "uid")}
        lo, hi = np.zeros((s, 2), np.int64), count - 1
        lane = np.arange(s)
        for k in range(t):
            sd = (k // 2) % 2
            first = k % 2 == 0
            slot = np.where(first, lo[:, sd], hi[:, sd])
            ok = lo[:, sd] <= hi[:, sd]
            cols["action"][:, k] = np.where(ok, 2, 0)
            cols["side"][:, k] = sd
            cols["price"][:, k] = np.where(ok, price[lane, sd, slot], 0)
            cols["oid"][:, k] = np.where(ok, oid[lane, sd, slot], 0)
            if first:
                lo[:, sd] += ok
            else:
                hi[:, sd] -= ok
        return books, _device_ops(config, cols, device)
    raise ValueError(f"unknown edge case {name!r}")


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


def main_path_grid(device, rows: int = 2048, t: int = 512):
    """Phase 2 (e): a dense grid shaped like those of the columnar Zipf run
    of phase 3 once its cap has escalated (cap 2,048, K 16, int32): books
    up to 60% full, one hot row with t live ops (flow_grids' mix), one with
    t / 2, every other row 0 to 8 ops, NOP-padded."""
    from gome_tpu_torch.engine.book import BookConfig, DeviceOp

    rng = np.random.default_rng(20261018)
    config = BookConfig(cap=2048, max_fills=16, dtype=torch.int32)
    books, seeded = deep_books(rng, config, rows, 0.6, device)
    grid = flow_grids(rng, config, rows, t, 1, seeded, device)[0]
    depth = rng.integers(0, 9, size=rows)
    depth[0], depth[1] = t, t // 2
    live = torch.from_numpy(np.arange(t)[None, :] < depth[:, None]).to(device)
    # A NOP of flow_grids carries a limit ADD's fields: make it that ADD.
    action = torch.where(grid.action == 0, 1, grid.action)
    grid = grid._replace(action=action)
    grid = DeviceOp(*(torch.where(live, a, torch.zeros_like(a)) for a in grid))
    return config, books, grid


def phase2(device, sizes) -> tuple[int, dict]:
    """Cases (a)-(d) chain three grids; (e) is one main-path grid, whose
    plain version runs once, timed. Returns the worst |error| and the
    timing inputs of (a) and (e)."""
    from gome_tpu_torch.engine.book import BookConfig
    from gome_tpu_torch.ops.match_step import (
        batch_step,
        batch_step_reference,
        uses_shared_memory,
    )

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
    timing = {}
    for label, config, s, t, fill in cases:
        if label == "(c)" and device.type == "cuda" and uses_shared_memory(
                config.cap, config.dtype):
            raise SystemExit("phase 2 (c): expected the device-memory path")
        books, seeded = deep_books(rng, config, s, fill, device)
        grids = flow_grids(rng, config, s, t, 3, seeded, device)
        worst = max(worst, check_kernel_case(label, config, books, grids))
        if label == "(a)":
            timing["a"] = (config, books, grids[0])
    config, books, grid = main_path_grid(device, sizes["e_rows"], sizes["e_t"])
    new_books, out = batch_step(config, books, grid)
    sync(device)
    t0 = time.perf_counter()
    plain = batch_step_reference(config, books, grid)
    sync(device)
    plain_s = time.perf_counter() - t0
    err = max(max_abs_err(out, plain[1]), max_abs_err(new_books, plain[0]))
    if err:
        raise SystemExit(f"phase 2 (e): differs (max |err| {err})")
    n_live = int((grid.action != 0).sum())
    print(f"phase 2 (e): S={grid.action.shape[0]} T={grid.action.shape[1]} "
          f"cap={config.cap} K={config.max_fills} int32 main-path grid "
          f"({n_live} live ops, hot rows of {int((grid.action[0] != 0).sum())}"
          f" and {int((grid.action[1] != 0).sum())}): equal on every leaf "
          f"({int(out.n_fills.sum())} fills, {int(out.cancel_found.sum())} "
          f"cancels); plain version {1e3 * plain_s:.1f} ms (one run)")
    timing["e"] = (config, books, grid)
    timing["e_plain_ms"] = 1e3 * plain_s
    return worst, timing


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


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
    """Bracket every device step of ``engine`` with CUDA events, and inside
    it the gather (the dense gather, or the full grid's slice to its cap
    class), the match-step kernel and the scatter (the dense scatter, or the
    full grid's write-back); around the whole block also the frame path's
    grid builds and event compactions. Yields a dict of lists of (start,
    end) event pairs ("step", "gather", "kernel", "scatter", "grid_build",
    "compaction"), read after the block (empty off the card), and under
    "grids" the (cap class, storage cap) of every step."""
    from gome_tpu_torch.engine import batch as batch_mod
    from gome_tpu_torch.engine import frames as frames_mod
    from gome_tpu_torch.ops import match_step

    batch = engine.batch
    inner = batch._step
    keys = ("step", "gather", "kernel", "scatter", "grid_build", "compaction")
    spans = {k: [] for k in keys}
    grids = []

    def bracket(fn, key):
        def timed(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            spans[key].append((a, b))
            return out
        return timed

    @contextlib.contextmanager
    def wrapped(places):
        # Each function is wrapped in place and restored (the launch count
        # stays on the kernel wrapper's own function).
        saved = [getattr(mod, name) for mod, name, _ in places]
        for (mod, name, key), fn in zip(places, saved):
            setattr(mod, name, bracket(fn, key))
        try:
            yield
        finally:
            for (mod, name, _), fn in zip(places, saved):
                setattr(mod, name, fn)

    def step(books, ops, lane_ids=None, cap_g=None):
        grids.append((cap_g, batch.config.cap))
        if batch.device.type != "cuda":
            return inner(books, ops, lane_ids, cap_g)
        with wrapped(((batch_mod, "_gather_rows", "gather"),
                      (batch_mod, "_slice_books_cap", "gather"),
                      (match_step, "batch_step", "kernel"),
                      (batch_mod, "_scatter_books_cap", "scatter"),
                      (batch_mod, "_writeback_full_cap", "scatter"))):
            return bracket(inner, "step")(books, ops, lane_ids, cap_g)

    frame_places = ((frames_mod, "_scatter_grid_fn", "grid_build"),
                    (frames_mod, "compact_accum", "compaction"))
    batch._step = step
    try:
        if batch.device.type == "cuda":
            with wrapped(frame_places):
                yield dict(spans, grids=grids)
        else:
            yield dict(spans, grids=grids)
    finally:
        del batch._step
    if spans["step"]:
        torch.cuda.synchronize()


def span_seconds(spans) -> float:
    return sum(a.elapsed_time(b) for a, b in spans) / 1e3


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
    split = {k: span_seconds(v) for k, v in spans.items() if k != "grids"}
    return launches, len(zipf) / secs, split, secs, zipf, want_zipf


# -- phase 5 -----------------------------------------------------------------

def frame_columns(orders) -> dict:
    """Orders -> one decoded ORDER frame, in the layout the wire decoder
    returns: uint8 action/side/kind, int64 price/volume, per-frame symbol
    and uuid dictionaries (first-seen order) with uint32 index columns, and
    the oids as a numpy bytes array."""
    n = len(orders)
    symbols, uuids, sym_ix, uuid_ix = [], [], {}, {}
    symbol_idx = np.empty(n, np.uint32)
    uuid_idx = np.empty(n, np.uint32)
    for i, o in enumerate(orders):
        symbol_idx[i] = sym_ix.setdefault(o.symbol, len(symbols))
        if symbol_idx[i] == len(symbols):
            symbols.append(o.symbol)
        uuid_idx[i] = uuid_ix.setdefault(o.uuid, len(uuids))
        if uuid_idx[i] == len(uuids):
            uuids.append(o.uuid)
    return dict(
        n=n,
        action=np.array([int(o.action) for o in orders], np.uint8),
        side=np.array([int(o.side) for o in orders], np.uint8),
        kind=np.array([int(o.order_type) for o in orders], np.uint8),
        price=np.array([o.price for o in orders], np.int64),
        volume=np.array([o.volume for o in orders], np.int64),
        symbols=symbols, symbol_idx=symbol_idx,
        uuids=uuids, uuid_idx=uuid_idx,
        oids=np.array([o.oid.encode() for o in orders]),
    )


@contextlib.contextmanager
def no_host_sync():
    """Run every frames.submit_frame inside the block under
    torch.cuda.set_sync_debug_mode("error"): a host sync anywhere in it
    (packing, the grids' steps, the compactions, the start of the fetch)
    raises. Yields a list holding the count of checked calls."""
    from gome_tpu_torch.engine import frames

    inner = frames.submit_frame
    checked = [0]

    def submit(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked[0] += 1
        return out

    frames.submit_frame = submit
    try:
        yield checked
    finally:
        frames.submit_frame = inner


@contextlib.contextmanager
def keep_kernel_inputs(every: int = 0):
    """Wrap K1's and K5's wrappers (match_step.batch_step,
    hawkes_scan.hawkes_scan) for the block and keep inputs for
    check_kept_inputs / check_kept_scans to re-run: for each K1 launch
    shape (cap, K, dtype, card) its deepest grid (most ops per row) and its
    widest (most rows); with `every`, also each kernel's first call, every
    `every`-th call after it and its last. The port never writes a
    kernel's input books, ops or draws in place, so they still hold what
    the kernel saw. Yields {wrapper name: {role: (size, args)}}."""
    from gome_tpu_torch.ops import hawkes_scan, match_step

    places = ((match_step, "batch_step"), (hawkes_scan, "hawkes_scan"))
    saved = [getattr(mod, name) for mod, name in places]
    kept = {name: {} for _, name in places}
    calls = dict.fromkeys(kept, 0)

    def hold(name, role, size, args):
        held = kept[name].get(role)
        if held is None or size > held[0]:
            kept[name][role] = (size, args)

    def keeper(fn, name):
        def run(*args):
            n = calls[name]
            calls[name] += 1
            if name == "batch_step":
                config, _, ops = args
                s, t = ops.action.shape
                shape = (f"{config.cap}/K{config.max_fills}/"
                         f"{str(config.dtype)[6:]}{card_tag(ops.action)}")
                hold(name, f"deep {shape}", (t, s), args)
                hold(name, f"wide {shape}", (s, t), args)
            if every:
                if n % every == 0:
                    kept[name][f"call {n}"] = (n, args)
                kept[name]["last"] = (n, args)
            return fn(*args)
        return run

    for (mod, name), fn in zip(places, saved):
        setattr(mod, name, keeper(fn, name))
    try:
        yield kept
    finally:
        for (mod, name), fn in zip(places, saved):
            setattr(mod, name, fn)


def card_tag(t: torch.Tensor) -> str:
    """Empty on the first card, "@cuda:<i>" on any other."""
    return "" if t.device.index in (None, 0) else f"@{t.device}"


def distinct_kept(kept, name) -> list:
    """The kept argument tuples of one wrapper, each once."""
    return list({id(args): args for _, args in kept[name].values()}.values())


#: main() sets this to a list: check_kept_inputs then queues each call's
#: kept K1 grids on the card (not those kept with `every`), and
#: check_queued_inputs holds them all against the plain version after
#: phase 16, the grids of one config in one plain run (plain_grouped),
#: where each call's own plain runs stepped every deep grid's 1,024
#: columns again. The port writes no kernel input in place (the engine's
#: write-backs go into copies), so the kept grids still hold what the
#: kernel saw.
KEPT_QUEUE: list | None = None
#: Cells (rows x columns) of one grouped plain run at most.
GROUP_CELLS = 1 << 21


def kept_shape(config, ops) -> str:
    s, t = ops.action.shape
    return (f"{s}x{t}@{config.cap}/K{config.max_fills}/"
            f"{str(config.dtype)[6:]}{card_tag(ops.action)}")


def kept_line(label, grids, every: bool) -> str:
    shapes: dict = {}
    for config, _, ops in grids:
        shape = kept_shape(config, ops)
        shapes[shape] = shapes.get(shape, 0) + 1
    which = "the deepest and the widest grid of each launch shape"
    if every:
        which += ", every kept call"
    return (f"{label}: kernel equal to its plain version on every leaf at "
            f"the inputs its path gave it ({which}): "
            + ", ".join(f"{k} x{v}" for k, v in shapes.items()))


def kept_error(label, config, ops, err) -> SystemExit:
    s, t = ops.action.shape
    return SystemExit(f"{label}: kernel differs from its plain version on "
                      f"the {s}x{t} grid at cap {config.cap}, K "
                      f"{config.max_fills}, {config.dtype} (max |err| {err})")


def check_kept_inputs(label, kept) -> tuple[int, str]:
    """Re-run every kept K1 grid through the kernel and its plain version;
    every book and StepOutput leaf must be equal. These launches come after
    the main path's count is read. With KEPT_QUEUE set, card grids are
    queued for check_queued_inputs instead. Returns (worst |error|, report
    line)."""
    from gome_tpu_torch.ops.match_step import batch_step, batch_step_reference

    grids = distinct_kept(kept, "batch_step")
    every = "last" in kept["batch_step"]
    if KEPT_QUEUE is not None and grids and not every and \
            all(books.price.is_cuda for _, books, _ in grids):
        KEPT_QUEUE.append((label, grids))
        return 0, (f"{label}: K1 inputs kept at "
                   + ", ".join(kept_shape(c, o) for c, _, o in grids)
                   + "; held against its plain version after phase 16")
    worst = 0
    for config, books, ops in grids:
        nb, out = batch_step(config, books, ops)
        pb, pout = batch_step_reference(config, books, ops)
        sync(books.price.device)
        err = max(max_abs_err(out, pout), max_abs_err(nb, pb))
        if err:
            raise kept_error(label, config, ops, err)
    return worst, kept_line(label, grids, every)


def plain_grouped(config, grids) -> list:
    """batch_step_reference over several (books, ops) grids of one config
    in one run: rows stacked, each grid's ops padded to the widest T with
    NOP columns (a NOP leaves its row's book as it was), so the run steps
    the deepest grid's columns once instead of every grid's. Rows never
    meet in the plain version. Returns each grid's (books, outputs)."""
    from gome_tpu_torch.engine.book import BookState, DeviceOp, StepOutput
    from gome_tpu_torch.ops.match_step import batch_step_reference

    t_max = max(ops.action.shape[1] for _, ops in grids)
    books = BookState(*(torch.cat(leaf) for leaf in zip(*(b for b, _ in grids))))
    ops = DeviceOp(*(
        torch.cat([torch.cat([f, f.new_zeros(f.shape[0], t_max - f.shape[1])],
                             dim=1) for f in leaf])
        for leaf in zip(*(o for _, o in grids))))
    nb, out = batch_step_reference(config, books, ops)
    res, r = [], 0
    for _, o in grids:
        s, t = o.action.shape
        res.append((BookState(*(x[r:r + s] for x in nb)),
                    StepOutput(*(x[r:r + s, :t] for x in out))))
        r += s
    return res


def check_queued_inputs(label: str) -> tuple[int, float]:
    """Hold every grid queued in KEPT_QUEUE against the plain version and
    empty the queue: per config and card, the grids deepest first, in
    plain runs of at most GROUP_CELLS padded cells (plain_grouped), each
    grid's kernel run on its own. Prints each queued call's line as
    check_kept_inputs would have; SystemExit on any difference. Returns
    (worst |error|, seconds)."""
    from gome_tpu_torch.ops.match_step import batch_step

    t0 = time.perf_counter()
    queue = list(KEPT_QUEUE or ())
    KEPT_QUEUE[:] = []
    groups: dict = {}
    for i, (_, grids) in enumerate(queue):
        for config, books, ops in grids:
            groups.setdefault((config, books.price.device), []).append(
                (i, books, ops))
    n_runs = 0
    for (config, device), items in groups.items():
        items.sort(key=lambda it: -it[2].action.shape[1])
        chunks, rows = [], 0
        for it in items:
            s = it[2].action.shape[0]
            if chunks and (rows + s) * chunks[-1][0][2].action.shape[1] \
                    <= GROUP_CELLS:
                chunks[-1].append(it)
                rows += s
            else:
                chunks.append([it])
                rows = s
        for chunk in chunks:
            plain = plain_grouped(config, [(b, o) for _, b, o in chunk])
            n_runs += 1
            for (i, books, ops), (pb, pout) in zip(chunk, plain):
                nb, out = batch_step(config, books, ops)
                sync(device)
                err = max(max_abs_err(out, pout), max_abs_err(nb, pb))
                if err:
                    raise kept_error(queue[i][0], config, ops, err)
    for call_label, grids in queue:
        print(kept_line(call_label, grids, False))
    secs = time.perf_counter() - t0
    print(f"{label}: the {sum(len(g) for _, g in queue)} K1 grids kept by "
          f"{len(queue)} calls held against the plain version in {n_runs} "
          f"grouped plain runs, {secs:.1f} s")
    return 0, secs


def check_kept_scans(label, kept) -> tuple[float, str]:
    """Re-run every kept K5 input through the kernel and its plain version
    (check_scan). Returns (worst |error|, report line)."""
    worst, lengths = 0.0, []
    for config, *args in distinct_kept(kept, "hawkes_scan"):
        worst = max(worst, check_scan(label, config, args)[2])
        lengths.append(args[2].shape[0])
    return worst, (f"{label}: K5 equal to its plain version at "
                   f"{len(lengths)} kept scans of T "
                   f"{'/'.join(str(t) for t in sorted(set(lengths)))}")


def run_frames(engine, frames, fast: bool = True):
    """Mark every frame's ADDs (as the gateway would), then feed the frames
    through MatchEngine.process_frame. Returns (events, seconds spent
    inside the process_frame calls)."""
    for cols in frames:
        engine.mark_frame(cols)
    spent, batches = 0.0, []
    for cols in frames:
        t0 = time.perf_counter()
        batches.append(engine.process_frame(cols, fast=fast))
        spent += time.perf_counter() - t0
    return [ev for b in batches for ev in b.to_results()], spent


def check_events(label, got, want) -> None:
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b) \
            if len(got) == len(want) else min(len(got), len(want))
        raise SystemExit(f"{label}: {len(got)} events vs oracle {len(want)}, "
                         f"first difference at {bad}")


def sweep_pair(r: int):
    """Round r of the fills-buffer flow: 64 symbols with 16 resting one-lot
    SELLs each, then 64 BUYs that each sweep one symbol's 16 (16 fills = K:
    only the fills buffer trips, sized 64 for a 64-op frame)."""
    from gome_tpu_torch.types import Order, Side

    syms = [f"fb{i}" for i in range(64)]
    rest = [Order(uuid="maker", oid=f"fb{r}-{s}-{i}", symbol=s,
                  side=Side.SALE, price=1000 + i, volume=1)
            for s in syms for i in range(16)]
    sweep = [Order(uuid="taker", oid=f"fbx{r}-{s}", symbol=s, side=Side.BUY,
                   price=2000, volume=16) for s in syms]
    return rest, sweep


def fill_buffer_check(device, symbols: int) -> str:
    """Phase 5 (b): sweep_pair's frames, twice. The first sweep frame must
    fall back, raise its class's fills floor to 1,024 and equal the oracle;
    the same pair of frames again must not fall back."""
    from gome_tpu_torch.engine import BookConfig, MatchEngine

    eng = MatchEngine(BookConfig(cap=256, max_fills=16, dtype=torch.int32),
                      n_slots=symbols, max_t=32, device=device)
    host = require_host(eng, "phase 5 (b)")
    orders, got, floors = [], [], []
    for r in range(2):
        rest, sweep = sweep_pair(r)
        orders += rest + sweep
        events, _ = run_frames(eng, [frame_columns(rest),
                                     frame_columns(sweep)])
        got += events
        floors.append((eng.stats.frame_fallbacks,
                       eng.batch._fills_buf_floor.get(64, 0)))
    check_events("phase 5 (b)", got, oracle_events(orders))
    eng.batch.verify_books()
    if floors != [(1, 1024), (1, 1024)]:
        raise SystemExit(f"phase 5 (b): (fallbacks, fills floor of class 64) "
                         f"after each pair {floors}, expected [(1, 1024), "
                         "(1, 1024)]")
    return (f"phase 5 (b): {host}: fills-buffer trip: {len(got)} events "
            f"equal to the oracle; 1 fallback on the first sweep frame, "
            f"class-64 fills floor 64 -> 1024, no fallback on the second")


def phase5(device, sizes, zipf, want_zipf):
    """Phase 5 (a): the phase-3 flow through MatchEngine.process_frame
    (fast) in frames of sizes["batch"] orders, every submit_frame checked
    for host syncs, the kernel held against its plain version at the
    inputs the run gave it; (b) fill_buffer_check. Returns the launches,
    the worst kernel |error|, the orders/s, the split, the fetch seconds
    and the report lines."""
    from gome_tpu_torch.engine import BookConfig, MatchEngine, frames
    from gome_tpu_torch.ops.match_step import batch_step

    frame_list = [frame_columns(zipf[i:i + sizes["batch"]])
                  for i in range(0, len(zipf), sizes["batch"])]
    eng = MatchEngine(BookConfig(cap=256, max_fills=16, dtype=torch.int32),
                      n_slots=sizes["symbols"], max_t=32, device=device)
    host = require_host(eng, "phase 5 (a)")
    frames.FETCH_SECONDS = frames.FETCH_TOTALS_SECONDS = 0.0
    batch_step.launches = 0
    with keep_kernel_inputs() as kept, step_timer(eng) as spans, \
            no_host_sync() as checked:
        got, secs = run_frames(eng, frame_list)
    launches = batch_step.launches
    worst, kept_line = check_kept_inputs("phase 5 (a)", kept)
    check_events("phase 5 (a) frame path", got, want_zipf)
    eng.batch.verify_books()
    st = eng.stats
    if launches <= 0 or launches != st.device_calls:
        raise SystemExit(f"phase 5 (a): {launches} kernel launches for "
                         f"{st.device_calls} device calls")
    below = sum(1 for c, storage in spans["grids"] if c < storage)
    if below == 0:
        raise SystemExit("phase 5 (a): no grid ran below the storage cap")
    if st.frame_fallbacks == 0 or st.cap_escalations == 0:
        raise SystemExit(f"phase 5 (a): the storage escalation did not go "
                         f"through the exact fallback: {st}")
    if checked[0] != len(frame_list):
        raise SystemExit(f"phase 5 (a): {checked[0]} submit_frame calls "
                         f"checked for {len(frame_list)} frames")
    per_class = {}
    for c, _ in spans["grids"]:
        per_class[c] = per_class.get(c, 0) + 1
    split = {k: span_seconds(v) for k, v in spans.items() if k != "grids"}
    fetch = (frames.FETCH_TOTALS_SECONDS,
             frames.FETCH_SECONDS - frames.FETCH_TOTALS_SECONDS)
    lines = [
        f"phase 5 (a): {host}: process_frame(fast) {len(zipf)} orders over "
        f"{sizes['symbols']} symbols in {len(frame_list)} frames -> {len(got)} "
        f"events equal to the oracle; books verified; {launches} kernel "
        f"launches = device calls; grids per cap class "
        f"{dict(sorted(per_class.items()))} ({below} below the storage cap, "
        f"storage cap {eng.config.cap}); {st.grid_cap_escalations} grid-cap "
        f"escalations, {st.cap_escalations} storage escalations, "
        f"{st.frame_fallbacks} frame fallbacks; no host sync in "
        f"{checked[0]} submit_frame calls",
        kept_line,
        fill_buffer_check(device, sizes["symbols"]),
    ]
    return launches, worst, len(zipf) / secs, split, secs, fetch, lines


# -- phase 6 -----------------------------------------------------------------

def consumer_stack(device, symbols: int, depth: int, batch_wait_s: float = 0,
                   host: str = "native", bus=None):
    """A fresh engine (cap 256, K 16, int32) on the given host branches
    (require_host), a bus (memory queues unless given) and an
    OrderConsumer on the frame wire at the given pipeline depth."""
    from gome_tpu_torch.bus import MemoryQueue, QueueBus
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.service import OrderConsumer

    eng = MatchEngine(BookConfig(cap=256, max_fills=16, dtype=torch.int32),
                      n_slots=symbols, max_t=32, device=device)
    require_host(eng, f"consumer at depth {depth}", host)
    if bus is None:
        bus = QueueBus(MemoryQueue("doOrder"), MemoryQueue("matchOrder"))
    consumer = OrderConsumer(eng, bus, batch_n=1, batch_wait_s=batch_wait_s,
                             match_wire="frame", pipeline_depth=depth)
    return eng, bus, consumer


HOST_PARTS = ("gateway", "decode", "admit", "submit", "resolve", "exact",
              "event_encode")


@contextlib.contextmanager
def host_split(engine):
    """Host seconds inside the consumer path's parts, by wrapping them for
    the block: the ORDER-frame decode, admission, submit_frame (packing and
    queueing the grids), resolve_frame (the fetch and the event decode),
    the exact re-runs of a fallback, and the EVENT-frame encode. Yields a
    dict of seconds; closed_loop adds the gateway steps."""
    from gome_tpu_torch.bus import colwire
    from gome_tpu_torch.engine import frames

    spent = dict.fromkeys(HOST_PARTS, 0.0)

    def timed(fn, part):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[part] += time.perf_counter() - t0
        return run

    places = ((colwire, "decode_order_frame", "decode"),
              (frames, "submit_frame", "submit"),
              (frames, "resolve_frame", "resolve"),
              (frames, "apply_frame", "exact"),
              (colwire, "encode_event_frame", "event_encode"))
    saved = [getattr(mod, name) for mod, name, _ in places]
    for (mod, name, part), fn in zip(places, saved):
        setattr(mod, name, timed(fn, part))
    engine.admit_frame = timed(engine.admit_frame, "admit")
    try:
        yield spent
    finally:
        del engine.admit_frame
        for (mod, name, _), fn in zip(places, saved):
            setattr(mod, name, fn)


def closed_loop(engine, bus, consumer, frame_list, spent):
    """bench.py --latency's loop: for each frame one gateway step, then one
    run_once; then run_once until every offset is committed. Returns the
    seconds, each frame's publish time and each frame's commit time; adds
    the gateway steps' seconds to spent["gateway"]."""
    q = bus.order_queue
    pub_t, done_t = [], []

    def note_commits():
        now = time.perf_counter()
        done_t.extend([now] * (q.committed() - len(done_t)))

    t0 = time.perf_counter()
    for cols in frame_list:
        pub_t.append(time.perf_counter())
        gateway_step(engine, q, cols)
        spent["gateway"] += time.perf_counter() - pub_t[-1]
        consumer.run_once()
        note_commits()
    while q.committed() < q.end_offset():
        consumer.run_once()
        note_commits()
    return time.perf_counter() - t0, pub_t, done_t


def latency_ms(frame_list, secs, pub_t, done_t) -> tuple[float, float]:
    """Order->publish p50 and p99 by bench.py's method: arrivals uniform
    over each frame's accumulation window (ending at its publish) at the
    run's sustained rate; completion is the frame's commit, which follows
    its events' publish."""
    rate = sum(c["n"] for c in frame_list) / secs
    lat = np.concatenate([
        d - (p - (np.arange(c["n"], dtype=np.float64)[::-1] + 1) / rate)
        for c, p, d in zip(frame_list, pub_t, done_t)])
    p50, p99 = np.percentile(lat, [50, 99])
    return 1e3 * p50, 1e3 * p99


def match_queue_events(bus):
    """Every event on the match queue, decoded, in publish order, and a
    MatchFeed drained over the same queue."""
    from gome_tpu_torch.bus.colwire import decode_event_frame
    from gome_tpu_torch.service import MatchFeed

    mq = bus.match_queue
    events = []
    for m in mq.read_from(0, mq.end_offset()):
        events.extend(decode_event_frame(m.body).to_results())
    feed = MatchFeed(bus, log_events=False)
    feed.drain()
    return events, feed


def unstamped(events):
    return [dataclasses.replace(e, seq=None) for e in events]


def check_consumer_run(label, engine, bus, want) -> tuple[list, object]:
    """Events on the match queue equal `want`, stamped 0..n-1; the feed saw
    each seq once; every offset committed; the books verified."""
    events, feed = match_queue_events(bus)
    check_events(label, unstamped(events), want)
    seqs = [e.seq for e in events]
    state = feed.seq_state()
    if seqs != list(range(len(want))) or state["gaps"] or state["dupes"] \
            or feed.suppressed or feed.events_seen != len(want):
        raise SystemExit(f"{label}: seqs not 0..{len(want) - 1} once each: "
                         f"{state}, {feed.events_seen} delivered")
    q = bus.order_queue
    if q.committed() != q.end_offset():
        raise SystemExit(f"{label}: committed {q.committed()} of "
                         f"{q.end_offset()}")
    engine.batch.verify_books()
    return events, feed


def consumer_fill_buffer_check(device, symbols: int) -> str:
    """Phase 6 (c) 1: phase 5 (b)'s frames (sweep_pair, twice) through a
    depth-2 consumer. The first sweep frame trips the fills buffer while
    the next pair is already queued on the card: the pipeline rewinds
    through them, re-runs the sweep exactly and resubmits the rest."""
    eng, bus, consumer = consumer_stack(device, symbols, 2)
    orders, frame_list = [], []
    for r in range(2):
        rest, sweep = sweep_pair(r)
        orders += rest + sweep
        frame_list += [frame_columns(rest), frame_columns(sweep)]
    for cols in frame_list:
        gateway_step(eng, bus.order_queue, cols)
    consumer.drain()
    events, _ = check_consumer_run("phase 6 (c) fills buffer", eng, bus,
                                   oracle_events(orders))
    if eng.stats.frame_fallbacks != 1:
        raise SystemExit(f"phase 6 (c): {eng.stats.frame_fallbacks} frame "
                         "fallbacks with frames in flight, expected 1")
    return (f"phase 6 (c) 1: fills-buffer trip with 2 frames in flight at "
            f"depth 2: {len(events)} events equal to the oracle, seqs "
            f"0..{len(events) - 1}, 1 frame fallback (rewound, re-run "
            f"exactly, later frames resubmitted)")


def consumer_commit_fault_check(device, symbols: int, frame_list,
                                zipf) -> str:
    """Phase 6 (c) 2: the third commit fails (FaultPlan, consumer.commit,
    raise) with two frames in flight; step_with_policy rolls the seq back,
    the pipeline aborts (books rewound to the oldest in-flight frame,
    marks restored) and the replay runs from the committed offset. The
    frame whose commit failed was applied and published, and its marks
    were consumed: its replay drops its ADDs and its DELs miss. So the
    match queue's events equal the oracle's on frames 0..2, frame 2's
    DELs again, then the rest; the replay re-stamps seqs from the last
    commit, and the feed suppresses each seq seen before."""
    from gome_tpu_torch.engine.pipeline import FramePipeline
    from gome_tpu_torch.types import Action
    from gome_tpu_torch.utils.faults import FAULTS, FaultPlan, FaultSpec

    eng, bus, consumer = consumer_stack(device, symbols, 2)
    q = bus.order_queue
    for cols in frame_list:
        gateway_step(eng, q, cols)
    aborts, inner_abort = [], FramePipeline.abort

    def abort(pipe):  # (committed offset, frames in flight) at each abort
        aborts.append((q.committed(), len(pipe)))
        inner_abort(pipe)

    FramePipeline.abort = abort
    FAULTS.install(FaultPlan(faults=(
        FaultSpec("consumer.commit", mode="raise", at=(3,)),)))
    try:
        for _ in range(10 * len(frame_list)):
            if q.committed() >= q.end_offset():
                break
            consumer.step_with_policy()
    finally:
        fired = FAULTS.report()["fired"]
        FAULTS.disable()
        FramePipeline.abort = inner_abort
    if [f["point"] for f in fired] != ["consumer.commit"] or aborts != [(2, 2)]:
        raise SystemExit(f"phase 6 (c): fault {fired}, aborts (committed, in "
                         f"flight) {aborts}, expected [(2, 2)]")
    n = [c["n"] for c in frame_list]
    head, k_frame, tail = zipf[:sum(n[:2])], zipf[sum(n[:2]):sum(n[:3])], \
        zipf[sum(n[:3]):sum(n)]
    replay = [o for o in k_frame if o.action is Action.DEL]
    want = oracle_events(head + k_frame + replay + tail)
    events, feed = match_queue_events(bus)
    check_events("phase 6 (c) commit fault", unstamped(events), want)
    seqs = [e.seq for e in events]
    dupes = len(seqs) - len(set(seqs))
    state = feed.seq_state()
    if sorted(set(seqs)) != list(range(len(set(seqs)))) or dupes == 0 \
            or feed.suppressed != dupes or state["gaps"] \
            or feed.events_seen != len(set(seqs)):
        raise SystemExit(f"phase 6 (c): seqs after the replay: {dupes} "
                         f"duplicates, feed {state}, suppressed "
                         f"{feed.suppressed}, delivered {feed.events_seen}")
    if q.committed() != q.end_offset():
        raise SystemExit("phase 6 (c): the replay did not commit every frame")
    eng.batch.verify_books()
    return (f"phase 6 (c) 2: consumer.commit failed once with 2 frames in "
            f"flight; pipeline aborted, seq rolled "
            f"back, replay from offset 2: {len(events)} events equal to the "
            f"oracle of the replayed flow, seqs 0..{len(set(seqs)) - 1} with "
            f"{dupes} re-stamped, the feed delivered each seq once "
            f"({feed.suppressed} suppressed, 0 gaps)")


def consumer_thread_check(device, symbols: int, frame_list, orders) -> str:
    """Phase 6 (d): start() the consumer, publish 4 frames from this
    thread, wait (at most 120 s) for every offset to commit, stop(). The
    kernel launches from the consumer's thread, on its current stream."""
    eng, bus, consumer = consumer_stack(device, symbols, 2,
                                        batch_wait_s=0.002)
    q = bus.order_queue
    consumer.start()
    try:
        for cols in frame_list:
            gateway_step(eng, q, cols)
        deadline = time.monotonic() + 120
        while q.committed() < q.end_offset():
            if time.monotonic() > deadline:
                raise SystemExit(f"phase 6 (d): {q.committed()} of "
                                 f"{q.end_offset()} frames committed in 120 s")
            time.sleep(0.005)
    finally:
        consumer.stop()
    events, _ = check_consumer_run("phase 6 (d) threaded", eng, bus,
                                   oracle_events(orders))
    return (f"phase 6 (d): threaded consumer (start/stop), {len(frame_list)} "
            f"frames published from the main thread: {len(events)} events "
            f"equal to the oracle, every offset committed")


def phase6(device, sizes, zipf, want_zipf, frame_list):
    """The consumer on the card: (a) the closed loop at depth 2, (b) the
    same flow at depth 0, byte-equal; (c) recovery with frames in flight;
    (d) the threaded consumer. Returns the launches of (a), the worst
    kernel |error|, and the report lines and numbers."""
    from gome_tpu_torch.engine import frames
    from gome_tpu_torch.ops.match_step import batch_step

    runs = {}
    with keep_kernel_inputs() as kept:
        for depth in (2, 0):
            eng, bus, consumer = consumer_stack(device, sizes["symbols"],
                                                depth)
            frames.FETCH_SECONDS = frames.FETCH_TOTALS_SECONDS = 0.0
            batch_step.launches = 0
            with host_split(eng) as spent, no_host_sync() as checked:
                secs, pub_t, done_t = closed_loop(eng, bus, consumer,
                                                  frame_list, spent)
            launches = batch_step.launches
            fetch = (frames.FETCH_TOTALS_SECONDS,
                     frames.FETCH_SECONDS - frames.FETCH_TOTALS_SECONDS)
            label = f"phase 6 ({'a' if depth else 'b'})"
            check_consumer_run(label, eng, bus, want_zipf)
            st = eng.stats
            if launches <= 0 or launches != st.device_calls:
                raise SystemExit(f"{label}: {launches} kernel launches for "
                                 f"{st.device_calls} device calls")
            if checked[0] < len(frame_list):
                raise SystemExit(f"{label}: {checked[0]} submit_frame calls "
                                 f"checked for {len(frame_list)} frames")
            runs[depth] = dict(
                host=require_host(eng, label),
                secs=secs, fetch=fetch, launches=launches, stats=st,
                split=spent,
                checked=checked[0], latency=latency_ms(frame_list, secs,
                                                       pub_t, done_t),
                bodies=[m.body for m in bus.match_queue.read_from(
                    0, bus.match_queue.end_offset())],
                books=eng.batch.lane_books())
            del eng, bus, consumer
        a, b = runs[2], runs[0]
        if a["bodies"] != b["bodies"]:
            raise SystemExit("phase 6 (b): match-queue bodies at depth 0 "
                             "differ from depth 2's")
        for name in a["books"]._fields:
            if not np.array_equal(getattr(a["books"], name),
                                  getattr(b["books"], name)):
                raise SystemExit(f"phase 6 (b): books leaf {name} differs "
                                 "between depth 0 and depth 2")
        lines = [
            f"phase 6 (a): {a['host']}: OrderConsumer(pipeline_depth=2, "
            f"match_wire=frame)"
            f" closed loop, {len(zipf)} orders over {sizes['symbols']} "
            f"symbols in {len(frame_list)} frames -> {len(want_zipf)} events "
            f"equal to the oracle, seqs 0..{len(want_zipf) - 1} once each in "
            f"the feed; every offset committed; books verified; "
            f"{a['launches']} kernel launches = device calls; "
            f"{a['stats'].frame_fallbacks} frame fallbacks; no host sync in "
            f"{a['checked']} submit_frame calls",
            f"phase 6 (b): {b['host']}: the same flow at pipeline_depth=0: "
            f"{len(b['bodies'])} match-queue bodies byte-equal to (a)'s, "
            f"books equal on every leaf; {b['launches']} kernel launches = "
            f"device calls; {b['stats'].frame_fallbacks} frame fallbacks; "
            f"no host sync in {b['checked']} submit_frame calls",
            consumer_fill_buffer_check(device, sizes["symbols"]),
            consumer_commit_fault_check(device, sizes["symbols"],
                                        frame_list[:8],
                                        zipf[:8 * sizes["batch"]]),
        ]
        worst, kept_line = check_kept_inputs("phase 6 (a)-(c)", kept)
    lines.append(kept_line)
    lines.append(consumer_thread_check(
        device, sizes["symbols"], frame_list[:4], zipf[:4 * sizes["batch"]]))
    return a["launches"], worst, runs, lines


# -- phase 7 -----------------------------------------------------------------

HOST_AB_ORDER = ("native", "python", "python", "native")


@contextlib.contextmanager
def python_host():
    """The port's Python host branches for the block: its own
    nativehost.available patched to False, so an engine built inside takes
    Interner and LocalPrePool, and the frame path its numpy forms."""
    from gome_tpu_torch.engine import nativehost

    inner = nativehost.available
    nativehost.available = lambda: False
    try:
        yield
    finally:
        nativehost.available = inner


def host_ab_run(device, sizes, frame_list, host: str, depth: int, want):
    """Phase 7 (a), one run: phase 6's closed loop on the given host
    branches, the launch count set to 0 just before it and read just
    after. Its match-queue bodies and books must equal phase 6 (a)'s
    (`want`)."""
    from gome_tpu_torch.ops.match_step import batch_step

    label = f"phase 7 (a) host={host} depth {depth}"
    with python_host() if host == "python" else contextlib.nullcontext():
        eng, bus, consumer = consumer_stack(device, sizes["symbols"], depth,
                                            host=host)
        batch_step.launches = 0
        with host_split(eng) as spent:
            secs, pub_t, done_t = closed_loop(eng, bus, consumer, frame_list,
                                              spent)
        launches = batch_step.launches
    q, mq = bus.order_queue, bus.match_queue
    if q.committed() != q.end_offset():
        raise SystemExit(f"{label}: committed {q.committed()} of "
                         f"{q.end_offset()}")
    if launches <= 0 or launches != eng.stats.device_calls:
        raise SystemExit(f"{label}: {launches} kernel launches for "
                         f"{eng.stats.device_calls} device calls")
    if [m.body for m in mq.read_from(0, mq.end_offset())] != want["bodies"]:
        raise SystemExit(f"{label}: match-queue bodies differ from phase 6 "
                         "(a)'s")
    books = eng.batch.lane_books()
    for name in books._fields:
        if not np.array_equal(getattr(books, name), getattr(want["books"],
                                                            name)):
            raise SystemExit(f"{label}: books leaf {name} differs from "
                             "phase 6 (a)'s")
    return dict(secs=secs, split=spent, launches=launches,
                latency=latency_ms(frame_list, secs, pub_t, done_t))


def native_file_bus_check(device, symbols: int, frame_list, orders) -> str:
    """Phase 7 (b): frame_list through a depth-2 consumer whose doOrder and
    matchOrder queues are the port's NativeFileQueue (fsync on) in a
    temporary directory; events equal to the oracle; both logs, closed and
    reopened with the Python FileQueue, give the same records and
    committed offsets."""
    from gome_tpu_torch.bus import FileQueue, NativeFileQueue, QueueBus

    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: os.path.join(tmp, name)
                 for name in ("doOrder", "matchOrder")}
        bus = QueueBus(*(NativeFileQueue(name, path, fsync=True)
                         for name, path in paths.items()))
        eng, bus, consumer = consumer_stack(device, symbols, 2, bus=bus)
        for cols in frame_list:
            gateway_step(eng, bus.order_queue, cols)
        consumer.drain()
        events, _ = check_consumer_run("phase 7 (b)", eng, bus,
                                       oracle_events(orders))
        logs = {}
        for q in (bus.order_queue, bus.match_queue):
            logs[q.name] = ([(m.offset, m.body) for m in
                             q.read_from(0, q.end_offset())], q.committed())
            q.close()
        for name, path in paths.items():
            q = FileQueue(name, path)
            got = ([(m.offset, m.body) for m in
                    q.read_from(0, q.end_offset())], q.committed())
            q.close()
            if got != logs[name]:
                raise SystemExit(f"phase 7 (b): the {name} log reopened with "
                                 "FileQueue differs from what the native "
                                 "queue wrote")
    return (f"phase 7 (b): {len(frame_list)} frames through two "
            f"NativeFileQueues (fsync on): {len(events)} events equal to the "
            f"oracle; doOrder ({len(logs['doOrder'][0])} records) and "
            f"matchOrder ({len(logs['matchOrder'][0])} records) reopened "
            f"with the Python FileQueue: the same records and committed "
            f"offsets")


def json_codec_check(orders) -> tuple[str, list, list]:
    """Phase 7 (c): the orders as JSON bodies through decode_orders_batch
    (the native parser) and through [decode_order(b) ...], timed in the
    order native, json, json, native after a gc.collect() each: equal, and
    equal to the orders, and the native parser accepted every body (none
    went through its per-message json fallback). Returns the line and the
    seconds of the native and of the json runs."""
    import gc

    from gome_tpu_torch.bus import decode_orders_batch, encode_order
    from gome_tpu_torch.bus import ordercodec
    from gome_tpu_torch.bus.codec import decode_order

    if ordercodec._load() is None:
        raise SystemExit("phase 7 (c): the native order parser is not loaded")
    bodies = [encode_order(o) for o in orders]
    declined, inner = [0], ordercodec.decode_order

    def counted(body):
        declined[0] += 1
        return inner(body)

    ways = {"native": lambda: decode_orders_batch(bodies),
            "json": lambda: [decode_order(b) for b in bodies]}
    secs = {"native": [], "json": []}
    ordercodec.decode_order = counted
    try:
        for way in ("native", "json", "json", "native"):
            gc.collect()
            t0 = time.perf_counter()
            got = ways[way]()
            secs[way].append(time.perf_counter() - t0)
            if got != list(orders):
                raise SystemExit(f"phase 7 (c): the {way} decode differs "
                                 "from the orders")
            del got
    finally:
        ordercodec.decode_order = inner
    if declined[0]:
        raise SystemExit(f"phase 7 (c): the native parser declined "
                         f"{declined[0]} of {2 * len(bodies)} bodies")
    return (f"phase 7 (c): {len(bodies)} JSON order bodies, twice each way: "
            f"decode_orders_batch (native, every body parsed natively) "
            f"equal to [decode_order(b) ...] and to the orders"), \
        secs["native"], secs["json"]


def phase7(device, sizes, zipf, frame_list, want):
    """The host layer: (a) the A/B of phase 6's flow on the native host
    layer and on the Python branches, per depth in HOST_AB_ORDER; (b) the
    native file bus; (c) the native JSON decode. Returns the runs of (a),
    the report lines and (c)'s seconds."""
    runs = []
    for depth in (2, 0):
        for host in HOST_AB_ORDER:
            runs.append((depth, host, host_ab_run(device, sizes, frame_list,
                                                  host, depth, want)))
    lines = [
        f"phase 7 (a): phase 6's flow on the native host layer and on the "
        f"Python branches, {len(runs)} runs (depths 2 and 0, each "
        f"{', '.join(HOST_AB_ORDER)}): every run's match-queue bodies "
        f"byte-equal to phase 6 (a)'s, books equal on every leaf, every "
        f"offset committed, kernel launches = device calls",
        native_file_bus_check(device, sizes["symbols"], frame_list[:4],
                              zipf[:4 * sizes["batch"]]),
    ]
    line, native_s, json_s = json_codec_check(zipf)
    lines.append(line)
    return runs, lines, (native_s, json_s)


# -- phase 8 -----------------------------------------------------------------

WIRE_BATCH = 4096  # DoOrderBatch entries per request
SERVICE_PARTS = ("gateway", "consumer", "consumer_wait", "publish", "feed",
                 "feed_wait")
# (label, pipeline depth, whether a SubscribeMatches stream takes the events)
SERVICE_RUNS = (("b", 0, True), ("a", 2, True), ("c", 0, False))
#: (b) and (a), the runs with a subscriber (one gRPC message an event,
#: ~2,000-4,500 orders/s), send the flow's first 13 DoOrderBatch requests
#: (53,248 orders) and leave load_client to (c): the script's time limit.
SUBSCRIBED_REQUESTS = 13
#: Phase 12 (a), the service over AMQP (one confirmed publish an event,
#: ~2,300-4,900 orders/s), sends the flow's first 10 requests (40,960
#: orders; the hot book passes the storage cap of 256 in the 9th, so the
#: cap-1,024 launches stay on this path): the script's time limit.
AMQP_REQUESTS = 10
#: Phase 12 (b), the split topology, sends a 102,400-order draw of phase
#: 3's Zipf flow (multi_symbol_stream, seed 7, in 13 ORDER frames of
#: 8,192; the 200,000-order draw's cap-2,048 launches stay on phase 8
#: (c)'s path): the script's time limit.
SPLIT_ORDERS = 102_400


def wire_batches(pb, orders):
    """The flow as DoOrderBatch requests of WIRE_BATCH entries, DELs
    flagged in the cancel mask."""
    from gome_tpu_torch.types import Action

    reqs = [wire_request(pb, o) for o in orders]
    cancel = [o.action is Action.DEL for o in orders]
    return [pb.OrderBatchRequest(orders=reqs[i:i + WIRE_BATCH],
                                 cancel=cancel[i:i + WIRE_BATCH])
            for i in range(0, len(orders), WIRE_BATCH)]


def unary_tail():
    """The unary calls sent after the flow, on its hottest symbol: a SALE
    and a BUY through DoOrder, then DeleteOrder of the SALE."""
    from gome_tpu_torch.types import Action, Order, Side

    sale = Order(uuid="unary", oid="ua", symbol="sym0", side=Side.SALE,
                 price=100_000_000, volume=500_000_000)
    buy = Order(uuid="unary", oid="ub", symbol="sym0", side=Side.BUY,
                price=100_000_000, volume=300_000_000)
    return [sale, buy, dataclasses.replace(sale, action=Action.DEL)]


class StreamCollector(threading.Thread):
    """A SubscribeMatches stream read on its own thread: every event's
    serialized bytes, and the time the `want`-th one arrived."""

    def __init__(self, stub, pb, want: int):
        super().__init__(name="phase8-subscriber", daemon=True)
        self.call = stub.SubscribeMatches(pb.SubscribeRequest())
        self.want = want
        self.got: list[bytes] = []
        self.t_done = None
        self.reached = threading.Event()
        self.error = None

    def run(self):
        import grpc

        try:
            for ev in self.call:
                self.got.append(ev.SerializeToString())
                if len(self.got) == self.want:
                    self.t_done = time.perf_counter()
                    self.reached.set()
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.CANCELLED:
                self.error = e
        self.reached.set()


def timed_parts(svc) -> dict:
    """Seconds inside the service's parts, summed over their threads, by
    wrapping them before start(): the gateway's columnar admission
    (_apply_columnar: validate, intern, mark_frame, encode, publish), the
    consumer's steps and the feed's, each with its queue poll's wait
    (the *_wait parts) counted apart, and inside the consumer's steps its
    event publish (the JSON encode and publish_batch)."""
    spent = dict.fromkeys(SERVICE_PARTS, 0.0)
    lock = threading.Lock()

    def wrap(obj, name, part):
        inner = getattr(obj, name)

        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                with lock:
                    spent[part] += dt
        setattr(obj, name, run)

    wrap(svc.gateway, "_apply_columnar", "gateway")
    wrap(svc.consumer, "run_once", "consumer")
    wrap(svc.bus.order_queue, "poll_batch", "consumer_wait")
    wrap(svc.consumer, "_publish", "publish")
    wrap(svc.feed, "run_once", "feed")
    wrap(svc.bus.match_queue, "poll_batch", "feed_wait")
    return spent


def http_get(port: int, path: str) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def metric(text: str, sample: str) -> float:
    """The value of one sample line of the /metrics text."""
    for line in text.splitlines():
        if not line.startswith("#") and line.rsplit(" ", 1)[0] == sample:
            return float(line.rsplit(" ", 1)[1])
    raise SystemExit(f"phase 8: /metrics has no sample {sample}")


def send_flow(label, stub, pb, requests, tail, hook=None) -> list[float]:
    """The flow's DoOrderBatch requests one at a time, each fully
    accepted, then the unary tail (if any); returns the round trips'
    seconds. `hook`, (i, fn), calls fn() before the i-th request."""
    rtt = []
    for i, req in enumerate(requests):
        if hook is not None and i == hook[0]:
            hook[1]()
        t = time.perf_counter()
        resp = stub.DoOrderBatch(req, timeout=120)
        rtt.append(time.perf_counter() - t)
        if resp.code or resp.accepted != len(req.orders) or \
                resp.reject_index:
            raise SystemExit(f"{label}: DoOrderBatch answered code "
                             f"{resp.code} ({resp.message!r}), accepted "
                             f"{resp.accepted} of {len(req.orders)}, "
                             f"{len(resp.reject_index)} rejects")
    if not tail:
        return rtt
    sale, buy, cancel = (wire_request(pb, o) for o in tail)
    for name, resp in (
            ("DoOrder", stub.DoOrder(sale, timeout=60)),
            ("DoOrder", stub.DoOrder(buy, timeout=60)),
            ("DeleteOrder", stub.DeleteOrder(cancel, timeout=60))):
        if resp.code:
            raise SystemExit(f"{label}: {name} answered code {resp.code} "
                             f"({resp.message!r})")
    return rtt


def wait_drained(label, svc, limit_s: float, n_events: int = 0) -> float:
    """Wait until every order is committed and the feed has committed
    n_events match-queue messages (one JSON document per event); returns
    the time it did."""
    q, mq = svc.bus.order_queue, svc.bus.match_queue
    deadline = time.monotonic() + limit_s
    while q.committed() < q.end_offset() or mq.committed() < n_events:
        if time.monotonic() > deadline:
            raise SystemExit(f"{label}: {q.committed()} of {q.end_offset()} "
                             f"orders and {mq.committed()} of {n_events} "
                             f"events committed in {limit_s} s")
        time.sleep(0.001)
    return time.perf_counter()


def service_run(sizes, depth: int, requests, tail, want, n_orders: int,
                kernel, subscribe: bool = True, mesh_devices: int = 0,
                bus=None, load_run: bool = True, label: str | None = None,
                ops_kw: dict | None = None, on_done=None, mid=None):
    """Phase 8, one run: EngineService from a Config written in code (gRPC
    on port 0, ops on), started on the card; with `subscribe`, a
    SubscribeMatches stream opened through the port's OrderStub first; the
    flow's DoOrderBatch requests one at a time, then the unary tail. The
    stream must deliver the oracle's events (`want`, MatchResults) through
    match_result_to_pb byte for byte; without it, the match queue's
    documents must decode to them, seqs 0..n-1. Then /healthz, /metrics,
    and load_client over the same server. `kernel` is the match-step
    wrapper whose launch count is read (imported before
    keep_kernel_inputs wraps it). The consumer's own parts are timed as
    in phase 6 (host_split). `mesh_devices` goes into the engine's config
    (the lane axis over that many cards); `bus`, a BusConfig, replaces
    the memory bus and names the run by its backend; `load_run` False
    leaves load_client out (phase 12 (a): its 200,001 orders would add
    about 46 s over AMQP, see PERF.md section 4). Without a
    subscriber the match-queue bodies of the flow are returned under
    "bodies"; /healthz's payload under "health". Every obs/ flag is off
    unless `ops_kw` (OpsConfig fields) turns it on; `on_done(svc)` runs
    once the flow is drained and checked, before the service stops, and
    its result is returned under "scraped"; `mid(svc, started)` runs on
    a thread of its own, started once a quarter of the requests are
    sent, and the sender waits until it sets `started` (so it begins
    with messages unconsumed); its result is returned under
    "mid" (the K1 launches the cost model's and profiler's entries make,
    costmodel.ENTRY_K1_LAUNCHES, count beside the consumer's device
    calls: "entry_launches"); `label` names the run."""
    import grpc

    from gome_tpu_torch.api import order_pb2 as pb
    from gome_tpu_torch.api.service import OrderStub
    from gome_tpu_torch.bus import decode_match_result
    from gome_tpu_torch.clients import load_client
    from gome_tpu_torch.obs import costmodel
    from gome_tpu_torch.config import Config, EngineConfig, GrpcConfig, \
        OpsConfig
    from gome_tpu_torch.service import EngineService
    from gome_tpu_torch.service.matchfeed import match_result_to_pb

    label = label or (
        f"phase 8 depth {depth}" if bus is None and not mesh_devices else
        f"phase 11 (d) mesh_devices {mesh_devices}, depth {depth}"
        if bus is None else
        f"phase 12 (a) {bus.backend}, depth {depth}") + (
        "" if subscribe else ", no subscriber")
    cfg = Config(
        **({} if bus is None else {"bus": bus}),
        grpc=GrpcConfig(host="127.0.0.1", port=0),
        engine=EngineConfig(cap=256, max_fills=16, n_slots=sizes["symbols"],
                            max_t=32, pipeline_depth=depth,
                            mesh_devices=mesh_devices),
        ops=OpsConfig(enabled=True, port=0, **{
            "trace": False, **dict.fromkeys(ALL_OBS_FLAGS, False),
            **(ops_kw or {})}))
    svc = EngineService(cfg)
    host = require_host(svc.engine, label)
    if svc.engine.config.dtype != torch.int64 or svc.consumer.batch_n != \
            32 * (sizes["symbols"] // 8) or svc.consumer.match_wire != "json":
        raise SystemExit(f"{label}: service built with {svc.engine.config}, "
                         f"batch_n {svc.consumer.batch_n}, "
                         f"{svc.consumer.match_wire} wire")
    spent = timed_parts(svc)
    svc.start()
    try:
        port = svc._server.bound_port
        m0 = http_get(svc.ops.port, "/metrics")[1]
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            stub = OrderStub(channel)
            if subscribe:
                want_pb = [match_result_to_pb(e).SerializeToString()
                           for e in want]
                sub = StreamCollector(stub, pb, len(want))
                sub.start()
                deadline = time.monotonic() + 30
                while not svc.feed._subs:
                    if time.monotonic() > deadline:
                        raise SystemExit(f"{label}: the subscriber never "
                                         "registered")
                    time.sleep(0.001)
            for part in spent:
                spent[part] = 0.0
            kernel.launches = 0
            entry0 = costmodel.ENTRY_K1_LAUNCHES
            mid_out = {}
            mid_started = threading.Event()

            def run_mid():
                try:
                    mid_out["result"] = mid(svc, mid_started)
                except BaseException as e:  # raised on the caller's thread
                    mid_out["error"] = e
                finally:
                    mid_started.set()

            def start_mid():
                mid_thread.start()
                mid_started.wait(120)

            mid_thread = threading.Thread(target=run_mid, name="mid-reads")
            with host_split(svc.engine) as consumer_split:
                t0 = time.perf_counter()
                rtt = send_flow(label, stub, pb, requests, tail,
                                hook=None if mid is None
                                else (len(requests) // 4, start_mid))
                if subscribe:
                    if not sub.reached.wait(300) or sub.t_done is None:
                        raise SystemExit(
                            f"{label}: the stream delivered {len(sub.got)} "
                            f"of {len(want)} events in 300 s ({sub.error})")
                    t_end = sub.t_done
                else:
                    t_end = wait_drained(label, svc, 300, len(want))
                secs = t_end - t0
                if mid is not None:
                    mid_thread.join()
                    if "error" in mid_out:
                        raise mid_out["error"]
                launches = kernel.launches
                entry_launches = costmodel.ENTRY_K1_LAUNCHES - entry0
                split = dict(spent)
                consumer_split = dict(consumer_split)
            calls = expected_launches(svc.engine) + entry_launches
            if launches <= 0 or launches != calls:
                raise SystemExit(f"{label}: {launches} kernel launches for "
                                 f"{calls} expected from the device calls")
            if subscribe:
                sub.call.cancel()
                sub.join(30)
                if sub.got != want_pb or sub.error is not None:
                    bad = next((i for i, (a, b) in enumerate(
                        zip(sub.got, want_pb)) if a != b),
                        min(len(sub.got), len(want_pb)))
                    raise SystemExit(f"{label}: {len(sub.got)} streamed "
                                     f"MatchEvents against the oracle's "
                                     f"{len(want)}, first difference at "
                                     f"{bad} ({sub.error})")
            else:
                mq = svc.bus.match_queue
                bodies = [m.body for m in mq.read_from(0, mq.end_offset())]
                got = [decode_match_result(b) for b in bodies]
                check_events(label, unstamped(got), want)
                if [e.seq for e in got] != list(range(len(want))):
                    raise SystemExit(f"{label}: seqs not 0..{len(want) - 1}")
            wait_drained(label, svc, 30, len(want))
            code, body = http_get(svc.ops.port, "/healthz")
            health = json.loads(body)
            m1 = http_get(svc.ops.port, "/metrics")[1]
            counters = {
                # Under the tracer the gateway takes its scalar loop: one
                # doOrder message per order.
                "doOrder messages": (
                    metric(m1, 'gome_bus_end_offset{queue="doOrder"}')
                    - metric(m0, 'gome_bus_end_offset{queue="doOrder"}'),
                    (n_orders if cfg.ops.trace else len(requests))
                    + len(tail)),
                "orders consumed": (
                    metric(m1, "gome_orders_consumed_total")
                    - metric(m0, "gome_orders_consumed_total"),
                    n_orders + len(tail)),
                "events published": (
                    metric(m1, "gome_match_events_total")
                    - metric(m0, "gome_match_events_total"), len(want)),
            }
            wrong = {k: v for k, v in counters.items() if v[0] != v[1]}
            if code != 200 or not health["healthy"] or wrong:
                raise SystemExit(f"{label}: /healthz {code} "
                                 f"healthy={health.get('healthy')}; counters "
                                 f"(read, sent) off: {wrong}")
            state = svc.feed.seq_state()
            if state["gaps"] or state["dupes"] or svc.feed.suppressed \
                    or svc.feed.events_seen != len(want):
                raise SystemExit(f"{label}: feed seqs {state}, "
                                 f"{svc.feed.events_seen} events seen")
            scraped = None if on_done is None else on_done(svc)
            load, load_secs = None, None
            if load_run:
                n_load = sizes["zipf_n"]
                t_load = time.perf_counter()
                load = load_client(
                    f"127.0.0.1:{port}", n=n_load + 1, concurrency=8,
                    batch_n=1024, seed=8,
                    symbols=[f"sym{i}" for i in range(sizes["symbols"])],
                    price_lo=0.9, price_hi=1.1, decimals=2)
                if (load["ok"], load["rejected"], load["aborted"]) != (
                        n_load, 0, 0):
                    raise SystemExit(f"{label}: load_client {load}")
                load_secs = wait_drained(label, svc, 300) - t_load
    finally:
        svc.stop()
    svc.engine.batch.verify_books()
    return dict(host=host, secs=secs, rtt=rtt, launches=launches,
                split=split, consumer_split=consumer_split,
                subscribe=subscribe, counters=counters, load=load,
                load_secs=load_secs, events=len(want),
                requests=len(requests), orders=n_orders, health=health,
                bodies=None if subscribe else bodies, scraped=scraped,
                mid=mid_out.get("result"), entry_launches=entry_launches)


def phase8(sizes, zipf):
    """The service on the card (grpc and protobuf import on the card's
    machine): the flow over the wire at depths 0 and 2 (SERVICE_RUNS; (c)
    repeats depth 0 with no subscriber, the stream's cost set apart), each
    event streamed back byte-equal to the oracle's, K1 held against its
    plain version at the inputs the service gave it. Returns the runs, the
    kernel's worst |error| and the report lines."""
    import logging

    from gome_tpu_torch.api import order_pb2 as pb
    from gome_tpu_torch.ops.match_step import batch_step

    # The feed logs every event at INFO (the reference's per-event print);
    # 116,000 lines on stderr would bury this run's report.
    logging.getLogger("gome_tpu_torch.matchfeed").setLevel(logging.WARNING)
    tail = unary_tail()
    want = oracle_events(list(zipf) + tail)
    requests = wire_batches(pb, zipf)
    n_sub = min(SUBSCRIBED_REQUESTS * WIRE_BATCH, len(zipf))
    want_sub = oracle_events(list(zipf[:n_sub]) + tail)
    runs = {}
    with keep_kernel_inputs() as kept:
        for tag, depth, subscribe in SERVICE_RUNS:
            if subscribe:
                flow = (requests[:SUBSCRIBED_REQUESTS], tail, want_sub, n_sub)
            else:
                flow = (requests, tail, want, len(zipf))
            runs[tag] = service_run(sizes, depth, *flow, batch_step,
                                    subscribe, load_run=not subscribe)
            runs[tag]["depth"] = depth
            torch.cuda.empty_cache()
        worst, kept_line = check_kept_inputs("phase 8", kept)
    lines = [
        f"phase 8 ({tag}): {r['host']}: EngineService "
        f"(grpc port 0, ops on, pipeline_depth={r['depth']}, json match wire, "
        f"int64, cap 256, K 16, max_t 32, batch_n {32 * (sizes['symbols'] // 8)}) "
        f"started on the card; {r['orders']} orders over {sizes['symbols']} "
        f"symbols sent as {r['requests']} DoOrderBatch requests of "
        f"{WIRE_BATCH} (cancel mask) plus 2 DoOrder and 1 DeleteOrder; "
        + (f"SubscribeMatches streamed {r['events']} MatchEvents byte-equal "
           f"to the oracle's through match_result_to_pb, in order"
           if r["subscribe"] else
           f"no subscriber: the {r['events']} match-queue documents equal "
           f"the oracle's events, seqs 0..{r['events'] - 1}")
        + "; /healthz 200; "
        f"/metrics " + ", ".join(f"{k} {int(v[0])}" for k, v in
                                 r["counters"].items())
        + f" = sent; {r['launches']} kernel launches = device calls; "
        + (f"load_client (concurrency 8, batch_n 1024) {r['load']['ok']} of "
           f"{r['load']['sent']} ok; " if r["load"] else "")
        + "books verified"
        for tag, r in runs.items()]
    lines.append(kept_line)
    return runs, worst, lines, (requests, tail, want)


def print_phase8(card: str, sizes, s_runs, p6_runs) -> None:
    """Phase 8's numbers, each run beside phase 6's rate at its depth in
    this run (p6_runs: phase 6's runs by depth)."""
    for tag, r in s_runs.items():
        depth = r["depth"]
        rate = r["orders"] / r["secs"]
        p6 = sizes["zipf_n"] / p6_runs[depth]["secs"]
        rtt_p50, rtt_p99 = np.percentile(np.array(r["rtt"]) * 1e3, [50, 99])
        sp = r["split"]
        load = r["load"]
        end = ("the last of {} MatchEvents streamed" if r["subscribe"] else
               "the feed's commit of the last of {} events, no subscriber")
        print(f"phase 8 [{card}]: ({tag}) pipeline_depth={depth}: {rate:,.0f} "
              f"orders/s over the wire (first DoOrderBatch sent to "
              f"{end.format(r['events'])}, {r['secs']:.3f} s); "
              f"phase 6 at depth {depth} in this run {p6:,.0f} orders/s "
              f"(int32, no wire; ratio {rate / p6:.3f}); DoOrderBatch round "
              f"trip p50 {rtt_p50:.2f} ms, p99 {rtt_p99:.2f} ms over "
              f"{r['requests']} requests of {WIRE_BATCH}; split, seconds "
              f"summed over threads: gateway admission {sp['gateway']:.4f}, "
              f"consumer {sp['consumer'] - sp['consumer_wait']:.4f} "
              f"(+ {sp['consumer_wait']:.4f} polling), feed "
              f"{sp['feed'] - sp['feed_wait']:.4f} (+ {sp['feed_wait']:.4f} "
              f"polling); in the consumer: event publish {sp['publish']:.4f}, "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          r["consumer_split"].items() if k != "gateway")
              + f"; {r['launches']} K1 launches"
              + (f"; load_client {load['sent'] / load['elapsed_s']:,.0f} "
                 f"orders/s accepted ({load['elapsed_s']:.3f} s), "
                 f"{load['sent'] / r['load_secs']:,.0f} orders/s to the "
                 f"last commit" if load else ""))


# -- phase 9 -----------------------------------------------------------------

PERSIST_EVERY = 4  # the drill's snapshot cadence, in committed batches
DRILL_ORDERS = 102_400  # (a): the flow's first orders, 13 ORDER frames
PERSIST_KEEP = 8
SERVICE_PERSIST_EVERY = 4  # (c)'s cadence
#: (c) sends the flow's first 5 DoOrderBatch requests (20,480 orders): a
#: snapshot at 4, one request for the restored service to replay (the
#: snapshots and restores at cap 1,024 are (a)'s and (b)'s). The file bus
#: fsyncs every event, so the flow's length is the script's time limit.
DURABLE_REQUESTS = 5


def kill_plan(cycle: int):
    """scripts/chaos.py's kill rotation, with hits placed for a 13-frame
    log at a cadence of 4 (depths alternate 2, 0, 2, 0: snapshots are
    taken only at depth 0, where every commit is a consistent cut):
    1. consumer.commit exit at hit 1 — inside the at-least-once window at
       offset 0 (events published, nothing committed, no snapshot);
    2. consumer.frame exit at hit 7 — after the first snapshot (cut 4);
    3. filelog.offset torn at hit 5 — a torn commit sidecar in the replay
       from that cut, frames in flight, no newer snapshot;
    4. snapshot.rename torn at hit 2 — the second snapshot of the replay
       from cut 4 (cut 12) published torn, then death: the next restore
       skips it and uses cut 8."""
    from gome_tpu_torch.utils.faults import FaultPlan, FaultSpec

    spec = {
        1: FaultSpec("consumer.commit", mode="exit", at=(1,)),
        2: FaultSpec("consumer.frame", mode="exit", at=(PERSIST_EVERY + 3,)),
        3: FaultSpec("filelog.offset", mode="torn", at=(5,)),
        4: FaultSpec("snapshot.rename", mode="torn", at=(2,)),
    }[cycle]
    return FaultPlan(seed=9000 + cycle, faults=(spec,))


def book_digest(engine) -> str:
    """sha256 over the full exported engine state (every book leaf, padding
    included, with dtype and shape; interners; geometry) and the sorted
    pre-pool — scripts/chaos.py's digest."""
    import hashlib

    state = engine.batch.export_state()
    h = hashlib.sha256()
    for key in sorted(state):
        val = state[key]
        h.update(key.encode())
        if key == "books":
            for name in sorted(val):
                arr = np.ascontiguousarray(val[name])
                h.update(name.encode())
                h.update(str(arr.dtype).encode())
                h.update(repr(arr.shape).encode())
                h.update(arr.tobytes())
        else:
            h.update(repr(val).encode())
    h.update(repr(sorted(engine.pre_pool)).encode())
    return h.hexdigest()


@contextlib.contextmanager
def timed_calls(places):
    """Wrap each (object, attribute, part) for the block; yields a dict of
    seconds per part, summed over the calls."""
    spent = {part: 0.0 for _, _, part in places}
    saved = [getattr(obj, name) for obj, name, _ in places]

    def timed(fn, part):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[part] += time.perf_counter() - t0
        return run

    for (obj, name, part), fn in zip(places, saved):
        setattr(obj, name, timed(fn, part))
    try:
        yield spent
    finally:
        for (obj, name, _), fn in zip(places, saved):
            setattr(obj, name, fn)


def drill_stack(args):
    """The worker's engine (int32, cap and K from args, on args.device),
    its file bus and a Persister at the drill's cadence, and an
    OrderConsumer(batch_n=1, match_wire="frame") at args.depth."""
    from gome_tpu_torch.bus import make_bus
    from gome_tpu_torch.config import BusConfig, PersistConfig
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.persist import Persister
    from gome_tpu_torch.service import OrderConsumer

    bus = make_bus(BusConfig(backend="file", dir=args.bus_dir,
                             match_wire="frame"))
    engine = MatchEngine(BookConfig(cap=args.cap, max_fills=args.max_fills,
                                    dtype=torch.int32),
                         n_slots=args.symbols, max_t=32, device=args.device)
    persist = Persister(PersistConfig(enabled=True, dir=args.snap_dir,
                                      every_n_batches=PERSIST_EVERY,
                                      keep=PERSIST_KEEP))
    consumer = OrderConsumer(engine, bus, batch_n=1, batch_wait_s=0.0,
                             on_batch=persist.on_batch, match_wire="frame",
                             pipeline_depth=args.depth)
    persist.attach(engine, bus, consumer=consumer)
    return engine, bus, persist, consumer


def persist_worker(argv) -> int:
    """One consumer-process lifetime of phase 9 (a)'s crash drill, as
    scripts/chaos.py's worker: boot, restore_latest(), THEN arm the
    cycle's FaultPlan, consume the file queue to its end (or die with
    EXIT_CODE where the plan says), drain a MatchFeed, digest the state.
    The result JSON is rewritten as the run goes (after the restore, at
    the catch-up to the pre-crash position, after each snapshot), so a
    death keeps what was known. A run that completes also holds K1
    against its plain version at the inputs its replay gave it, and with
    --cost-dir times one snapshot and one restore (phase 9 (b))."""
    import argparse

    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.persist import snapshot as snapshot_mod
    from gome_tpu_torch.service import MatchFeed
    from gome_tpu_torch.utils.faults import FAULTS, FaultPlan

    ap = argparse.ArgumentParser()
    ap.add_argument("--persist-worker", action="store_true")
    for name in ("--bus-dir", "--snap-dir", "--out"):
        ap.add_argument(name, required=True)
    ap.add_argument("--plan")
    ap.add_argument("--cost-dir")
    ap.add_argument("--device", default="cuda")
    for name, default in (("--depth", 0), ("--symbols", 10240),
                          ("--cap", 256), ("--max-fills", 16)):
        ap.add_argument(name, type=int, default=default)
    args = ap.parse_args(argv)
    entered = time.time()  # the parent takes the interpreter's start apart
    t_boot = time.perf_counter()
    engine, bus, persist, consumer = drill_stack(args)
    oq = bus.order_queue
    result = {"pre_committed": oq.committed(), "depth": args.depth,
              "completed": False, "snapshots": [], "entered_unix": entered}

    def write_result() -> None:
        with open(args.out + ".tmp", "w") as f:
            json.dump(result, f, sort_keys=True)
        os.replace(args.out + ".tmp", args.out)

    inner_snapshot = persist.snapshot

    def snapshot():
        t0 = time.perf_counter()
        path = inner_snapshot()
        result["snapshots"].append(dict(
            name=os.path.basename(path), bytes=persist.last_snapshot_bytes,
            seconds=time.perf_counter() - t0))
        write_result()
        return path

    persist.snapshot = snapshot
    t0 = time.perf_counter()
    result["boot_s"] = t0 - t_boot
    with timed_calls(((persist.store, "load_latest", "load"),
                      (engine.batch, "import_state", "import_state"),
                      (persist, "_reconstruct_marks", "mark_rebuild"))) \
            as restore_split:
        persist.restore_latest()
    result["restore"] = dict(persist.probe(), split=restore_split,
                             seconds=persist.last_recovery_seconds,
                             cut=oq.committed())
    if args.plan:  # armed AFTER the restore: hits count this run's replay
        with open(args.plan) as f:
            FAULTS.install(FaultPlan.from_json(f.read()))
    caught_up = oq.committed() >= result["pre_committed"]
    if caught_up:
        result["recovery_s"] = persist.last_recovery_seconds
    write_result()
    batch_step.launches = 0
    with keep_kernel_inputs() as kept:
        while oq.committed() < oq.end_offset():
            consumer.run_once()
            if not caught_up and oq.committed() >= result["pre_committed"]:
                caught_up = True
                result["recovery_s"] = time.perf_counter() - t0
                write_result()
        launches = batch_step.launches
        feed = MatchFeed(bus, log_events=False)
        feed.drain()
        worst, kept_line = check_kept_inputs("phase 9 (a) worker", kept)
    engine.batch.verify_books()
    result.update(
        completed=True, seconds=time.perf_counter() - t0,
        book_digest=book_digest(engine), feed=feed.seq_state(),
        delivered=feed.events_seen, launches=launches,
        device_calls=engine.stats.device_calls, cap=engine.config.cap,
        kernel_worst=worst, kept_line=kept_line)
    if args.cost_dir:
        result["cost"] = snapshot_cost(args, engine, bus, snapshot_mod)
    write_result()
    return 0


def snapshot_cost(args, engine, bus, snapshot_mod) -> dict:
    """Phase 9 (b): one Persister.snapshot() of the drained engine into a
    fresh directory, split into export_state (the device-to-host copy of
    every leaf), np.savez and the fsyncs; one restore_latest() into a
    fresh engine on the same device, split into the load, import_state
    and the mark rebuild. The restored state must equal the source's leaf
    by leaf and pass verify_books."""
    from gome_tpu_torch.config import PersistConfig
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.persist import Persister

    src = Persister(PersistConfig(enabled=True, dir=args.cost_dir,
                                  every_n_batches=PERSIST_EVERY, keep=2))
    src.attach(engine, bus)
    with timed_calls(((engine.batch, "export_state", "export_state"),
                      (snapshot_mod.np, "savez", "savez"),
                      (snapshot_mod.os, "fsync", "fsync"))) as split:
        t0 = time.perf_counter()
        src.snapshot()
        snap_s = time.perf_counter() - t0
    fresh = MatchEngine(BookConfig(cap=args.cap, max_fills=args.max_fills,
                                   dtype=torch.int32),
                        n_slots=args.symbols, max_t=32, device=args.device)
    dst = Persister(PersistConfig(enabled=True, dir=args.cost_dir,
                                  every_n_batches=PERSIST_EVERY, keep=2))
    dst.attach(fresh, bus)
    with timed_calls(((dst.store, "load_latest", "load"),
                      (fresh.batch, "import_state", "import_state"),
                      (dst, "_reconstruct_marks", "mark_rebuild"))) \
            as rsplit:
        t0 = time.perf_counter()
        if not dst.restore_latest():
            raise SystemExit("phase 9 (b): restore_latest found no snapshot")
        sync(fresh.batch.device)
        restore_s = time.perf_counter() - t0
    a, b = engine.batch.export_state(), fresh.batch.export_state()
    for leaf, arr in a["books"].items():
        if arr.dtype != b["books"][leaf].dtype or \
                not np.array_equal(arr, b["books"][leaf]):
            raise SystemExit(f"phase 9 (b): restored leaf {leaf} differs")
    if {k: v for k, v in a.items() if k != "books"} != \
            {k: v for k, v in b.items() if k != "books"}:
        raise SystemExit("phase 9 (b): restored interners or geometry differ")
    fresh.batch.verify_books()
    return dict(snapshot_s=snap_s, split=split, restore_s=restore_s,
                restore_split=rsplit, bytes=src.last_snapshot_bytes,
                array_bytes=int(sum(v.nbytes for v in a["books"].values())),
                cap=a["cap"], dtype=a["dtype"])


def run_worker(work, name: str, bus_dir: str, depth: int, device: str,
               geometry: dict, timeout_s: float, plan=None,
               cost: bool = False) -> dict:
    """Start one worker as a fresh interpreter (never a fork of this
    CUDA process) and wait for it; returns its result JSON with its exit
    code and wall seconds."""
    out = os.path.join(work, f"{name}.json")
    cmd = [sys.executable, os.path.abspath(__file__), "--persist-worker",
           "--bus-dir", bus_dir, "--snap-dir", bus_dir + "-snaps",
           "--out", out, "--depth", str(depth), "--device", device,
           *(f"--{k.replace('_', '-')}={v}" for k, v in geometry.items())]
    if plan is not None:
        with open(out + ".plan", "w") as f:
            f.write(plan.to_json())
        cmd += ["--plan", out + ".plan"]
    if cost:
        cmd += ["--cost-dir", os.path.join(work, "cost-snaps")]
    t0, launched = time.perf_counter(), time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout_s,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    result = {}
    if os.path.exists(out):
        with open(out) as f:
            result = json.load(f)
        result["start_s"] = result["entered_unix"] - launched
    result.update(rc=proc.returncode, wall_s=wall,
                  stderr_tail=proc.stderr[-2000:])
    return result


def persist_drill(work: str, device: str = "cuda", n_orders: int = 200_000,
                  n_symbols: int = 10240, frame_n: int = 8192,
                  cycles: int = 4, timeout_s: float = 300,
                  cap: int = 256, max_fills: int = 16,
                  cost: bool = False) -> dict:
    """Phase 9 (a): phase 3's Zipf flow as ORDER frames in two file
    queues; an uninterrupted worker on one, beside the kill cycles
    (kill_plan) and a final clean worker on the other, depths alternating
    2 and 0.
    Fails (SystemExit) unless every kill exits with EXIT_CODE, the final
    run completes, its match-queue bodies equal the uninterrupted run's
    byte for byte, its events equal the oracle's with seqs 0..n-1 once
    each in the feed, its book digest equals the uninterrupted run's and
    K1 equals its plain version at the final replay's inputs."""
    from gome_tpu_torch.bus.colwire import decode_event_frame
    from gome_tpu_torch.bus.filelog import FileQueue
    from gome_tpu_torch.utils.faults import EXIT_CODE
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    orders = multi_symbol_stream(n=n_orders, n_symbols=n_symbols,
                                 zipf_a=1.2, cancel_prob=0.3, seed=7)
    payloads = [encode_frame(frame_columns(orders[i:i + frame_n]))
                for i in range(0, n_orders, frame_n)]
    dirs = {}
    for name in ("clean", "crash"):
        dirs[name] = os.path.join(work, name)
        q = FileQueue("doOrder", os.path.join(dirs[name], "doOrder"))
        for p in payloads:
            q.publish(p)
        q.close()
    geometry = dict(symbols=n_symbols, cap=cap, max_fills=max_fills)
    # The uninterrupted worker runs beside the kill cycles: its own queue
    # and snapshot directory, a fresh interpreter of its own.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        clean_run = pool.submit(run_worker, work, "clean", dirs["clean"], 0,
                                device, geometry, timeout_s)
        runs = []
        for c in range(1, cycles + 1):
            runs.append(run_worker(work, f"cycle{c}", dirs["crash"],
                                   2 if c % 2 else 0, device, geometry,
                                   timeout_s, plan=kill_plan(c)))
        final = run_worker(work, "final", dirs["crash"], 2 if cycles % 2 == 0
                           else 0, device, geometry, timeout_s, cost=cost)
        clean = clean_run.result()
    for label, r in (("uninterrupted", clean), ("final", final)):
        if r["rc"] != 0 or not r.get("completed"):
            raise SystemExit(f"phase 9 (a): the {label} worker exited "
                             f"{r['rc']}: {r['stderr_tail']}")
    if cycles > 1 and final["restore"]["last_restore"] != "restored":
        raise SystemExit(f"phase 9 (a): the final worker did not restore a "
                         f"snapshot: {final['restore']}")
    bad = [(i + 1, r["rc"]) for i, r in enumerate(runs)
           if r["rc"] != EXIT_CODE]
    if bad:
        raise SystemExit(f"phase 9 (a): kill cycles (cycle, exit code) "
                         f"{bad}, expected {EXIT_CODE}: "
                         f"{runs[bad[0][0] - 1]['stderr_tail']}")
    queues = {}
    for name, d in dirs.items():
        q = FileQueue("matchOrder", os.path.join(d, "matchOrder"))
        queues[name] = [m.body for m in q.read_from(0, q.end_offset())]
        q.close()
    events = [e for b in queues["crash"]
              for e in decode_event_frame(b).to_results()]
    want = oracle_events(orders)
    seqs = [e.seq for e in events]
    if queues["crash"] != queues["clean"]:
        raise SystemExit(f"phase 9 (a): {len(queues['crash'])} recovered "
                         f"match-queue bodies differ from the uninterrupted "
                         f"run's {len(queues['clean'])}")
    check_events("phase 9 (a) recovered stream", unstamped(events), want)
    if seqs != list(range(len(want))) or final["feed"]["gaps"] or \
            final["feed"]["dupes"] or final["delivered"] != len(want):
        raise SystemExit(f"phase 9 (a): seq audit {final['feed']}, "
                         f"{final['delivered']} delivered of {len(want)}")
    if final["book_digest"] != clean["book_digest"]:
        raise SystemExit(f"phase 9 (a): book digest {final['book_digest']} "
                         f"after recovery, {clean['book_digest']} "
                         "uninterrupted")
    for label, r in (("uninterrupted", clean), ("final", final)):
        if device == "cuda" and (r["launches"] <= 0
                                 or r["launches"] != r["device_calls"]):
            raise SystemExit(f"phase 9 (a): the {label} worker launched K1 "
                             f"{r['launches']} times for {r['device_calls']}"
                             " device calls")
    return dict(cycles=runs, clean=clean, final=final, n_events=len(events),
                n_frames=len(payloads))


def durable_config(sizes, work: str, store_port: int):
    """Phase 8 (c)'s service config (int64, json match wire, depth 0, ops
    on) over a file bus, with a persist: section (every 16 batches) and a
    redis: section naming the phase's FakeRedisServer."""
    from gome_tpu_torch.config import BusConfig, Config, EngineConfig, \
        GrpcConfig, OpsConfig, PersistConfig, StoreConfig

    return Config(
        grpc=GrpcConfig(host="127.0.0.1", port=0),
        bus=BusConfig(backend="file", dir=os.path.join(work, "bus")),
        engine=EngineConfig(cap=256, max_fills=16, n_slots=sizes["symbols"],
                            max_t=32, pipeline_depth=0),
        persist=PersistConfig(enabled=True, dir=os.path.join(work, "snaps"),
                              every_n_batches=SERVICE_PERSIST_EVERY, keep=2),
        store=StoreConfig(enabled=True, host="127.0.0.1", port=store_port),
        ops=OpsConfig(enabled=True, port=0, trace=False,
                      **dict.fromkeys(ALL_OBS_FLAGS, False)))


def durable_service(cfg):
    """EngineService with a Persister from cfg.persist, as service.app's
    main() builds it; every snapshot timed. Returns (service, the list of
    (bytes, seconds) per snapshot)."""
    from gome_tpu_torch.engine.prepool import RespPrePool
    from gome_tpu_torch.persist import Persister
    from gome_tpu_torch.service import EngineService

    persist = Persister(cfg.persist)
    svc = EngineService(cfg, persist=persist)
    if not isinstance(svc.engine.pre_pool, RespPrePool):
        raise SystemExit("phase 9 (c): the redis: section did not give a "
                         f"RespPrePool ({type(svc.engine.pre_pool).__name__})")
    if svc.engine.config.dtype != torch.int64 or \
            svc.consumer.match_wire != "json":
        raise SystemExit(f"phase 9 (c): service built with "
                         f"{svc.engine.config}, {svc.consumer.match_wire}")
    snaps, inner = [], persist.snapshot

    def snapshot():
        t0 = time.perf_counter()
        path = inner()
        snaps.append((persist.last_snapshot_bytes, time.perf_counter() - t0))
        return path

    persist.snapshot = snapshot
    # The cadence counts consumer batches. The service's batch_n (32 x
    # 10,240 / 8 messages) lets one batch take every request waiting, so
    # the count would follow the host's timing; one request per batch
    # makes "every 4" every 4 requests (16,384 orders).
    svc.consumer.batch_n = 1
    return svc, snaps


def durable_service_check(sizes, zipf, want, work: str):
    """Phase 9 (c): the flow over gRPC into a durable service (a persist:
    and a redis: section, the marks and consumes through RespPrePool),
    stopped, then a second service over the same directories and store:
    its start() restores and replays the tail, and its books must equal
    the first's, /durability must report the restore, and the match
    queue's documents must equal the oracle's events with seqs 0..n-1.
    Returns the first service's engine (for (d)), the store, and the
    numbers."""
    import grpc

    from gome_tpu_torch.api import order_pb2 as pb
    from gome_tpu_torch.api.service import OrderStub
    from gome_tpu_torch.bus import decode_match_result
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.persist.respserver import FakeRedisServer

    label = "phase 9 (c)"
    requests = wire_batches(pb, zipf)
    store = FakeRedisServer()
    store.start()
    cfg = durable_config(sizes, work, store.port)
    svc, snaps = durable_service(cfg)
    spent = timed_parts(svc)
    svc.start()
    try:
        for part in spent:
            spent[part] = 0.0
        batch_step.launches = 0
        with grpc.insecure_channel(
                f"127.0.0.1:{svc._server.bound_port}") as channel:
            t0 = time.perf_counter()
            rtt = send_flow(label, OrderStub(channel), pb, requests, [])
            secs = wait_drained(label, svc, 300, len(want)) - t0
        split = dict(spent)
        launches = batch_step.launches
        if launches <= 0 or launches != svc.engine.stats.device_calls:
            raise SystemExit(f"{label}: {launches} K1 launches for "
                             f"{svc.engine.stats.device_calls} device calls")
    finally:
        svc.stop()
    if not snaps:
        raise SystemExit(f"{label}: the first service took no snapshot")
    first = svc.engine.batch.export_state()
    marks = sorted(svc.engine.pre_pool)

    svc2, snaps2 = durable_service(cfg)
    with keep_kernel_inputs() as kept:
        batch_step.launches = 0
        t0 = time.perf_counter()
        svc2.start()
        try:
            restored = svc2.persist.last_restore
            wait_drained(label, svc2, 300, len(want))
            replay_s = time.perf_counter() - t0
            replay_launches = batch_step.launches
            code, body = http_get(svc2.ops.port, "/durability")
            durability = json.loads(body)
        finally:
            svc2.stop()
        worst, kept_line = check_kept_inputs(f"{label} replay", kept)
    persist = durability.get("persist") or {}
    if code != 200 or restored != "restored" or \
            persist.get("last_restore") != "restored":
        raise SystemExit(f"{label}: /durability {code}, persist {persist}")
    second = svc2.engine.batch.export_state()
    for leaf, arr in first["books"].items():
        if not np.array_equal(arr, second["books"][leaf]):
            raise SystemExit(f"{label}: the restored service's books leaf "
                             f"{leaf} differs from the first service's")
    if {k: v for k, v in first.items() if k != "books"} != \
            {k: v for k, v in second.items() if k != "books"}:
        raise SystemExit(f"{label}: the restored service's interners or "
                         "geometry differ from the first service's")
    if sorted(svc2.engine.pre_pool) != marks:
        raise SystemExit(f"{label}: marks in the store differ after restore")
    mq = svc2.bus.match_queue
    got = [decode_match_result(m.body)
           for m in mq.read_from(0, mq.end_offset())]
    check_events(label, unstamped(got), want)
    if [e.seq for e in got] != list(range(len(want))):
        raise SystemExit(f"{label}: seqs not 0..{len(want) - 1}")
    svc2.engine.batch.verify_books()
    return svc.engine, store, dict(
        secs=secs, rtt=rtt, launches=launches, snaps=snaps, snaps2=snaps2,
        split=split,
        restore=persist, replay_s=replay_s, replay_launches=replay_launches,
        events=len(want), requests=len(requests), cap=first["cap"],
        orders=len(zipf), worst=worst, kept_line=kept_line)


def continuation(sizes, n: int):
    """n more orders of the flow's generator (another seed), their oids
    renamed so none meets an oid of the flow."""
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    more = multi_symbol_stream(n=n, n_symbols=sizes["symbols"], zipf_a=1.2,
                               cancel_prob=0.3, seed=17)
    return [dataclasses.replace(o, oid="m" + o.oid) for o in more]


def same_resting_orders(label, a, b) -> int:
    """The resting orders of engines a and b equal per lane (matched by
    symbol), side and slot: price, lots, and the oid and uid strings.
    Returns the count."""
    ba, bb = a.batch.lane_books(), b.batch.lane_books()
    lanes_b = {s: i for i, s in enumerate(b.batch.symbols.to_list())}
    total = 0
    for ia, sym in enumerate(a.batch.symbols.to_list()):
        ib = lanes_b.get(sym)
        for side in (0, 1):
            n = int(ba.count[ia, side])
            if n and (ib is None or int(bb.count[ib, side]) != n):
                raise SystemExit(f"{label}: {sym} side {side} holds {n} "
                                 "orders before and not after")
            for leaf, table in (("price", None), ("lots", None),
                                ("oid", "oids"), ("uid", "uids")):
                va = getattr(ba, leaf)[ia, side][:n]
                vb = getattr(bb, leaf)[ib, side][:n] if n else va
                if table is not None:
                    ta, tb = getattr(a.batch, table), getattr(b.batch, table)
                    va = [ta.lookup(int(x)) for x in va]
                    vb = [tb.lookup(int(x)) for x in vb]
                if list(map(str, va)) != list(map(str, vb)):
                    raise SystemExit(f"{label}: {sym} side {side} {leaf} "
                                     "differs")
            total += n
    if total != int(bb.count.sum()):
        raise SystemExit(f"{label}: {int(bb.count.sum())} resting orders "
                         f"after, {total} before")
    return total


def redis_migration_check(sizes, zipf, want_zipf, engine, store) -> dict:
    """Phase 9 (d): the engine of (c) through book_redis_commands into a
    DictRedis, then restore_from_redis into a fresh int64 engine on the
    card: equal resting orders and marks (the next frame's, marked
    before the export); then 10,000 more orders on both engines: events
    equal to each other and to the oracle's continued from the flow."""
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.persist import DictRedis, restore_from_redis
    from gome_tpu_torch.persist.redis_schema import book_redis_commands

    label = "phase 9 (d)"
    more = continuation(sizes, 10_000)
    frames = [frame_columns(more[i:i + sizes["batch"]])
              for i in range(0, len(more), sizes["batch"])]
    # The gateway has marked the first frame of the next orders: its marks
    # are queued state that migrates with the books.
    engine.mark_frame(frames[0])
    t0 = time.perf_counter()
    cmds = book_redis_commands(engine)
    redis = DictRedis()
    for cmd in cmds:
        redis.execute_command(*cmd)
    export_s = time.perf_counter() - t0
    fresh = MatchEngine(BookConfig(cap=256, max_fills=16, dtype=torch.int64),
                        n_slots=sizes["symbols"], max_t=32,
                        device=engine.batch.device)
    t0 = time.perf_counter()
    n_resting = restore_from_redis(fresh, redis)
    sync(fresh.batch.device)
    import_s = time.perf_counter() - t0
    if same_resting_orders(label, engine, fresh) != n_resting:
        raise SystemExit(f"{label}: {n_resting} orders imported")
    marks = sorted(fresh.pre_pool)
    if not marks or marks != sorted(engine.pre_pool):
        raise SystemExit(f"{label}: marks differ after the migration")
    fresh.batch.verify_books()
    calls = -engine.stats.device_calls - fresh.stats.device_calls
    batch_step.launches = 0
    got_src, _ = run_frames(engine, frames)
    got_dst, _ = run_frames(fresh, frames)
    launches = batch_step.launches
    calls += engine.stats.device_calls + fresh.stats.device_calls
    want = oracle_events(list(zipf) + more)[len(want_zipf):]
    check_events(f"{label} source engine", got_src, want)
    check_events(f"{label} migrated engine", got_dst, want)
    if launches <= 0 or launches != calls:
        raise SystemExit(f"{label}: {launches} K1 launches for {calls} "
                         "device calls")
    fresh.batch.verify_books()
    store.stop()
    return dict(commands=len(cmds), export_s=export_s, import_s=import_s,
                resting=n_resting, marks=len(marks),
                events=len(want), launches=launches, calls=calls)


def phase9(card: str, device, sizes, zipf, want_zipf, p8c_secs: float):
    """Durability on the card, each part printed as it ends: (a) the crash
    drill with real process deaths, (b) one snapshot and one restore at
    full width (in the drill's final worker), (c) the durable service over
    gRPC restored by a second service, (d) the Redis migration of (c)'s
    engine. p8c_secs: phase 8 (c)'s seconds in this run. Returns the
    numbers."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phase9a-") as work:
        drill = persist_drill(work, device=device.type,
                              n_orders=DRILL_ORDERS,
                              n_symbols=sizes["symbols"],
                              frame_n=sizes["batch"], cycles=4, cost=True)
    print_drill(card, sizes, drill, time.perf_counter() - t_phase)
    durable = zipf[:DURABLE_REQUESTS * WIRE_BATCH]
    want_durable = oracle_events(durable)
    with tempfile.TemporaryDirectory(prefix="phase9c-") as work:
        engine, store, svc = durable_service_check(sizes, durable,
                                                   want_durable, work)
    print_service(card, sizes, svc, p8c_secs)
    migration = redis_migration_check(sizes, durable, want_durable, engine,
                                      store)
    del engine
    torch.cuda.empty_cache()
    print(f"phase 9 (d): Redis migration of (c)'s engine: "
          f"{migration['commands']} commands, {migration['resting']} resting "
          f"orders and {migration['marks']} marks equal after "
          f"restore_from_redis into a fresh int64 engine on the card; 10,000 "
          f"more orders on both engines: {migration['events']} events each, "
          f"equal to the oracle's continued from the flow "
          f"({migration['launches']} K1 launches = device calls)")
    seconds = time.perf_counter() - t_phase
    print(f"phase 9 [{card}]: (d) book_redis_commands + DictRedis "
          f"{migration['export_s']:.3f} s for {migration['commands']:,} "
          f"commands; restore_from_redis {migration['import_s']:.3f} s for "
          f"{migration['resting']:,} resting orders; phase 9 in all "
          f"{seconds:.1f} s")
    return dict(drill=drill, svc=svc, migration=migration, seconds=seconds)


def snapshots_text(snaps) -> str:
    return ", ".join(f"{s['name']} {s['bytes']:,} B {s['seconds']:.3f} s"
                     for s in snaps) or "none"


def print_drill(card: str, sizes, drill, seconds: float) -> None:
    final, clean = drill["final"], drill["clean"]
    cost = final["cost"]
    print(f"phase 9 (a): crash drill: the flow's first {DRILL_ORDERS:,} "
          f"orders over "
          f"{sizes['symbols']} symbols as {drill['n_frames']} ORDER frames of "
          f"{sizes['batch']} in a file queue; workers are fresh interpreters "
          f"(OrderConsumer(batch_n=1, match_wire=frame), Persister every "
          f"{PERSIST_EVERY} batches, keep {PERSIST_KEEP}, restore_latest "
          f"before the FaultPlan is armed); {len(drill['cycles'])} kill "
          f"cycles each exited {drill['cycles'][0]['rc']}; the final "
          f"worker's {drill['n_events']} events: match-queue bodies "
          f"byte-equal to the uninterrupted worker's, equal to the oracle, "
          f"seqs 0..{drill['n_events'] - 1} once each in the feed (gaps "
          f"{final['feed']['gaps']}, dupes {final['feed']['dupes']})"
          f"; book digest equal ({final['book_digest'][:16]}, storage cap "
          f"{final['cap']}); K1 launches = device calls in the uninterrupted "
          f"({clean['launches']}) and final ({final['launches']}) workers")
    print(final["kept_line"])
    print(f"phase 9 (b): restored books equal the source's leaf by leaf "
          f"({cost['dtype']}, cap {cost['cap']}), verify_books passed")
    for i, c in enumerate([*drill["cycles"], final]):
        tag = f"cycle {i + 1}" if i < len(drill["cycles"]) else "final"
        rs = c["restore"]
        print(f"phase 9 [{card}]: (a) {tag} depth {c['depth']}: exit "
              f"{c['rc']} after {c['wall_s']:.2f} s (interpreter and torch "
              f"import {c['start_s']:.2f} s, engine build and CUDA context "
              f"{c['boot_s']:.2f} s); restore {rs['seconds']:.3f} s ({rs['last_restore']}, "
              f"cut {rs['cut']}, load {rs['split']['load']:.3f} + "
              f"import_state {rs['split']['import_state']:.3f} + mark "
              f"rebuild {rs['split']['mark_rebuild']:.3f} s, "
              f"wal_replay_frames {rs['wal_replay_frames']}); recovery "
              + (f"{c['recovery_s']:.3f} s" if "recovery_s" in c else
                 "not reached")
              + f" (to the pre-crash offset {c['pre_committed']}); "
              f"snapshots {snapshots_text(c['snapshots'])}")
    print(f"phase 9 [{card}]: (a) uninterrupted worker: {clean['seconds']:.3f}"
          f" s after its restore, snapshots {snapshots_text(clean['snapshots'])}"
          f"; (a) in all {seconds:.1f} s")
    sp, rsp = cost["split"], cost["restore_split"]
    print(f"phase 9 [{card}]: (b) snapshot of {cost['array_bytes']:,} B of "
          f"{cost['dtype']} books at cap {cost['cap']} ({cost['bytes']:,} B "
          f"on disk): {cost['snapshot_s']:.3f} s = export_state (device to "
          f"host) {sp['export_state']:.3f} + np.savez {sp['savez']:.3f} + "
          f"fsync {sp['fsync']:.3f} + other "
          f"{cost['snapshot_s'] - sum(sp.values()):.3f} s; restore "
          f"{cost['restore_s']:.3f} s = load {rsp['load']:.3f} + "
          f"import_state (host to device) {rsp['import_state']:.3f} + mark "
          f"rebuild {rsp['mark_rebuild']:.3f} + other "
          f"{cost['restore_s'] - sum(rsp.values()):.3f} s")


def print_service(card: str, sizes, svc, p8c_secs: float) -> None:
    print(f"phase 9 (c): EngineService with persist: (every "
          f"{SERVICE_PERSIST_EVERY} batches) and redis: (FakeRedisServer, "
          f"RespPrePool) over a file bus, int64, json match wire, depth 0, "
          f"one request per consumer batch: the flow's first "
          f"{svc['orders']:,} orders as "
          f"{svc['requests']} DoOrderBatch requests; a second EngineService "
          f"over the same directories and store restored "
          f"({svc['restore']['last_restore']}, "
          f"{svc['restore']['wal_replay_frames']} order-log messages rewound)"
          f" and replayed the tail: books equal the first's on every leaf "
          f"(cap {svc['cap']}), marks equal, the match queue's "
          f"{svc['events']} documents equal the oracle's, seqs 0.."
          f"{svc['events'] - 1}; K1 launches = device calls "
          f"({svc['launches']})")
    print(svc["kept_line"])
    rate = svc["orders"] / svc["secs"]
    p8 = sizes["zipf_n"] / p8c_secs
    rtt50, rtt99 = np.percentile(np.array(svc["rtt"]) * 1e3, [50, 99])
    print(f"phase 9 [{card}]: (c) durable service {rate:,.0f} orders/s over "
          f"the wire ({svc['secs']:.3f} s to the feed's last commit); phase "
          f"8 (c) in this run {p8:,.0f} orders/s (ratio {rate / p8:.3f}); "
          f"DoOrderBatch p50 {rtt50:.2f} ms, p99 {rtt99:.2f} ms; snapshots "
          + ", ".join(f"{b:,} B {t:.3f} s" for b, t in svc["snaps"])
          + f"; second service: restore {svc['restore']['recovery_s']} s, "
          f"start to replayed {svc['replay_s']:.3f} s, "
          f"{svc['replay_launches']} K1 launches")
    sp = svc["split"]
    print(f"phase 9 [{card}]: (c) split, seconds summed over threads: "
          f"gateway admission {sp['gateway']:.4f}, consumer "
          f"{sp['consumer'] - sp['consumer_wait']:.4f} (+ "
          f"{sp['consumer_wait']:.4f} polling; of it event publish "
          f"{sp['publish']:.4f}, snapshots "
          f"{sum(t for _, t in svc['snaps']):.4f}), feed "
          f"{sp['feed'] - sp['feed_wait']:.4f} (+ {sp['feed_wait']:.4f} "
          f"polling)")


# -- phase 10 ----------------------------------------------------------------

SM_CLOCK_HZ = 1.98e9  # H100 SXM boost clock
SIM_SEED = 3


def sim_env_config(lanes: int, cap: int = 32, k: int = 8, **flow):
    """The environment at `lanes` lanes, int32 books at cap / K, the
    default flow but for `flow`'s fields."""
    from gome_tpu_torch.engine.book import BookConfig
    from gome_tpu_torch.sim import EnvConfig, FlowConfig

    return EnvConfig(flow=FlowConfig(n_lanes=lanes, **flow),
                     book=BookConfig(cap=cap, max_fills=k, dtype=torch.int32))


def chain_latencies(device) -> dict:
    """Cycles of one dependent step of each operation on a bin's path,
    from hawkes_scan.cu's one-warp clock64 probe (the best of three runs
    of 2**14 steps each): `add` a float add, `log` logf(x + c), `exp`
    expf(x * c), `cs` a compare and select (the probe's step less one
    add); the steps that can pick a realized candidate: `shfl` a shuffle
    whose source lane is the previous result, `ballot` a ballot of a
    compare, `lds` a shared-memory load; and `update` an event-free bin's
    update of one intensity (subtract, fused multiply-add)."""
    import ctypes

    from gome_tpu_torch.ops import build

    probe = build.load("hawkes_scan").gome_hawkes_latency_probe
    probe.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    n = 1 << 14
    cycles = torch.zeros(8, dtype=torch.int64, device=device)
    sink = torch.zeros(8 * 32, dtype=torch.float32, device=device)
    best = None
    for _ in range(3):
        err = probe(n, 1.0, cycles.data_ptr(), sink.data_ptr(),
                    torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise SystemExit(f"phase 10 (a): the latency probe did not "
                             f"launch (error {err})")
        got = (cycles.cpu().double() / n).tolist()
        best = got if best is None else [min(a, b) for a, b in zip(best, got)]
    add, log, exp, cs_add, shfl, ballot, lds, update = best
    return dict(add=add, log=log, exp=exp, cs=cs_add - add, shfl=shfl,
                ballot=ballot, lds=lds, update=update)


def hawkes_chain_cycles(lat) -> float:
    """Cycles of one bin's least dependent path from lam to the next lam
    when bins are taken one at a time (the chain without speculation),
    from the probe's latencies: the larger of (A) log(lam + eps), + g,
    and a three-level tree argmax whose compare-selects carry alpha's
    column from registers as their payload, and (B) the six-term sum left
    to right (the function's rounding order: five adds), * -dt, exp and
    1 - p; then the compare u < p selecting that column or 0, and the
    update's add. The decay's FMA runs beside both. Speculation goes
    below it: it evaluates later bins before this path ends."""
    a = lat["log"] + lat["add"] + 3 * lat["cs"]
    b = 5 * lat["add"] + lat["exp"] + lat["add"]
    return max(a, b) + lat["cs"] + lat["add"]


def hawkes_spec_cycles(lat) -> float:
    """Cycles a bin that no design removes, speculating or not: the probe's
    event-free update of one intensity, fma(lam - mu, decay, mu), a
    subtract and a fused multiply-add. Every design applies T such updates
    in order, since the outputs and the last lam are the realized path's,
    bit for bit, and each update rounds what the last one gave; a bin with
    an event also adds alpha's column. The reference's + 0.0f on an
    event-free bin is not counted: the FMA never returns -0 while mu is
    not -0, so adding +0 changes no bit. The pick of a realized candidate
    is not counted either: a design may pick once for many bins (K5 once a
    round of up to five)."""
    return lat["update"]


def hawkes_bound_ms(t_bins: int, cycles_per_bin: float) -> tuple[float, str]:
    """Least time for one scan of T bins: its bytes (draws in, three [T]
    outputs, lam and the counter) over HBM bandwidth, or T times
    `cycles_per_bin` (hawkes_spec_cycles for the bound, hawkes_chain_cycles
    for the chain without speculation) at the boost clock, whichever is
    larger."""
    nbytes = t_bins * (4 + 6 * 4 + 3 * 4) + 2 * 6 * 4 + 2 * 4
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_chain = t_bins * cycles_per_bin / SM_CLOCK_HZ * 1e3
    return (by_bytes, "bytes") if by_bytes > by_chain else (by_chain,
                                                            "operations")


def stationary_lam(config) -> np.ndarray:
    """The flow's stationary intensity (I - alpha / decay)^-1 mu."""
    g = config.alpha() / config.decay
    return np.linalg.solve(np.eye(len(g)) - g, config.mu())


def scan_inputs(config, t_bins: int, lam0, seed: int, device):
    """(lam, oid0, u_ev, g_ty) drawn on `device` from a seeded generator
    by the flow's own draw_bins."""
    from gome_tpu_torch.sim.flow import draw_bins

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draws, _ = draw_bins(config, gen.get_state(), t_bins, device)
    lam = torch.tensor(lam0, dtype=torch.float32, device=device)
    oid0 = torch.ones((), dtype=torch.int32, device=device)
    return lam, oid0, draws.u_ev, draws.g_ty


#: T values of K5's edge inputs: around a warp (32) and a 1,024-bin grid.
HAWKES_EDGE_T = (1, 2, 3, 7, 8, 31, 32, 33, 1023, 1024, 1025)
#: K5's edge inputs, built by hawkes_edge_case.
HAWKES_EDGE_CASES = ("event_every_bin", "no_event", "u_equals_p",
                     "tied_maxima", "zero_intensity", "partial_last_round",
                     *(f"T{t}" for t in HAWKES_EDGE_T))
#: The etype of tied_maxima's g_ty rows, in turn.
HAWKES_TIE_ETYPES = (0, 2, 4, 0)
#: The intensities zero_intensity starts at 0.
HAWKES_ZERO_TYPES = (0, 3, 5)


def hawkes_event_thresholds(config, lam, t_bins: int) -> torch.Tensor:
    """p_event of each of `t_bins` bins along the event-free path from
    `lam`, on lam's device, with hawkes_scan_reference's own expressions
    (so equal to its p_event bit for bit)."""
    from gome_tpu_torch.ops.hawkes_scan import N_EVENT_TYPES, _constants

    mu_np, _, decay, neg_dt = _constants(config)
    mu = torch.from_numpy(mu_np).to(lam.device)
    mu64 = mu.double()
    zero = torch.zeros(N_EVENT_TYPES, dtype=torch.float32, device=lam.device)
    out = torch.empty(t_bins, dtype=torch.float32, device=lam.device)
    for t in range(t_bins):
        total = lam[0]
        for i in range(1, N_EVENT_TYPES):
            total = total + lam[i]
        out[t] = 1.0 - torch.exp(total * neg_dt)
        lam = ((lam - mu).double() * decay + mu64).float() + zero
    return out


def hawkes_edge_case(config, name: str, device):
    """(lam, oid0, u_ev, g_ty) on `device` for one of HAWKES_EDGE_CASES,
    from numpy draws seeded by the name (u_ev uniform, g_ty Gumbel, both
    float32; T 1,024 unless named): event_every_bin: 100 times the
    stationary lam and u_ev 0, so every bin has an event; no_event: u_ev
    1; u_equals_p: u_ev equal to each bin's p_event along the event-free
    path (hawkes_event_thresholds on `device`), so the strict u < p never
    holds; tied_maxima: lam = mu and no event, so the two sides of each
    kind stay tied, and g_ty rows tied on types 0-1, 2-3, 4-5 and on all
    six in turn (HAWKES_TIE_ETYPES); zero_intensity: the stationary lam
    with HAWKES_ZERO_TYPES at 0, so log(lam + eps) is log(1e-12), below
    every other type's score at bin 0; partial_last_round: no event at T
    1,027, so the kernel's last round of five bins is cut short; T<n>: the
    stationary lam and random draws at T = n."""
    import zlib

    t_bins = int(name[1:]) if name.startswith("T") else (
        1027 if name == "partial_last_round" else 1024)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    u_ev = rng.random(t_bins, dtype=np.float32)
    u_ty = rng.random((t_bins, 6), dtype=np.float32)
    g_ty = -np.log(-np.log(np.maximum(u_ty, np.finfo(np.float32).tiny)))
    lam0 = stationary_lam(config)
    if name == "event_every_bin":
        lam0 = 100 * lam0
        u_ev[:] = 0
    elif name in ("no_event", "partial_last_round"):
        u_ev[:] = 1
    elif name == "tied_maxima":
        lam0 = config.mu()
        u_ev[:] = 1
        rows = np.zeros((len(HAWKES_TIE_ETYPES), 6), np.float32)
        for r, e in enumerate(HAWKES_TIE_ETYPES[:3]):
            rows[r, e:e + 2] = 5.0
        g_ty = rows[np.arange(t_bins) % len(rows)]
    elif name == "zero_intensity":
        lam0 = lam0.copy()
        lam0[list(HAWKES_ZERO_TYPES)] = 0.0
    elif not name.startswith("T") and name != "u_equals_p":
        raise ValueError(f"no K5 edge case {name!r}")
    lam = torch.tensor(lam0, dtype=torch.float32, device=device)
    oid0 = torch.ones((), dtype=torch.int32, device=device)
    u = (hawkes_event_thresholds(config, lam, t_bins) if name == "u_equals_p"
         else torch.from_numpy(u_ev).to(device))
    g = torch.from_numpy(np.ascontiguousarray(g_ty, np.float32)).to(device)
    return lam, oid0, u, g


def time_scan(config, args) -> dict:
    """K5's ms (median of CUDA events around one call), device_ms and
    cycles a bin at `args` (200 calls, 20 from T 4,096 on)."""
    from gome_tpu_torch.ops.hawkes_scan import hawkes_scan

    t_bins = args[2].shape[0]
    runs = 200 if t_bins < 4096 else 20
    dev_ms = device_ms(lambda: hawkes_scan(config, *args), runs)
    return dict(ms=time_ms(lambda: hawkes_scan(config, *args), runs),
                device_ms=dev_ms,
                cycles_per_bin=dev_ms * 1e-3 * SM_CLOCK_HZ / t_bins)


def check_scan(label, config, args) -> tuple[int, float, float]:
    """K5 against its plain version on the same inputs: occur, etype, oid
    and next_oid equal, lam bit-equal (the stated tolerance: none). Returns
    the events, the plain version's seconds (one run) and the largest
    |kernel - plain| over every output."""
    from gome_tpu_torch.ops.hawkes_scan import (
        ScanOut,
        hawkes_scan,
        hawkes_scan_reference,
    )

    out = hawkes_scan(config, *args)
    sync(args[0].device)
    t0 = time.perf_counter()
    plain = hawkes_scan_reference(config, *args)
    sync(args[0].device)
    secs = time.perf_counter() - t0
    worst = 0.0
    for name in ScanOut._fields:
        a, b = getattr(out, name), getattr(plain, name)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise SystemExit(f"{label}: K5's {name} is {a.dtype}"
                             f"{tuple(a.shape)}, its plain version's "
                             f"{b.dtype}{tuple(b.shape)}")
        diff = (a.double() - b.double()).abs().reshape(-1)
        err = float(diff.max())
        if err:
            bad = int(diff.argmax())
            raise SystemExit(
                f"{label}: K5 differs from its plain version in {name} at "
                f"{bad}: kernel {a.reshape(-1)[bad].item()} plain "
                f"{b.reshape(-1)[bad].item()}")
        worst = max(worst, err)
    return int(out.occur.sum()), secs, worst


def env_to(state, device):
    """An EnvState's tensors on `device` (the generator state stays)."""
    from gome_tpu_torch.engine.book import BookState
    from gome_tpu_torch.sim.env import EnvState
    from gome_tpu_torch.sim.flow import FlowState

    f = state.flow
    return EnvState(
        books=BookState(*(a.to(device) for a in state.books)),
        flow=FlowState(f.lam.to(device), f.rng, f.next_oid.to(device),
                       f.t_model.to(device)),
        t=state.t.to(device), cash=state.cash.to(device),
        inv=state.inv.to(device), mtm=state.mtm.to(device))


def scripted_action(config, step: int, device):
    """Slot 0 rests a bid 3 ticks under the reference price on lane
    step % S; slot 1 market-sells 2 lots on the lane slot 0 used the step
    before (the agent's own bid, when it still rests)."""
    from gome_tpu_torch.sim import AgentAction

    s = config.flow.n_lanes
    ref = config.flow.ref_price
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return AgentAction(
        lane=i32([step % s, (step - 1) % s]), action=i32([1, int(step > 0)]),
        side=i32([0, 1]), is_market=i32([0, 1]), price=i32([ref - 3, 0]),
        volume=i32([4, 2]), oid=i32([(1 << 24) + 2 * step,
                                     (1 << 24) + 2 * step + 1]))


def f32_close(label, port, ref, scale) -> None:
    """float32 sums taken in another order (CUDA reductions against the
    CPU's): 32 ulps (2**-18) of the step's largest magnitude among cash,
    mark to market and inventory value."""
    tol = 2.0 ** -18 * max(float(scale), 1.0)
    if abs(float(port) - float(ref)) > tol:
        raise SystemExit(f"{label}: {float(port)} vs {float(ref)} "
                         f"(tolerance {tol})")


def same_step(label, got, want) -> None:
    """Two env_step results: books, Obs, StepInfo and inventory equal;
    reward, cash and mark to market within f32_close."""
    (g_state, g_obs, g_reward, g_info) = got
    (w_state, w_obs, w_reward, w_info) = want
    for group, a, b in (("books", g_state.books, w_state.books),
                        ("obs", g_obs, w_obs), ("info", g_info, w_info)):
        for name, x, y in zip(a._fields, a, b):
            if not torch.equal(x.cpu(), y.cpu()):
                raise SystemExit(f"{label}: {group}.{name} differs")
    if not torch.equal(g_state.inv.cpu(), w_state.inv.cpu()):
        raise SystemExit(f"{label}: inventory differs")
    scale = max(abs(float(w_state.cash)), abs(float(w_state.mtm)),
                float((w_state.inv.double().cpu()
                       * w_obs.mid.double().cpu()).abs().sum()))
    f32_close(f"{label} cash", g_state.cash, w_state.cash, scale)
    f32_close(f"{label} mark to market", g_state.mtm, w_state.mtm, scale)
    f32_close(f"{label} reward", g_reward, w_reward, scale)


def card_against_cpu(label, config, steps: int, device) -> int:
    """`steps` env_steps with the scripted agent from one seeded state,
    on the CPU and on the card, with draws made on the CPU and copied to
    the card: every step equal (same_step). Returns the events seen."""
    from gome_tpu_torch.sim import env_reset, env_step
    from gome_tpu_torch.sim.flow import Draws, draw_bins

    cpu_state, _ = env_reset(config, SIM_SEED, "cpu")
    card_state = env_to(cpu_state, device)
    rng = cpu_state.flow.rng
    events = 0
    for step in range(steps):
        draws, rng = draw_bins(config.flow, rng, config.flow.t_bins, "cpu")
        want = env_step(config, cpu_state, scripted_action(config, step,
                                                           "cpu"), draws)
        got = env_step(config, card_state,
                       scripted_action(config, step, device),
                       Draws(*(d.to(device) for d in draws)))
        same_step(f"{label} step {step}", got, want)
        cpu_state, card_state = want[0], got[0]
        events += int(want[3].events)
    return events


def pure_step_check(label, config, state, device) -> None:
    """env_step twice on one state with an agent action: equal."""
    from gome_tpu_torch.sim import env_step

    act = scripted_action(config, 7, device)
    same_step(label, env_step(config, state, act), env_step(config, state,
                                                            act))


def sim_worker(argv) -> int:
    """`--sim-worker <manifest.json>`: replay the manifest on the card in
    this (fresh) process and print run_from_manifest's result as JSON."""
    from gome_tpu_torch.sim import run_from_manifest

    with open(argv[1]) as f:
        manifest = json.load(f)
    print(json.dumps(run_from_manifest(manifest, "cuda")))
    return 0


def launch_counts():
    from gome_tpu_torch.ops import hawkes_scan, match_step

    return match_step._counted, hawkes_scan._counted


def sim_rollout(label, config, steps: int, device, keep_every: int):
    """env_reset(SIM_SEED) and a `steps`-step rollout under
    torch.cuda.set_sync_debug_mode("error"), with K1's and K5's launches
    counted from 0; fails unless the flow ran (> steps events, > steps /
    10 trades) with both overflow counters at zero. Then K1 and K5 against
    their plain versions at the inputs of every `keep_every`-th call and
    the last. Returns the numbers and the final state."""
    from gome_tpu_torch.sim import env_reset, rollout

    state, _ = env_reset(config, SIM_SEED, device)
    warm, _ = rollout(config, state, 3)  # allocator and caches, off the clock
    sync(device)
    k1, k5 = launch_counts()
    k1.launches = k5.launches = 0
    with keep_kernel_inputs(keep_every) as kept:
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            final, (rewards, info) = rollout(config, state, steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync(device)
        secs = time.perf_counter() - t0
    launches = (k1.launches, k5.launches)
    events, trades = int(info.events.sum()), int(info.trades.sum())
    b_over = int(info.book_overflow.sum())
    f_over = int(info.fill_overflow.sum())
    if events <= steps or trades <= steps // 10 or b_over or f_over:
        raise SystemExit(f"{label}: {events} events, {trades} trades, "
                         f"overflow {b_over} book / {f_over} fills over "
                         f"{steps} steps")
    if launches != (steps, steps):
        raise SystemExit(f"{label}: K1 / K5 launches {launches} for {steps} "
                         f"steps")
    del warm
    worst, k1_line = check_kept_inputs(label, kept)
    scan_worst, k5_line = check_kept_scans(label, kept)
    return dict(secs=secs, events=events, trades=trades, launches=launches,
                steps=steps, final=final, worst=worst, scan_worst=scan_worst,
                kept_lines=[k1_line, k5_line],
                finite=bool(torch.isfinite(rewards).all()))


@contextlib.contextmanager
def step_split():
    """Host seconds and CUDA-event milliseconds inside an env step's
    parts, by wrapping them for the block: the draws (flow.draw_bins), K5
    (hawkes_scan), the resolve and scatter (flow._resolve, flow._scatter)
    and K1 (match_step.batch_step). Yields {part: [host s, [events]]}."""
    from gome_tpu_torch.ops import hawkes_scan, match_step
    from gome_tpu_torch.sim import flow

    places = ((flow, "draw_bins", "draws"), (hawkes_scan, "hawkes_scan", "K5"),
              (flow, "_resolve", "resolve+scatter"),
              (flow, "_scatter", "resolve+scatter"),
              (match_step, "batch_step", "K1"))
    parts = {p: [0.0, []] for _, _, p in places}
    saved = [getattr(m, n) for m, n, _ in places]

    def timed(fn, part):
        def run(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = fn(*args)
            b.record()
            parts[part][0] += time.perf_counter() - t0
            parts[part][1].append((a, b))
            return out
        return run

    for (m, n, p), fn in zip(places, saved):
        setattr(m, n, timed(fn, p))
    try:
        yield parts
    finally:
        for (m, n, _), fn in zip(places, saved):
            setattr(m, n, fn)


def split_text(parts, total_s: float, steps: int) -> str:
    torch.cuda.synchronize()
    host = {p: v[0] for p, v in parts.items()}
    dev = {p: span_seconds(v[1]) for p, v in parts.items()}
    rest = total_s - sum(host.values())
    return (", ".join(f"{p} {1e3 * host[p] / steps:.3f} ms host / "
                      f"{1e3 * dev[p] / steps:.3f} ms device"
                      for p in host)
            + f", PnL+Obs+info and the rest {1e3 * rest / steps:.3f} ms host"
            " (per step)")


def sim_traffic(device, n_orders: int, lanes: int, t_bins: int,
                keep_every: int):
    """bench.py's _SimFlow pump on the card, geometry (iii): per pump
    flow._gen (the draws, K5, the resolve and scatter of a [10,240, 1,024]
    grid), K1 on the sim-side books (cap 64, K 8, int32) and the fetch of
    the occurring bins' columns (bin_columns, drop_misses=True), until
    n_orders; on the first pump the columns must equal grid_to_columns of
    the whole grid. The parts are timed by step_split; then K1 and K5
    against their plain versions at the inputs of every `keep_every`-th
    pump and the last. Returns the orders and the numbers."""
    from gome_tpu_torch.engine.book import BookConfig, init_books
    from gome_tpu_torch.ops import match_step
    from gome_tpu_torch.sim import FlowConfig, flow_init
    from gome_tpu_torch.sim import flow as flow_mod
    from gome_tpu_torch.sim.replay import (
        bin_columns,
        grid_host,
        grid_to_columns,
        orders_from_columns,
    )

    config = FlowConfig(n_lanes=lanes, t_bins=t_bins, ref_price=100_000_000,
                        ref_spread=50)
    book_cfg = BookConfig(cap=64, max_fills=8, dtype=torch.int32)
    books = init_books(book_cfg, config.n_lanes, device)
    state = flow_init(config, SIM_SEED, device)
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    k1, k5 = launch_counts()
    k1.launches = k5.launches = 0
    fetch_s, cols, n, pumps = 0.0, [], 0, 0
    with step_split() as parts, keep_kernel_inputs(keep_every) as kept:
        t0 = time.perf_counter()
        while n < n_orders:
            state, ops, bins = flow_mod._gen(config, state, books)
            books, _ = match_step.batch_step(book_cfg, books, ops)
            t1 = time.perf_counter()
            got = bin_columns(bins, drop_misses=True)
            fetch_s += time.perf_counter() - t1
            if pumps == 0:
                whole = grid_to_columns(grid_host(ops), drop_misses=True)
                for k in whole:
                    if not np.array_equal(whole[k], got[k]):
                        raise SystemExit(f"phase 10 (d): bin_columns' {k} "
                                         f"differs from grid_to_columns'")
            pumps += 1
            if got["n"]:
                cols.append(got)
                n += got["n"]
        secs = time.perf_counter() - t0
    launches = (k1.launches, k5.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del ops, bins
    worst, k1_line = check_kept_inputs("phase 10 (d) pumps", kept)
    scan_worst, k5_line = check_kept_scans("phase 10 (d) pumps", kept)
    orders = [o for c in cols for o in orders_from_columns(c)][:n_orders]
    return orders, dict(
        secs=secs, pumps=pumps, fetch_s=fetch_s,
        host_s={p: v[0] for p, v in parts.items()},
        device_s={p: span_seconds(v[1]) for p, v in parts.items()},
        launches=launches, peak_gb=peak_gb, worst=worst,
        scan_worst=scan_worst, kept_lines=[k1_line, k5_line])


def sim_consumer(device, orders, frame_n: int, lanes: int):
    """The simulated orders as ORDER frames of `frame_n` through phase 6's
    consumer stack at depth 0 on the card: events equal to the oracle's,
    seqs 0..n-1, books verified, K1 equal to its plain version at the
    inputs the consumer gave it. Returns (seconds, K1 launches, events,
    worst |error|, report line)."""
    k1, _ = launch_counts()
    frame_list = [frame_columns(orders[i:i + frame_n])
                  for i in range(0, len(orders), frame_n)]
    want = oracle_events(orders)
    eng, bus, consumer = consumer_stack(device, lanes, 0)
    k1.launches = 0
    with keep_kernel_inputs() as kept:
        secs, _, _ = closed_loop(eng, bus, consumer, frame_list,
                                 {"gateway": 0.0})
    launches = k1.launches
    check_consumer_run("phase 10 (d)", eng, bus, want)
    worst, line = check_kept_inputs("phase 10 (d) consumer", kept)
    return secs, launches, len(want), worst, line


def sim_stats_check(device, lanes: int, t_bins: int) -> list[str]:
    """(e): the reference's statistical bounds on the card's own generator
    (tests/test_sim.py's TestFlowStats), and the Zipf fit at 10,240 lanes
    over 300 grids of 1,024 bins."""
    from gome_tpu_torch.engine.book import BookConfig, init_books
    from gome_tpu_torch.sim import FlowConfig, flow_init
    from gome_tpu_torch.sim import stats as sim_stats
    from gome_tpu_torch.sim.flow import _gen

    lines = []
    config = FlowConfig(n_lanes=32, t_bins=64)
    s = sim_stats.sample_grids(config, 0, 300, device=device)
    fit = sim_stats.zipf_exponent(sim_stats.symbol_counts(s))
    per_grid = sim_stats.events_per_grid(s)
    n_hat = sim_stats.empirical_branching_ratio(config, int(per_grid.sum()),
                                                len(per_grid))
    disp = sim_stats.dispersion_index(per_grid)
    if not (abs(fit - config.zipf_a) < 0.3
            and 0.25 < n_hat < config.branching_ratio() + 0.05 and disp > 1.2):
        raise SystemExit(f"phase 10 (e): Zipf fit {fit}, branching {n_hat}, "
                         f"dispersion {disp} outside the bounds")
    poisson = FlowConfig(n_lanes=32, t_bins=64, excite_self=1e-6,
                         excite_cross=1e-6, excite_kind=1e-6)
    p = sim_stats.events_per_grid(
        sim_stats.sample_grids(poisson, 1, 300, device=device))
    p_disp = sim_stats.dispersion_index(p)
    p_hat = sim_stats.empirical_branching_ratio(poisson, int(p.sum()), len(p))
    if not (abs(p_disp - 1.0) < 0.25 and abs(p_hat) < 0.12):
        raise SystemExit(f"phase 10 (e): Poisson limit dispersion {p_disp}, "
                         f"branching {p_hat} outside the bounds")
    lines.append(
        f"phase 10 (e): 300 grids at 32 lanes x 64 bins on the card: Zipf fit "
        f"{fit:.4f} (a = {config.zipf_a}, bound 0.3), branching {n_hat:.4f} "
        f"in (0.25, {config.branching_ratio() + 0.05:.2f}), dispersion "
        f"{disp:.4f} > 1.2; Poisson limit: dispersion {p_disp:.4f}, branching"
        f" {p_hat:.4f}; all within tests/test_sim.py's bounds")
    wide = FlowConfig(n_lanes=lanes, t_bins=t_bins)
    books = init_books(BookConfig(cap=4, max_fills=1, dtype=torch.int32),
                       wide.n_lanes, device)
    state = flow_init(wide, 0, device)
    counts = torch.zeros(wide.n_lanes, dtype=torch.int64, device=device)
    for _ in range(300):
        state, _ops, bins = _gen(wide, state, books)
        counts.index_add_(0, bins.lane.long(), (bins.action != 0).long())
    counts = counts.cpu().numpy()
    lines.append(
        f"phase 10 (e): 300 grids at {lanes:,} lanes x {t_bins:,} bins: "
        f"{int(counts.sum())} events on {int((counts > 0).sum())} lanes, "
        f"Zipf fit {sim_stats.zipf_exponent(counts):.4f} (a = {wide.zipf_a}; "
        f"printed, not bounded: most lanes see 0-2 events)")
    return lines


def phase10a(card: str, device, sizes) -> dict:
    """Phase 10 (a): K5 against its plain version on draws made on the
    card and at every edge input (HAWKES_EDGE_CASES), then timed beside
    its two bounds, each line printed as it ends."""
    from gome_tpu_torch.ops.hawkes_scan import hawkes_scan_reference
    from gome_tpu_torch.sim import FlowConfig

    flow = FlowConfig()
    scans, scan_worst = {}, 0.0
    scan_t = sizes["sim_scan_t"]
    for t_bins in scan_t:
        starts = (("mu", flow.mu()), ("stationary", stationary_lam(flow)))
        for name, lam0 in starts[1:] if t_bins == scan_t[-1] else starts:
            args = scan_inputs(flow, t_bins, lam0, 100 + t_bins, device)
            events, plain_s, err = check_scan(
                f"phase 10 (a) T={t_bins} from {name}", flow, args)
            scans[(t_bins, name)] = (args, events, plain_s)
            scan_worst = max(scan_worst, err)
    edges = []
    for name in HAWKES_EDGE_CASES:
        events, _, err = check_scan(f"phase 10 (a) edge input {name}", flow,
                                    hawkes_edge_case(flow, name, device))
        scan_worst = max(scan_worst, err)
        edges.append(f"{name} {events}")
    lat = chain_latencies(device)
    chain = hawkes_chain_cycles(lat)
    spec = hawkes_spec_cycles(lat)
    k5 = {}
    for t_bins in scan_t:
        args = scans[(t_bins, "stationary")][0]
        bound, bound_by = hawkes_bound_ms(t_bins, spec)
        plain_ms = (time_ms(lambda: hawkes_scan_reference(flow, *args), 5, 1)
                    if t_bins == 32 else
                    1e3 * scans[(t_bins, "stationary")][2])
        k5[t_bins] = dict(
            **time_scan(flow, args), plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by,
            chain_bound_ms=hawkes_bound_ms(t_bins, chain)[0],
            events=scans[(t_bins, "stationary")][1])
    for t_bins, r in k5.items():
        print(f"phase 10 (a) [{card}]: hawkes_scan (K5) T={t_bins}: equal to "
              f"its plain version on the card (occur, etype, oid, next_oid; "
              f"lam bit-equal), {r['events']} events from the stationary "
              f"lam; ms {r['ms']:.4f} (median), device_ms "
              f"{r['device_ms']:.4f}; plain {r['plain_ms']:.3f} ms "
              f"({'median of 5' if t_bins == 32 else 'one run'}); bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {spec:.2f} cycles a "
              f"bin, an event-free update of lam, at "
              f"{SM_CLOCK_HZ / 1e9:.2f} GHz); the chain without speculation "
              f"{r['chain_bound_ms']:.5f} ms ({chain:.1f} cycles a bin); the "
              f"kernel {r['cycles_per_bin']:.1f} cycles a bin")
    print(f"phase 10 (a) [{card}]: K5 equal to its plain version at "
          f"{len(edges)} edge inputs (name and events): " + ", ".join(edges))
    print(f"phase 10 (a) [{card}]: latency probe (one warp, clock64, best "
          f"of 3 x 2**14 dependent steps), cycles a step: add "
          f"{lat['add']:.2f}, logf(x + c) {lat['log']:.2f}, expf(x * c) "
          f"{lat['exp']:.2f}, compare-select {lat['cs']:.2f}, shuffle "
          f"{lat['shfl']:.2f}, ballot {lat['ballot']:.2f}, shared load "
          f"{lat['lds']:.2f} (the last four: the steps that can pick a "
          f"realized candidate), an event-free update (sub, fma) "
          f"{lat['update']:.2f}; a bin's least dependent path without "
          f"speculation max(log + add + 3 cs, 6 add + exp + add) + cs + "
          f"add = {chain:.2f} cycles; the bound, any design: the update, "
          f"{spec:.2f} cycles")
    return dict(k5=k5, worst=scan_worst)


def phase10(card: str, device, sizes) -> dict:
    """The market simulator on the card, each part printed as it ends."""
    from gome_tpu_torch.sim import make_manifest, run_from_manifest

    t_phase = time.perf_counter()
    a = phase10a(card, device, sizes)
    k5, scan_worst = a["k5"], a["worst"]
    scan_t = sizes["sim_scan_t"]

    # (b) geometry (i): 256 lanes, the reference's acceptance rollout.
    config_i = sim_env_config(sizes["sim_i_lanes"])
    run_i = sim_rollout("phase 10 (b)", config_i, sizes["sim_i_steps"],
                        device, keep_every=sizes["sim_i_steps"] // 4)
    pure_step_check("phase 10 (b) env_step twice", config_i,
                    run_i["final"], device)
    manifest = make_manifest(config_i, SIM_SEED, 200)
    digest = run_from_manifest(manifest, device)
    again = run_from_manifest(manifest, device)
    with tempfile.TemporaryDirectory(prefix="phase10-") as work:
        path = os.path.join(work, "manifest.json")
        with open(path, "w") as f:
            json.dump(manifest, f)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--sim-worker", path],
            capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise SystemExit(f"phase 10 (b): sim worker exited {proc.returncode}:"
                         f"\n{proc.stderr[-3000:]}")
    there = json.loads(proc.stdout.strip().splitlines()[-1])
    if not (digest == again == there):
        raise SystemExit(f"phase 10 (b): digests differ: {digest}, {again}, "
                         f"{there}")
    cpu_events = card_against_cpu("phase 10 (b) card against CPU", config_i,
                                  50, device)
    small = sim_rollout("phase 10 (b) 64 lanes", sim_env_config(64),
                        sizes["sim_small_steps"], device,
                        keep_every=sizes["sim_small_steps"] // 2)
    print(f"phase 10 (b): env_reset(seed {SIM_SEED}) + rollout of "
          f"{run_i['steps']:,} steps at {sizes['sim_i_lanes']} lanes (cap 32, "
          f"K 8, int32, T 2+32) under "
          f"set_sync_debug_mode('error'): {run_i['events']} events, "
          f"{run_i['trades']} trades, overflow 0 / 0, rewards finite "
          f"{run_i['finite']}; env_step twice on one state equal; "
          f"run_from_manifest (200 steps) digest {digest['digest'][:16]}… "
          f"twice in process and in a fresh `--sim-worker` process; 50 steps"
          f" with the scripted agent on the card equal to the CPU's with the "
          f"same draws ({cpu_events} events; reward, cash and mark to market "
          f"within 2**-18 of scale)")
    for line in run_i["kept_lines"] + small["kept_lines"]:
        print(line)

    # (c) geometry (ii): the engine's production width.
    config_ii = sim_env_config(sizes["sim_lanes"])
    run_ii = sim_rollout("phase 10 (c)", config_ii, sizes["sim_ii_steps"],
                         device, keep_every=sizes["sim_ii_steps"] // 4)
    pure_step_check("phase 10 (c) env_step twice", config_ii,
                    run_ii["final"], device)
    m_ii = make_manifest(config_ii, SIM_SEED, 20)
    if run_from_manifest(m_ii, device) != run_from_manifest(m_ii, device):
        raise SystemExit("phase 10 (c): in-process digests differ")
    ii_events = card_against_cpu("phase 10 (c) card against CPU", config_ii,
                                 sizes["sim_ii_cpu_steps"], device)
    from gome_tpu_torch.sim import env_reset, rollout

    state, _ = env_reset(config_ii, SIM_SEED, device)
    rollout(config_ii, state, 3)
    sync(device)
    with step_split() as parts:
        t0 = time.perf_counter()
        rollout(config_ii, state, 100)
        sync(device)
        split_s = time.perf_counter() - t0
    split = split_text(parts, split_s, 100)
    print(f"phase 10 (c): rollout of {run_ii['steps']:,} steps at "
          f"{sizes['sim_lanes']:,} lanes under set_sync_debug_mode('error'): "
          f"{run_ii['events']} "
          f"events, {run_ii['trades']} trades, overflow 0 / 0; env_step twice "
          f"equal; run_from_manifest (20 steps) twice equal; "
          f"{sizes['sim_ii_cpu_steps']} steps on the card equal to the CPU's "
          f"({ii_events} events)")
    for line in run_ii["kept_lines"]:
        print(line)

    # (d) geometry (iii): the simulator as the service's traffic source.
    orders, gen = sim_traffic(device, sizes["sim_orders"], sizes["sim_lanes"],
                              sizes["sim_t"], sizes["sim_pump_keep"])
    c_secs, c_launches, n_events, c_worst, c_line = sim_consumer(
        device, orders, sizes["batch"], sizes["sim_lanes"])
    print(f"phase 10 (d): {len(orders):,} simulated orders ({gen['pumps']} "
          f"pumps of a {sizes['sim_lanes']:,} x {sizes['sim_t']:,} grid, "
          f"sim-side books cap 64 K 8) "
          f"through the consumer at depth 0 in frames of {sizes['batch']}: "
          f"{n_events} events equal to the oracle, seqs 0..n-1, books "
          f"verified; bin_columns equal to grid_to_columns on pump 0")
    for line in gen["kept_lines"] + [c_line]:
        print(line)
    stats_lines = sim_stats_check(device, sizes["sim_lanes"], sizes["sim_t"])
    for line in stats_lines:
        print(line)
    seconds = time.perf_counter() - t_phase

    for tag, lanes, r in (("b", sizes["sim_i_lanes"], run_i), ("b", 64, small),
                          ("c", sizes["sim_lanes"], run_ii)):
        print(f"phase 10 ({tag}) [{card}]: rollout at {lanes} lanes: "
              f"{r['steps'] / r['secs']:,.1f} steps/s, "
              f"{r['events'] / r['secs']:,.0f} events/s "
              f"({r['steps']} steps in {r['secs']:.3f} s; "
              f"{r['events'] / r['steps']:.3f} events and "
              f"{r['trades'] / r['steps']:.3f} trades per step); K1 "
              f"{r['launches'][0]}, K5 {r['launches'][1]} launches")
    print(f"phase 10 (c) [{card}]: one step at {sizes['sim_lanes']:,} lanes "
          f"(mean of 100): "
          f"{1e3 * split_s / 100:.3f} ms: {split}")
    dev = gen["device_s"]
    print(f"phase 10 (d) [{card}]: generator {len(orders) / gen['secs']:,.0f} "
          f"orders/s ({gen['pumps']} pumps in {gen['secs']:.3f} s, "
          f"{len(orders) / gen['pumps']:.1f} orders a pump); device: "
          + ", ".join(f"{p} {v:.4f} s" for p, v in dev.items())
          + f"; fetch (bin_columns, waits for the pump) {gen['fetch_s']:.4f} "
          f"s; K1 {gen['launches'][0]}, K5 {gen['launches'][1]} launches; "
          f"peak device memory {gen['peak_gb']:.2f} GB (with the kept "
          f"inputs of every {sizes['sim_pump_keep']}th pump); consumer "
          f"{len(orders) / c_secs:,.0f} orders/s ({c_secs:.3f} s, "
          f"{c_launches} K1 launches)")
    print(f"phase 10 [{card}]: in all {seconds:.1f} s")
    head = k5[scan_t[0]]
    runs = (run_i, small, run_ii, gen)
    return dict(
        k5=k5, seconds=seconds,
        worst=max([r["worst"] for r in runs] + [c_worst]),
        hawkes_row=dict(
            max_abs_err=max([scan_worst] + [r["scan_worst"] for r in runs]),
            ms=head["ms"], device_ms=head["device_ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], chain_bound_ms=head["chain_bound_ms"],
            cycles_per_bin=head["cycles_per_bin"],
            launches=run_i["launches"][1],
            per_t={str(t): r for t, r in k5.items()},
            sim_path_launches=dict(
                rollout_256=run_i["launches"][1],
                rollout_64=small["launches"][1],
                rollout_10240=run_ii["launches"][1],
                traffic=gen["launches"][1])),
        k1_launches=dict(
            rollout_256=run_i["launches"][0], rollout_64=small["launches"][0],
            rollout_10240=run_ii["launches"][0],
            traffic_pumps=gen["launches"][0], traffic_consumer=c_launches))


# -- phase 11 ----------------------------------------------------------------

MESH_SIZES = (1, 2, 4)


@contextlib.contextmanager
def plain_k1():
    """K1's wrapper replaced by its plain version for the block: the
    sharded steps look match_step.batch_step up at every call, so inside
    it they run the plain version on the same blocks."""
    from gome_tpu_torch.ops import match_step

    inner = match_step.batch_step
    match_step.batch_step = match_step.batch_step_reference
    try:
        yield
    finally:
        match_step.batch_step = inner


def one_card_mesh(device, d: int):
    """d shards, every block on `device` (one card)."""
    from gome_tpu_torch.parallel import make_mesh

    return make_mesh(d, devices=[device] * d)


def launches_of(fn):
    """fn() and the K1 launches it made (the count set to 0 just
    before)."""
    from gome_tpu_torch.ops import match_step

    match_step._counted.launches = 0
    out = fn()
    return out, match_step._counted.launches


def sharded_steps_check(device, sizes, timing, zipf):
    """Phase 11 (a): sharded_batch_step on phase 2's grid (a) and
    sharded_dense_step on a dense grid of the Zipf flow (the first quarter
    of the 6th frame packed on books the first five frames built), each
    at D = 1, 2, 4 on
    cuda:0 blocks: new books and every StepOutput leaf equal to the
    unsharded K1 call and to the same sharded step with K1's plain
    version. Returns (worst |error|, report lines, the K1 launches of
    each call as {step: {"D=<d>": n}})."""
    from gome_tpu_torch.engine import BookConfig, DeviceOp
    from gome_tpu_torch.engine.batch import BatchEngine
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.parallel import (shard_batch, sharded_batch_step,
                                         sharded_dense_step)
    from gome_tpu_torch.parallel.mesh import localize_ids

    worst, lines = 0, []
    counts = {"sharded_batch_step": {}, "sharded_dense_step": {}}
    home = one_card_mesh(device, 1).home
    config, books, ops = timing["a"]
    ref_books, ref_outs = batch_step(config, books, ops)
    per_d = []
    for d in MESH_SIZES:
        mesh = one_card_mesh(device, d)
        sb, so = shard_batch(mesh, books), shard_batch(mesh, ops)
        step = sharded_batch_step(config, mesh)
        (kb, ko), n = launches_of(lambda: step(sb, so))
        with plain_k1():
            pb, po = step(sb, so)
        sync(device)
        kb, ko = kb.gather(), ko.gather()
        err = max(max_abs_err(kb, ref_books), max_abs_err(ko, ref_outs),
                  max_abs_err(kb, pb.gather()), max_abs_err(ko, po.gather()))
        if err or n != d:
            raise SystemExit(f"phase 11 (a) full grid D={d}: max |err| "
                             f"{err}, {n} K1 launches")
        worst = max(worst, err)
        counts["sharded_batch_step"][f"D={d}"] = n
        per_d.append(f"D={d} {n} launch{'es' if n > 1 else ''} of "
                     f"{sb.block_rows}x{ops.action.shape[1]}")
    s, t = ops.action.shape
    lines.append(f"phase 11 (a): sharded_batch_step on grid (a) ({s}x{t}, "
                 f"cap {config.cap}, K {config.max_fills}, int32) on {home} "
                 f"blocks: books and every StepOutput leaf equal to the "
                 f"unsharded K1 call and to the plain version per shard; "
                 f"per-shard K1 launches: " + ", ".join(per_d))

    cfg = BookConfig(cap=256, max_fills=16, dtype=torch.int32)
    batch = sizes["batch"]
    base = BatchEngine(cfg, n_slots=sizes["symbols"], max_t=32,
                       device=device)
    base.process_columnar(list(zipf[:5 * batch]))
    state = base.export_state()
    pending = list(enumerate(zipf[5 * batch:5 * batch + batch // 4]))
    per_d = []
    for d in MESH_SIZES:
        eng = BatchEngine(cfg, n_slots=sizes["symbols"], max_t=32,
                          mesh=one_card_mesh(device, d))
        eng.import_state(state)
        grid, meta, _, lane_ids = eng._pack_grid_vectorized(pending)
        if lane_ids is None:
            raise SystemExit(f"phase 11 (a) D={d}: the frame packed a full "
                             "grid")
        mesh, n_slots = eng.mesh, eng.n_slots
        step_cfg = dataclasses.replace(
            eng.config, max_fills=min(eng.config.max_fills, eng.config.cap))
        ids = localize_ids(lane_ids, n_slots, mesh)
        so = shard_batch(mesh, grid)
        step = sharded_dense_step(step_cfg, mesh)
        (kb, ko), n = launches_of(lambda: step(eng.books, ids, so))
        with plain_k1():
            pb, po = step(eng.books, ids, so)
        # The unsharded K1 call on the same rows, live rows first.
        perm = np.argsort(lane_ids >= n_slots, kind="stable")
        u = BatchEngine(cfg, n_slots=n_slots, max_t=32, device=device)
        u.import_state(state)
        ub, uo = u._step(u.books, u._upload_tree(DeviceOp(
            *(a[perm] for a in grid))), lane_ids[perm])
        sync(device)
        kb, ko = kb.gather(), ko.gather()
        at = torch.from_numpy(perm).to(device)
        ko_perm = type(ko)(*(a[at] for a in ko))
        err = max(max_abs_err(kb, ub), max_abs_err(ko_perm, uo),
                  max_abs_err(kb, pb.gather()), max_abs_err(ko, po.gather()))
        if err or n != d:
            raise SystemExit(f"phase 11 (a) dense grid D={d}: max |err| "
                             f"{err}, {n} K1 launches")
        worst = max(worst, err)
        counts["sharded_dense_step"][f"D={d}"] = n
        live = np.bincount(lane_ids[lane_ids < n_slots] // (n_slots // d),
                           minlength=d)
        per_d.append(f"D={d} {n} launch{'es' if n > 1 else ''} of "
                     f"{so.block_rows}x{grid.action.shape[1]} (live rows "
                     f"{'/'.join(map(str, live))})")
        del eng, u
    lines.append(f"phase 11 (a): sharded_dense_step on the Zipf flow "
                 f"({len(pending)} orders after {5 * batch}, "
                 f"{len(meta['arrival'])} "
                 f"packed, cap {state['cap']}) on {home} blocks: books and "
                 f"every StepOutput leaf equal to the unsharded K1 call on "
                 f"the same rows and to the plain version per shard; "
                 f"per-shard K1 launches: " + ", ".join(per_d))
    return worst, lines, counts


@contextlib.contextmanager
def gather_timer(engine):
    """CUDA events around every Sharded.gather the engine's mesh makes in
    the block (the per-grid StepOutput join onto the home device and the
    count join of the fetch), recorded on the home device's stream.
    Yields the list of (start, end) pairs."""
    from gome_tpu_torch.parallel import Sharded

    home = engine.batch.mesh.home
    inner = Sharded.gather
    spans = []

    def gather(self, device=None):
        stream = torch.cuda.current_stream(home)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        out = inner(self, device)
        b.record(stream)
        spans.append((a, b))
        return out

    Sharded.gather = gather
    try:
        yield spans
    finally:
        Sharded.gather = inner


def mesh_frame_run(label, device, sizes, frame_list, want, mesh) -> dict:
    """Phase 11 (b), one run: the flow through MatchEngine.process_frame
    (fast) on `mesh`, every submit_frame checked for host syncs, K1 held
    against its plain version at the inputs the run gave it, then
    shard_execution_report on the run's largest dense grid."""
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.parallel import shard_execution_report

    eng = MatchEngine(BookConfig(cap=256, max_fills=16, dtype=torch.int32),
                      n_slots=sizes["symbols"], max_t=32, mesh=mesh)
    host = require_host(eng, label)
    batch = eng.batch
    inner = batch._step
    widest = {}

    def step(books, ops, lane_ids=None, cap_g=None):
        if lane_ids is not None and len(lane_ids) > widest.get("rows", 0):
            cap = batch.config.cap if cap_g is None else cap_g
            widest.update(rows=len(lane_ids), args=(dataclasses.replace(
                batch.config, cap=cap,
                max_fills=min(batch.config.max_fills, cap)),
                books, lane_ids, ops))
        return inner(books, ops, lane_ids, cap_g)

    batch._step = step
    batch_step.launches = 0
    try:
        with keep_kernel_inputs() as kept, gather_timer(eng) as spans, \
                no_host_sync() as checked:
            got, secs = run_frames(eng, frame_list)
        launches = batch_step.launches
    finally:
        del batch._step
    gather_s = span_seconds(spans)
    worst, kept_line = check_kept_inputs(label, kept)
    check_events(label, got, want)
    batch.verify_books()
    if launches <= 0 or launches != expected_launches(eng):
        raise SystemExit(f"{label}: {launches} K1 launches, "
                         f"{expected_launches(eng)} expected from "
                         f"{eng.stats.device_calls} device calls")
    if checked[0] != len(frame_list):
        raise SystemExit(f"{label}: {checked[0]} submit_frame calls checked "
                         f"for {len(frame_list)} frames")
    if "args" not in widest:
        raise SystemExit(f"{label}: no dense grid ran")
    cfg, books, lane_ids, ops = widest["args"]
    report = shard_execution_report(cfg, mesh, books, lane_ids, ops,
                                    repeats=5)
    return dict(engine=eng, host=host, secs=secs, launches=launches,
                worst=worst, kept_line=kept_line, report=report,
                gather_s=gather_s, gathers=len(spans), checked=checked[0],
                grid_cap=cfg.cap)


def report_text(rep) -> str:
    shards = "; ".join(
        f"shard {s['shard']} ({s['device']}) {s['live_lanes']} live lanes "
        f"{s['exec_ms']:.4f} ms" for s in rep["shards"])
    return (f"{rep['n_shards']} shards x {rep['rows_per_shard']} rows "
            f"({rep['live_lanes']} live lanes): {shards}; exec_ms max "
            f"{rep['exec_ms_max']:.4f}, mean {rep['exec_ms_mean']:.4f}; "
            f"live skew {rep['live_skew']:.4f}, rows per live lane "
            f"{rep['rows_per_live_lane']:.4f}")


def same_states(label, a: dict, b: dict, widths: bool = True) -> str:
    """Two export_state dicts equal: every book leaf and every other key.
    With widths=False the storage caps may differ (an engine whose grids
    differ can escalate its storage to another power of two): the
    narrower stack's slot axis is then zero-padded to the wider one's —
    active slots are a prefix and the tail is zero, so equal books are
    equal leaf by leaf either way. Returns a note of the caps."""
    if set(a) != set(b):
        raise SystemExit(f"{label}: state keys differ")
    cap = max(a["cap"], b["cap"])
    for name, x in a["books"].items():
        y = b["books"][name]
        if not widths and x.ndim == 3:
            pad = lambda v: np.pad(v, [(0, 0), (0, 0),
                                       (0, cap - v.shape[-1])])
            x, y = pad(x), pad(y)
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(
                x, y):
            raise SystemExit(f"{label}: book leaf {name} differs")
    for k in a:
        if k != "books" and a[k] != b[k] and (widths or k != "cap"):
            raise SystemExit(f"{label}: {k} differs")
    return (f"storage cap {a['cap']}" if a["cap"] == b["cap"] else
            f"storage caps {a['cap']} and {b['cap']}, compared at {cap}")


def sharded_engine_check(device, sizes, zipf) -> dict:
    """Phase 11 (c): ShardedEngine, 4 shards (shard i on card
    i % device_count), the flow's first 20,000 orders through process in
    batches of 2,000: events equal to the oracle, K1 held against its plain
    version at the inputs the run gave it on each card."""
    from gome_tpu_torch.engine import BookConfig
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.parallel import ShardedEngine

    orders = list(zipf[:20_000])
    se = ShardedEngine(4, config=BookConfig(cap=256, max_fills=16,
                                            dtype=torch.int32),
                       n_slots=sizes["symbols"] // 4, max_t=32)
    for o in orders:
        se.mark(o)
    batch_step.launches = 0
    got = []
    with keep_kernel_inputs() as kept:
        t0 = time.perf_counter()
        for i in range(0, len(orders), 2000):
            got += se.process(orders[i:i + 2000])
        secs = time.perf_counter() - t0
        launches = batch_step.launches
    worst, kept_line = check_kept_inputs("phase 11 (c)", kept)
    check_events("phase 11 (c)", got, oracle_events(orders))
    want = sum(expected_launches(s) for s in se.shards)
    if launches <= 0 or launches != want:
        raise SystemExit(f"phase 11 (c): {launches} K1 launches for {want}")
    for s in se.shards:
        s.batch.verify_books()
    devices = sorted({str(s.batch.device) for s in se.shards})
    return dict(launches=launches, worst=worst, lines=[
        f"phase 11 (c): ShardedEngine(4) on {', '.join(devices)}: "
        f"{len(orders)} orders -> {len(got)} events equal to the oracle "
        f"({len(orders) / secs:,.0f} orders/s, batches of 2,000, object "
        f"path); {launches} K1 launches; books verified", kept_line])


def restores_check(device, sizes, zipf, want_zipf, engine) -> dict:
    """Phase 11 (e): a snapshot (SnapshotStore, snap-<n>/) of (b)'s D=4
    engine restored into D=4, D=2, D=1 meshes of cuda:0 blocks and a
    non-mesh engine: books equal leaf by leaf, and 10,000 more orders give
    the oracle's events on each. Then restore_from_redis of a small int64
    engine into meshes of 4 and 3 shards: n_slots rounded to the mesh
    size, resting orders equal, 1,000 more orders equal to the oracle. On
    every engine K1 is held against its plain version at the inputs the
    run gave it."""
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.persist import DictRedis, restore_from_redis
    from gome_tpu_torch.persist.redis_schema import book_redis_commands
    from gome_tpu_torch.persist.snapshot import SnapshotStore
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    label = "phase 11 (e)"
    state = engine.batch.export_state()
    with tempfile.TemporaryDirectory(prefix="phase11e-") as work:
        store = SnapshotStore(work)
        t0 = time.perf_counter()
        store.save({k: v for k, v in state.items() if k != "books"},
                   state["books"])
        save_s = time.perf_counter() - t0
        manifest, books = store.load_latest()
    more = continuation(sizes, 10_000)
    frames = [frame_columns(more[i:i + sizes["batch"]])
              for i in range(0, len(more), sizes["batch"])]
    want = oracle_events(list(zipf) + more)[len(want_zipf):]
    cfg = BookConfig(cap=256, max_fills=16, dtype=torch.int32)
    rows, launches, worst, kept_lines = [], 0, 0, []
    for d in (4, 2, 1, None):
        e = MatchEngine(cfg, n_slots=sizes["symbols"], max_t=32,
                        device=None if d else device,
                        mesh=one_card_mesh(device, d) if d else None)
        t0 = time.perf_counter()
        e.batch.import_state({**manifest, "books": books})
        sync(device)
        restore_s = time.perf_counter() - t0
        same_states(f"{label} D={d}", e.batch.export_state(), state)
        batch_step.launches = 0
        with keep_kernel_inputs() as kept:
            got, _ = run_frames(e, frames)
        if batch_step.launches != expected_launches(e):
            raise SystemExit(f"{label} D={d}: {batch_step.launches} K1 "
                             f"launches, {expected_launches(e)} expected")
        launches += batch_step.launches
        err, line = check_kept_inputs(
            f"{label} {'D=%d' % d if d else 'no mesh'}", kept)
        worst, kept_lines = max(worst, err), kept_lines + [line]
        del kept
        check_events(f"{label} D={d}", got, want)
        e.batch.verify_books()
        rows.append((d, restore_s, len(got)))
        del e
    torch.cuda.empty_cache()

    small = multi_symbol_stream(n=2000, n_symbols=5, zipf_a=1.2,
                                cancel_prob=0.3, seed=23)
    extra = [dataclasses.replace(o, oid="e" + o.oid) for o in
             multi_symbol_stream(n=1000, n_symbols=5, zipf_a=1.2,
                                 cancel_prob=0.3, seed=29)]
    big = BookConfig(cap=256, max_fills=16, dtype=torch.int64)
    src = MatchEngine(big, n_slots=8, max_t=32, device=device)
    run_engine(src, small, 500, columnar=True)
    redis = DictRedis()
    for cmd in book_redis_commands(src):
        redis.execute_command(*cmd)
    want_extra = oracle_events(small + extra)[len(oracle_events(small)):]
    redis_rows = []
    for d, n_slots in ((4, 4), (3, 3)):
        dst = MatchEngine(big, n_slots=n_slots, max_t=32, max_slots=d * 4096,
                          mesh=one_card_mesh(device, d))
        n = restore_from_redis(dst, redis)
        if dst.batch.n_slots % d or dst.batch.n_slots < 5:
            raise SystemExit(f"{label}: restore_from_redis into {d} shards "
                             f"left n_slots {dst.batch.n_slots}")
        if same_resting_orders(f"{label} redis D={d}", src, dst) != n:
            raise SystemExit(f"{label}: {n} orders imported")
        with keep_kernel_inputs() as kept:
            got, _ = run_engine(dst, extra, 500, columnar=True)
        err, line = check_kept_inputs(f"{label} redis D={d}", kept)
        worst, kept_lines = max(worst, err), kept_lines + [line]
        check_events(f"{label} redis D={d}", got, want_extra)
        dst.batch.verify_books()
        redis_rows.append((d, n_slots, dst.batch.n_slots, n))
    return dict(save_s=save_s, rows=rows, launches=launches,
                redis=redis_rows, events=len(want), worst=worst,
                kept_lines=kept_lines)


def phase11(card: str, device, sizes, zipf, want_zipf, timing, p5_rate,
            flow8, p8c) -> dict:
    """Phase 11, the mesh (gome_tpu_torch.parallel): (a) the sharded steps,
    (b) the frame path on a D=4 mesh of cuda:0 blocks (and on distinct
    cards where there are two or more), (c) ShardedEngine, (d) the service
    with engine.mesh_devices = the card count, (e) restores. Returns the
    numbers; each part prints as it ends."""
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    worst, lines, step_counts = sharded_steps_check(device, sizes, timing,
                                                    zipf)
    for line in lines:
        print(line)
    torch.cuda.empty_cache()

    frame_list = [frame_columns(zipf[i:i + sizes["batch"]])
                  for i in range(0, len(zipf), sizes["batch"])]
    single = MatchEngine(BookConfig(cap=256, max_fills=16, dtype=torch.int32),
                         n_slots=sizes["symbols"], max_t=32, device=device)
    got, single_s = run_frames(single, frame_list)
    check_events("phase 11 (b) unsharded", got, want_zipf)
    single_state = single.batch.export_state()
    del single
    runs = {}
    mesh4 = one_card_mesh(device, 4)
    meshes = [(f"D=4 on {mesh4.home}", mesh4)]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        meshes.append((f"D={min(4, n_cards)} on {min(4, n_cards)} cards",
                       make_mesh(min(4, n_cards))))
    for name, mesh in meshes:
        label = f"phase 11 (b) {name}"
        r = mesh_frame_run(label, device, sizes, frame_list, want_zipf, mesh)
        caps = same_states(label, r["engine"].batch.export_state(),
                           single_state, widths=False)
        worst = max(worst, r["worst"])
        runs[name] = r
        st = r["engine"].stats
        print(f"{label}: {r['host']}: process_frame(fast) {len(zipf)} orders "
              f"in {len(frame_list)} frames -> {len(want_zipf)} events equal "
              f"to the oracle (and to phase 5's); books verified, "
              f"export_state equal to the unsharded engine's leaf by leaf "
              f"({caps}); "
              f"{st.device_calls} device calls, {r['launches']} K1 launches "
              f"(one per shard per grid); {st.frame_fallbacks} frame "
              f"fallbacks; no host sync in {r['checked']} submit_frame calls")
        print(r["kept_line"])
        print(f"phase 11 (b) [{card}] {name}: {len(zipf) / r['secs']:,.0f} "
              f"orders/s ({r['secs']:.3f} s); the unsharded engine in this "
              f"phase {len(zipf) / single_s:,.0f} orders/s, phase 5 "
              f"{p5_rate:,.0f}; output gathers onto {mesh.home} "
              f"{r['gather_s']:.4f} s of CUDA-event span over {r['gathers']} "
              f"gathers ("
              + ("a device-local torch.cat, no peer copy"
                 if len(set(mesh.devices)) == 1 else
                 "peer copies from the other cards, then torch.cat")
              + f"); shard_execution_report on the widest dense grid (cap "
              f"{r['grid_cap']}, best of 5): {report_text(r['report'])}")
    d4 = runs[meshes[0][0]]["engine"]
    d4_digest = book_digest(d4)  # phase 15 (b) holds its ranks to it
    for name in list(runs)[1:]:
        del runs[name]["engine"]
    torch.cuda.empty_cache()

    c = sharded_engine_check(device, sizes, zipf)
    for line in c["lines"]:
        print(line)
    worst = max(worst, c["worst"])

    requests, tail, want = flow8
    with keep_kernel_inputs() as kept:
        svc = service_run(sizes, 0, requests, tail, want, len(zipf),
                          batch_step, subscribe=False, mesh_devices=n_cards)
    d_worst, d_line = check_kept_inputs("phase 11 (d)", kept)
    worst = max(worst, d_worst)
    del kept
    if svc["bodies"] != p8c["bodies"]:
        raise SystemExit("phase 11 (d): match-queue bodies differ from "
                         "phase 8 (c)'s")
    rate, rate8 = len(zipf) / svc["secs"], len(zipf) / p8c["secs"]
    print(f"phase 11 (d): {svc['host']}: EngineService with "
          f"engine.mesh_devices={n_cards} (int64, depth 0, json match wire, "
          f"no subscriber): {len(svc['bodies'])} match-queue bodies "
          f"byte-equal to phase 8 (c)'s; {svc['launches']} K1 launches; "
          f"load_client (concurrency 8, batch_n 1024) {svc['load']['ok']} "
          f"of {svc['load']['sent']} ok")
    print(d_line)
    print(f"phase 11 (d) [{card}]: {rate:,.0f} orders/s over the wire "
          f"({svc['secs']:.3f} s), phase 8 (c) {rate8:,.0f} in this run "
          f"(ratio {rate / rate8:.3f})")
    svc_launches = svc["launches"]
    del svc
    e = restores_check(device, sizes, zipf, want_zipf, d4)
    print(f"phase 11 (e): snapshot of (b)'s D=4 engine "
          f"({e['save_s']:.3f} s to save) restored into "
          + ", ".join(f"{'D=%d' % d if d else 'no mesh'} "
                      f"({s:.3f} s)" for d, s, _ in e["rows"])
          + f": books equal leaf by leaf; 10,000 more orders -> "
          f"{e['events']} events equal to the oracle on each "
          f"({e['launches']} K1 launches); restore_from_redis into "
          + ", ".join(f"{d} shards of n_slots {n0} -> {n1} ({n} resting "
                      f"orders)" for d, n0, n1, n in e["redis"])
          + "; 1,000 more orders equal to the oracle on each")
    for line in e["kept_lines"]:
        print(line)
    worst = max(worst, e["worst"])
    secs = time.perf_counter() - t_phase
    print(f"phase 11 [{card}]: the mesh in {secs:.1f} s")
    return dict(worst=worst, runs=runs, step_counts=step_counts,
                c_launches=c["launches"], svc_launches=svc_launches, e=e,
                seconds=secs, d4_name=meshes[0][0], d4_digest=d4_digest)


# -- phase 12 ----------------------------------------------------------------

FAULT_ORDERS = 20_000  # (c): the flow's first orders, under broker faults
FAULT_FRAME_N = 512  # (c)'s ORDER frames: ~40 publishes a queue
FAULT_EVERY = 9  # (c): every connection dies at its 9th publish
AMQP_WAIT_S = 300  # (b): the whole three-process run


def fast_policy():
    """(c)'s reconnect schedule: real reconnects, no visible latency."""
    from gome_tpu_torch.utils.resilience import BackoffPolicy

    return BackoffPolicy(base_s=0.005, max_s=0.05, max_retries=60,
                         budget_s=30)


def race_orders():
    """tests/test_multiprocess.py's scripted race, on the flow's first
    symbol (a new one would grow the lanes): the gateway accepted
    (marked) this ADD, but a DeleteOrder of it reached doOrder first.
    Returns (add, delete)."""
    from gome_tpu_torch.types import Action, Order, Side

    add = Order(uuid="u9", oid="race", symbol="sym0", side=Side.BUY,
                price=3_000_000, volume=7)
    return add, dataclasses.replace(add, volume=0, action=Action.DEL)


def raced_oracle(orders):
    """The oracle under the race's interleaving: the ADD marked, the DEL
    and then the ADD queued ahead of the flow. Returns (events, stats)."""
    from gome_tpu_torch.oracle import OracleEngine

    add, delete = race_orders()
    oracle = OracleEngine()
    oracle.pre_pool.add((add.symbol, add.uuid, add.oid))
    oracle.queue.append(delete)
    oracle.queue.append(add)
    for o in orders:
        oracle.submit(o)
    return oracle.drain(), oracle.stats


def amqp_gateway(args) -> dict:
    """Phase 12 (b)'s gateway process: args.orders of phase 3's Zipf flow
    (multi_symbol_stream, seed 7) as ORDER frames,
    each through gateway_step (encode, mark_frame into a RespPrePool on
    the marker server, publish to doOrder over AMQP), with the race's DEL
    and marked ADD published first as JSON documents."""
    from gome_tpu_torch.bus import encode_order
    from gome_tpu_torch.bus.amqp import AmqpQueue
    from gome_tpu_torch.engine.prepool import RespPrePool
    from gome_tpu_torch.persist.resp import RespClient
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    orders = multi_symbol_stream(n=args.orders, n_symbols=args.symbols,
                                 zipf_a=1.2, cancel_prob=0.3, seed=7)
    frame_list = [frame_columns(orders[i:i + args.frame_n])
                  for i in range(0, len(orders), args.frame_n)]
    pool = RespPrePool(RespClient(port=args.resp_port))
    queue = AmqpQueue("doOrder", port=args.broker_port)
    add, delete = race_orders()
    pool.add((add.symbol, add.uuid, add.oid))
    with timed_calls(((pool, "mark_frame", "mark_frame"),
                      (queue, "publish", "publish"))) as split:
        t0 = time.time()
        queue.publish(encode_order(delete))
        queue.publish(encode_order(add))
        for cols in frame_list:
            gateway_step(pool, queue, cols)
        t1 = time.time()
    queue.close()
    return dict(first_unix=t0, last_unix=t1, orders=len(orders),
                messages=2 + len(frame_list), split=split)


def amqp_consumer(args) -> dict:
    """Phase 12 (b)'s consumer process: a MatchEngine on args.device whose
    pre-pool is a RespPrePool on the marker server (it never marks), an
    OrderConsumer at depth 2 on the frame wire over two AmqpQueues, run
    until args.messages are committed; K1's launches counted and K1 held
    against its plain version at the inputs the run gave it; on the card
    every submit_frame under no_host_sync()."""
    from gome_tpu_torch.bus import QueueBus
    from gome_tpu_torch.bus.amqp import AmqpQueue
    from gome_tpu_torch.engine.prepool import RespPrePool
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.persist.resp import RespClient

    device = torch.device(args.device)
    bus = QueueBus(AmqpQueue("doOrder", port=args.broker_port),
                   AmqpQueue("matchOrder", port=args.broker_port))
    eng, bus, consumer = consumer_stack(device, args.symbols, 2,
                                        batch_wait_s=0.002, bus=bus)
    host = require_host(eng, "phase 12 (b) consumer")
    eng.pre_pool = RespPrePool(RespClient(port=args.resp_port))
    q = bus.order_queue
    q.end_offset()  # consume from here on: the gateway publishes next
    print("READY", flush=True)
    guard = (no_host_sync() if device.type == "cuda"
             else contextlib.nullcontext([0]))
    t_first = None
    deadline = time.monotonic() + AMQP_WAIT_S
    batch_step.launches = 0
    with keep_kernel_inputs() as kept, guard as checked, \
            host_split(eng) as split:
        while q.committed() < args.messages:
            if time.monotonic() > deadline:
                raise SystemExit(f"phase 12 (b) consumer: {q.committed()} "
                                 f"of {args.messages} messages in "
                                 f"{AMQP_WAIT_S} s")
            if t_first is None and q.end_offset():
                t_first = time.time()
            consumer.run_once()
        t_last = time.time()
        launches = batch_step.launches
    worst, kept_line = check_kept_inputs("phase 12 (b) consumer", kept)
    eng.batch.verify_books()
    bus.order_queue.close()
    bus.match_queue.close()
    split = {k: v for k, v in split.items() if k != "gateway"}
    return dict(first_unix=t_first, last_unix=t_last, launches=launches,
                split=split, expected=expected_launches(eng),
                orders=eng.stats.orders,
                dropped=eng.stats.dropped_no_prepool, kernel_worst=worst,
                kept_line=kept_line, checked=checked[0], host=host,
                fallbacks=eng.stats.frame_fallbacks)


def amqp_worker(argv) -> int:
    """`python3 chip_smoke.py --amqp-consumer|--amqp-gateway ...`: one
    process of phase 12 (b)'s split topology; writes its result JSON."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    for name in ("--broker-port", "--resp-port", "--symbols", "--orders",
                 "--frame-n", "--messages"):
        ap.add_argument(name, type=int, default=0)
    args = ap.parse_args(argv[1:])
    run = amqp_consumer if argv[0] == "--amqp-consumer" else amqp_gateway
    result = run(args)
    with open(args.out, "w") as f:
        json.dump(result, f, sort_keys=True)
    return 0


def split_topology(work: str, device: str = "cuda", n_orders: int = 200_000,
                   n_symbols: int = 10240, frame_n: int = 8192,
                   timeout_s: float = AMQP_WAIT_S) -> dict:
    """Phase 12 (b): the reference's three processes and the broker. This
    process holds the port's FakeBroker and reads matchOrder through a
    port AmqpQueue; `python -m gome_tpu_torch.persist.respserver` is the
    marker store; a consumer process (amqp_consumer) on `device` and then
    a gateway process (amqp_gateway) join them. The events must equal
    the oracle's under the race's interleaving, seqs 0..n-1, both
    counting one dropped ADD; the consumer checks K1 and its books
    itself. Returns the processes' results and the end-to-end times."""
    from gome_tpu_torch.bus.amqp import AmqpQueue
    from gome_tpu_torch.bus.colwire import decode_event_frame
    from gome_tpu_torch.bus.fakebroker import FakeBroker
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    here = os.path.dirname(os.path.abspath(__file__))
    orders = multi_symbol_stream(n=n_orders, n_symbols=n_symbols, zipf_a=1.2,
                                 cancel_prob=0.3, seed=7)
    want, oracle_stats = raced_oracle(orders)
    n_messages = 2 + -(-n_orders // frame_n)
    broker = FakeBroker().start()
    procs, errs = [], {}
    try:
        srv = subprocess.Popen(
            [sys.executable, "-m", "gome_tpu_torch.persist.respserver",
             "--port", "0"], stdout=subprocess.PIPE, text=True, cwd=here)
        procs.append(srv)
        ready = srv.stdout.readline().split()
        if not ready or ready[0] != "READY":
            raise SystemExit(f"phase 12 (b): marker server said {ready}")
        common = ["--broker-port", str(broker.port), "--resp-port", ready[1],
                  "--symbols", str(n_symbols)]
        reader = AmqpQueue("matchOrder", port=broker.port)
        reader.end_offset()  # this process consumes matchOrder
        outs = {r: os.path.join(work, f"amqp-{r}.json")
                for r in ("consumer", "gateway")}
        t_launch = time.time()
        errs = {r: open(p + ".err", "w+") for r, p in outs.items()}
        consumer = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--amqp-consumer",
             "--out", outs["consumer"], "--device", device,
             "--messages", str(n_messages), *common],
            stdout=subprocess.PIPE, stderr=errs["consumer"], text=True,
            cwd=here)
        procs.append(consumer)
        line = consumer.stdout.readline().strip()
        if line != "READY":
            consumer.wait(30)
            raise SystemExit(f"phase 12 (b): consumer said {line!r}: "
                             f"{tail_of(errs['consumer'])}")
        consumer_boot = time.time() - t_launch
        gateway = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--amqp-gateway",
             "--out", outs["gateway"], "--orders", str(n_orders),
             "--frame-n", str(frame_n), *common],
            stdout=subprocess.DEVNULL, stderr=errs["gateway"], text=True,
            cwd=here)
        procs.append(gateway)
        events, t_done = [], None
        deadline = time.monotonic() + timeout_s
        while len(events) < len(want):
            if time.monotonic() > deadline:
                raise SystemExit(f"phase 12 (b): {len(events)} of "
                                 f"{len(want)} events in {timeout_s} s")
            for name, p in (("consumer", consumer), ("gateway", gateway)):
                if p.poll() not in (None, 0):
                    raise SystemExit(f"phase 12 (b): the {name} exited "
                                     f"{p.returncode}: "
                                     f"{tail_of(errs[name])}")
            msgs = reader.poll_batch(64, 0.05)
            for m in msgs:
                events.extend(decode_event_frame(m.body).to_results())
            if msgs:
                reader.commit(msgs[-1].offset + 1)
        t_done = time.time()
        for name, p in (("consumer", consumer), ("gateway", gateway)):
            if p.wait(timeout_s) != 0:
                raise SystemExit(f"phase 12 (b): the {name} exited "
                                 f"{p.returncode}: {tail_of(errs[name])}")
        reader.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for f in errs.values():
            f.close()
        broker.stop()
    res = {}
    for role, path in outs.items():
        with open(path) as f:
            res[role] = json.load(f)
    c, g = res["consumer"], res["gateway"]
    check_events("phase 12 (b) split topology", unstamped(events), want)
    if [e.seq for e in events] != list(range(len(want))):
        raise SystemExit(f"phase 12 (b): seqs not 0..{len(want) - 1}")
    if (c["dropped"], oracle_stats.dropped_no_prepool) != (1, 1):
        raise SystemExit(f"phase 12 (b): dropped_no_prepool consumer "
                         f"{c['dropped']}, oracle "
                         f"{oracle_stats.dropped_no_prepool}, expected 1")
    if device == "cuda" and (c["launches"] <= 0
                             or c["launches"] != c["expected"]):
        raise SystemExit(f"phase 12 (b): the consumer launched K1 "
                         f"{c['launches']} times for {c['expected']} "
                         "expected from its device calls")
    return dict(consumer=c, gateway=g, events=len(events), t_done=t_done,
                consumer_boot=consumer_boot, messages=n_messages,
                orders=n_orders)


def broker_fault_check(device, symbols: int, orders,
                       frame_n: int = FAULT_FRAME_N) -> dict:
    """Phase 12 (c), tests/test_reconnect.py's drill at the engine's width:
    `orders` as ORDER frames through a depth-0 consumer (batch_n 1, frame
    wire), first on memory queues, then on two SupervisedAmqpQueues of a
    FakeBroker that kills every connection at its FAULT_EVERY-th publish
    (the order feed's and the event publishes), with one kill of the
    consuming connection once half the frames are committed. Every frame
    is published first, then the consumer steps (step_with_policy). The
    match-queue bodies must equal the memory run's byte for byte, and the
    events the oracle's. K1 held against its plain version at the faulted
    run's inputs."""
    from gome_tpu_torch.bus import QueueBus
    from gome_tpu_torch.bus.amqp import SupervisedAmqpQueue
    from gome_tpu_torch.bus.colwire import decode_event_frame
    from gome_tpu_torch.bus.fakebroker import FakeBroker
    from gome_tpu_torch.ops.match_step import batch_step

    frame_list = [frame_columns(orders[i:i + frame_n])
                  for i in range(0, len(orders), frame_n)]

    def run(bus, mid_kill=None):
        eng, bus, consumer = consumer_stack(device, symbols, 0, bus=bus)
        for cols in frame_list:
            gateway_step(eng, bus.order_queue, cols)
        q = bus.order_queue
        deadline = time.monotonic() + 120
        while q.committed() < q.end_offset():
            if time.monotonic() > deadline:
                raise SystemExit(f"phase 12 (c): {q.committed()} of "
                                 f"{q.end_offset()} frames in 120 s")
            consumer.step_with_policy()
            if mid_kill is not None:
                mid_kill(q.committed())
        eng.batch.verify_books()
        mq = bus.match_queue
        return eng, [m.body for m in mq.read_from(0, mq.end_offset())]

    _, plain_bodies = run(None)
    broker = FakeBroker(close_abruptly_on_publish=FAULT_EVERY).start()
    kills = []
    try:
        bus = QueueBus(*(SupervisedAmqpQueue(name, port=broker.port,
                                             policy=fast_policy())
                         for name in ("doOrder", "matchOrder")))

        def mid_kill(committed):
            if committed >= len(frame_list) // 2 and not kills:
                kills.append(broker.kill_connections(consuming="doOrder"))

        t0 = time.perf_counter()
        batch_step.launches = 0
        with keep_kernel_inputs() as kept:
            eng, bodies = run(bus, mid_kill)
            launches = batch_step.launches
        secs = time.perf_counter() - t0
        worst, kept_line = check_kept_inputs("phase 12 (c)", kept)
        connects = {q.name: q.supervisor().snapshot()["connects_total"]
                    for q in (bus.order_queue, bus.match_queue)}
        for q in (bus.order_queue, bus.match_queue):
            q.close()
    finally:
        broker.stop()
    if bodies != plain_bodies:
        raise SystemExit(f"phase 12 (c): {len(bodies)} match-queue bodies "
                         f"under broker faults differ from the memory bus's "
                         f"{len(plain_bodies)}")
    events = [e for b in bodies for e in decode_event_frame(b).to_results()]
    check_events("phase 12 (c)", unstamped(events), oracle_events(orders))
    if kills != [1] or min(connects.values()) < 2:
        raise SystemExit(f"phase 12 (c): kills {kills}, connects {connects}")
    if device.type == "cuda" and (launches <= 0 or
                                  launches != expected_launches(eng)):
        raise SystemExit(f"phase 12 (c): {launches} K1 launches for "
                         f"{expected_launches(eng)} expected")
    return dict(launches=launches, connects=connects, frames=len(frame_list),
                bodies=len(bodies), events=len(events), secs=secs,
                worst=worst, kept_line=kept_line)


def phase12(card: str, device, sizes, zipf, flow8, p8c) -> dict:
    """Phase 12, the RabbitMQ transport: (a) the service booted from a
    rabbitmq: section against the port's FakeBroker, (b) the split
    topology across processes, (c) broker faults. Returns the numbers;
    each part prints as it ends."""
    from gome_tpu_torch.bus.fakebroker import FakeBroker
    from gome_tpu_torch.config import load_config
    from gome_tpu_torch.ops.match_step import batch_step

    t_phase = time.perf_counter()
    requests, tail, _ = flow8
    requests = requests[:AMQP_REQUESTS]
    n_a = sum(len(r.orders) for r in requests)
    n_flow = len(oracle_events(list(zipf[:n_a])))
    want = oracle_events(list(zipf[:n_a]) + tail)
    broker = FakeBroker().start()
    try:
        with tempfile.TemporaryDirectory() as work:
            path = os.path.join(work, "config.yaml")
            with open(path, "w") as f:
                f.write(f"rabbitmq:\n  host: 127.0.0.1\n  port: "
                        f"{broker.port}\n  username: guest\n"
                        f"  password: guest\n")
            bus_cfg = load_config(path).bus
        if bus_cfg.backend != "amqp":
            raise SystemExit(f"phase 12 (a): rabbitmq: loaded as {bus_cfg}")
        with keep_kernel_inputs() as kept:
            svc = service_run(sizes, 0, requests, tail, want, n_a,
                              batch_step, subscribe=False, bus=bus_cfg,
                              load_run=False)
        a_worst, a_line = check_kept_inputs("phase 12 (a)", kept)
        del kept
    finally:
        broker.stop()
    if svc["bodies"][:n_flow] != p8c["bodies"][:n_flow]:
        raise SystemExit("phase 12 (a): matchOrder bodies over AMQP differ "
                         "from phase 8 (c)'s")
    conns = svc["health"]["detail"]["connections"]
    amqp_conns = {k: v for k, v in conns.items() if k.startswith("amqp:")}
    if sorted(amqp_conns) != ["amqp:doOrder", "amqp:matchOrder"] or any(
            v["breaker"] != "closed" for v in amqp_conns.values()):
        raise SystemExit(f"phase 12 (a): /healthz connections {conns}")
    rate, rate8 = n_a / svc["secs"], len(zipf) / p8c["secs"]
    sp = svc["split"]
    print(f"phase 12 (a): {svc['host']}: EngineService from a rabbitmq: "
          f"section (SupervisedAmqpQueue doOrder and matchOrder on the "
          f"port's FakeBroker; int64, depth 0, json match wire, no "
          f"subscriber), the flow's first {n_a:,} orders and the unary "
          f"tail: {len(svc['bodies'])} matchOrder bodies, read back "
          f"through the service's AMQP match queue, the oracle's, the "
          f"flow's {n_flow} byte-equal to phase 8 (c)'s memory-bus "
          f"bodies; /healthz 200 with "
          + ", ".join(f"{k} breaker {v['breaker']} ({v['connects_total']} "
                      f"connects)" for k, v in sorted(amqp_conns.items()))
          + f"; {svc['launches']} K1 launches = device calls")
    print(a_line)
    print(f"phase 12 (a) [{card}]: {rate:,.0f} orders/s over the wire and "
          f"AMQP ({svc['secs']:.3f} s), phase 8 (c) {rate8:,.0f} in this run "
          f"(ratio {rate / rate8:.3f}); consumer thread busy "
          f"{sp['consumer'] - sp['consumer_wait']:.4f} s (+ "
          f"{sp['consumer_wait']:.4f} polling), event publish "
          f"{sp['publish']:.4f} s ({svc['events']} JSON documents, one "
          f"confirmed publish each); feed {sp['feed'] - sp['feed_wait']:.4f} "
          f"s (+ {sp['feed_wait']:.4f} polling); gateway admission "
          f"{sp['gateway']:.4f} s")
    a_launches = svc["launches"]
    del svc
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work:
        b = split_topology(work, "cuda", SPLIT_ORDERS, sizes["symbols"],
                           sizes["batch"])
    c, g = b["consumer"], b["gateway"]
    e2e = b["t_done"] - g["first_unix"]
    print(f"phase 12 (b): the split topology: the port's marker server "
          f"(python -m gome_tpu_torch.persist.respserver), a consumer "
          f"process on the card ({c['host']}; RespPrePool, never marks; "
          f"OrderConsumer depth 2, frame wire, two AmqpQueues; booted in "
          f"{b['consumer_boot']:.1f} s), a gateway process ({g['orders']:,} "
          f"orders over {sizes['symbols']:,} symbols in {g['messages'] - 2} "
          f"ORDER frames of {sizes['batch']:,}, each encode + mark_frame "
          f"into the marker server + publish, after the race's DEL and "
          f"marked ADD) and this process reading matchOrder: {b['events']:,} "
          f"events equal to the oracle's under the race's interleaving, "
          f"seqs 0..{b['events'] - 1}; dropped_no_prepool 1 in the consumer "
          f"and the oracle; {c['launches']} K1 launches = device calls; "
          f"books verified; no host sync in {c['checked']} submit_frame "
          f"calls; {c['fallbacks']} frame fallbacks")
    print(c["kept_line"])
    g_s = g["last_unix"] - g["first_unix"]
    c_s = c["last_unix"] - c["first_unix"]
    print(f"phase 12 (b) [{card}]: gateway {g['orders'] / g_s:,.0f} "
          f"orders/s ({g_s:.3f} s publishing: mark_frame into the marker "
          f"server {g['split']['mark_frame']:.4f} s, AMQP publish "
          f"{g['split']['publish']:.4f} s); consumer "
          f"{c['orders'] / c_s:,.0f} orders/s ({c_s:.3f} s from its first "
          f"message to its last commit; host split: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in c["split"].items())
          + f", other {c_s - sum(c['split'].values()):.4f} s); end to end "
          f"{g['orders'] / e2e:,.0f} orders/s ({e2e:.3f} s from the "
          f"gateway's first publish to the last event read here)")

    fc = broker_fault_check(device, sizes["symbols"], zipf[:FAULT_ORDERS])
    print(f"phase 12 (c): broker faults: the flow's first {FAULT_ORDERS:,} "
          f"orders in {fc['frames']} ORDER frames of {FAULT_FRAME_N} through "
          f"a depth-0 consumer on the card over SupervisedAmqpQueues of a "
          f"FakeBroker(close_abruptly_on_publish={FAULT_EVERY}) plus one "
          f"kill_connections(consuming='doOrder') mid-drain: "
          f"{fc['bodies']} matchOrder bodies byte-equal to the memory bus's, "
          f"{fc['events']:,} events equal to the oracle's; connects_total "
          + ", ".join(f"{k} {v}" for k, v in fc["connects"].items())
          + f"; {fc['launches']} K1 launches = device calls; "
          f"{fc['secs']:.3f} s")
    print(fc["kept_line"])
    secs = time.perf_counter() - t_phase
    print(f"phase 12 [{card}]: the RabbitMQ transport in {secs:.1f} s")
    return dict(worst=max(a_worst, c["kernel_worst"], fc["worst"]),
                launches=dict(service=a_launches,
                              split_topology_consumer=c["launches"],
                              broker_faults=fc["launches"]), seconds=secs)


# -- phase 13 ----------------------------------------------------------------

#: (a)'s armed run: the obs/ surfaces the port has, the timeline sampling
#: four times a second.
OBS_ARMED = dict(timeline=True, timeline_interval_s=0.25, hostprof=True,
                 placement=True)
TRACED_ORDERS = 20_000  # (b): the flow's first orders, with the tracer on
OBS_STAGES = ("pad_pack", "device_execute", "decode", "publish")
#: The reference's artifacts, each measured on a TPU: no payload of the
#: port may carry one of their values, nor name them.
TPU_ARTIFACTS = ("CAPACITY_r01", "PLACEMENT_r01", "MULTICHIP_r06",
                 "BENCH_SERVICE_r05", "BENCH_r05", "FLEET_r01")
#: The reference's top-level keys of each route's payload (armed).
OBS_KEYS = dict(
    timeline={"enabled", "interval_s", "samples"},
    placement={"enabled", "admits", "top", "topk_share", "sketch",
               "occupancy", "lanes", "attribution", "verdict"},
    capacity={"enabled"},
    hostprof={"enabled", "hz", "keep", "admits", "live", "drill"},
)
TIMELINE_KEYS = {"ts", "t", "rss_bytes", "cpu_utime_s", "cpu_stime_s",
                 "majflt", "nvcsw", "nivcsw", "frames", "orders", "engine",
                 "live", "compile", "queue", "bus", "placement"}


@contextlib.contextmanager
def dense_grids():
    """Record every dense grid geometry any engine decides in the block
    (BatchEngine._grid_geometry, wrapped on the class): yields the list of
    their rows per live lane."""
    from gome_tpu_torch.engine.batch import BatchEngine

    inner = BatchEngine._grid_geometry
    seen = []

    def geometry(self, live, first=True, cls=None):
        out = inner(self, live, first, cls)
        if out[0]:
            seen.append(out[1] / len(live))
        return out

    BatchEngine._grid_geometry = geometry
    try:
        yield seen
    finally:
        BatchEngine._grid_geometry = inner


def disarm_obs() -> None:
    """Every process-wide obs/ singleton and the tracer back to disarmed."""
    from gome_tpu_torch.obs import HOSTPROF, JOURNAL, TIMELINE
    from gome_tpu_torch.obs.fleet import FLEET
    from gome_tpu_torch.obs.placement import PLACEMENT
    from gome_tpu_torch.obs.profiler import PROFILER
    from gome_tpu_torch.utils.trace import TRACER

    for single in (TIMELINE, HOSTPROF, PLACEMENT, JOURNAL, PROFILER, FLEET,
                   TRACER):
        single.disable()


def obs_scrape(svc) -> dict:
    """Phase 13 (c), while the armed service is still up and drained: wait
    for two timeline samples taken after the drain, then read the four
    routes, /hostprof?format=collapsed and ?drill=1, /metrics, and the
    books' bytes (obs.live.pytree_stats)."""
    from gome_tpu_torch.obs.live import pytree_stats
    from gome_tpu_torch.obs.timeline import TIMELINE

    t_drained = TIMELINE.clock()
    deadline = time.monotonic() + 10
    while sum(1 for x in TIMELINE.series() if x["t"] > t_drained) < 2:
        if time.monotonic() > deadline:
            raise SystemExit("phase 13 (c): the timeline took no two samples "
                             "in 10 s after the drain")
        time.sleep(0.05)
    port = svc.ops.port
    out = {}
    for route in (*OBS_KEYS, "hostprof?format=collapsed",
                  "hostprof?drill=1", "metrics"):
        code, body = http_get(port, f"/{route}")
        if code != 200:
            raise SystemExit(f"phase 13 (c): /{route} answered {code}")
        out[route] = body if route in ("metrics", "hostprof?format=collapsed"
                                       ) else json.loads(body)
    out["books"] = pytree_stats(svc.engine.batch.books)
    out["device"] = str(svc.engine.batch.books.price.device)
    return out


def stage_totals(text: str) -> dict:
    """{stage: [count, seconds]} of gome_stage_seconds in /metrics text."""
    out = {}
    for line in text.splitlines():
        for part, i in (("_count", 0), ("_sum", 1)):
            head = f'gome_stage_seconds{part}{{stage="'
            if line.startswith(head):
                stage = line[len(head):].split('"', 1)[0]
                out.setdefault(stage, [0.0, 0.0])[i] = float(
                    line.rsplit(" ", 1)[1])
    return out


def check_obs_payloads(sc: dict, flow_orders, dense) -> dict:
    """Phase 13 (c)'s checks on the armed run's scrape; returns the
    numbers it prints."""
    for route, want in OBS_KEYS.items():
        missing = want - set(sc[route])
        if missing or sc[route]["enabled"] is not (route != "capacity"):
            raise SystemExit(f"phase 13 (c): /{route} misses {missing} or "
                             f"is enabled={sc[route].get('enabled')}")
    text = json.dumps([sc[r] for r in OBS_KEYS]) + json.dumps(
        sc["hostprof?drill=1"])
    named = [a for a in TPU_ARTIFACTS if a in text]
    if named:
        raise SystemExit(f"phase 13 (c): a payload names {named}")
    samples = sc["timeline"]["samples"]
    books = sc["books"]["bytes"]
    if len(samples) < 4 or any(TIMELINE_KEYS - set(x) for x in samples):
        raise SystemExit(f"phase 13 (c): /timeline has {len(samples)} "
                         "samples, or one misses a key")
    last = samples[-2:]
    card_live = [x["live"]["devices"][sc["device"]]["allocated_bytes"]
                 for x in last]
    hashes = {x["engine"]["geometry_hash"] for x in last}
    if min(card_live) < books or len(hashes) != 1:
        raise SystemExit(f"phase 13 (c): /timeline's last samples: "
                         f"{sc['device']} live {card_live} against the "
                         f"books' {books} B, "
                         f"geometry hashes {hashes}")
    pl = sc["placement"]
    occ = pl["occupancy"]
    top_flow = collections.Counter(
        o.symbol for o in flow_orders).most_common(1)[0]
    if occ["frames"] != len(dense) or not pl["top"] or \
            pl["top"][0]["symbol"] != top_flow[0] or \
            pl["admits"] != len(flow_orders):
        raise SystemExit(f"phase 13 (c): /placement ledger {occ['frames']} "
                         f"dispatches against {len(dense)} dense grids run, "
                         f"top {pl['top'][:1]} against the flow's "
                         f"{top_flow}, admits {pl['admits']} of "
                         f"{len(flow_orders)}")
    # The verdict and the baselines are the port's own artifacts (None
    # without them), never a TPU run's.
    from gome_tpu_torch.obs import placement

    attr = pl["attribution"]
    if pl["verdict"] != placement.default_verdict() or \
            attr["hash_partition"]["baseline"] != \
            placement.partition_imbalance_baseline() or \
            [c["baseline"] for c in attr["components"]] != \
            [placement.shard_skew_baseline(), None] or \
            not attr["reconciliation"]["within_tol"]:
        raise SystemExit(f"phase 13 (c): /placement verdict or baselines "
                         f"not the port's artifacts, or not reconciled: "
                         f"{attr}")
    if sc["capacity"] != {"enabled": False}:
        raise SystemExit(f"phase 13 (c): /capacity {sc['capacity']}")
    live = sc["hostprof"]["live"]
    drill = sc["hostprof?drill=1"]["drill"]
    if not live["total_samples"] or not live["stages"] or drill is None \
            or not drill["stages"]:
        raise SystemExit(f"phase 13 (c): /hostprof live {live.get('stages')}"
                         f" ({live.get('total_samples')} samples), drill "
                         f"{None if drill is None else drill['stages']}")
    collapsed = sc["hostprof?format=collapsed"]
    if not collapsed.strip() or collapsed.startswith("#"):
        raise SystemExit("phase 13 (c): /hostprof?format=collapsed is empty")
    return dict(samples=len(samples), last=samples[-1], books=books,
                device=sc["device"],
                card_live=card_live[-1], hash=hashes.pop(),
                p50=float(np.median(dense)), occupancy=occ,
                top=pl["top"][0], live=live, drill=drill,
                gauge_p50=metric(sc["metrics"],
                                 "gome_dispatched_rows_per_live_lane_p50"),
                stacks=len(collapsed.splitlines()))


def phase13(card: str, sizes, zipf, flow8, p8c) -> dict:
    """Phase 13, the host-side observability plane (obs/): (a) phase 8
    (c)'s service disarmed, then armed (timeline every 0.25 s, hostprof,
    placement, and the compile journal by hand): bodies byte-equal, K1 at
    the armed run's inputs; (b) the armed service with the tracer on over
    the flow's first 20,000 orders: the engine's stages on /metrics; (c) the
    armed run's four routes; (d) the columnar admit drill on the native
    pre-pool. Returns the numbers; each part prints as it ends."""
    from gome_tpu_torch.api import order_pb2 as pb
    from gome_tpu_torch.obs import JOURNAL
    from gome_tpu_torch.obs.hostprof import gateway_drill
    from gome_tpu_torch.ops.match_step import batch_step

    t_phase = time.perf_counter()
    requests, tail, want = flow8
    n = len(zipf)
    disarm_obs()
    try:
        off = service_run(sizes, 0, requests, tail, want, n, batch_step,
                          subscribe=False, load_run=False,
                          label="phase 13 (a) obs disarmed")
        torch.cuda.empty_cache()
        # The compile journal too: `cost` (its /cost) is not ported, so no
        # ops: flag arms it; installed by hand it records the frame path's
        # first-seen dispatch combos.
        JOURNAL.install()
        # The armed hooks read no device value: every submit_frame of the
        # armed run runs under set_sync_debug_mode("error").
        with keep_kernel_inputs() as kept, dense_grids() as dense, \
                no_host_sync() as checked:
            on = service_run(sizes, 0, requests, tail, want, n, batch_step,
                             subscribe=False, load_run=False,
                             label="phase 13 (a) obs armed",
                             ops_kw=OBS_ARMED, on_done=obs_scrape)
        if not checked[0]:
            raise SystemExit("phase 13 (a): the armed run made no "
                             "submit_frame call")
        journal = JOURNAL.summary()
        journal_export = JOURNAL.export()
        disarm_obs()
        a_worst, kept_line = check_kept_inputs("phase 13 (a)", kept)
        del kept
        torch.cuda.empty_cache()
        for tag, r in (("disarmed", off), ("armed", on)):
            if r["bodies"] != p8c["bodies"]:
                bad = next((i for i, (x, y) in enumerate(
                    zip(r["bodies"], p8c["bodies"])) if x != y),
                    min(len(r["bodies"]), len(p8c["bodies"])))
                raise SystemExit(f"phase 13 (a): the {tag} run's matchOrder "
                                 f"bodies differ from phase 8 (c)'s at {bad}")
        c = check_obs_payloads(on["scraped"], list(zipf) + tail, dense)
        rate_off, rate_on = n / off["secs"], n / on["secs"]
        print(f"phase 13 (a): {on['host']}: phase 8 (c)'s service (int64, "
              f"depth 0, json wire, no subscriber) disarmed, then with "
              f"timeline (0.25 s), hostprof and placement armed and the "
              f"compile journal installed: "
              f"{len(on['bodies'])} matchOrder bodies byte-equal between "
              f"the two and to phase 8 (c)'s; {off['launches']} / "
              f"{on['launches']} K1 launches = device calls; no host sync "
              f"in the armed run's {checked[0]} submit_frame calls")
        print(kept_line)
        print(f"phase 13 (a) [{card}]: disarmed {rate_off:,.0f} orders/s "
              f"({off['secs']:.3f} s), armed {rate_on:,.0f} orders/s "
              f"({on['secs']:.3f} s); armed / disarmed {rate_on / rate_off:.4f}"
              f"; consumer busy {off['split']['consumer'] - off['split']['consumer_wait']:.4f}"
              f" / {on['split']['consumer'] - on['split']['consumer_wait']:.4f} s, "
              f"gateway admission {off['split']['gateway']:.4f} / "
              f"{on['split']['gateway']:.4f} s; journal: "
              + (", ".join(f"{k} {v['count']} first-seen in "
                           f"{v['seconds']:.4f} s" for k, v in journal.items())
                 or "empty"))

        n_b = TRACED_ORDERS
        req_b, want_b = wire_batches(pb, zipf[:n_b]), oracle_events(zipf[:n_b])
        try:
            traced = service_run(
                sizes, 0, req_b, [], want_b, n_b, batch_step,
                subscribe=False, load_run=False,
                label="phase 13 (b) traced", ops_kw=dict(OBS_ARMED, trace=True),
                on_done=lambda svc: http_get(svc.ops.port, "/metrics")[1])
        finally:
            disarm_obs()
        stages = stage_totals(traced["scraped"])
        zero = [st for st in OBS_STAGES if stages.get(st, [0, 0])[0] <= 0]
        if zero:
            raise SystemExit(f"phase 13 (b): gome_stage_seconds has no "
                             f"observation of {zero}: {stages}")
        print(f"phase 13 (b) [{card}]: the armed service with ops.trace on, "
              f"{n_b:,} orders (the gateway's scalar "
              f"loop under the tracer): {n_b / traced['secs']:,.0f} orders/s"
              f" ({traced['secs']:.3f} s), {len(want_b):,} events equal to "
              f"the oracle's; gome_stage_seconds count / summed s: "
              + ", ".join(f"{st} {int(v[0])} / {v[1]:.4f}"
                          for st, v in stages.items())
              + f"; {traced['launches']} K1 launches")

        last, occ, live, dr = c["last"], c["occupancy"], c["live"], c["drill"]
        print(f"phase 13 (c) [{card}]: /timeline {c['samples']} samples "
              f"(last: rss {last['rss_bytes'] / 2**20:.1f} MiB, cpu "
              f"{last['cpu_utime_s']:.2f} + {last['cpu_stime_s']:.2f} s, "
              f"nivcsw {last['nivcsw']}, {c['device']} live "
              f"{c['card_live'] / 2**20:.1f} MiB >= the books' "
              f"{c['books'] / 2**20:.1f} MiB, geometry hash {c['hash']} on "
              f"the last two, {last['engine']['seen_combos']} combos); "
              f"/placement {occ['frames']} ledger dispatches = dense grids "
              f"run, rows per live lane p50 {c['p50']:.4f} (this run; "
              f"gauge {c['gauge_p50']:.4f} over the process), ledger "
              f"{occ['rows_per_live_lane']:.4f}, padding "
              f"{occ['padding_bytes'] / 2**20:.1f} MiB; top {c['top']['symbol']}"
              f" {c['top']['count']} = the flow's; /capacity no verdict; "
              f"/hostprof live {live['total_samples']} samples, coverage "
              f"{live['coverage_pct']}%: "
              + ", ".join(f"{k} {v['pct']}%" for k, v in live["stages"].items())
              + f"; ?drill=1 scalar admit {dr['admit_ns_per_order']:.1f} "
              f"ns/order; ?format=collapsed {c['stacks']} stacks; no TPU "
              f"artifact's value in any payload")

        d = gateway_drill(n_orders=16_384, min_samples=64, max_rounds=24,
                          path="columnar", batch_n=1024)
        if d["prepool"] != "native":
            raise SystemExit(f"phase 13 (d): the columnar drill marked "
                             f"through the {d['prepool']} pre-pool")
        print(f"phase 13 (d) [{card}]: gateway_drill(columnar, batch 1,024) "
              f"on the native pre-pool: {d['orders']:,} orders in "
              f"{d['rounds']} rounds, {d['admit_ns_per_order']:.1f} ns/order, "
              f"{d['admit_orders_per_sec_per_core']:,} orders/s/core, "
              f"{d['sampler']['samples']} samples ({d['sampler']['mode']}), "
              f"coverage {d['coverage_pct']}%: "
              + ", ".join(f"{k} {v.get('ns_per_order')} ns"
                          for k, v in d["stages"].items()))
    finally:
        disarm_obs()
    secs = time.perf_counter() - t_phase
    print(f"phase 13 [{card}]: the observability plane in {secs:.1f} s")
    return dict(worst=a_worst, seconds=secs, launches=dict(
        disarmed=off["launches"], armed=on["launches"],
        traced=traced["launches"]),
        ratio=rate_on / rate_off, p50=c["p50"], stages=stages,
        journal=journal_export)


# -- phase 14 ----------------------------------------------------------------

#: (a)'s armed run: the compile journal (cost) and the measured-roofline
#: profiler (profile); the other obs/ flags stay off.
COST_ARMED = dict(cost=True, profile=True)
FLEET_ORDERS = 10_000  # (b): the flow's first orders over the partitions
FLEET_PARTITIONS = 2
FLEET_WAIT_S = 240  # (b): boot, drive and drain of the whole fleet
GEOMETRY_FRAMES = 8  # (c): the first frames timed cold and warm


class StallProbe:
    """Where the threads of this process spend one request's wall time:
    every 1/`hz` s each thread's Python stack (sys._current_frames) and
    its CPU seconds (utime + stime in /proc/self/task/<tid>/stat). A
    thread whose CPU seconds fall far below its sampled span was waiting
    (for the GIL, a lock or the device), not running."""

    TICK_S = os.sysconf("SC_CLK_TCK")

    def __init__(self, hz: float = 50.0):
        self.hz = hz
        self.threads: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chip-smoke-stall-probe")

    def __enter__(self):
        self.t0 = time.perf_counter()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.wall = time.perf_counter() - self.t0
        return False

    @classmethod
    def _cpu(cls, tid) -> float | None:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            return None
        return (int(fields[11]) + int(fields[12])) / cls.TICK_S

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(1.0 / self.hz):
            live = {t.ident: t for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                t = live.get(ident)
                if ident == me or t is None:
                    continue
                nodes = []
                while frame is not None:
                    code = frame.f_code
                    nodes.append(f"{frame.f_globals.get('__name__', '?')}:"
                                 f"{code.co_qualname}")
                    frame = frame.f_back
                cpu = self._cpu(t.native_id)
                rec = self.threads.setdefault(ident, dict(
                    name=t.name, samples=0, cpu0=cpu, cpu1=cpu, nodes=set(),
                    where=collections.Counter()))
                rec["samples"] += 1
                rec["cpu1"] = cpu if cpu is not None else rec["cpu1"]
                rec["nodes"].update(nodes)
                own = next((n for n in nodes
                            if n.startswith("gome_tpu_torch")), "-")
                rec["where"][own if own == nodes[0]
                             else f"{own} < {nodes[0]}"] += 1

    def thread(self, node: str) -> dict | None:
        """The sampled thread whose stacks held `node` (the longest such)."""
        hits = [r for r in self.threads.values()
                if any(node in n for n in r["nodes"])]
        return max(hits, key=lambda r: r["samples"]) if hits else None

    def summary(self, node: str, top: int = 4) -> dict | None:
        rec = self.thread(node)
        if rec is None:
            return None
        cpu = (rec["cpu1"] - rec["cpu0"]) if rec["cpu0"] is not None else None
        return dict(name=rec["name"], samples=rec["samples"],
                    span_s=rec["samples"] / self.hz, cpu_s=cpu,
                    where=[(w, c / rec["samples"])
                           for w, c in rec["where"].most_common(top)])


def stall_line(probe: StallProbe) -> str:
    """The /cost handler's and the consumer's threads over one read."""
    parts = []
    for tag, node in (("handler", "cost_payload"),
                      ("consumer", "gome_tpu_torch.service.consumer:")):
        sm = probe.summary(node)
        if sm is None:
            parts.append(f"{tag}: not sampled")
            continue
        cpu = "n/a" if sm["cpu_s"] is None else f"{sm['cpu_s']:.2f}"
        parts.append(
            f"{tag} ({sm['name']}) {sm['samples']} samples over "
            f"{sm['span_s']:.2f} s, CPU {cpu} s, at "
            + ", ".join(f"{w} {share:.0%}" for w, share in sm["where"]))
    return (f"wall {probe.wall:.2f} s, {len(probe.threads)} threads; "
            + "; ".join(parts))


def cost_profile_reads(label, svc, started=None) -> dict:
    """/cost, then /profile?refresh=1, of a running service; the
    consumer's committed doOrder offset (one message a DoOrderBatch
    request) is read before and after (mid-flow: messages were still
    unconsumed when the reads began), and `started` is set once it was
    read. The /cost read runs under a StallProbe."""
    q = svc.bus.order_queue
    out = {"committed_before": q.committed(), "seconds": {}}
    if started is not None:
        started.set()
    for route in ("cost", "profile?refresh=1"):
        t0 = time.perf_counter()
        with (StallProbe() if route == "cost"
              else contextlib.nullcontext()) as probe:
            code, body = http_get(svc.ops.port, f"/{route}")
        if probe is not None:
            out["stall"] = stall_line(probe)
        if code != 200:
            raise SystemExit(f"{label}: /{route} answered {code}")
        key = route.split("?")[0]
        out[key] = json.loads(body)
        out["seconds"][key] = time.perf_counter() - t0
    out["committed_after"] = q.committed()
    return out


def check_cost_profile(label, reads: dict) -> dict:
    """Phase 14 (a)'s checks on one pair of reads: every RATCHET_ENTRIES
    row in /cost without an error, and in /profile with device time from
    CUDA kernels (> 0) and an efficiency of at most 105% of its
    roofline ceiling; K1 among batch_step's kernels once per call. The
    capture counts only the device events of its own stream (marked by
    profiler.STREAM_MARKER): the trace's K1 events outside that count are
    the consumer's.
    Returns the numbers it prints."""
    from gome_tpu_torch.obs import costmodel, profiler

    cost, prof = reads["cost"], reads["profile"]
    want = list(costmodel.RATCHET_ENTRIES)
    got = [e["entry"] for e in cost["cost_model"].get("entries", ())
           if "error" not in e]
    if got != want or not cost["compile_journal"]["enabled"]:
        raise SystemExit(f"{label}: /cost entries {got} "
                         f"({cost['cost_model']}), journal "
                         f"{cost['compile_journal']['enabled']}")
    rep = prof.get("report")
    if not prof.get("enabled") or rep is None or prof.get("error"):
        raise SystemExit(f"{label}: /profile {prof}")
    rows = rep["entries"]
    bad = {e: rows.get(e) for e in want
           if e not in rows or "error" in rows[e]
           or rows[e]["device_time_source"] != "cuda_kernels"
           or not rows[e]["device_us_per_call"] > 0
           or rows[e].get("efficiency_pct") is None
           or not rows[e]["efficiency_pct"] <= 105}
    if bad or rep["platform"] != "cuda":
        raise SystemExit(f"{label}: /profile rows {bad} on "
                         f"{rep['platform']}")
    events = profiler.load_trace_events(rep["run_dir"])
    names = profiler.window_event_names(events, "batch_step",
                                        streams=rep["streams"])
    k1_own = sum("match_step" in n for n in names)
    k1_all = sum(1 for e in events if e.get("cat") == "kernel"
                 and "match_step" in e.get("name", ""))
    if k1_own != rep["repeats"]:
        raise SystemExit(f"{label}: {k1_own} K1 kernels in batch_step's "
                         f"window for {rep['repeats']} calls: {names}")
    return dict(rows=rows, peaks=rep["peaks"], k1_own=k1_own,
                k1_all=k1_all, repeats=rep["repeats"], stall=reads["stall"],
                streams=rep["streams"],
                cost={e["entry"]: e for e in cost["cost_model"]["entries"]},
                seconds=reads["seconds"],
                committed=(reads["committed_before"],
                           reads["committed_after"]))


def phase14a(card: str, sizes, zipf, flow8, p8c) -> dict:
    """Phase 14 (a): phase 8 (c)'s service with cost and profile armed
    (Config's own defaults for both) and every other obs/ flag off;
    /cost and /profile?refresh=1 read once mid-flow (on a thread that
    the sender starts once a quarter of the requests are sent) and once
    after; bodies
    byte-equal to phase 8 (c)'s; K1 at the run's inputs."""
    from gome_tpu_torch.obs import JOURNAL, costmodel, profiler
    from gome_tpu_torch.ops.match_step import batch_step

    requests, tail, want = flow8
    n = len(zipf)
    label = "phase 14 (a) cost and profile armed"
    disarm_obs()
    try:
        with keep_kernel_inputs() as kept:
            on = service_run(
                sizes, 0, requests, tail, want, n, batch_step,
                subscribe=False, load_run=False, label=label,
                ops_kw=COST_ARMED,
                mid=lambda svc, started: cost_profile_reads(
                    label + " mid-flow", svc, started),
                on_done=lambda svc: cost_profile_reads(label + " after", svc))
        # ops.cost armed the compile journal: phase 16 (c) holds its
        # export to the committed combo universe.
        journal_export = JOURNAL.export()
    finally:
        disarm_obs()
    worst, kept_line = check_kept_inputs("phase 14 (a)", kept)
    del kept
    torch.cuda.empty_cache()
    if on["bodies"] != p8c["bodies"]:
        bad = next((i for i, (x, y) in enumerate(
            zip(on["bodies"], p8c["bodies"])) if x != y),
            min(len(on["bodies"]), len(p8c["bodies"])))
        raise SystemExit(f"phase 14 (a): matchOrder bodies differ from "
                         f"phase 8 (c)'s at {bad}")
    mid = check_cost_profile("phase 14 (a) mid-flow", on["mid"])
    after = check_cost_profile("phase 14 (a) after", on["scraped"])
    n_msgs = len(requests) + len(tail)
    if not mid["committed"][0] < n_msgs:
        raise SystemExit(f"phase 14 (a): the mid-flow reads began with "
                         f"{mid['committed'][0]} of {n_msgs} doOrder "
                         "messages committed")
    rate_off, rate_on = n / p8c["secs"], n / on["secs"]
    print(f"phase 14 (a): {on['host']}: phase 8 (c)'s service (int64, depth "
          f"0, json wire, no subscriber) with ops cost and profile on "
          f"(the compile journal, the cost model, the profiler; every other "
          f"obs flag off): {len(on['bodies'])} matchOrder bodies byte-equal "
          f"to phase 8 (c)'s; {on['launches']} K1 launches = the consumer's "
          f"device calls + {on['entry_launches']} by the cost model's and "
          f"profiler's entries; /cost and /profile?refresh=1 read mid-flow "
          f"(/cost {mid['seconds']['cost']:.3f} s, /profile "
          f"{mid['seconds']['profile']:.3f} s; consumer at "
          f"{mid['committed'][0]} -> {mid['committed'][1]} of {n_msgs} "
          f"doOrder messages) and after (/cost "
          f"{after['seconds']['cost']:.3f} s, /profile "
          f"{after['seconds']['profile']:.3f} s): every entry of "
          f"{', '.join(mid['rows'])} on cuda_kernels, device time > 0, "
          f"efficiency <= 105%; K1 in batch_step's window {mid['k1_own']} "
          f"/ {after['k1_own']} times for {mid['repeats']} calls, the "
          f"consumer's {mid['k1_all'] - mid['k1_own']} / "
          f"{after['k1_all'] - after['k1_own']} K1 kernels in the same "
          f"traces left out (the capture's own stream, {mid['streams']})")
    print(kept_line)
    pk = after["peaks"]
    quiet = profiler.machine_peaks(refresh=True, device=torch.device("cuda"))
    print(f"phase 14 (a) [{card}]: calibrated peaks (the service's, taken "
          f"mid-flow) {pk['peak_gflops']:,.1f} GFLOP/s (float32 512^3 "
          f"matmul, TF32 {pk.get('tf32')}), {pk['peak_gbps']:,.1f} GB/s (one "
          f"elementwise pass over 4M float32); again on the quiet card "
          f"{quiet['peak_gflops']:,.1f} GFLOP/s, {quiet['peak_gbps']:,.1f} "
          f"GB/s; orders/s "
          f"armed {rate_on:,.0f} ({on['secs']:.3f} s), phase 8 (c) disarmed "
          f"{rate_off:,.0f} ({p8c['secs']:.3f} s), armed / disarmed "
          f"{rate_on / rate_off:.4f}")
    for tag, r in (("mid-flow", mid), ("after", after)):
        print(f"phase 14 (a) [{card}]: /profile {tag}: "
              + "; ".join(
                  f"{e} {row['device_us_per_call']:.3f} us/call "
                  f"(wall {row['wall_us_per_call']:.3f}), "
                  f"{row['achieved_gbps']:.4f} GB/s, "
                  f"{row['efficiency_pct']:.4f}% of "
                  f"{row['roofline_ceiling_gflops']:.1f} G/s"
                  for e, row in r["rows"].items()))
    c = after["cost"]
    print(f"phase 14 (a) [{card}]: /cost (int64, cap 8, K 4, S 2, T 4): "
          + "; ".join(
              f"{e} {row['argument_bytes']} + {row['output_bytes']} B, "
              f"{row['flops']:.0f} ops, peak {row['peak_hbm_bytes']} B, "
              f"{row['jaxpr_eqns']} launches" for e, row in c.items()))
    for tag, r in (("mid-flow", mid), ("after", after)):
        print(f"phase 14 (a) [{card}]: /cost {tag} under the stall probe: "
              f"{r['stall']}")
    return dict(worst=worst, launches=on["launches"],
                entry_launches=on["entry_launches"], rate_on=rate_on,
                rate_off=rate_off, peaks=pk, quiet_peaks=quiet,
                mid={e: r["device_us_per_call"] for e, r in mid["rows"].items()},
                after={e: r["device_us_per_call"]
                       for e, r in after["rows"].items()},
                k1_total=costmodel.ENTRY_K1_LAUNCHES, journal=journal_export)


def fleet_worker(argv) -> int:
    """`python3 chip_smoke.py --fleet-gateway|--fleet-consumer ...`: one
    member of phase 14 (b)'s fleet (gome_tpu_torch.scripts.fleet_drill's
    members; the consumer holds K1 against its plain version at the
    inputs its run gave it)."""
    from gome_tpu_torch.scripts import fleet_drill

    def consumer(args):
        return fleet_drill.fleet_consumer(args, keep=keep_kernel_inputs,
                                          check=check_kept_inputs)

    role = "consumer" if argv[0] == "--fleet-consumer" else "gateway"
    return fleet_drill.run_worker(role, argv[1:], consumer=consumer)


def fleet_launcher(role: str) -> list:
    """Phase 14 (b)'s members run as this script's --fleet-<role>."""
    return [sys.executable, os.path.abspath(__file__), f"--fleet-{role}"]


def phase14b(card: str, sizes, zipf, device: str = "cuda",
             n_orders: int = FLEET_ORDERS) -> dict:
    """Phase 14 (b): a fleet of two partitions (scripts/fleet_drill.py's
    shape): the port's marker server; per partition a gateway process
    and a consumer process on the card over a file bus, orders routed by
    fleet.partition_of; this process's FLEET polls the four ops servers.
    Merged /metrics totals equal the members' sums, the rollup stays
    green, the fleet-wide seq audit is exact, journeys stitch across the
    gateway -> consumer boundary, and each partition's events equal the
    oracle's. `device` names the consumers' device ("cpu" in tests)."""
    from gome_tpu_torch.obs.fleet import FLEET
    from gome_tpu_torch.scripts import fleet_drill
    from gome_tpu_torch.utils.metrics import family_total

    if fleet_drill.N_PARTITIONS != FLEET_PARTITIONS:
        raise SystemExit(f"phase 14 (b): fleet_drill has "
                         f"{fleet_drill.N_PARTITIONS} partitions")
    t_phase = time.perf_counter()
    orders = list(zipf[:n_orders])
    reqs = fleet_drill.requests_by_partition(orders)
    parts = [[orders[gi] for gi, _, _ in r] for r in reqs]
    wants = [oracle_events(part) for part in parts]
    procs, errs = {}, {}
    results = {}
    with tempfile.TemporaryDirectory(prefix="phase14b-") as work:
        try:
            resp_port = fleet_drill.start_respserver(procs)
            t_boot = time.perf_counter()
            ports = fleet_members(work, resp_port, sizes["symbols"],
                                  device, procs, errs, fleet_launcher,
                                  trace_keep=2 * FLEET_ORDERS)
            boot = time.perf_counter() - t_boot
            members = {name: f"http://127.0.0.1:{ops}"
                       for name, (ops, _) in ports.items()}
            FLEET.install(members, interval_s=0.25, timeout_s=5.0,
                          stale_after_s=10.0)
            FLEET.start()
            drives = [{} for _ in range(FLEET_PARTITIONS)]
            threads = [threading.Thread(
                target=fleet_drill.drive_partition,
                args=(f"127.0.0.1:{ports[f'gw{p}'][1]}", reqs[p], drives[p]))
                for p in range(FLEET_PARTITIONS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(FLEET_WAIT_S)
            # Every order of a partition accepted, none rejected, no
            # transport error.
            if any("sent" not in d or "transport_error" in d
                   or d["codes"] != {"0": d["sent"]} for d in drives):
                raise SystemExit(f"phase 14 (b): drives "
                                 f"{[{k: d.get(k) for k in ('sent', 'codes', 'transport_error')} for d in drives]}")
            deadline = time.monotonic() + FLEET_WAIT_S
            for p in range(FLEET_PARTITIONS):
                if not fleet_drill.await_drained(
                        f"http://127.0.0.1:{ports[f'c{p}'][0]}",
                        len(parts[p]), max(deadline - time.monotonic(), 0.0),
                        procs={n: pr for n, pr in procs.items()
                               if n != "respserver"}):
                    raise SystemExit("phase 14 (b): the fleet did not drain "
                                     f"in {FLEET_WAIT_S} s")
            secs = time.perf_counter() - t0
            FLEET.stop()
            FLEET.poll()
            payload = FLEET.payload()
            snap = dict(FLEET._last)
            stitch = FLEET.stitch()
            rollup = FLEET.rollup()
        finally:
            FLEET.disable()
            results = fleet_drill.stop_members(procs, work, errs)
        for name, res in results.items():
            if res["exit_code"] != 0:
                raise SystemExit(f"phase 14 (b): {name} exited "
                                 f"{res['exit_code']}: {res.get('stderr')}")
        events = [fleet_drill.read_match_events(os.path.join(work, f"p{p}"))
                  for p in range(FLEET_PARTITIONS)]
    for p in range(FLEET_PARTITIONS):
        check_events(f"phase 14 (b) partition {p}", unstamped(events[p]),
                     wants[p])
        if [e.seq for e in events[p]] != list(range(len(wants[p]))):
            raise SystemExit(f"phase 14 (b): partition {p}'s seqs not "
                             f"0..{len(wants[p]) - 1}")
        c = results[f"c{p}"]
        if device == "cuda" and (c["launches"] <= 0
                                 or c["launches"] != c["expected"]):
            raise SystemExit(f"phase 14 (b): c{p} launched K1 "
                             f"{c['launches']} times for {c['expected']} "
                             "expected from its device calls")
    # Merged /metrics: every family's total equals the members' sum over
    # the same scrape.
    fams = payload["metrics"].get("families")
    if not fams:
        raise SystemExit(f"phase 14 (b): /fleet metrics {payload['metrics']}")
    off = {}
    for name, fam in fams.items():
        total = sum(family_total(st["families"][name])
                    for st in snap.values()
                    if st["families"] and name in st["families"])
        if not math.isclose(total, fam["total"], rel_tol=1e-9, abs_tol=1e-9):
            off[name] = (fam["total"], total)
    consumed = fams.get("gome_orders_consumed_total", {}).get("total")
    if off or consumed != len(orders):
        raise SystemExit(f"phase 14 (b): merged totals off the members' "
                         f"sums {off}; orders consumed {consumed}")
    if rollup["polls"] < 4 or rollup["unhealthy_polls"] or \
            rollup["degraded_polls"] or rollup["fetch_errors"] or \
            payload["unreachable"]:
        raise SystemExit(f"phase 14 (b): rollup {rollup}, unreachable "
                         f"{payload['unreachable']}")
    seq = payload["seq"]["fleet"]
    if seq != {"observed": sum(map(len, wants)), "dupes": 0, "gaps": 0}:
        raise SystemExit(f"phase 14 (b): fleet seq audit {seq}")
    pairs = [sum(1 for j in stitch["journeys"]
                 if {f"gw{p}", f"c{p}"} <= set(j["procs"]))
             for p in range(FLEET_PARTITIONS)]
    if not all(pairs):
        raise SystemExit(f"phase 14 (b): journeys stitched per partition "
                         f"{pairs} of {stitch['traces']} traces")
    durations = sorted(j["duration_s"] for j in stitch["journeys"])
    flow = (payload.get("placement") or {}).get("flow") or {}
    print(f"phase 14 (b): {results['c0']['host']}: a fleet of "
          f"{FLEET_PARTITIONS} partitions ({len(orders):,} orders by "
          f"fleet.partition_of: {[len(p) for p in parts]}): the port's "
          f"marker server, per partition a gateway process (traced scalar "
          f"loop, file bus) and a consumer process on {device} "
          f"(EngineService, int64, json wire, ops.trace on); events equal "
          f"to each partition's oracle, seqs 0..n-1; K1 launches = device "
          f"calls in each consumer "
          f"({', '.join(str(results[f'c{p}']['launches']) for p in range(FLEET_PARTITIONS))}); "
          f"FLEET over the 4 ops servers: {rollup['polls']} polls, 0 "
          f"unhealthy, 0 degraded, 0 fetch errors; merged /metrics: "
          f"{len(fams)} families, every total = the members' sum, "
          f"gome_orders_consumed_total {consumed:,.0f}; fleet seq audit "
          f"{seq}; {stitch['joined']:,} journeys stitched of "
          f"{stitch['traces']:,} traces (per partition {pairs}), offsets "
          + ", ".join(f"{k} {v * 1e3:.3f} ms"
                      for k, v in stitch["offsets"].items())
          + f"; placement rollup top {flow.get('top', [{}])[0]}, imbalance "
          f"{payload['placement']['partition_imbalance_max_over_mean']:.4f}")
    for p in range(FLEET_PARTITIONS):
        print(results[f"c{p}"]["kept_line"])
    drive_secs = ", ".join(f"{d['wall_s']:.3f}" for d in drives)
    p50 = durations[len(durations) // 2]
    p99 = durations[min(len(durations) - 1, int(0.99 * len(durations)))]
    print(f"phase 14 (b) [{card}]: members ready in {boot:.1f} s; "
          f"{len(orders):,} orders driven and drained in {secs:.3f} s "
          f"({len(orders) / secs:,.0f} orders/s over the fleet; gateway "
          f"drives {drive_secs} s); stitched "
          f"gateway -> consumer journeys p50 {p50 * 1e3:.2f} ms, p99 "
          f"{p99 * 1e3:.2f} ms")
    return dict(worst=max(results[f"c{p}"]["worst"]
                          for p in range(FLEET_PARTITIONS)),
                launches=[results[f"c{p}"]["launches"]
                          for p in range(FLEET_PARTITIONS)],
                secs=secs, boot=boot, joined=stitch["joined"],
                p50=p50, p99=p99, seconds=time.perf_counter() - t_phase)


def first_frames(eng, frame_list) -> tuple[list, list[float]]:
    """The frames through process_frame(fast) one by one after marking
    them all: each frame's events and seconds (synchronous: each frame
    resolves before the next)."""
    for cols in frame_list:
        eng.mark_frame(cols)
    events, secs = [], []
    for cols in frame_list:
        t0 = time.perf_counter()
        batch = eng.process_frame(cols, fast=True)
        secs.append(time.perf_counter() - t0)
        events.append(batch.to_results())
    return events, secs


def phase14c(card: str, device, sizes, zipf, want_zipf) -> dict:
    """Phase 14 (c), the geometry warm-up: phase 6's engine (cap 256,
    K 16, int32) over the whole flow in frames of 8,192, its manifest
    saved (save_geometry); then fresh engines, each after empty_cache,
    cold or after load_geometry (ensure_cap, the floors, every combo
    replayed: one K1 launch each), in the order cold, warm, warm, cold:
    the first GEOMETRY_FRAMES frames' events equal across all four and to
    the oracle's prefix, their seconds printed."""
    from gome_tpu_torch.engine import frames
    from gome_tpu_torch.ops.match_step import batch_step

    frame_list = [frame_columns(zipf[i:i + sizes["batch"]])
                  for i in range(0, len(zipf), sizes["batch"])]
    with tempfile.TemporaryDirectory(prefix="phase14c-") as work:
        path = os.path.join(work, "geometry.json")
        eng, _, _ = consumer_stack(device, sizes["symbols"], 0)
        got, _ = run_frames(eng, frame_list)
        check_events("phase 14 (c) manifest flow", got, want_zipf)
        eng.save_geometry(path)
        manifest = eng.batch.shape_manifest()
        del eng
        runs = []
        for tag in ("cold", "warm", "warm", "cold"):
            torch.cuda.empty_cache()
            eng, _, _ = consumer_stack(device, sizes["symbols"], 0)
            load_s, replayed, replay_launches = 0.0, 0, 0
            if tag == "warm":
                batch_step.launches = 0
                t0 = time.perf_counter()
                replayed = eng.load_geometry(path)
                load_s = time.perf_counter() - t0
                replay_launches = batch_step.launches
                if replayed != len(manifest["combos"]) or (
                        device.type == "cuda"
                        and replay_launches != replayed):
                    raise SystemExit(f"phase 14 (c): {replayed} of "
                                     f"{len(manifest['combos'])} combos "
                                     f"replayed, {replay_launches} K1 "
                                     "launches")
            batch_step.launches = 0
            frames.FETCH_SECONDS = 0.0
            events, secs = first_frames(eng, frame_list[:GEOMETRY_FRAMES])
            runs.append(dict(tag=tag, events=events, secs=secs,
                             load_s=load_s, replayed=replayed,
                             replay_launches=replay_launches,
                             launches=batch_step.launches,
                             calls=eng.stats.device_calls,
                             fallbacks=eng.stats.frame_fallbacks,
                             escalations=eng.stats.cap_escalations,
                             cap=eng.config.cap))
            if device.type == "cuda" and \
                    batch_step.launches != eng.stats.device_calls:
                raise SystemExit(f"phase 14 (c) {tag}: {batch_step.launches}"
                                 f" K1 launches for {eng.stats.device_calls}"
                                 " device calls")
            eng.batch.verify_books()
            del eng
    n_first = sum(cols["n"] for cols in frame_list[:GEOMETRY_FRAMES])
    want = oracle_events(zipf[:n_first])
    for r in runs:
        check_events(f"phase 14 (c) {r['tag']}",
                     [e for b in r["events"] for e in b], want)
    print(f"phase 14 (c): save_geometry after phase 6's flow (cap 256 -> "
          f"{manifest['floors']['cap']}, {len(manifest['combos'])} combos, "
          f"floors {manifest['floors']}); four fresh engines (cold, warm, "
          f"warm, cold; warm = load_geometry: ensure_cap, the floors, every "
          f"combo replayed with one K1 launch): the first {GEOMETRY_FRAMES} "
          f"frames' {len(want):,} events equal across all four and to the "
          f"oracle; launches = device calls in each")
    for r in runs:
        print(f"phase 14 (c) [{card}]: {r['tag']}: "
              + (f"load_geometry {r['load_s']:.3f} s ({r['replayed']} "
                 f"combos, {r['replay_launches']} K1 launches); "
                 if r["tag"] == "warm" else "")
              + f"first {GEOMETRY_FRAMES} frames {sum(r['secs']):.4f} s ("
              + ", ".join(f"{s * 1e3:.1f}" for s in r["secs"])
              + f" ms); cap {r['cap']}, {r['escalations']} storage "
              f"escalations, {r['fallbacks']} exact fallbacks, "
              f"{r['launches']} K1 launches")
    return dict(runs=[{k: v for k, v in r.items() if k != "events"}
                      for r in runs],
                combos=len(manifest["combos"]))


def phase14(card: str, device, sizes, zipf, want_zipf, flow8, p8c) -> dict:
    """Phase 14: the cost model, the profiler and the fleet aggregator,
    and the geometry warm-up. Returns the numbers; each part prints as it
    ends."""
    t_phase = time.perf_counter()
    a = phase14a(card, sizes, zipf, flow8, p8c)
    b = phase14b(card, sizes, zipf)
    c = phase14c(card, device, sizes, zipf, want_zipf)
    secs = time.perf_counter() - t_phase
    print(f"phase 14 [{card}]: cost, profile, fleet and geometry in "
          f"{secs:.1f} s ((b) {b['seconds']:.1f} s)")
    return dict(worst=max(a["worst"], b["worst"]), seconds=secs, a=a, b=b,
                c=c, launches=dict(
                    armed_service=a["launches"],
                    cost_profile_entries=a["entry_launches"],
                    fleet_consumers=b["launches"],
                    geometry_replay=c["runs"][1]["replay_launches"]))


# -- phase 4 -----------------------------------------------------------------

# -- phase 15 ----------------------------------------------------------------

RACE_SYMBOL = "eth2usdt"
RACE_SECONDS = 1.0  # (a)'s traffic window; the armed consumer drains after
MESH_RANKS = 2  # (b): two ranks ...
MESH_LOCAL = 2  # ... of two shards each: D = 4, phase 11 (b)'s mesh size
MESH_WAIT_S = 300  # (b): both ranks' whole run


def race_drill(device, seconds: float = 3.0, threads: int = 4,
               engine=None) -> dict:
    """Phase 15 (a), the port of scripts/race_drill.py: an EngineService
    built with GOME_RACECHECK=1 (the app's hook arms analysis.racecheck's
    lockset detector over the feed, its SeqTracker, the consumer's seq
    frontier and the batcher and persister when present), `threads`
    gateway threads sending mixed add/cancel flow through the real
    DoOrder/DeleteOrder handlers for `seconds`, the consumer and feed
    loops live, one SubscribeMatches drain. `engine` (an EngineConfig)
    replaces the config's engine section. Fails (SystemExit) unless orders
    flowed, no unsuppressed race was reported and the match queue's events
    equal the oracle's over the order queue's messages in their order,
    and, on the card, unless K1 equals its plain version at the inputs
    the service gave it (check_kept_inputs). Returns the verdict."""
    import logging
    import random

    from gome_tpu_torch.analysis.racecheck import RACECHECK
    from gome_tpu_torch.api import order_pb2 as pb
    from gome_tpu_torch.bus import decode_match_result, decode_message_orders
    from gome_tpu_torch.config import Config, OpsConfig
    from gome_tpu_torch.ops import match_step
    from gome_tpu_torch.oracle import OracleEngine
    from gome_tpu_torch.service import EngineService

    saved = os.environ.get("GOME_RACECHECK")
    os.environ["GOME_RACECHECK"] = "1"
    RACECHECK.reset()
    try:
        cfg = Config(ops=OpsConfig(enabled=False),
                     **({} if engine is None else {"engine": engine}))
        svc = EngineService(cfg, device=device)
    finally:
        if saved is None:
            del os.environ["GOME_RACECHECK"]
        else:
            os.environ["GOME_RACECHECK"] = saved
    if not RACECHECK.enabled:
        raise SystemExit("phase 15 (a): the GOME_RACECHECK hook did not arm")
    # Thousands of per-fill INFO lines would bury the verdict.
    feed_log = logging.getLogger("gome_tpu_torch.matchfeed")
    feed_level = feed_log.level
    feed_log.setLevel(logging.WARNING)
    stop = threading.Event()
    accepted = [0] * threads
    rejected = [0] * threads
    sub_events = [0]

    def gateway_worker(i: int) -> None:
        rng = random.Random(0xACE + i)
        n = 0
        resting: list[str] = []
        while not stop.is_set():
            n += 1
            oid = f"o{i}-{n}"
            if resting and rng.random() < 0.3:
                dead = resting.pop(rng.randrange(len(resting)))
                svc.gateway.DeleteOrder(
                    pb.OrderRequest(uuid=f"u{i}", oid=dead, symbol=RACE_SYMBOL,
                                    transaction=pb.BUY, price=1.0,
                                    volume=1.0), None)
                continue
            side = pb.BUY if rng.random() < 0.5 else pb.SALE
            r = svc.gateway.DoOrder(
                pb.OrderRequest(uuid=f"u{i}", oid=oid, symbol=RACE_SYMBOL,
                                transaction=side,
                                price=round(rng.uniform(0.90, 1.10), 2),
                                volume=float(rng.randint(1, 5))), None)
            if r.code == 0:
                accepted[i] += 1
                resting.append(oid)
            else:
                rejected[i] += 1

    def subscriber() -> None:
        for _ in svc.feed.subscribe():
            sub_events[0] += 1

    q = svc.bus.order_queue
    # The service's K1 inputs are kept from the consumer's start to its
    # drain, and held against the plain version after the count is read.
    k1 = match_step.batch_step  # the wrapper, not keep_kernel_inputs' keeper
    with keep_kernel_inputs() as kept:
        k1.launches = 0
        svc.consumer.start()
        svc.feed.start()
        sub = threading.Thread(target=subscriber, name="drill-subscriber")
        sub.start()
        workers = [threading.Thread(target=gateway_worker, args=(i,),
                                    name=f"drill-gateway-{i}")
                   for i in range(threads)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        time.sleep(seconds)
        stop.set()
        for w in workers:
            w.join(timeout=30)
        deadline = time.monotonic() + 180
        while q.committed() < q.end_offset() and time.monotonic() < deadline:
            time.sleep(0.05)
        svc.consumer.stop()
        svc.feed.stop()
        sub.join(timeout=10)
        RACECHECK.disable()
        feed_log.setLevel(feed_level)
        launches = k1.launches
        drill_s = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    worst, kept_line = (check_kept_inputs("phase 15 (a) race drill", kept)
                        if on_card else (0, ""))
    kept_grids = len(distinct_kept(kept, "batch_step"))
    del kept
    reports = RACECHECK.reports()
    all_reports = RACECHECK.reports(include_suppressed=True)
    RACECHECK.reset()
    if q.committed() != q.end_offset():
        raise SystemExit(f"phase 15 (a): {q.committed()} of "
                         f"{q.end_offset()} doOrder messages committed")
    queued = [o for m in q.read_from(0, q.end_offset())
              for o in decode_message_orders(m.body)]
    oracle = OracleEngine()
    for o in queued:
        oracle.submit(o)
    want = oracle.drain()
    mq = svc.bus.match_queue
    got = [decode_match_result(m.body)
           for m in mq.read_from(0, mq.end_offset())]
    check_events("phase 15 (a) race drill", unstamped(got), unstamped(want))
    verdict = dict(
        seconds=drill_s, gateway_threads=threads,
        orders_accepted=sum(accepted), orders_rejected=sum(rejected),
        orders_queued=len(queued), events=len(got),
        events_fanned_out=svc.feed.events_seen,
        subscriber_events=sub_events[0], matchfeed_seq=svc.feed.seq.state(),
        race_reports_total=len(all_reports),
        race_reports_suppressed=len(all_reports) - len(reports),
        race_reports=[r.format() for r in reports], launches=launches,
        device_calls=svc.engine.stats.device_calls, worst=worst,
        kept_line=kept_line, kept_grids=kept_grids)
    if not (verdict["orders_accepted"] > 0 and verdict["events"] > 0) \
            or reports:
        raise SystemExit(f"phase 15 (a): race drill failed: {verdict}")
    if on_card and (
            launches <= 0 or launches != expected_launches(svc.engine)):
        raise SystemExit(f"phase 15 (a): {launches} K1 launches for "
                         f"{svc.engine.stats.device_calls} device calls")
    return verdict


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def events_sha(events) -> str:
    import hashlib

    return hashlib.sha256(repr(unstamped(events)).encode()).hexdigest()


def mesh_rank(args) -> dict:
    """One rank of phase 15 (b)'s mesh across processes: a process group
    on 127.0.0.1 (gloo when the ranks share a card or run on the CPU,
    NCCL when each owns one: parallel.mesh_backend), multihost_mesh with
    `n_local` shards on this rank's device, phase 3's Zipf flow through
    MatchEngine.process_frame(fast) in frames, and, with `grid`, one grid
    through sharded_batch_step. Every rank runs the same program; the
    result is this rank's."""
    import torch.distributed as dist

    from gome_tpu_torch.engine import BookConfig, BookState, DeviceOp, \
        MatchEngine
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.parallel import Sharded, mesh_backend, \
        multihost_mesh, shard_batch, sharded_batch_step
    from gome_tpu_torch.parallel import mesh as mesh_mod
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    t_boot = time.perf_counter()
    dev = torch.device(args.device)
    devices = [dev] * args.n_local
    backend = mesh_backend(devices, shared_card=bool(args.shared))
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{args.port}",
        rank=args.mesh_rank, world_size=args.world)
    try:
        mesh = multihost_mesh(args.n_local, devices=devices)
        cfg = BookConfig(cap=args.cap, max_fills=args.max_fills,
                         dtype=getattr(torch, args.dtype))
        orders = multi_symbol_stream(n=args.orders, n_symbols=args.symbols,
                                     zipf_a=1.2, cancel_prob=0.3, seed=7)
        frames = [frame_columns(orders[i:i + args.frame_n])
                  for i in range(0, len(orders), args.frame_n)]
        eng = MatchEngine(cfg, n_slots=args.symbols, max_t=args.max_t,
                          mesh=mesh)
        boot_s = time.perf_counter() - t_boot
        joins = [0.0, 0, 0]  # seconds, collectives, bytes this rank sent
        saved = mesh_mod.gather_ranks, Sharded.row

        def timed(fn):  # the host clock: gloo's collectives block it
            def run(*a, **kw):
                if fn is saved[0]:
                    joins[2] += sum(t.numel() * t.element_size()
                                    for t in a[1])
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    joins[0] += time.perf_counter() - t0
                    joins[1] += 1
            return run

        mesh_mod.gather_ranks, Sharded.row = map(timed, saved)
        batch_step.launches = 0
        try:
            with keep_kernel_inputs() as kept:
                got, secs = run_frames(eng, frames)
            launches = batch_step.launches
        finally:
            mesh_mod.gather_ranks, Sharded.row = saved
        label = f"phase 15 (b) rank {args.mesh_rank}"
        worst, kept_line = (check_kept_inputs(label, kept)
                            if dev.type == "cuda" else (0, ""))
        del kept
        eng.batch.verify_books()
        state = eng.batch.export_state()
        out = dict(
            rank=args.mesh_rank, backend=backend, mesh=repr(mesh),
            boot_s=boot_s, secs=secs, joins_s=joins[0], joins=joins[1],
            join_bytes=joins[2], frames=len(frames),
            n_events=len(got), events_sha=events_sha(got),
            digest=book_digest(eng), launches=launches,
            expected=expected_launches(eng), worst=worst,
            kept_line=kept_line,
            stats=dataclasses.asdict(eng.stats))
        if args.keep:
            out.update(events=got, state=state)
        if args.grid:
            with np.load(args.grid) as z:
                books = BookState(*(z[f"books_{f}"]
                                    for f in BookState._fields))
                ops = DeviceOp(*(z[f"ops_{f}"] for f in DeviceOp._fields))
            gcfg = dataclasses.replace(cfg, max_fills=min(cfg.max_fills,
                                                          cfg.cap))
            nb, no = sharded_batch_step(gcfg, mesh)(
                shard_batch(mesh, books), shard_batch(mesh, ops))
            out.update(grid_books=nb.host(), grid_outs=no.host())
        return out
    finally:
        dist.destroy_process_group()


def mesh_rank_worker(argv) -> int:
    """`--mesh-rank R ...`: one rank of phase 15 (b) (mesh_rank), its
    result pickled to --out."""
    import argparse
    import pickle

    ap = argparse.ArgumentParser(prog="chip_smoke.py --mesh-rank")
    ap.add_argument("--mesh-rank", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--grid", default="")
    ap.add_argument("--dtype", default="int32")
    for name, default in (("--world", MESH_RANKS), ("--port", 0),
                          ("--shared", 1), ("--n-local", MESH_LOCAL),
                          ("--symbols", 10240), ("--orders", 200_000),
                          ("--frame-n", 8192), ("--cap", 256),
                          ("--max-fills", 16), ("--max-t", 32),
                          ("--keep", 0)):
        ap.add_argument(name, type=int, default=default)
    args = ap.parse_args(argv)
    out = mesh_rank(args)
    with open(args.out, "wb") as fh:
        pickle.dump(out, fh)
    return 0


def mesh_ranks(work: str, devices, timeout_s: float = MESH_WAIT_S,
               **kw) -> list[dict]:
    """Phase 15 (b)'s ranks as fresh interpreters (`python3 chip_smoke.py
    --mesh-rank r ...`), rank r on devices[r]; the ranks share a card when
    two name the same one. kw: mesh_rank_worker's other options (symbols,
    orders, frame_n, cap, max_fills, max_t, dtype, grid, keep). Returns
    the ranks' results; fails (SystemExit) when a rank fails or the run
    outlasts timeout_s."""
    import pickle

    port = free_port()
    shared = int(len(set(map(str, devices))) < len(devices))
    procs, outs = [], []
    for r, dev in enumerate(devices):
        out = os.path.join(work, f"rank{r}.pkl")
        outs.append(out)
        cmd = [sys.executable, os.path.abspath(__file__), "--mesh-rank",
               str(r), "--out", out, "--device", str(dev), "--world",
               str(len(devices)), "--port", str(port), "--shared",
               str(shared)]
        for k, v in kw.items():
            cmd += [f"--{k.replace('_', '-')}", str(v)]
        log = open(out + ".log", "w")
        procs.append((subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, GLOO_SOCKET_IFNAME="lo")), log))
    deadline = time.monotonic() + timeout_s
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise SystemExit(f"phase 15 (b): the ranks outlasted {timeout_s} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results = []
    for r, ((p, _), out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            with open(out + ".log") as fh:
                raise SystemExit(f"phase 15 (b): rank {r} exited "
                                 f"{p.returncode}: {fh.read()[-2000:]}")
        with open(out, "rb") as fh:
            results.append(pickle.load(fh))
    return results


def lint_gate(label: str = "phase 15 (c)", *args) -> tuple[float, str]:
    """`python -m gome_tpu_torch.analysis gome_tpu_torch [args]` must exit
    0 (no finding outside the committed baseline): phase 15 (c) with no
    arguments, phase 16 (d) with GL9 and a journal. Returns (seconds, its
    summary line)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "gome_tpu_torch.analysis", "gome_tpu_torch",
         *args],
        capture_output=True, text=True, cwd=here, timeout=300)
    secs = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0:
        raise SystemExit(f"{label}: gomelint exited {r.returncode}: "
                         + "\n".join(lines[-20:]) + r.stderr[-2000:])
    return secs, lines[-1] if lines else ""


def phase15(card: str, device, sizes, want_zipf, p11) -> dict:
    """Phase 15: (a) the race drill on the card, (b) phase 11 (b)'s flow
    on a mesh of two processes (D = 4: two cuda:0 shards each, gloo;
    then, with two or more cards, one card each, NCCL), every rank's
    events equal to the oracle's, its books (state digest) equal to phase
    11 (b)'s single-process D = 4 engine's and K1 equal to its plain
    version at its inputs, (c) the port's gomelint. Returns the numbers;
    each part prints as it ends."""
    t_phase = time.perf_counter()
    v = race_drill(device, seconds=RACE_SECONDS, threads=4)
    print(f"phase 15 (a): race drill: EngineService with GOME_RACECHECK=1 "
          f"(lockset detector armed over MatchFeed, SeqTracker, "
          f"OrderConsumer), {v['gateway_threads']} gateway threads through "
          f"DoOrder/DeleteOrder for {RACE_SECONDS} s: "
          f"{v['orders_accepted']} orders "
          f"accepted, {v['orders_queued']} queued, {v['events']} events on "
          f"matchOrder equal to the oracle's over doOrder in its order; "
          f"{v['events_fanned_out']} fanned out, {v['subscriber_events']} "
          f"to the subscriber; {v['race_reports_total']} race reports "
          f"({v['race_reports_suppressed']} suppressed); {v['launches']} "
          f"K1 launches = device calls")
    print(v["kept_line"])
    print(f"phase 15 (a) [{card}]: {v['seconds']:.2f} s, "
          f"{v['orders_accepted'] / v['seconds']:,.0f} orders/s accepted")
    want_sha = events_sha(want_zipf)
    want_digest = p11["d4_digest"]
    p11b = p11["runs"][p11["d4_name"]]
    layouts = [("two ranks on cuda:0, gloo", ["cuda:0"] * MESH_RANKS)]
    if torch.cuda.device_count() >= MESH_RANKS:
        layouts.append(("a card per rank, NCCL",
                        [f"cuda:{r}" for r in range(MESH_RANKS)]))
    runs, worst, launches = {}, v["worst"], {}
    for name, devs in layouts:
        with tempfile.TemporaryDirectory(prefix="phase15b-") as work:
            ranks = mesh_ranks(work, devs, symbols=sizes["symbols"],
                               orders=sizes["zipf_n"],
                               frame_n=sizes["batch"])
        label = f"phase 15 (b) {name}"
        for r in ranks:
            if r["n_events"] != len(want_zipf) or r["events_sha"] != want_sha:
                raise SystemExit(f"{label}: rank {r['rank']}'s "
                                 f"{r['n_events']} events differ from the "
                                 f"oracle's {len(want_zipf)}")
            if r["digest"] != want_digest:
                raise SystemExit(f"{label}: rank {r['rank']}'s books differ "
                                 "from phase 11 (b)'s D=4 engine's")
            if r["launches"] <= 0 or r["launches"] != r["expected"]:
                raise SystemExit(f"{label}: rank {r['rank']}: "
                                 f"{r['launches']} K1 launches, "
                                 f"{r['expected']} expected")
            worst = max(worst, r["worst"])
            launches[f"{name} rank {r['rank']}"] = r["launches"]
            print(r["kept_line"])
        runs[name] = ranks
        print(f"{label}: {MESH_RANKS} fresh interpreters ({ranks[0]['mesh']}"
              f"): process_frame(fast) {sizes['zipf_n']} orders in frames "
              f"of {sizes['batch']} on every rank -> {ranks[0]['n_events']} "
              f"events equal to the oracle's, books verified and equal to "
              f"phase 11 (b)'s single-process D=4 engine's (state digest "
              f"{want_digest[:16]}); K1 launches "
              + ", ".join(str(r["launches"]) for r in ranks)
              + " (one per local shard per grid, = expected)")
        print(f"phase 15 (b) [{card}] {name}: "
              + "; ".join(f"rank {r['rank']} "
                          f"{sizes['zipf_n'] / r['secs']:,.0f} orders/s "
                          f"({r['secs']:.3f} s), cross-rank joins "
                          f"{r['joins_s']:.4f} s over {r['joins']} "
                          f"collectives ({r['join_bytes']:,} B sent, "
                          f"{r['frames']} frames, "
                          f"{r['stats']['frame_fallbacks']} run exactly; "
                          f"host clock), boot "
                          f"{r['boot_s']:.2f} s" for r in ranks)
              + f"; phase 11 (b) D=4 in one process "
              f"{sizes['zipf_n'] / p11b['secs']:,.0f} orders/s, output "
              f"gathers {p11b['gather_s']:.4f} s (CUDA-event span)")
    lint_s, lint_line = lint_gate()
    print(f"phase 15 (c) [{card}]: python -m gome_tpu_torch.analysis "
          f"gome_tpu_torch exited 0 in {lint_s:.2f} s ({lint_line})")
    secs = time.perf_counter() - t_phase
    print(f"phase 15 [{card}]: race drill, mesh across processes and "
          f"gomelint in {secs:.1f} s")
    return dict(race=v, runs=runs, worst=worst, launches=launches,
                race_launches=v["launches"], seconds=secs)


def phase15_alone() -> int:
    """`--phase15`: phase 11 (b)'s one-process D=4 run on cuda:0 (the
    books phase 15 (b) holds its ranks to), then phase 15; with two or
    more cards (b) runs a card a rank too. Exits 1 without a card."""
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    if not torch.cuda.is_available():
        print("chip_smoke --phase15: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    print(card)
    load_kernel(card)
    sizes = dict(symbols=10240, zipf_n=200_000, batch=8192)
    zipf = multi_symbol_stream(n=sizes["zipf_n"], n_symbols=sizes["symbols"],
                               zipf_a=1.2, cancel_prob=0.3, seed=7)
    want = oracle_events(zipf)
    frames = [frame_columns(zipf[i:i + sizes["batch"]])
              for i in range(0, len(zipf), sizes["batch"])]
    name = "D=4 on cuda:0"
    r = mesh_frame_run(f"phase 11 (b) {name}", device, sizes, frames, want,
                       one_card_mesh(device, 4))
    print(f"phase 11 (b) [{card}] {name}: {len(zipf) / r['secs']:,.0f} "
          f"orders/s ({r['secs']:.3f} s), output gathers "
          f"{r['gather_s']:.4f} s")
    phase15(card, device, sizes, want, dict(
        runs={name: r}, d4_name=name, d4_digest=book_digest(r["engine"])))
    print(f"chip_smoke --phase15 [{card}]: {time.perf_counter() - t0:.1f} s")
    return 0


# -- phase 16: fuzz, soak, the compile surface -------------------------------

FUZZ_SEED0 = 1000  # scripts/fuzz.py's default first seed
FUZZ_CASES = 100  # (a): run_case seeds FUZZ_SEED0 ...
FUZZ_SIM_SEED0 = 7000  # tests/test_fuzz.py's sim seeds
FUZZ_SIM_CASES = 4  # (a): run_sim_case seeds FUZZ_SIM_SEED0 ...
SOAK_SECONDS = 30.0  # (b)'s wall clock in the full script
SOAK_FAULT_COUNTERS = (
    "gome_gateway_retryable_rejects_total",
    "gome_gateway_spilled_frames_total",
    "gome_consumer_step_failures_total",
)
#: (b)'s settling, after svc_warmup: frames until the geometry manifest's
#: hash has held for SOAK_SETTLE_FRAMES frames in a row, at most
#: SOAK_SETTLE_MAX. At 10,240 symbols the mixed flow keeps minting combos
#: (the storage cap's escalation, deeper lanes' cap classes, rare
#: packed-op buckets) for well over a thousand frames after bench.py's
#: warm-up (8 to 12 frames, sized for 256 symbols): on the H100 at seed 11
#: the hash changed at frames 5, 230, 282, 713 and 1,697, so the hold is
#: longer than the widest gap between two changes (984 frames). The timed
#: window then has to mint nothing (geometry_stable); the report lists the
#: frames at which the hash changed.
SOAK_SETTLE_FRAMES = 1024
SOAK_SETTLE_MAX = 3072
#: (b)'s verdict bounds: scripts/soak.py's defaults.
SOAK_RSS_SLOPE_MB_PER_MIN = 8.0
SOAK_RSS_GROWTH_MB = 8.0
SOAK_RSS_BYTES_PER_ORDER = 256.0


def _fuzz_result(desc: str, engine, device, got, expected, **case) -> dict:
    """A fuzz case's check, as run_case ends: the events equal the
    oracle's, the books verify, and on the card K1 ran. Returns the case
    with its run_case-style line."""
    if got != expected:
        first = next((j for j, (a, b) in enumerate(zip(got, expected))
                      if a != b), min(len(got), len(expected)))
        raise SystemExit(
            f"DIVERGENCE [{desc}] events {len(got)} vs {len(expected)}, "
            f"first mismatch at {first}:\n got: "
            f"{got[first] if first < len(got) else '<none>'}\n exp: "
            f"{expected[first] if first < len(expected) else '<none>'}")
    engine.verify_books()
    if torch.device(device).type == "cuda" and case["launches"] <= 0:
        raise SystemExit(f"fuzz [{desc}]: no K1 launch")
    st = engine.stats
    return dict(
        case, events=got, cap_escalations=st.cap_escalations,
        record_escalations=st.fill_record_escalations,
        line=(f"OK [{desc}] events={len(got)} esc={st.cap_escalations}"
              f"/{st.fill_record_escalations}"))


def _fuzz_feed(engine, orders, mode: str, chunk: int) -> list:
    got = []
    for i in range(0, len(orders), chunk):
        part = orders[i:i + chunk]
        if mode == "columnar":
            got.extend(engine.process_columnar(part).to_results())
        else:
            got.extend(engine.process(part))
    return got


def fuzz_case(seed: int, device="cuda") -> dict:
    """scripts/fuzz.py's run_case on the port: the same
    np.random.default_rng(seed) draws in the same order (geometry, dtype,
    mode, orders, chunking; int32 <-> torch.int32), the port's engine
    against the port's oracle, then verify_books. On the card every case
    must launch K1. Fails (SystemExit) on a divergence; returns the case
    (its line equals run_case's for the seed: kernel=scan is the engine
    argument run_case passes by default, and both of the port's values run
    K1)."""
    from gome_tpu_torch.engine import BatchEngine, BookConfig
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.oracle import OracleEngine
    from gome_tpu_torch.types import Action, Order, OrderType, Side

    rng = np.random.default_rng(seed)
    cap = int(rng.choice([4, 8, 16, 64]))
    max_fills = int(rng.choice([1, 2, 4, 8]))
    max_t = int(rng.choice([1, 3, 16]))
    n_slots = int(rng.choice([1, 2, 8, 16]))
    dtype = torch.int32 if rng.random() < 0.5 else torch.int64
    mode = str(rng.choice(["object", "columnar", "frame"]))
    n_symbols = int(rng.choice([1, 3, 7]))
    base_price = int(rng.choice(
        [100, 10_000_000,
         10_000_000_000_000 if dtype == torch.int32 else 100_000]))
    band = int(rng.choice([3, 50, 5_000]))
    n_orders = int(rng.choice([50, 200]))
    market_p = float(rng.choice([0.0, 0.15]))
    cancel_p = float(rng.choice([0.0, 0.3]))
    chunk = int(rng.choice([1, 17, 64]))

    orders = []
    live: list[tuple[str, str, Side, int]] = []
    for i in range(n_orders):
        sym = f"s{int(rng.integers(n_symbols))}"
        if live and rng.random() < cancel_p:
            sym_o, oid, side_o, price_o = live[int(rng.integers(len(live)))]
            if rng.random() < 0.25:  # a deliberate miss
                price_o = price_o + int(rng.integers(1, band + 2))
            orders.append(Order(uuid="u", oid=oid, symbol=sym_o, side=side_o,
                                price=price_o, volume=0, action=Action.DEL))
            continue
        kind = OrderType.MARKET if rng.random() < market_p else OrderType.LIMIT
        side = Side(int(rng.integers(2)))
        price = (0 if (kind is OrderType.MARKET and rng.random() < 0.5)
                 else base_price + int(rng.integers(-band, band + 1)))
        orders.append(Order(uuid=f"u{int(rng.integers(3))}", oid=str(i),
                            symbol=sym, side=side, price=price,
                            volume=int(rng.integers(1, 30)),
                            order_type=kind))
        if kind is OrderType.LIMIT:
            live.append((sym, str(i), side, price))

    oracle = OracleEngine()
    expected = []
    for o in orders:
        expected.extend(oracle.process(o))

    k0 = batch_step.launches
    depth = 0
    config = BookConfig(cap=cap, max_fills=max_fills, dtype=dtype)
    if mode == "frame":
        from gome_tpu_torch.bus.colwire import decode_order_frame, encode_orders
        from gome_tpu_torch.engine import MatchEngine
        from gome_tpu_torch.engine.pipeline import FramePipeline

        depth = int(rng.choice([1, 2, 3]))
        meng = MatchEngine(config=config, n_slots=n_slots, max_t=max_t,
                           kernel="scan", device=device)
        engine = meng.batch
        for o in orders:
            meng.mark(o)
        pipe = FramePipeline(meng, depth=depth)
        got = []
        for i in range(0, len(orders), chunk):
            cols = decode_order_frame(encode_orders(orders[i:i + chunk]))
            for _tok, batch in pipe.feed(cols):
                got.extend(batch.to_results())
        for _tok, batch in pipe.flush():
            got.extend(batch.to_results())
    else:
        engine = BatchEngine(config, n_slots=n_slots, max_t=max_t,
                             kernel="scan", device=device)
        got = _fuzz_feed(engine, orders, mode, chunk)
    dt_name = str(dtype).removeprefix("torch.")
    desc = (f"seed={seed} cap={cap} K={max_fills} max_t={max_t} "
            f"slots={n_slots} dtype={dt_name} mode={mode}"
            f"{f'(depth={depth})' if depth else ''} kernel=scan "
            f"base={base_price} band={band} n={n_orders} chunk={chunk}")
    return _fuzz_result(desc, engine, device, got, expected, seed=seed,
                        mode=mode, dtype=dt_name, orders=orders,
                        launches=batch_step.launches - k0, k5=0)


def fuzz_sim_case(seed: int, device="cuda", orders=None) -> dict:
    """scripts/fuzz.py's run_sim_case on the port: the same rng draws for
    the flow (lanes, bins, excitation, rates, offsets, volumes), its grid
    count and the adversarial engine geometry. The flow is the port's
    simulator (sim.env, K5 and K1) on `device`, its grids linearized into
    orders (sim.replay.orders_from_grid) for the port's oracle and an
    engine of the drawn geometry, unless `orders` (a flow made elsewhere,
    e.g. the reference's jax.random flow for the same seed) is given."""
    from gome_tpu_torch.engine import BatchEngine, BookConfig
    from gome_tpu_torch.ops.hawkes_scan import hawkes_scan
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.oracle import OracleEngine
    from gome_tpu_torch.sim.env import EnvConfig, env_reset
    from gome_tpu_torch.sim.flow import FlowConfig
    from gome_tpu_torch.sim.replay import _record_step, grid_host, \
        orders_from_grid

    rng = np.random.default_rng(seed)
    flow = FlowConfig(
        n_lanes=int(rng.choice([2, 4, 7])),
        t_bins=int(rng.choice([32, 64])),
        excite_self=float(rng.choice([0.25, 0.45])),
        cancel_rate=float(rng.choice([0.8, 1.4, 2.0])),
        market_rate=float(rng.choice([0.2, 0.8])),
        offset_p=float(rng.choice([0.2, 0.5])),
        vol_max=int(rng.choice([5, 60])),
    )
    gen_cfg = EnvConfig(flow=flow,
                        book=BookConfig(cap=64, max_fills=8,
                                        dtype=torch.int32))
    n_grids = int(rng.choice([8, 20]))
    k0, s0 = batch_step.launches, hawkes_scan.launches
    if orders is None:
        state, _ = env_reset(gen_cfg, seed, device=device)
        orders = []
        for _ in range(n_grids):
            state, bg_ops, _info, _bins = _record_step(gen_cfg, state)
            orders.extend(orders_from_grid(grid_host(bg_ops)))

    oracle = OracleEngine()
    expected = []
    for o in orders:
        expected.extend(oracle.process(o))

    cap = int(rng.choice([4, 8, 16]))
    max_fills = int(rng.choice([1, 2, 4]))
    max_t = int(rng.choice([1, 3, 16]))
    n_slots = int(rng.choice([1, 2, flow.n_lanes]))
    dtype = torch.int32 if rng.random() < 0.5 else torch.int64
    mode = str(rng.choice(["object", "columnar"]))
    chunk = int(rng.choice([1, 17, 64]))
    engine = BatchEngine(BookConfig(cap=cap, max_fills=max_fills,
                                    dtype=dtype),
                         n_slots=n_slots, max_t=max_t, device=device)
    got = _fuzz_feed(engine, orders, mode, chunk)
    dt_name = str(dtype).removeprefix("torch.")
    desc = (f"seed={seed} SIM lanes={flow.n_lanes} t_bins={flow.t_bins} "
            f"grids={n_grids} n={len(orders)} cap={cap} K={max_fills} "
            f"max_t={max_t} slots={n_slots} dtype={dt_name} mode={mode} "
            f"chunk={chunk}")
    return _fuzz_result(desc, engine, device, got, expected, seed=seed,
                        mode=f"sim-{mode}", dtype=dt_name, orders=orders,
                        launches=batch_step.launches - k0,
                        k5=hawkes_scan.launches - s0)


def fuzz_drill(device, n: int = FUZZ_CASES, seed0: int = FUZZ_SEED0,
               n_sim: int = FUZZ_SIM_CASES, sim_seed0: int = FUZZ_SIM_SEED0,
               out=None) -> dict:
    """Phase 16 (a): n fuzz_case seeds from seed0 and n_sim fuzz_sim_case
    seeds from sim_seed0, each case's line written to `out` when given.
    Fails on the first divergence or case without K1. Returns the counts
    by mode and dtype, the escalations, K1 and K5 launches and the
    seconds."""
    t0 = time.perf_counter()
    by = collections.Counter()
    cap_esc = rec_esc = launches = k5 = events = 0
    cases = [(fuzz_case, s) for s in range(seed0, seed0 + n)]
    cases += [(fuzz_sim_case, s) for s in range(sim_seed0, sim_seed0 + n_sim)]
    for case, seed in cases:
        r = case(seed, device=device)
        if out is not None:
            out.write(r["line"] + f" k1={r['launches']} k5={r['k5']}\n")
        by[(r["mode"], r["dtype"])] += 1
        cap_esc += r["cap_escalations"]
        rec_esc += r["record_escalations"]
        launches += r["launches"]
        k5 += r["k5"]
        events += len(r["events"])
    return dict(cases=len(cases), by=dict(sorted(by.items())),
                cap_escalations=cap_esc, record_escalations=rec_esc,
                launches=launches, k5=k5, events=events,
                seconds=time.perf_counter() - t0)


def fuzz_text(f: dict) -> str:
    return (f"{f['cases']} cases in {f['seconds']:.1f} s "
            f"({f['cases'] / f['seconds']:.2f} cases/s), 0 divergences, "
            f"books verified; by mode and dtype: "
            + ", ".join(f"{m}/{d} {c}" for (m, d), c in f["by"].items())
            + f"; {f['events']} events; escalations cap "
            f"{f['cap_escalations']}, record {f['record_escalations']}; K1 "
            f"launches {f['launches']}"
            + (" (every case > 0)" if f["launches"] else "")
            + f", K5 launches {f['k5']}")


def soak_settle(engine, consumer, bus, make_frame) -> tuple[int, list]:
    """Frames through the stack until the geometry manifest's hash
    (obs.timeline.geometry_manifest_hash) holds for SOAK_SETTLE_FRAMES
    frames in a row, at most SOAK_SETTLE_MAX: the soak's own loop (one
    run_once a frame, frames in flight at the pipeline's depth), both logs
    compacted, then a drain. Returns the frames run and the frame numbers at which the
    hash changed."""
    from gome_tpu_torch.obs.timeline import geometry_manifest_hash

    mq = bus.match_queue
    last = geometry_manifest_hash(engine.batch)
    changes, held, n = [], 0, 0
    while held < SOAK_SETTLE_FRAMES and n < SOAK_SETTLE_MAX:
        gateway_step(engine, bus.order_queue, make_frame())
        consumer.run_once()
        mq.commit(mq.end_offset())
        mq.compact()
        bus.order_queue.compact()
        n += 1
        h = geometry_manifest_hash(engine.batch)
        if h == last:
            held += 1
        else:
            changes.append(n)
            last, held = h, 0
    consumer.drain()  # the timed loop starts with no frame in flight
    return n, changes


def rss_fit(samples: list[dict]) -> dict:
    """scripts/soak.py's _rss_fit: least-squares RSS slope, growth and
    growth per processed order over the sample window."""
    t = np.asarray([s["t"] for s in samples], np.float64)
    rss = np.asarray([s["rss_bytes"] for s in samples], np.float64)
    slope = (float(np.polyfit(t - t[0], rss, 1)[0])
             if len(t) >= 2 and t[-1] > t[0] else 0.0)
    growth = int(rss[-1] - rss[0]) if len(rss) else 0
    orders = int(samples[-1]["orders"] - samples[0]["orders"]) \
        if samples else 0
    return {
        "samples": len(samples),
        "window_s": round(float(t[-1] - t[0]), 3) if len(t) else 0.0,
        "slope_bytes_per_s": round(slope, 1),
        "slope_mb_per_min": round(slope * 60 / 2**20, 3),
        "growth_bytes": growth,
        "window_orders": orders,
        "growth_bytes_per_order": round(growth / max(orders, 1), 2),
        "first_bytes": int(rss[0]) if len(rss) else 0,
        "last_bytes": int(rss[-1]) if len(rss) else 0,
    }


def soak_drill(device, seconds: float = SOAK_SECONDS, symbols: int = 10240,
               cap: int = 256, max_fills: int = 16, frame_n: int = 8192,
               depth: int = 2, interval: float = 1.0, seed: int = 11,
               gate=None) -> dict:
    """Phase 16 (b), scripts/soak.py's run_soak on the port: the mixed
    flow (MixedFlow) through gateway steps (encode, mark_frame, publish)
    and an OrderConsumer (frame wire, memory bus, `depth`) on an int32
    engine, warmed off the record (svc_warmup, then soak_settle until
    the geometry holds still), then a wall-clock closed
    loop for `seconds` with the timeline sampler armed (obs.timeline
    service_timeline) and the compile journal installed before the
    warm-up; the match queue drained and decoded, both logs compacted.
    Verdicts: live_buffers_flat (obs.live.assert_steady_state over 6
    further frames after 3 to settle), rss_bounded (slope, growth or
    bytes per order), geometry_stable (stricter than scripts/soak.py's
    last half: one geometry hash over every sample of the timed window
    and no combo minted in it), zero_breaker_trips; then the journal's
    export against the committed combo universe (GL906,
    analysis.surface.journal_escapes). K1's inputs from the warm-up, the
    settling and the timed loop are kept (keep_kernel_inputs) and, on the
    card, held against its plain version after the count is read. Fails
    (SystemExit) unless every verdict passes, nothing escapes and K1
    agrees. `gate`, if given, is called with the warm-up's and the
    settling's numbers between the settling and the timed loop, and the
    loop starts when it returns (DrillWorker). Returns the report."""
    import types as pytypes

    from gome_tpu_torch.bus.colwire import decode_event_frame
    from gome_tpu_torch.bus import MemoryQueue, QueueBus
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.obs import JOURNAL, live
    from gome_tpu_torch.obs.timeline import TIMELINE, service_timeline
    from gome_tpu_torch.ops import match_step
    from gome_tpu_torch.service import OrderConsumer
    from gome_tpu_torch.utils.metrics import REGISTRY

    engine = MatchEngine(BookConfig(cap=cap, max_fills=max_fills,
                                    dtype=torch.int32),
                         n_slots=symbols, max_t=32, device=device)
    bus = QueueBus(MemoryQueue("doOrder"), MemoryQueue("matchOrder"))
    consumer = OrderConsumer(engine, bus, batch_n=1, batch_wait_s=0,
                             match_wire="frame", pipeline_depth=depth)
    flow = MixedFlow(np.random.default_rng(seed), symbols)
    names = [f"sym{i}" for i in range(symbols)]

    def make_frame():
        return dict(flow.frame(frame_n), symbols=names, uuids=MIXED_UUIDS)

    monitor = live.service_monitor(engine)
    JOURNAL.install(keep_n=256)
    k1 = match_step.batch_step  # the wrapper, not keep_kernel_inputs' keeper
    try:
        with keep_kernel_inputs() as kept:
            t0 = time.perf_counter()
            n_warm = svc_warmup(engine, consumer, bus, make_frame)
            warm_s = time.perf_counter() - t0
            n_settle, settle_changes = soak_settle(engine, consumer, bus,
                                                   make_frame)
            settle_s = time.perf_counter() - t0 - warm_s
            sync(torch.device(device))
            if gate is not None:
                gate(dict(warmup_frames=n_warm, warmup_s=warm_s,
                          settle_frames=n_settle, settle_s=settle_s))
            manifest0 = engine.batch.shape_manifest()
            TIMELINE.install(interval_s=interval, keep_n=4096)
            service_timeline(pytypes.SimpleNamespace(engine=engine, bus=bus))
            faults0 = {n: int(REGISTRY.counter(n).value())
                       for n in SOAK_FAULT_COUNTERS}
            k0 = k1.launches
            TIMELINE.sample()
            TIMELINE.start()
            mq = bus.match_queue
            frames = orders = done = events = 0
            n_combos, window_changes = engine.batch.combo_count(), []
            ev_off = mq.end_offset()
            deadline = time.monotonic() + seconds
            t0 = time.perf_counter()
            while time.monotonic() < deadline:
                cols = make_frame()
                gateway_step(engine, bus.order_queue, cols)
                frames += 1
                orders += int(cols["n"])
                done += consumer.run_once()
                for m in mq.read_from(ev_off, 1 << 20):
                    events += len(decode_event_frame(m.body))
                    ev_off = m.offset + 1
                mq.commit(ev_off)
                mq.compact()
                bus.order_queue.compact()
                if engine.batch.combo_count() != n_combos:
                    n_combos = engine.batch.combo_count()
                    window_changes.append(n_settle + frames)
            done += consumer.drain()
            for m in mq.read_from(ev_off, 1 << 20):
                events += len(decode_event_frame(m.body))
                ev_off = m.offset + 1
            elapsed = time.perf_counter() - t0
            TIMELINE.stop()
            TIMELINE.sample()
            launches = k1.launches - k0
        manifest1 = engine.batch.shape_manifest()
        new_combos = sorted(set(manifest1["combos"])
                            - set(manifest0["combos"]))
        if done != orders:
            raise SystemExit(f"phase 16 (b): the consumer committed {done} "
                             f"of {orders} orders")
        series = TIMELINE.series()
        faults = {n: int(REGISTRY.counter(n).value()) - faults0[n]
                  for n in SOAK_FAULT_COUNTERS}
        verdicts: dict = {}

        def step():
            gateway_step(engine, bus.order_queue, make_frame())
            consumer.drain()

        try:
            leak = live.assert_steady_state(step, steps=6, settle=3)
            verdicts["live_buffers_flat"] = {
                "pass": True, "leaked": leak["leaked"],
                "baseline": leak["baseline"], "counts": leak["counts"]}
        except AssertionError as exc:
            verdicts["live_buffers_flat"] = {"pass": False,
                                             "detail": str(exc)}
        steady = series[max(len(series) * 2 // 5, 1):] or series
        fit = rss_fit(steady)
        fit["pass"] = (
            fit["slope_mb_per_min"] <= SOAK_RSS_SLOPE_MB_PER_MIN
            or fit["growth_bytes"] <= SOAK_RSS_GROWTH_MB * 2**20
            or fit["growth_bytes_per_order"] <= SOAK_RSS_BYTES_PER_ORDER)
        verdicts["rss_bounded"] = fit
        window = [s["engine"]["geometry_hash"] for s in series
                  if isinstance(s.get("engine"), dict)
                  and "geometry_hash" in s["engine"]]
        verdicts["geometry_stable"] = {
            "pass": bool(window) and len(set(window)) == 1 and not new_combos,
            "hashes": sorted(set(window)), "window_samples": len(window),
            "new_combos": new_combos, "changed_at_frames": window_changes}
        degraded = sum(1 for s in series
                       if isinstance(s.get("batcher"), dict)
                       and s["batcher"].get("degraded"))
        verdicts["zero_breaker_trips"] = {
            "pass": degraded == 0 and all(v == 0 for v in faults.values()),
            "degraded_samples": degraded, "fault_counter_deltas": faults}
        verdicts["pass"] = all(v["pass"] for v in verdicts.values()
                               if isinstance(v, dict))
        journal = JOURNAL.export()
    finally:
        TIMELINE.disable()
        JOURNAL.disable()
        del monitor
    engine.batch.verify_books()
    st = engine.batch.stats
    report = dict(
        seconds_requested=seconds, seconds_elapsed=elapsed,
        warmup_frames=n_warm, warmup_s=warm_s, settle_frames=n_settle,
        settle_s=settle_s, settle_changes=settle_changes,
        new_combos=new_combos,
        floors_moved={k: (v, manifest1["floors"][k])
                      for k, v in manifest0["floors"].items()
                      if manifest1["floors"][k] != v},
        frames=frames, orders=orders,
        events=events, orders_per_s=orders / max(elapsed, 1e-9),
        launches=launches, cap=engine.batch.config.cap,
        cap_escalations=st.cap_escalations,
        frame_fallbacks=st.frame_fallbacks, verdicts=verdicts,
        samples=len(series), journal=journal,
        combos=engine.batch.combo_count())
    if not verdicts["pass"]:
        raise SystemExit("phase 16 (b): soak verdict failed: " + json.dumps(
            {k: v for k, v in report.items() if k != "journal"},
            default=str))
    report["dispatches"] = journal_check("phase 16 (b)", journal)
    on_card = torch.device(device).type == "cuda"
    if on_card and launches <= 0:
        raise SystemExit("phase 16 (b): the soak launched no K1")
    report["worst"], report["kept_line"] = (
        check_kept_inputs("phase 16 (b)", kept) if on_card else (0, ""))
    report["kept_grids"] = len(distinct_kept(kept, "batch_step"))
    return report


def soak_text(r: dict) -> str:
    v = r["verdicts"]
    fit, lb, geo = v["rss_bounded"], v["live_buffers_flat"], \
        v["geometry_stable"]
    return (f"{r['frames']} frames, {r['orders']:,} orders, "
            f"{r['events']:,} events in {r['seconds_elapsed']:.2f} s "
            f"({r['orders_per_s']:,.0f} orders/s; warm-up {r['warmup_frames']}"
            f" frames in {r['warmup_s']:.2f} s, then {r['settle_frames']} "
            f"frames in {r['settle_s']:.2f} s settling until the geometry "
            f"held for {SOAK_SETTLE_FRAMES} (at most {SOAK_SETTLE_MAX}), its "
            f"hash changing at frames {r['settle_changes']}), "
            f"{r['launches']} K1 launches,"
            f" cap {r['cap']} ({r['cap_escalations']} escalations, "
            f"{r['frame_fallbacks']} exact fallbacks), {r['samples']} timeline"
            f" samples; verdicts: live_buffers_flat (baseline "
            f"{lb['baseline']}, leaked {lb['leaked']}), rss_bounded (slope "
            f"{fit['slope_mb_per_min']} MB/min, growth "
            f"{fit['growth_bytes'] / 2**20:.2f} MiB, "
            f"{fit['growth_bytes_per_order']} B/order over "
            f"{fit['window_orders']:,} orders), geometry_stable (one hash "
            f"{geo['hashes'][0][:12]} over all {geo['window_samples']} "
            f"samples, no combo minted in the window), "
            f"zero_breaker_trips; journal {r['dispatches']} first-seen "
            f"dispatch combos ({r['combos']} recorded), 0 GL906 escapes")


def committed_universe() -> dict:
    """gome_tpu_torch/analysis/combo_universe.json of this checkout."""
    from gome_tpu_torch.analysis.surface import DEFAULT_UNIVERSE, load_universe

    universe = load_universe(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), DEFAULT_UNIVERSE))
    if universe is None:
        raise SystemExit("phase 16: no committed combo universe")
    return universe


def journal_check(label: str, export: dict) -> int:
    """GL906 over one compile-journal export against the committed
    universe, in process. Fails on an escape; returns the dispatch combos
    checked."""
    from gome_tpu_torch.analysis.surface import journal_escapes

    escapes = journal_escapes(export["entries"], committed_universe())
    if escapes:
        raise SystemExit(f"{label}: {len(escapes)} dispatch combo(s) escape "
                         f"the committed universe: {escapes[:4]}")
    return sum(1 for e in export["entries"]
               if e.get("entry") == "frame_dispatch")


def phase16(card: str, device, journals: dict, drills: DrillWorker) -> dict:
    """Phase 16: (a) the fuzz drill and (b) the soak drill with its
    verdict and GL906 over its journal, both in `drills`, a fresh
    interpreter started before phase 9, (c) GL906 over phases 13 and 14's
    journal exports, (d) `python -m gome_tpu_torch.analysis
    gome_tpu_torch --select GL9 --journal <(b)'s export>` (GL901-GL905
    over the tree, GL906 over the soak) exits 0. Returns the numbers."""
    t_phase = time.perf_counter()
    f = drills.fuzz()
    kinds = {m for m, _ in f["by"]} & {"object", "columnar", "frame"}
    dtypes = {d for _, d in f["by"]}
    if kinds != {"object", "columnar", "frame"} or \
            dtypes != {"int32", "int64"}:
        raise SystemExit(f"phase 16 (a): the seeds covered {sorted(kinds)} "
                         f"x {sorted(dtypes)} only")
    print(f"phase 16 (a) [{card}]: the fuzz drill (scripts/fuzz.py's cases, "
          f"seeds {FUZZ_SEED0}..{FUZZ_SEED0 + FUZZ_CASES - 1} and sim seeds "
          f"{FUZZ_SIM_SEED0}..{FUZZ_SIM_SEED0 + FUZZ_SIM_CASES - 1}) against "
          f"the port's oracle, run first in the drill worker, beside phase "
          f"9 (this phase waited {f['wait_s']:.1f} s for it): "
          + fuzz_text(f))
    s = drills.soak()
    print(f"phase 16 (b) [{card}]: the soak drill, {SOAK_SECONDS:g} s at "
          f"10,240 symbols x cap 256 (storage cap {s['cap']:,} after the "
          f"settling) x K 16, int32, frames of 8,192, depth 2, memory bus, "
          f"frame wire, in the drill worker after the fuzz: its warm-up and "
          f"settling ran beside phases 9 onward, its timed loop alone, "
          f"{s['started_s']:.1f} s after the worker started (this phase "
          f"waited {s['settle_wait_s']:.1f} s for the settling): "
          + soak_text(s))
    print(s["kept_line"])
    checked = {name: journal_check(f"phase 16 (c) {name}", doc)
               for name, doc in journals.items()}
    print(f"phase 16 (c) [{card}]: GL906 over the compile journals of "
          + ", ".join(f"{name} ({n} dispatch combos)"
                      for name, n in checked.items())
          + ": 0 escapes from gome_tpu_torch/analysis/combo_universe.json")
    with tempfile.TemporaryDirectory(prefix="phase16-") as work:
        path = os.path.join(work, "soak_journal.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(s["journal"], fh, default=list)
        lint_s, lint_line = lint_gate("phase 16 (d)", "--select", "GL9",
                                      "--journal", path)
    print(f"phase 16 (d) [{card}]: python -m gome_tpu_torch.analysis "
          f"gome_tpu_torch --select GL9 --journal <(b)'s export> exited 0 in "
          f"{lint_s:.2f} s (GL901-GL905 over the tree, GL906 over the soak; "
          f"{lint_line})")
    secs = time.perf_counter() - t_phase
    print(f"phase 16 [{card}]: fuzz, soak and the compile surface in "
          f"{secs:.1f} s")
    return dict(fuzz=f, soak=s, journals=checked, seconds=secs,
                worst=s["worst"],
                launches=dict(fuzz=f["launches"], soak=s["launches"]))


def warm_prefix_slices(eng, combos) -> None:
    """gome_tpu's precompile_combos warm-up of its _prefix_slice_fn, on
    the port: each recorded fill and cancel buffer's used prefix copied to
    the host at every pow2 length from 64."""
    from gome_tpu_torch.engine import frames

    wide = torch.promote_types(torch.int32, eng.config.dtype)
    for n_fields, e in sorted({
        (len(fields), c[col]) for c in combos if len(c) == 9
        for fields, col in ((frames._FILL_FIELDS, 6),
                            (frames._CANCEL_FIELDS, 7))
    }):
        zeros = torch.zeros((n_fields, e), dtype=wide,
                            device=eng.batch.device)
        length = e
        while length >= 64:
            frames._prefix_slice_fn(zeros, length)
            length //= 2
    sync(eng.batch.device)


def prefix_warm_ab(rounds: int = 3) -> int:
    """`--prefix-warm-ab`: whether warming phase 2's prefix slices after
    load_geometry (warm_prefix_slices) moves phase 14 (c)'s warm first
    frames. Phase 14 (c)'s manifest flow (phase 6's engine over the Zipf
    flow), then `rounds` rounds of four fresh engines after load_geometry
    in the order plain, slices, slices, plain; each engine's first
    GEOMETRY_FRAMES frames timed (first_frames), their events equal
    across engines. Exits 1 without a card."""
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    if not torch.cuda.is_available():
        print("chip_smoke --prefix-warm-ab: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    print(card)
    load_kernel(card)
    sizes = dict(symbols=10240, zipf_n=200_000, batch=8192)
    zipf = multi_symbol_stream(n=sizes["zipf_n"], n_symbols=sizes["symbols"],
                               zipf_a=1.2, cancel_prob=0.3, seed=7)
    frame_list = [frame_columns(zipf[i:i + sizes["batch"]])
                  for i in range(0, len(zipf), sizes["batch"])]
    times, warm_s, first = {"plain": [], "slices": []}, [], None
    with tempfile.TemporaryDirectory(prefix="prefix-ab-") as work:
        path = os.path.join(work, "geometry.json")
        eng, _, _ = consumer_stack(device, sizes["symbols"], 0)
        run_frames(eng, frame_list)
        eng.save_geometry(path)
        combos = eng.batch.shape_manifest()["combos"]
        del eng
        for _ in range(rounds):
            for tag in ("plain", "slices", "slices", "plain"):
                torch.cuda.empty_cache()
                eng, _, _ = consumer_stack(device, sizes["symbols"], 0)
                eng.load_geometry(path)
                if tag == "slices":
                    t1 = time.perf_counter()
                    warm_prefix_slices(eng, combos)
                    warm_s.append(time.perf_counter() - t1)
                events, secs = first_frames(eng, frame_list[:GEOMETRY_FRAMES])
                flat = [e for b in events for e in b]
                if first is None:
                    first = flat
                elif flat != first:
                    raise SystemExit("--prefix-warm-ab: events differ "
                                     "between engines")
                times[tag].append(sum(secs))
                del eng
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"chip_smoke --prefix-warm-ab [{card}]: first {GEOMETRY_FRAMES} "
          f"frames after load_geometry ({len(combos)} combos), {rounds} "
          f"rounds of plain, slices, slices, plain: plain "
          + ", ".join(f"{t:.4f}" for t in times["plain"])
          + " s (median " + f"{med['plain']:.4f}), slices "
          + ", ".join(f"{t:.4f}" for t in times["slices"])
          + f" s (median {med['slices']:.4f}; the warm-up itself "
          f"{float(np.median(warm_s)):.4f} s); slices / plain "
          f"{med['slices'] / med['plain']:.4f}; events equal in all "
          f"{4 * rounds}; {time.perf_counter() - t0:.1f} s")
    return 0


def drill_alone(argv) -> int:
    """`--soak SECONDS` / `--fuzz N [SEED0]`: one drill alone on the card,
    its report printed. Exits 1 without a card."""
    if not torch.cuda.is_available():
        print(f"chip_smoke {argv[0]}: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = card_line()
    print(card)
    load_kernel(card)
    if argv[0] == "--soak":
        seconds = float(argv[1]) if len(argv) > 1 else SOAK_SECONDS
        s = soak_drill("cuda", seconds=seconds)
        print(f"chip_smoke --soak [{card}]: {seconds:g} s at 10,240 symbols "
              f"x cap 256 (storage cap {s['cap']:,} after the settling) x "
              f"K 16, int32, frames of 8,192, depth 2: " + soak_text(s))
        print(s["kept_line"])
        print(json.dumps({k: v for k, v in s.items() if k != "journal"},
                         default=str))
    else:
        n = int(argv[1]) if len(argv) > 1 else FUZZ_CASES
        seed0 = int(argv[2]) if len(argv) > 2 else FUZZ_SEED0
        f = fuzz_drill("cuda", n=n, seed0=seed0, out=sys.stdout)
        print(f"chip_smoke --fuzz [{card}]: seeds {seed0}..{seed0 + n - 1} "
              f"and sim seeds {FUZZ_SIM_SEED0}.."
              f"{FUZZ_SIM_SEED0 + FUZZ_SIM_CASES - 1}: " + fuzz_text(f))
        print(json.dumps({k: (str(v) if k == "by" else v)
                          for k, v in f.items()}))
    print(f"chip_smoke {argv[0]} [{card}]: {time.perf_counter() - t0:.1f} s")
    return 0


# -- phase 17: the operator artifacts' drivers --------------------------------

#: (a)'s capacity smoke ladder at the main path's width (10,240 symbols,
#: cap 256, K 16, int32, memory bus, frame wire): 4 points over 3 s of
#: ladder (at most 12 s), every order it sends held against the oracle.
P17_CAPACITY = dict(seconds=3.0, points=4, symbols=10240, cap=256,
                    batch_n=256, dtype="int32")
#: (b)'s timed steps a point (part A's chains, the curve's).
P17_MESH_REPS = (20, 5)
#: (c): each committed artifact of the port and what its schema check
#: reads: (key, value) pairs the document must hold.
CUDA_ARTIFACTS = {
    "PLACEMENT_CUDA_r01": (("schema", "gome-placement-verdict-v1"),),
    "MULTICHIP_CUDA_r01": (("artifact", "MULTICHIP_CUDA_r01"),),
    "FLEET_CUDA_r01": (("schema", "gome-fleet-verdict-v1"),
                       ("artifact", "FLEET_CUDA_r01"), ("pass", True)),
    "CAPACITY_CUDA_r01": (("schema", "gome-capacity-verdict-v1"),
                          ("artifact", "CAPACITY_CUDA_r01"),
                          ("mode", "fleet"), ("pass", True)),
    "HOSTPROF_CUDA_r01": (("artifact", "HOSTPROF_CUDA_r01"),),
    "HOSTPROF_CUDA_r02": (("artifact", "HOSTPROF_CUDA_r02"),),
}


def load_cuda_artifacts() -> dict:
    """Phase 17 (c): every committed *_CUDA_r0N.json at the repo root,
    each with its schema and (all but the host-deterministic placement
    verdict) an NVIDIA card in its provenance."""
    here = os.path.dirname(os.path.abspath(__file__))
    docs = {}
    for name, keys in CUDA_ARTIFACTS.items():
        with open(os.path.join(here, f"{name}.json"), encoding="utf-8") as f:
            doc = json.load(f)
        bad = [(k, doc.get(k)) for k, v in keys if doc.get(k) != v]
        card = (doc.get("provenance") or {}).get("card") or ""
        if bad or (name != "PLACEMENT_CUDA_r01" and "NVIDIA" not in card):
            raise SystemExit(f"phase 17 (c): {name}.json has {bad}, card "
                             f"{card!r}")
        docs[name] = doc
    capacity_artifact_check(docs["CAPACITY_CUDA_r01"])
    return docs


def capacity_artifact_check(doc: dict) -> None:
    """Phase 17 (c): the committed fleet capacity verdict holds every
    check of its own (the reference's attribution check, within 5% at
    the knee, among them), brackets its knee (an index neither None nor
    0) and audits zero seq dupes and gaps at every point."""
    failed = [k for k, ok in doc["checks"].items() if not ok]
    knee = doc["knee"].get("index")
    eo = [(p["exactly_once"]["dupes"], p["exactly_once"]["gaps"])
          for p in doc["ladder"]]
    if failed or not doc["pass"] or \
            "attribution_within_tol_at_knee" not in doc["checks"] or \
            not knee or any(eo_p != (0, 0) for eo_p in eo):
        raise SystemExit(f"phase 17 (c): CAPACITY_CUDA_r01.json fails "
                         f"{failed}, knee index {knee}, dupes/gaps {eo}")


def phase17a(device) -> tuple[dict, int, int, str]:
    """Phase 17 (a): obs_snapshot on the card into a temporary directory,
    its capacity smoke ladder at P17_CAPACITY: the ladder's events equal
    the oracle's for exactly the orders sent, zero seq dupes and gaps,
    attribution within 5% at every point, offered rates strictly
    increasing (each asserted inside snapshot and again here). Returns
    the summary, K1's launches, the worst |err| at the kept inputs and
    their line."""
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.scripts import obs_snapshot

    with tempfile.TemporaryDirectory(prefix="phase17a-") as out, \
            keep_kernel_inputs() as kept:
        batch_step.launches = 0
        s = obs_snapshot.snapshot(out, str(device), capacity=P17_CAPACITY)
        launches = batch_step.launches
        files = sorted(os.listdir(out))
    v = s["capacity"]
    ladder = v["ladder"]
    offered = [p["offered_per_sec"] for p in ladder]
    bad = [name for name, ok in (
        ("events_equal_oracle", v["oracle"]["equal"]),
        ("seq", v["seq"]["dupes"] == 0 and v["seq"]["gaps"] == 0
         and all(p["exactly_once"]["dupes"] == 0
                 and p["exactly_once"]["gaps"] == 0 for p in ladder)),
        ("attribution", all(p["attribution"]["within_tol"]
                            and p["attribution"]["frac_err"] <= 0.05
                            for p in ladder)),
        ("offered", all(b > a for a, b in zip(offered, offered[1:]))),
        ("points", len(ladder) == P17_CAPACITY["points"]),
        # (the plain version runs on the CPU: no launches to count there)
        ("launches", launches > 0 or str(device) == "cpu")) if not ok]
    if bad:
        raise SystemExit(f"phase 17 (a): {bad} failed: oracle {v['oracle']}, "
                         f"seq {v['seq']}, ladder {offered}, {launches} K1 "
                         "launches")
    worst, line = check_kept_inputs("phase 17 (a)", kept)
    s["files"] = files
    return s, launches, worst, line


def phase17b(device, artifact: dict) -> dict:
    """Phase 17 (b): mesh_overhead part A at 10,240 x 32 (the unsharded
    and D=1 outputs equal), then the curve at D = 1, 2, 4, 8 on cuda:0
    (every D's books and outputs equal to the unsharded step's, inside
    curve()), each D's live_per_shard and dispatched_rows equal to the
    committed MULTICHIP_CUDA_r01.json's and to part B's arithmetic
    (dense_geometry on the same live set)."""
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.scripts import mesh_overhead as mo

    with keep_kernel_inputs() as kept:
        batch_step.launches = 0
        a = mo.part_a(str(device), reps=P17_MESH_REPS[0])
        c = mo.curve(str(device), reps=P17_MESH_REPS[1], profile=False)
        launches = batch_step.launches
    if a["full_max_abs_err"] or a["dense_max_abs_err"] or \
            (launches <= 0 and str(device) != "cpu"):
        raise SystemExit(f"phase 17 (b): part A max |err| full "
                         f"{a['full_max_abs_err']}, dense "
                         f"{a['dense_max_abs_err']}; {launches} K1 launches")
    _, live = mo.curve_live_set()
    committed = {p["devices"]: p for p in artifact["curve"]}
    for p in c["curve"]:
        d = p["devices"]
        geo = mo.dense_geometry(live, mo.C_SYMBOLS, d)
        want = (committed[d]["live_per_shard"], committed[d]["dispatched_rows"])
        for name, w in (("MULTICHIP_CUDA_r01.json", want),
                        ("part B's arithmetic", (geo["live_per_shard"],
                                                 geo["dispatched_rows"]))):
            if (p["live_per_shard"], p["dispatched_rows"]) != tuple(w):
                raise SystemExit(
                    f"phase 17 (b): D={d} live_per_shard/dispatched_rows "
                    f"{p['live_per_shard']}/{p['dispatched_rows']} against "
                    f"{name}'s {w}")
        if p["max_abs_err_vs_unsharded"]:
            raise SystemExit(f"phase 17 (b): D={d} differs from the "
                             "unsharded step")
    worst, line = check_kept_inputs("phase 17 (b)", kept)
    return dict(a=a, curve=c, launches=launches, worst=worst, line=line)


def phase17c(docs: dict, placement: dict) -> None:
    """Phase 17 (c): build_verdict() byte-equal to PLACEMENT_CUDA_r01.json;
    the /placement that (a)'s EngineService served (ops.placement armed)
    carries that verdict, and its attribution's baselines cite
    MULTICHIP_CUDA_r01 and FLEET_CUDA_r01 with their numbers."""
    from gome_tpu_torch.scripts import placement_eval

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "PLACEMENT_CUDA_r01.json"),
              encoding="utf-8") as f:
        text = f.read()
    if placement_eval.verdict_text(placement_eval.build_verdict()) != text:
        raise SystemExit("phase 17 (c): build_verdict() differs from "
                         "PLACEMENT_CUDA_r01.json")
    attr = placement["attribution"]
    skew = next(c["baseline"] for c in attr["components"]
                if c["component"] == "lane_placement_skew")
    mesh_last = docs["MULTICHIP_CUDA_r01"]["curve"][-1]
    imb = docs["FLEET_CUDA_r01"]["table"]["imbalance"]
    want_skew = {"artifact": "MULTICHIP_CUDA_r01",
                 "devices": mesh_last["devices"],
                 "shard_skew": mesh_last["shard_skew"],
                 "rows_per_live_lane": mesh_last["rows_per_live_lane"]}
    want_imb = {"artifact": "FLEET_CUDA_r01",
                "max_over_min_orders": imb["max_over_min_orders"],
                "orders_per_partition": imb["orders_per_partition"]}
    if placement["verdict"] != docs["PLACEMENT_CUDA_r01"] or \
            skew != want_skew or \
            attr["hash_partition"]["baseline"] != want_imb:
        raise SystemExit(f"phase 17 (c): /placement verdict "
                         f"{(placement['verdict'] or {}).get('artifact')}, "
                         f"baselines {skew}, "
                         f"{attr['hash_partition']['baseline']}")


def phase17d() -> dict:
    """Phase 17 (d): bench_admit() and hostprof_artifact(path="columnar")
    at small round counts, each drill's stage coverage >= 80%."""
    from gome_tpu_torch.obs import hostprof

    admit = hostprof.bench_admit(n_orders=8192, min_samples=64)
    art = hostprof.hostprof_artifact(n_orders=8192, min_samples=64,
                                     max_rounds=8, path="columnar",
                                     artifact="HOSTPROF_CUDA_r02")
    cover = [admit["scalar"]["coverage_pct"], admit["columnar"]["coverage_pct"],
             art["drill"]["coverage_pct"]]
    if min(cover) < 80.0:
        raise SystemExit(f"phase 17 (d): stage coverage {cover} (< 80%)")
    return dict(admit=admit, artifact=art, coverage=cover)


def phase17(card: str, device) -> dict:
    """Phase 17: the operator artifacts' drivers (gome_tpu_torch/scripts)
    on the card and the committed artifacts they wrote: (a) the snapshot
    with its capacity ladder, (b) the mesh's part A and curve, (c) the
    artifacts and /placement, (d) the host profile."""
    t0 = time.perf_counter()
    docs = load_cuda_artifacts()
    s, a_launches, a_worst, a_line = phase17a(device)
    t_a = time.perf_counter() - t0
    b = phase17b(device, docs["MULTICHIP_CUDA_r01"])
    t_b = time.perf_counter() - t0 - t_a
    phase17c(docs, s["placement"])
    d = phase17d()
    secs = time.perf_counter() - t0
    v = s["capacity"]
    cfg, knee = v["config"], v["knee"]
    print(f"phase 17 (a): obs_snapshot on {device}: {len(s['files'])} files "
          f"({', '.join(s['files'])}); capacity ladder at {cfg['symbols']:,} "
          f"symbols, cap {cfg['cap']}, K {cfg['max_fills']}, {cfg['dtype']}, "
          f"frames of {cfg['batch_n']}: {v['oracle']['orders']:,} orders, "
          f"{v['oracle']['events']:,} events equal to the oracle's, seq "
          f"audit {v['seq']}, attribution err "
          + "/".join(f"{p['attribution']['frac_err']:.4f}"
                     for p in v["ladder"])
          + f"; {a_launches} K1 launches")
    print(a_line)
    print(f"phase 17 (a) [{card}]: calibration "
          f"{cfg['calibration_orders_per_sec']:,.0f} orders/s closed loop; "
          "offered/delivered "
          + ", ".join(f"{p['offered_per_sec']:,.0f}/{p['delivered_per_sec']:,.0f}"
                      for p in v["ladder"])
          + " orders/s; corrected p99 "
          + "/".join(f"{p['corrected']['p99_s'] * 1e3:.2f}" for p in v["ladder"])
          + " ms; knee "
          + (f"at point {knee['index']} ({knee['offered_per_sec']:,.0f}/s, "
             f"{knee['offered_per_sec'] / cfg['calibration_orders_per_sec']:.2f}"
             f" x the calibration; {knee['reason']}; saturated stage "
             f"{knee['saturated_stage']})" if knee["found"] else "not reached")
          + f"; the sweep {s['capacity_s']:.1f} s (warm-up "
          f"{cfg['warmup_s']:.1f} s, oracle check {v['oracle']['seconds']:.1f}"
          f" s) of (a)'s {t_a:.1f} s")
    a = b["a"]
    print(f"phase 17 (b): mesh part A at 10,240 x 32: unsharded and D=1 "
          f"outputs equal (max |err| {a['full_max_abs_err']} full, "
          f"{a['dense_max_abs_err']} dense); curve D=1/2/4/8 on cuda:0 "
          f"blocks, books and outputs equal to the unsharded step, "
          f"live_per_shard and dispatched_rows equal to "
          f"MULTICHIP_CUDA_r01.json's and part B's arithmetic (D=8 "
          f"{b['curve']['curve'][-1]['live_per_shard']}, skew "
          f"{b['curve']['curve'][-1]['shard_skew']}); {b['launches']} K1 "
          f"launches")
    print(b["line"])
    print(f"phase 17 (b) [{card}]: full step {a['full_unsharded_ms']:.4f} ms "
          f"unsharded, {a['full_mesh1_ms']:.4f} ms D=1 "
          f"({a['full_mesh1_overhead_ms']:+.4f} ms, "
          f"{a['full_mesh1_overhead_pct']:+.1f}%); dense "
          f"{a['dense_unsharded_ms']:.4f} / {a['dense_mesh1_ms']:.4f} ms; "
          f"traced chains of {a['full_trace']['reps']}: "
          f"{a['full_trace']['unsharded']['launches_per_step']} / "
          f"{a['full_trace']['mesh1']['launches_per_step']} device ops a "
          f"step, the same names and counts: "
          f"{a['full_trace']['same_launches']}, busy "
          f"{a['full_trace']['unsharded']['busy_ms_per_step']:.4f} / "
          f"{a['full_trace']['mesh1']['busy_ms_per_step']:.4f} ms a step "
          f"({a['full_trace']['busy_delta_ms']:+.4f}), wall "
          f"{a['full_trace']['unsharded']['wall_ms_per_step']:.4f} / "
          f"{a['full_trace']['mesh1']['wall_ms_per_step']:.4f} "
          f"({a['full_trace']['wall_delta_ms']:+.4f}); curve step_ms "
          + "/".join(f"{p['step_ms']:.4f}" for p in b["curve"]["curve"])
          + f"; {t_b:.1f} s")
    print("phase 17 (c): " + ", ".join(f"{n}.json" for n in CUDA_ARTIFACTS)
          + " load with their schemas, the measured ones naming "
          + docs["MULTICHIP_CUDA_r01"]["provenance"]["card"]
          + "; CAPACITY_CUDA_r01.json passes every check, knee at point "
          f"{docs['CAPACITY_CUDA_r01']['knee']['index']}, attribution err "
          f"{docs['CAPACITY_CUDA_r01']['knee']['attribution_frac_err']:.4f} "
          "there, 0 seq dupes and gaps at every point"
          "; build_verdict() byte-equal to PLACEMENT_CUDA_r01.json; "
          "/placement serves it, baselines cite MULTICHIP_CUDA_r01 and "
          "FLEET_CUDA_r01")
    ad = d["admit"]
    print(f"phase 17 (d) [{card}]: bench_admit scalar "
          f"{ad['scalar']['admit_ns_per_order']} / columnar "
          f"{ad['columnar']['admit_ns_per_order']} ns/order "
          f"({ad.get('speedup_x')}x); hostprof_artifact(columnar) "
          f"{d['artifact']['drill']['admit_ns_per_order']} ns/order; "
          f"coverage {d['coverage']} %")
    print(f"phase 17 [{card}]: {secs:.1f} s")
    return dict(launches=dict(obs_snapshot_capacity=a_launches,
                              mesh_overhead=b["launches"]),
                worst=max(a_worst, b["worst"]), seconds=secs)


def phase17_alone() -> int:
    """`--phase17`: phase 17 alone on the card. Exits 1 without a card."""
    if not torch.cuda.is_available():
        print("chip_smoke --phase17: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = card_line()
    print(card)
    load_kernel(card)
    phase17(card, torch.device("cuda"))
    print(f"chip_smoke --phase17 [{card}]: {time.perf_counter() - t0:.1f} s")
    return 0


#: The drill worker gives up waiting for its go file after this long.
DRILL_WAIT_S = 1100.0


def _write_json(path: str, doc) -> None:
    with open(path + ".tmp", "w") as fh:
        json.dump(doc, fh, default=list)
    os.replace(path + ".tmp", path)


def drill_worker(argv) -> int:
    """`--drill-worker DIR SECONDS`: phase 16's drills on the card in a
    fresh interpreter for DrillWorker: fuzz_drill (report to
    DIR/fuzz.json), then soak_drill, which after its settling writes
    DIR/settled.json and waits for DIR/go (exits 1 if its parent goes
    away or after DRILL_WAIT_S) before its timed loop; its report goes to
    DIR/soak.json."""
    work, seconds = argv[1], float(argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke --drill-worker: no CUDA card", file=sys.stderr)
        return 1
    parent, t0 = os.getppid(), time.monotonic()
    load_kernel(card_line())
    f = fuzz_drill("cuda")
    f["by"] = [[m, d, c] for (m, d), c in f["by"].items()]
    _write_json(os.path.join(work, "fuzz.json"), f)

    def gate(info):
        _write_json(os.path.join(work, "settled.json"), info)
        while not os.path.exists(os.path.join(work, "go")):
            if os.getppid() != parent or \
                    time.monotonic() - t0 > DRILL_WAIT_S:
                raise SystemExit("chip_smoke --drill-worker: no go from "
                                 "the parent")
            time.sleep(0.05)

    _write_json(os.path.join(work, "soak.json"),
                soak_drill("cuda", seconds=seconds, gate=gate))
    return 0


class DrillWorker:
    """Phase 16 (a) and (b) in a fresh interpreter (drill_worker), started
    before phase 9: the fuzz, the soak's warm-up and its settling (about
    2,700 frames) run beside phases 9 onward, and the soak's timed loop
    runs alone, when phase 16 (b) asks for it (soak) and this process
    only waits. stop() kills the worker if it is still running."""

    def __init__(self, seconds: float = SOAK_SECONDS):
        self.work = tempfile.mkdtemp(prefix="phase16-")
        self.log_path = os.path.join(self.work, "worker.log")
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--drill-worker",
                 self.work, str(seconds)],
                stdout=log, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)))

    def _fail(self, what: str) -> SystemExit:
        with open(self.log_path) as fh:
            tail = fh.read()[-3000:]
        return SystemExit(f"phase 16: the drill worker {what}:\n{tail}")

    def _wait_for(self, name: str, timeout_s: float) -> tuple[dict, float]:
        t0 = time.perf_counter()
        path = os.path.join(self.work, name)
        while not os.path.exists(path):
            if self.proc.poll() is not None:
                raise self._fail(f"exited {self.proc.returncode} before "
                                 f"writing {name}")
            if time.perf_counter() - t0 > timeout_s:
                raise self._fail(f"wrote no {name} in {timeout_s:g} s")
            time.sleep(0.05)
        with open(path) as fh:
            return json.load(fh), time.perf_counter() - t0

    def fuzz(self, timeout_s: float = 300.0) -> dict:
        """fuzz_drill's report, with the seconds this process waited for
        it (wait_s)."""
        f, waited = self._wait_for("fuzz.json", timeout_s)
        f["by"] = {(m, d): c for m, d, c in f["by"]}
        f["wait_s"] = waited
        return f

    def soak(self, timeout_s: float = 300.0) -> dict:
        """Wait for the settling, start the timed loop, wait for the
        report. Returns soak_drill's report with the seconds this process
        waited for the settling (settle_wait_s) and from the worker's
        start to its timed loop (started_s)."""
        _, waited = self._wait_for("settled.json", timeout_s)
        started = time.perf_counter() - self.t0
        open(os.path.join(self.work, "go"), "w").close()
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            raise self._fail(f"did not end within {timeout_s:g} s of go")
        if rc != 0:
            raise self._fail(f"exited {rc}")
        r, _ = self._wait_for("soak.json", 1.0)
        r.update(settle_wait_s=waited, started_s=started)
        return r

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.work, ignore_errors=True)


def time_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median per-call milliseconds with CUDA events (one call between each
    pair, so the wrapper's host work between the events counts)."""
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


def device_ms(fn, runs: int, warmup: int = 3) -> float:
    """Device milliseconds per call: the mean of `runs` calls launched back
    to back behind a GPU spin (torch.cuda._sleep, 1 ms at 2 GHz per call),
    so the host's per-call work (the wrapper's checks and allocations) is
    done while the card spins and opens no gaps between the two CUDA events.
    A call whose host time exceeds its spin share still counts its gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * runs))
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def bound_ms(config, books, ops) -> tuple[float, str]:
    """Least time for the grid on this card: bytes (each input read once,
    each output written once) over HBM bandwidth, or integer operations
    over the INT32 rate, whichever is larger. Bytes and operations are
    the cost model's data mode (obs.costmodel.k1_work): operations follow
    the data, an ADD a log-depth scan plus ~20 elementwise passes over
    cap slots, a DEL ~10, a NOP none."""
    from gome_tpu_torch.obs.costmodel import k1_work

    nbytes, n_ops = k1_work(config, books, ops, "data")
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def load_kernel(card: str) -> None:
    """Phase 1: build (or load) the kernel with nvcc and the native host
    library with g++, both at once; ptxas lines go to stderr. A failed
    build raises; no g++ fails the run."""
    from gome_tpu_torch.native import build as host_build
    from gome_tpu_torch.ops import build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        kernels = [pool.submit(build.load, name) for name in KERNEL_ROWS]
        host = pool.submit(host_build.load)
        for kernel in kernels:
            kernel.result()
        if host.result() is None:
            raise SystemExit("phase 1: no g++ on PATH: the port's native "
                             "host layer cannot be built")
    built = [name for name in KERNEL_ROWS if name in build.build_info]
    print(f"phase 1 [{card}]: kernels {', '.join(KERNEL_ROWS)} ready in "
          f"{time.perf_counter() - t0:.1f} s"
          + (f" (built by nvcc: {', '.join(built)})" if built
             else " (cached builds)")
          + f"; native host library: {host_line()}")
    for name in built:
        for line in build.build_info[name][1].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas {name}: {line.strip()}", file=sys.stderr)


OBS_AB_RUNS = ("off", "all", "timeline", "hostprof", "placement",
               "placement", "hostprof", "timeline", "all", "off")


def obs_ab() -> int:
    """`--obs-ab`: phase 8 (c)'s service (int64, depth 0, json wire, no
    subscriber) over the 200,000-order flow in OBS_AB_RUNS's order, each
    run's matchOrder bodies byte-equal to the first's; one JSON line of
    orders/s, the consumer's busy seconds and the gateway's admission
    seconds per run."""
    if not torch.cuda.is_available():
        print("chip_smoke --obs-ab: needs a CUDA card", file=sys.stderr)
        return 1
    import logging

    from gome_tpu_torch.api import order_pb2 as pb
    from gome_tpu_torch.ops.match_step import batch_step
    from gome_tpu_torch.utils.streams import multi_symbol_stream

    card = card_line()
    load_kernel(card)
    logging.getLogger("gome_tpu_torch.matchfeed").setLevel(logging.WARNING)
    sizes = dict(symbols=10240, zipf_n=200_000)
    zipf = multi_symbol_stream(n=sizes["zipf_n"], n_symbols=sizes["symbols"],
                               zipf_a=1.2, cancel_prob=0.3, seed=7)
    tail = unary_tail()
    want = oracle_events(list(zipf) + tail)
    requests = wire_batches(pb, zipf)
    runs, first = [], None
    for arm in OBS_AB_RUNS:
        kw = {} if arm == "off" else OBS_ARMED if arm == "all" else {
            arm: True, "timeline_interval_s": 0.25}
        try:
            r = service_run(sizes, 0, requests, tail, want, len(zipf),
                            batch_step, subscribe=False, load_run=False,
                            label=f"--obs-ab {arm}", ops_kw=kw)
        finally:
            disarm_obs()
        first = first or r["bodies"]
        if r["bodies"] != first:
            raise SystemExit(f"--obs-ab {arm}: bodies differ from the "
                             "first run's")
        sp = r["split"]
        runs.append(dict(
            arm=arm, orders_per_s=len(zipf) / r["secs"], secs=r["secs"],
            consumer_busy=sp["consumer"] - sp["consumer_wait"],
            gateway=sp["gateway"], feed_busy=sp["feed"] - sp["feed_wait"],
            launches=r["launches"]))
        del r
        torch.cuda.empty_cache()
    print(json.dumps(dict(card=card, runs=runs)))
    return 0


def k5_times(argv) -> int:
    """`--k5-times <tree>`: K5 of the gome_tpu_torch package in <tree> (a
    checkout's root, built there) on this card: equal to that package's
    plain version at phase 10 (a)'s draws from the stationary lam (T 32 and
    1,024) and at every edge input, then ms, device_ms and cycles a bin at
    T 32, 1,024 and 65,536, and phase 10 (d)'s generator (sim_traffic,
    after one pump off the clock) on that package. Prints one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke --k5-times: needs a CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(argv[1])
    sys.path.insert(0, tree)
    import gome_tpu_torch

    if not os.path.abspath(gome_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit(f"--k5-times: gome_tpu_torch came from "
                         f"{gome_tpu_torch.__file__}, not {tree}")
    from gome_tpu_torch.ops.hawkes_scan import hawkes_scan
    from gome_tpu_torch.sim import FlowConfig

    device = torch.device("cuda")
    flow = FlowConfig()
    for name in HAWKES_EDGE_CASES:
        check_scan(f"--k5-times {tree} edge input {name}", flow,
                   hawkes_edge_case(flow, name, device))
    out = {}
    for t_bins in (32, 1024, 65536):
        args = scan_inputs(flow, t_bins, stationary_lam(flow), 100 + t_bins,
                           device)
        if t_bins < 4096:
            check_scan(f"--k5-times {tree} T={t_bins}", flow, args)
        out[str(t_bins)] = dict(
            **time_scan(flow, args),
            events=int(hawkes_scan(flow, *args).occur.sum()))
    sim_traffic(device, 1, 10_240, 1_024, 0)
    orders, gen = sim_traffic(device, 50_000, 10_240, 1_024, 128)
    gen = dict(orders_per_s=len(orders) / gen["secs"], secs=gen["secs"],
               pumps=gen["pumps"], fetch_s=gen["fetch_s"],
               host_s=gen["host_s"], device_s=gen["device_s"],
               launches=gen["launches"])
    print(json.dumps(dict(tree=tree, card=card_line(), k5=out,
                          edges=len(HAWKES_EDGE_CASES), generator=gen)))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--persist-worker"]:
        return persist_worker(sys.argv[1:])
    if sys.argv[1:2] == ["--sim-worker"]:
        return sim_worker(sys.argv[1:])
    if sys.argv[1:2] in (["--amqp-consumer"], ["--amqp-gateway"]):
        return amqp_worker(sys.argv[1:])
    if sys.argv[1:2] in (["--fleet-consumer"], ["--fleet-gateway"]):
        return fleet_worker(sys.argv[1:])
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank_worker(sys.argv[1:])
    if sys.argv[1:2] == ["--phase15"]:
        return phase15_alone()
    if sys.argv[1:2] == ["--phase17"]:
        return phase17_alone()
    if sys.argv[1:2] in (["--soak"], ["--fuzz"]):
        return drill_alone(sys.argv[1:])
    if sys.argv[1:2] == ["--drill-worker"]:
        return drill_worker(sys.argv[1:])
    if sys.argv[1:2] == ["--obs-ab"]:
        return obs_ab()
    if sys.argv[1:2] == ["--prefix-warm-ab"]:
        return prefix_warm_ab()
    if sys.argv[1:2] == ["--k5-times"]:
        return k5_times(sys.argv[1:])
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    from gome_tpu_torch.ops.match_step import batch_step, batch_step_reference

    global KEPT_QUEUE
    device = torch.device("cuda")
    card = card_line()
    print(card)
    load_kernel(card)
    KEPT_QUEUE = []

    sizes = dict(a=10240, b=1024, c=64, d=512, e_rows=2048, e_t=512,
                 zipf_n=200_000, symbols=10240, hot_n=20_000, batch=8192,
                 sim_scan_t=(32, 1024, 65536), sim_i_lanes=256,
                 sim_i_steps=1000, sim_small_steps=200, sim_lanes=10240,
                 sim_t=1024, sim_orders=25_000, sim_pump_keep=128,
                 sim_ii_steps=1000, sim_ii_cpu_steps=10)
    worst, timing = phase2(device, sizes)
    launches, orders_per_s, split, engine_s, zipf, want_zipf = phase3(
        device, sizes)

    results = {}
    for key, runs in (("a", 30), ("e", 10)):
        config, books, ops = timing[key]
        ms = time_ms(lambda: batch_step(config, books, ops), runs=runs)
        dev = device_ms(lambda: batch_step(config, books, ops), runs=runs)
        bound, bound_by = bound_ms(config, books, ops)
        results[key] = dict(ms=ms, device_ms=dev, bound_ms=bound,
                            bound_by=bound_by)
        s, t = ops.action.shape
        print(f"phase 4 [{card}]: match_step kernel on ({key}) {ms:.4f} ms per "
              f"{s}x{t} grid (cap {config.cap}, K {config.max_fills}, int32, "
              f"{int((ops.action != 0).sum())} live ops; median of {runs} "
              f"calls); device time {dev:.4f} ms (mean of {runs} queued "
              f"launches); bound {bound:.4f} ms ({bound_by})")
    config, books, ops = timing["a"]
    results["a"]["plain_ms"] = time_ms(
        lambda: batch_step_reference(config, books, ops), runs=5, warmup=1)
    results["e"]["plain_ms"] = timing["e_plain_ms"]
    print(f"phase 4 [{card}]: plain PyTorch version {results['a']['plain_ms']:.3f}"
          f" ms on (a) (median of 5), {results['e']['plain_ms']:.1f} ms on (e) "
          f"(one run, phase 2)")
    step_s = split["step"]
    print(f"phase 4 [{card}]: MatchEngine.process_columnar "
          f"{orders_per_s:,.0f} orders/s end to end ({sizes['zipf_n']} orders,"
          f" {sizes['symbols']} symbols, micro-batches of {sizes['batch']});"
          f" device steps {step_s:.4f} s of {engine_s:.3f} s "
          f"({100 * step_s / engine_s:.1f}%): gather {split['gather']:.4f} s, "
          f"kernel {split['kernel']:.4f} s, scatter {split['scatter']:.4f} s")
    f_launches, f_worst, f_orders_per_s, f_split, frame_s, fetch, lines = \
        phase5(device, sizes, zipf, want_zipf)
    for line in lines:
        print(line)
    f_step = f_split["step"]
    print(f"phase 5 [{card}]: MatchEngine.process_frame(fast) "
          f"{f_orders_per_s:,.0f} orders/s end to end ({sizes['zipf_n']} "
          f"orders, frames of {sizes['batch']}); device steps {f_step:.4f} s "
          f"of {frame_s:.3f} s ({100 * f_step / frame_s:.1f}%): gather "
          f"{f_split['gather']:.4f} s, kernel {f_split['kernel']:.4f} s, "
          f"scatter {f_split['scatter']:.4f} s; compaction "
          f"{f_split['compaction']:.4f} s, grid builds "
          f"{f_split['grid_build']:.4f} s; fetch {fetch[0]:.4f} s (phase 1, "
          f"totals, waits for the frame's device work) + {fetch[1]:.4f} s "
          f"(phase 2, event prefixes); phase 3 process_columnar "
          f"{orders_per_s:,.0f} orders/s, device steps {step_s:.4f} s, in "
          f"this run")
    frame_list = [frame_columns(zipf[i:i + sizes["batch"]])
                  for i in range(0, len(zipf), sizes["batch"])]
    c_launches, c_worst, runs, c_lines = phase6(device, sizes, zipf,
                                                want_zipf, frame_list)
    for line in c_lines:
        print(line)
    n_frames = -(-sizes["zipf_n"] // sizes["batch"])
    for depth, tag in ((2, "a"), (0, "b")):
        r = runs[depth]
        print(f"phase 6 [{card}]: ({tag}) OrderConsumer pipeline_depth="
              f"{depth}: {sizes['zipf_n'] / r['secs']:,.0f} orders/s closed "
              f"loop (gateway step + run_once per frame of {sizes['batch']}, "
              f"{sizes['zipf_n']} orders, {r['secs']:.3f} s); order->publish "
              f"p50 {r['latency'][0]:.2f} ms, p99 {r['latency'][1]:.2f} ms; "
              f"fetch {r['fetch'][0]:.4f} s (phase 1) + {r['fetch'][1]:.4f} s "
              f"(phase 2) over {n_frames} frames; host split: "
              + ", ".join(f"{k} {v:.4f} s" for k, v in r["split"].items())
              + f", other {r['secs'] - sum(r['split'].values()):.4f} s")
    print(f"phase 6 [{card}]: K1 launches on the consumer path (a): "
          f"{c_launches}")
    ab_runs, h_lines, (native_s, json_s) = phase7(device, sizes, zipf,
                                                  frame_list, runs[2])
    for line in h_lines:
        print(line)
    for depth, host, r in ab_runs:
        print(f"phase 7 [{card}]: (a) host={host} pipeline_depth={depth}: "
              f"{sizes['zipf_n'] / r['secs']:,.0f} orders/s closed loop "
              f"({r['secs']:.3f} s); order->publish p50 {r['latency'][0]:.2f}"
              f" ms, p99 {r['latency'][1]:.2f} ms; {r['launches']} kernel "
              f"launches; host split: "
              + ", ".join(f"{k} {v:.4f} s" for k, v in r["split"].items())
              + f", other {r['secs'] - sum(r['split'].values()):.4f} s")
    print(f"phase 7 [{card}]: (c) decode_orders_batch "
          + " / ".join(f"{t:.4f}" for t in native_s)
          + " s, [decode_order(b) ...] "
          + " / ".join(f"{t:.4f}" for t in json_s)
          + f" s for {sizes['zipf_n']} bodies (json / native "
          f"{min(json_s) / min(native_s):.2f}x, best of each)")
    s_runs, s_worst, s_lines, flow8 = phase8(sizes, zipf)
    for line in s_lines:
        print(line)
    print_phase8(card, sizes, s_runs, runs)
    drills = DrillWorker()
    try:
        p9 = phase9(card, device, sizes, zipf, want_zipf,
                    s_runs["c"]["secs"])
        p10 = phase10(card, device, sizes)
        p11 = phase11(card, device, sizes, zipf, want_zipf, timing,
                      f_orders_per_s, flow8, s_runs["c"])
        p12 = phase12(card, device, sizes, zipf, flow8, s_runs["c"])
        p13 = phase13(card, sizes, zipf, flow8, s_runs["c"])
        p14 = phase14(card, device, sizes, zipf, want_zipf, flow8,
                      s_runs["c"])
        p15 = phase15(card, device, sizes, want_zipf, p11)
        p16 = phase16(card, device,
                      {"phase 13 (a) armed": p13["journal"],
                       "phase 14 (a) cost": p14["a"]["journal"]}, drills)
        p17 = phase17(card, device)
        q_worst, _ = check_queued_inputs("phases 5-17")
    finally:
        drills.stop()
    h_launches = ab_runs[0][2]["launches"]
    row = dict(name="match_step", **KERNEL_ROWS["match_step"],
               launches=launches, frame_path_launches=f_launches,
               consumer_path_launches=c_launches,
               host_layer_path_launches=h_launches,
               service_path_launches=s_runs["a"]["launches"],
               durability_path_launches=dict(
                   crash_drill_final_worker=p9["drill"]["final"]["launches"],
                   durable_service=p9["svc"]["launches"],
                   restored_service_replay=p9["svc"]["replay_launches"],
                   redis_migration=p9["migration"]["launches"]),
               sim_path_launches=p10["k1_launches"],
               mesh_path_launches=dict(
                   **p11["step_counts"],
                   **{f"frame_path {name}": r["launches"]
                      for name, r in p11["runs"].items()},
                   sharded_engine=p11["c_launches"],
                   service_mesh=p11["svc_launches"],
                   restores=p11["e"]["launches"]),
               amqp_path_launches=p12["launches"],
               obs_path_launches=p13["launches"],
               cost_profile_fleet_geometry_path_launches=p14["launches"],
               race_drill_path_launches=p15["race_launches"],
               process_mesh_path_launches=p15["launches"],
               fuzz_soak_path_launches=p16["launches"],
               operator_artifacts_path_launches=p17["launches"],
               max_abs_err=max(worst, f_worst, c_worst, s_worst,
                               p9["drill"]["final"]["kernel_worst"],
                               p9["svc"]["worst"], p10["worst"],
                               p11["worst"], p12["worst"], p13["worst"],
                               p14["worst"], p15["worst"], p16["worst"],
                               p17["worst"], q_worst),
               ms=results["a"]["ms"],
               device_ms=results["a"]["device_ms"], plain_ms=results["a"]["plain_ms"],
               bound_ms=results["a"]["bound_ms"],
               bound_by=results["a"]["bound_by"], library_ms=None,
               checked=True, grid="a", main_path_grid=dict(
                   grid="e", library_ms=None, **results["e"]))
    scan_row = dict(name="hawkes_scan", **KERNEL_ROWS["hawkes_scan"],
                    library_ms=None, checked=True,
                    T=sizes["sim_scan_t"][0],
                    **p10["hawkes_row"])
    print(f"chip_smoke [{card}]: phases 1-17 in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [row, scan_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
