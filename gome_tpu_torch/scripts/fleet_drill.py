"""Fleet drill: a 2-gateway x 2-consumer fleet on the card with a
machine-checked aggregate-observability verdict (the port of
scripts/fleet_drill.py).

When the engine is deployed as a partitioned fleet (disjoint symbol sets,
one gateway process and one consumer process per partition sharing a file
bus and the RESP marker store), can one aggregator (obs.fleet.FLEET) see
the whole thing: merged /metrics lossless over the members, a health
rollup that stays green for the run, a fleet-wide exactly-once seq audit,
and order journeys stitched across the gateway/consumer process boundary?

Topology (the parent drives everything; 5 children):

    parent                              children
    ------                              --------
    the 10,240-symbol Zipf flow         respserver (RESP marker store)
    route via fleet.partition_of        gw0, gw1: OrderGateway + gRPC +
    drive both partitions over gRPC         ops server (file bus p{i})
    FLEET polls all 4 ops servers       c0, c1: EngineService on the card
    drain via /durability; stitch           (consumer + matchfeed + ops)
    journeys; audit seqs; verdict

The members are the ones chip_smoke.py's phase 14 (b) runs
(`fleet_gateway`, `fleet_consumer`); the flow is chip_smoke.py's phase 3
Zipf flow (multi_symbol_stream, 200,000 orders over 10,240 symbols, Zipf
1.2, seed 7), of which the drill takes the first --orders. Each
partition's events must equal the oracle's on that partition's orders.

The verdict (schema ``gome-fleet-verdict-v1``; ``--out
FLEET_CUDA_r01.json``) carries the throughput table, the imbalance row
(``table.imbalance``, read by obs.placement.partition_imbalance_baseline),
the rollup, the stitch, the merge proof, the seq audit, the checks and
the run's provenance (card, commit, command line).

    python -m gome_tpu_torch.scripts.fleet_drill --out FLEET_CUDA_r01.json
    python -m gome_tpu_torch.scripts.fleet_drill --device cpu --orders 2000
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time

from .common import (REPO, expected_launches, host_line, provenance,
                     require_device, wire_request, write_json)

SCHEMA = "gome-fleet-verdict-v1"
N_PARTITIONS = 2
SYMBOLS = 10_240
#: chip_smoke.py phase 3's Zipf flow: its first DRILL_ORDERS are the drill.
FLOW = dict(n=200_000, n_symbols=SYMBOLS, zipf_a=1.2, cancel_prob=0.3,
            seed=7)
DRILL_ORDERS = 20_000
#: Orders per DoOrderBatch RPC for a closed-loop drive.
DRIVE_BATCH_N = 1024
#: Trace ring depth in each member: every journey of the run stays
#: joinable.
TRACE_KEEP = 2 * DRILL_ORDERS
#: Seconds of steady observation after the drain, before the stitch.
WINDOW_S = 2.0


def partition_of(symbol: str) -> int:
    """Stable symbol -> partition routing (fleet.router.partition_of,
    fnv1a), the same function every member recomputes."""
    from ..fleet.router import partition_of as _partition_of

    return _partition_of(symbol, N_PARTITIONS)


def zipf_flow(n: int = DRILL_ORDERS, n_symbols: int = SYMBOLS) -> list:
    """The first n orders of the Zipf flow over n_symbols symbols."""
    from ..utils.streams import multi_symbol_stream

    return multi_symbol_stream(**dict(FLOW, n_symbols=n_symbols))[:n]


def rusage_self() -> dict:
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {
        "utime_s": round(ru.ru_utime, 4),
        "stime_s": round(ru.ru_stime, 4),
        "maxrss_kb": ru.ru_maxrss,
    }


# -- members -----------------------------------------------------------------
#
# Protocol (both roles): print one "READY ops=<port> grpc=<port>" line on
# stdout once serving, then block reading stdin; any line (or EOF) is the
# stop signal. On stop: tear down and write the result JSON to --out.


def fleet_gateway(args) -> dict:
    """One partition's gateway process: OrderGateway over the partition's
    file bus, marks in the marker server, the tracer armed (the scalar
    loop: one doOrder document an order, with its trace context), the
    timeline and the placement observatory, gRPC, and an ops server of
    its own for the aggregator. No engine."""
    from ..bus import make_bus
    from ..bus.base import export_queue_metrics
    from ..config import BusConfig, Config, EngineConfig, GrpcConfig
    from ..engine.prepool import RespPrePool, make_marker
    from ..obs.placement import PLACEMENT
    from ..obs.timeline import TIMELINE
    from ..persist.resp import RespClient
    from ..service.gateway import OrderGateway, serve_gateway
    from ..service.ops import OpsServer
    from ..utils.trace import TRACER, FlightRecorder

    bus = make_bus(BusConfig(backend="file", dir=args.bus_dir))
    export_queue_metrics(bus.order_queue)
    export_queue_metrics(bus.match_queue)
    # Gateway-side journeys never complete here (the consumer closes
    # them): a deep open ring keeps the whole run joinable.
    TRACER.install(FlightRecorder(keep_n=512, max_open=args.trace_keep))
    TIMELINE.install(interval_s=0.25, keep_n=256)
    PLACEMENT.install(partitions=N_PARTITIONS)
    pool = RespPrePool(RespClient(port=args.resp_port))
    gateway = OrderGateway(bus, accuracy=EngineConfig().accuracy,
                           mark=make_marker(pool), mark_frame=pool.mark_frame)
    server = serve_gateway(gateway, Config(grpc=GrpcConfig(host="127.0.0.1",
                                                           port=0)))
    ops = OpsServer(service=None, host="127.0.0.1", port=0).start()
    TIMELINE.start()
    print(f"READY ops={ops.port} grpc={server.bound_port}", flush=True)
    sys.stdin.readline()
    result = dict(role="gateway", partition=args.partition,
                  published=bus.order_queue.end_offset(),
                  rusage=rusage_self())
    server.stop(grace=1).wait()
    TIMELINE.stop()
    ops.stop()
    bus.order_queue.close()
    bus.match_queue.close()
    return result


def fleet_consumer(args, keep=None, check=None) -> dict:
    """One partition's consumer process: EngineService on args.device
    (cap 256, K 16, max_t 32, args.dtype, depth 0, json wire) over the
    partition's file bus, its pre-pool in the marker server, the tracer
    and the timeline armed (cost, profile, hostprof, placement off); K1's
    launches counted, books verified. `keep` (a context manager factory
    yielding kept kernel inputs) and `check(label, kept)` -> (worst,
    line) let a caller hold K1 against its plain version at the run's
    inputs."""
    import logging

    from ..config import (BusConfig, Config, EngineConfig, GrpcConfig,
                          OpsConfig, StoreConfig)
    from ..engine import nativehost
    from ..ops.match_step import batch_step
    from ..service import EngineService

    label = f"fleet consumer p{args.partition}"
    logging.getLogger("gome_tpu_torch.matchfeed").setLevel(logging.WARNING)
    cfg = Config(
        grpc=GrpcConfig(host="127.0.0.1", port=0),
        bus=BusConfig(backend="file", dir=args.bus_dir),
        engine=EngineConfig(cap=256, max_fills=16, n_slots=args.symbols,
                            max_t=32, dtype=args.dtype),
        store=StoreConfig(enabled=True, host="127.0.0.1",
                          port=args.resp_port),
        ops=OpsConfig(enabled=True, host="127.0.0.1", port=0, trace=True,
                      trace_keep=args.trace_keep, timeline_interval_s=0.25,
                      cost=False, profile=False, hostprof=False,
                      placement=False))
    with (keep() if keep else contextlib.nullcontext(None)) as kept:
        svc = EngineService(cfg, device=None if args.device == "cuda"
                            else args.device)
        # The store section puts the pre-pool in the marker server.
        names = (nativehost.available(), type(svc.engine.pre_pool).__name__)
        if names != (True, "RespPrePool"):
            raise RuntimeError(f"{label}: host layer (available, pre-pool) "
                               f"{names}, expected (True, 'RespPrePool')")
        host = f"host=native, RespPrePool ({host_line()})"
        batch_step.launches = 0
        svc.start()
        print(f"READY ops={svc.ops.port} grpc=0", flush=True)
        sys.stdin.readline()
        launches = batch_step.launches
        oq = svc.bus.order_queue
        result = dict(role="consumer", partition=args.partition, host=host,
                      launches=launches,
                      expected=expected_launches(svc.engine),
                      orders=svc.engine.stats.orders,
                      feed=svc.feed.seq_state(), consumed=oq.committed(),
                      rusage=rusage_self())
        svc.stop()
    if check is not None:
        result["worst"], result["kept_line"] = check(label, kept)
    svc.engine.batch.verify_books()
    return result


def worker_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--bus-dir", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="int64")
    for name in ("--resp-port", "--symbols", "--partition"):
        ap.add_argument(name, type=int, default=0)
    ap.add_argument("--trace-keep", type=int, default=TRACE_KEEP)
    return ap.parse_args(argv)


def run_worker(role: str, argv, consumer=fleet_consumer) -> int:
    """One member: serve until a line arrives on stdin, then write its
    result JSON to --out."""
    args = worker_args(argv)
    run = consumer if role == "consumer" else fleet_gateway
    result = run(args)
    with open(args.out, "w") as f:
        json.dump(result, f, sort_keys=True)
    return 0


def default_launcher(role: str) -> list:
    return [sys.executable, "-m", "gome_tpu_torch.scripts.fleet_drill",
            "--worker", role]


class Worker:
    """One child process with the READY/stdin-stop protocol (the
    reference's fleet_drill.Worker), the one launcher of every drill's
    members: `ready` holds the READY line's tokens and `ports` its
    key=value integers. With `err`, the child's stderr goes to that
    file."""

    def __init__(self, name: str, cmd: list[str], err: str | None = None):
        self.name = name
        self.err = err
        with (open(err, "w") if err else contextlib.nullcontext()) as fh:
            self.proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=fh, text=True, cwd=REPO)
        self.ready: list[str] = []
        self.ports: dict[str, int] = {}
        self._stopping = False

    def await_ready(self, timeout_s: float = 120.0) -> "Worker":
        deadline = time.monotonic() + timeout_s
        line = ""
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                with contextlib.suppress(subprocess.TimeoutExpired):
                    self.proc.wait(30)
                raise RuntimeError(
                    f"{self.name} exited before READY "
                    f"(rc={self.proc.poll()}): {self.stderr_tail()}")
            if line.startswith("READY"):
                self.ready = line.split()
                for tok in self.ready[1:]:
                    key, eq, val = tok.partition("=")
                    if eq:
                        self.ports[key] = int(val)
                return self
        raise RuntimeError(f"{self.name} never became READY: {line!r}")

    def stderr_tail(self) -> str:
        if not self.err:
            return ""
        try:
            with open(self.err) as f:
                return f.read()[-2000:]
        except OSError:
            return ""

    def request_stop(self) -> None:
        """Send the stop line (once); stop() then waits."""
        if self._stopping or self.proc.poll() is not None:
            return
        self._stopping = True
        try:
            self.proc.stdin.write("STOP\n")
            self.proc.stdin.flush()
        except OSError:
            pass

    def stop(self, timeout_s: float = 60.0) -> int:
        self.request_stop()
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait(timeout=10)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


def start_respserver(procs: dict) -> int:
    """The port's RESP marker server as a child (procs["respserver"]);
    returns its port."""
    srv = procs["respserver"] = Worker(
        "respserver", [sys.executable, "-m",
                       "gome_tpu_torch.persist.respserver", "--port", "0"])
    return int(srv.await_ready(30).ready[1])


def fleet_members(work, resp_port, symbols, device, procs,
                  launcher=default_launcher, dtype: str = "int64",
                  trace_keep: int = TRACE_KEEP) -> dict:
    """Start each partition's consumer and gateway process (Workers in
    procs); returns {name: (ops port, grpc port)} once every member said
    READY. Each partition's file bus is work/p{i}."""
    started = {}
    for p in range(N_PARTITIONS):
        bus_dir = os.path.join(work, f"p{p}")
        os.makedirs(bus_dir, exist_ok=True)
        for role, name in (("consumer", f"c{p}"), ("gateway", f"gw{p}")):
            procs[name] = started[name] = Worker(
                name, [*launcher(role),
                       "--out", os.path.join(work, f"{name}.json"),
                       "--bus-dir", bus_dir, "--resp-port", str(resp_port),
                       "--symbols", str(symbols), "--partition", str(p),
                       "--device", device, "--dtype", dtype,
                       "--trace-keep", str(trace_keep)],
                err=os.path.join(work, f"{name}.err"))
    for w in started.values():
        w.await_ready()
    return {name: (w.ports["ops"], w.ports["grpc"])
            for name, w in started.items()}


def stop_members(procs: dict, work: str) -> dict:
    """Send every member its stop line, wait for it, kill the marker
    server; returns {name: result} with each member's exit code."""
    members = {n: w for n, w in procs.items() if n != "respserver"}
    for w in members.values():
        w.request_stop()
    results = {}
    for name, w in members.items():
        rc = w.stop(120)
        try:
            with open(os.path.join(work, f"{name}.json")) as f:
                results[name] = json.load(f)
        except (OSError, ValueError):
            results[name] = {}
        results[name]["exit_code"] = rc
        if rc != 0:
            results[name]["stderr"] = w.stderr_tail()
    if "respserver" in procs:
        procs["respserver"].kill()
    return results


def fetch_text(url: str, timeout_s: float = 5.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode()


def fetch_json(url: str, timeout_s: float = 5.0) -> dict:
    return json.loads(fetch_text(url, timeout_s))


def drained(ops_url: str, n_orders: int) -> bool:
    """A consumer has committed n_orders orders and its feed every event
    of the match queue."""
    try:
        doc = fetch_json(ops_url + "/durability")
    except (OSError, ValueError):
        return False
    q = doc.get("queues") or {}
    oq, mq = q.get("order_queue") or {}, q.get("match_queue") or {}
    return (oq.get("committed", -1) >= n_orders
            and mq.get("committed", -1) >= mq.get("end", 0))


def await_drained(ops_url: str, n_orders: int, timeout_s: float,
                  procs: dict | None = None) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if drained(ops_url, n_orders):
            return True
        for name, w in (procs or {}).items():
            if w.proc.poll() is not None:
                raise RuntimeError(f"{name} exited {w.proc.returncode}")
        time.sleep(0.05)
    return False


#: The reference's sim flow for the chaos drills (dense enough that no
#: step is empty and most frames publish match events), at n_lanes lanes
#: and t_bins bins a step.
SIM_FLOW = dict(t_bins=8, dt=0.07, submit_rate=3.0, cancel_rate=1.5,
                market_rate=1.0)
#: The card's drills: bins a step at 10,240 lanes, bench.py's _SimFlow
#: geometry (10,240 x 1,024). The flow holds at most one event a bin,
#: its lane drawn Zipf(1.1), so the orders a step follow the bins, not
#: the lanes: ~3.4 a step at 8 bins, whatever the lane count.
CARD_BINS = 1024


def record_sim_frames(seed: int, n_steps: int, lanes: int = 16,
                      device: str | None = None,
                      bins: int = SIM_FLOW["t_bins"]) -> list[bytes]:
    """The sim flow's GCO ORDER frames (sim.replay.record_frames), one
    per non-empty step of `bins` bins, recorded on `device` (the CUDA
    card by default; a CUDA generator's draws are not a CPU one's)."""
    from ..sim.env import EnvConfig
    from ..sim.flow import FlowConfig
    from ..sim.replay import record_frames

    cfg = EnvConfig(flow=FlowConfig(n_lanes=lanes,
                                    **dict(SIM_FLOW, t_bins=bins)))
    return record_frames(cfg, seed, n_steps, device=device)


def requests_from_frames(frames: list[bytes]) -> list[list]:
    """Decode recorded GCO frames into per-partition gRPC request
    streams: [(global_idx, is_cancel, OrderRequest), ...] per partition,
    global arrival order preserved inside each partition (a symbol maps
    to one partition, so ADD-before-DEL holds). Prices and volumes go on
    the wire as the frame's ticks, for a gateway at accuracy 0."""
    from ..api import order_pb2 as pb
    from ..bus.colwire import decode_order_frame

    parts: list[list] = [[] for _ in range(N_PARTITIONS)]
    gi = 0
    for fr in frames:
        cols = decode_order_frame(fr)
        symbols, uuids = cols["symbols"], cols["uuids"]
        for i in range(cols["n"]):
            action = int(cols["action"][i])
            if action == 0:  # NOP padding never reaches the wire
                continue
            symbol = symbols[int(cols["symbol_idx"][i])]
            req = pb.OrderRequest(
                uuid=uuids[int(cols["uuid_idx"][i])],
                oid=cols["oids"][i].decode(),
                symbol=symbol,
                transaction=int(cols["side"][i]),
                price=float(int(cols["price"][i])),
                volume=float(int(cols["volume"][i])),
                kind=int(cols["kind"][i]),
            )
            parts[partition_of(symbol)].append((gi, action == 2, req))
            gi += 1
    return parts


def requests_by_partition(orders) -> list[list]:
    """Per partition [(global index, is_cancel, OrderRequest), ...], the
    flow's order kept inside each partition (a symbol maps to one
    partition, so ADD-before-DEL holds)."""
    from ..api import order_pb2 as pb
    from ..types import Action

    parts: list[list] = [[] for _ in range(N_PARTITIONS)]
    for gi, o in enumerate(orders):
        parts[partition_of(o.symbol)].append(
            (gi, o.action is Action.DEL, wire_request(pb, o)))
    return parts


def drive_partition(target: str, reqs: list, out: dict, sched=None,
                    rank=None, batch_n: int = DRIVE_BATCH_N) -> None:
    """Chunked gRPC drive of one partition's gateway: DoOrderBatch with
    per-chunk cancel masks, arrival order preserved. Tallies per-order
    response codes; a transport error is recorded, not raised. With
    `sched` (an OpenLoopSchedule) each chunk waits for the intended time
    of its last order (`rank` maps global index -> schedule tick) and is
    sent at once when behind. Each chunk's record (first rank, size, due
    time, send and return times, accepted) lands in out["batches"]."""
    import grpc

    from ..api import order_pb2 as pb
    from ..api.service import OrderStub

    codes: dict[int, int] = {}
    batches = []
    t0 = time.perf_counter()
    try:
        with grpc.insecure_channel(target) as channel:
            stub = OrderStub(channel)
            for i in range(0, len(reqs), batch_n):
                chunk = reqs[i:i + batch_n]
                due = None
                if sched is not None:
                    last = max(g for g, _, _ in chunk)
                    due = sched.intended(rank[last] if rank else last)
                    now = time.perf_counter()
                    if now < due:
                        time.sleep(due - now)
                t_send = time.perf_counter()
                resp = stub.DoOrderBatch(pb.OrderBatchRequest(
                    orders=[r for _, _, r in chunk],
                    cancel=[c for _, c, _ in chunk]), timeout=60)
                batches.append({"first_rank": i, "n": len(chunk),
                                "due": due, "t_send": t_send,
                                "t_ret": time.perf_counter(),
                                "accepted": resp.accepted})
                codes[0] = codes.get(0, 0) + resp.accepted
                for r in resp.rejects:
                    codes[r.code] = codes.get(r.code, 0) + 1
                seen = resp.accepted + len(resp.rejects)
                if resp.code != 0 and seen < len(chunk):
                    codes[resp.code] = (codes.get(resp.code, 0)
                                        + len(chunk) - seen)
    except grpc.RpcError as exc:
        out["transport_error"] = str(exc)
    out["codes"] = {str(k): v for k, v in sorted(codes.items())}
    out["batches"] = batches
    out["accepted"] = codes.get(0, 0)
    out["sent"] = len(reqs)
    out["wall_s"] = time.perf_counter() - t0


def read_match_events(bus_dir: str) -> list:
    """The durable record of one partition: every event of its match
    queue (json wire, one document an event), seqs included."""
    from ..bus import decode_match_result
    from ..bus.filelog import FileQueue

    q = FileQueue("matchOrder", os.path.join(bus_dir, "matchOrder"))
    try:
        return [decode_match_result(m.body)
                for m in q.read_from(0, q.end_offset())]
    finally:
        q.close()


def audit_seqs(seqs: list[int]) -> dict:
    from ..service.matchfeed import SeqTracker

    tracker = SeqTracker(first_seq=0)
    for s in seqs:
        tracker.observe(s)
    return tracker.state()


def pctl(xs: list[float], p: float) -> float | None:
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1))))]


def _ms(s: float | None) -> float | None:
    return None if s is None else round(s * 1e3, 3)


def run_parent(args) -> dict:
    """Boot the fleet, drive the flow, drain, audit; returns the verdict.
    The members' work directory is removed at the end, whatever happens."""
    import tempfile

    work = tempfile.mkdtemp(prefix="fleet-drill-", dir=args.workdir or None)
    try:
        return _run_fleet(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run_fleet(args, work: str) -> dict:
    import dataclasses

    from ..obs.capacity import OpenLoopSchedule
    from ..obs.fleet import FLEET
    from ..oracle import OracleEngine
    from ..utils.metrics import (family_total, merge_expositions,
                                 parse_exposition, render_exposition)

    orders = zipf_flow(args.orders, args.symbols)
    parts = requests_by_partition(orders)
    n_orders = len(orders)
    sym_counts = [len({r.symbol for _, _, r in p}) for p in parts]
    procs = {}
    print(f"fleet: {n_orders} orders -> partitions {[len(p) for p in parts]}"
          f" (symbols {sym_counts}) in {work}", flush=True)
    results = {}
    t_boot = time.perf_counter()
    try:
        resp_port = start_respserver(procs)
        ports = fleet_members(work, resp_port, args.symbols, args.device,
                              procs, dtype=args.dtype,
                              trace_keep=max(TRACE_KEEP, 2 * n_orders))
        boot_s = time.perf_counter() - t_boot
        members = {name: f"http://127.0.0.1:{ops}"
                   for name, (ops, _) in ports.items()}
        FLEET.install(members, interval_s=0.25, timeout_s=5.0,
                      stale_after_s=10.0)
        FLEET.start()

        def drive_all(slices, out, sched=None, rank=None,
                      batch_n=DRIVE_BATCH_N):
            threads = [threading.Thread(
                target=drive_partition,
                args=(f"127.0.0.1:{ports[f'gw{i}'][1]}", slices[i],
                      out[f"gw{i}"], sched, rank, batch_n))
                for i in range(N_PARTITIONS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        # Warm-up slice, drained before the measured window: the first
        # grids of each consumer build their combos off the record.
        warm_n = [min(48, len(p) // 3) for p in parts]
        warm = {f"gw{i}": {} for i in range(N_PARTITIONS)}
        drive_all([parts[i][:warm_n[i]] for i in range(N_PARTITIONS)], warm)
        warm_drained = [await_drained(members[f"c{i}"], warm_n[i], 240.0,
                                      procs) for i in range(N_PARTITIONS)]
        # Measured drive: one open-loop schedule at --rate over the flow's
        # global order (warm-up re-ranked out), both gateways at once.
        measured = [parts[i][warm_n[i]:] for i in range(N_PARTITIONS)]
        rank = {gi: k for k, gi in enumerate(sorted(
            gi for sl in measured for gi, _, _ in sl))}
        sched = (OpenLoopSchedule(args.rate, t0=time.perf_counter())
                 if args.rate > 0 else None)
        drive = {f"gw{i}": {} for i in range(N_PARTITIONS)}
        t0 = time.perf_counter()
        drive_all(measured, drive, sched=sched, rank=rank,
                  batch_n=args.drive_batch)
        drive_wall = time.perf_counter() - t0
        n_measured = n_orders - sum(warm_n)
        all_drained = [await_drained(members[f"c{i}"], len(parts[i]), 240.0,
                                     procs) for i in range(N_PARTITIONS)]
        drain_wall = time.perf_counter() - t0
        print(f"fleet: drive {drive_wall:.2f} s, drained {all_drained} at "
              f"{drain_wall:.2f} s", flush=True)
        time.sleep(WINDOW_S)
        FLEET.stop()
        FLEET.poll()
        stitch = FLEET.stitch()
        per_part_stitched = [sum(
            1 for j in stitch["journeys"]
            if {f"gw{i}", f"c{i}"} <= set(j["procs"]))
            for i in range(N_PARTITIONS)]
        member_exps = {name: FLEET._fetch(url + "/metrics", 5.0)
                       for name, url in members.items()}
        merged = merge_expositions(member_exps)
        merged_text = render_exposition(merged)
        merge_roundtrip_ok = render_exposition(
            parse_exposition(merged_text)) == merged_text
        member_consumed = sum(
            family_total(fam) for fam in (
                parse_exposition(t).get("gome_orders_consumed_total")
                for t in member_exps.values()) if fam is not None)
        fam = merged.get("gome_orders_consumed_total")
        merged_consumed = family_total(fam) if fam else -1.0
        accepted = sum(d.get("codes", {}).get("0", 0)
                       for phase in (warm, drive) for d in phase.values())
        payload = FLEET.payload()
        rollup = FLEET.rollup()
    finally:
        FLEET.disable()
        results = stop_members(procs, work)

    audits, oracle_ok = [], []
    for i in range(N_PARTITIONS):
        events = read_match_events(os.path.join(work, f"p{i}"))
        seqs = [e.seq for e in events if e.seq is not None]
        audits.append({"partition": i, "events": len(events),
                       "stamped": len(seqs), "seq_audit": audit_seqs(seqs)})
        oracle = OracleEngine()
        for o in (orders[gi] for gi, _, _ in parts[i]):
            oracle.submit(o)
        want = oracle.drain()
        oracle_ok.append([dataclasses.replace(e, seq=None)
                          for e in events] == want)

    lat_by_part = {}
    for i in range(N_PARTITIONS):
        js = sorted((j for j in stitch["journeys"] if f"c{i}" in j["procs"]),
                    key=lambda j: j["start"])
        keep = min(len(js), len(parts[i]) - warm_n[i])
        lat_by_part[i] = [j["duration_s"] for j in js[len(js) - keep:]]
    lat_all = [d for i in range(N_PARTITIONS) for d in lat_by_part[i]]
    procs_table = {}
    for i in range(N_PARTITIONS):
        gw, con = f"gw{i}", f"c{i}"
        sent = drive[gw].get("sent", 0)
        procs_table[gw] = {
            "role": "gateway", "partition": i,
            "orders_sent": sent + warm[gw].get("sent", 0),
            "orders_measured": sent,
            "orders_per_sec": round(sent / drive_wall, 1),
            "grpc_codes": drive[gw].get("codes", {}),
            "rusage": results.get(gw, {}).get("rusage"),
        }
        procs_table[con] = {
            "role": "consumer", "partition": i,
            "orders_consumed": results.get(con, {}).get("consumed", 0),
            "orders_per_sec": round(sent / drain_wall, 1),
            "k1_launches": results.get(con, {}).get("launches"),
            "feed": results.get(con, {}).get("feed"),
            "rusage": results.get(con, {}).get("rusage"),
        }
    part_counts = [len(p) for p in parts]
    table = {
        "drive_wall_s": round(drive_wall, 3),
        "drain_wall_s": round(drain_wall, 3),
        "boot_s": round(boot_s, 3),
        "warmup_orders": warm_n,
        "procs": procs_table,
        "fleet": {
            "orders": n_measured,
            "orders_per_sec": round(n_measured / drain_wall, 1),
        },
        "imbalance": {
            "orders_per_partition": part_counts,
            "symbols_per_partition": sym_counts,
            "max_over_min_orders": round(
                max(part_counts) / max(1, min(part_counts)), 2),
        },
        "e2e_latency_ms": {
            "samples": len(lat_all),
            "p50": _ms(pctl(lat_all, 50)),
            "p90": _ms(pctl(lat_all, 90)),
            "p99": _ms(pctl(lat_all, 99)),
            "per_partition": {
                str(i): {"samples": len(lat_by_part[i]),
                         "p50": _ms(pctl(lat_by_part[i], 50)),
                         "p99": _ms(pctl(lat_by_part[i], 99))}
                for i in range(N_PARTITIONS)},
        },
    }
    feed_states = [results.get(f"c{i}", {}).get("feed") or {}
                   for i in range(N_PARTITIONS)]
    checks = {
        "all_members_ready": len(results) == 2 * N_PARTITIONS,
        "all_members_exited_clean": all(
            r.get("exit_code") == 0 for r in results.values()),
        "all_members_healthy": (
            rollup["polls"] >= 4 and rollup["unhealthy_polls"] == 0
            and rollup["fetch_errors"] == 0),
        "zero_degradations": (
            rollup["degraded_polls"] == 0 and accepted == n_orders
            and not any("transport_error" in d
                        for phase in (warm, drive) for d in phase.values())),
        "all_partitions_drained": all(all_drained) and all(warm_drained),
        "exactly_once_fleet": all(
            a["seq_audit"]["dupes"] == 0 and a["seq_audit"]["gaps"] == 0
            for a in audits) and all(
            f.get("dupes") == 0 and f.get("gaps") == 0
            for f in feed_states),
        "events_equal_oracle": all(oracle_ok),
        "stitched_per_partition": all(n >= 1 for n in per_part_stitched),
        "merge_roundtrip": merge_roundtrip_ok,
        "merge_lossless": (merged_consumed == member_consumed
                           == float(accepted) and accepted > 0),
        "fleet_payload_serves": (
            payload.get("enabled") is True
            and "exposition" in (payload.get("metrics") or {})),
    }
    return {
        "schema": SCHEMA,
        "artifact": os.path.splitext(os.path.basename(args.out))[0],
        "provenance": provenance(args.device),
        "config": {
            "orders": n_orders,
            "flow": dict(FLOW, n_symbols=args.symbols,
                         source="gome_tpu_torch.utils.streams."
                                "multi_symbol_stream, first `orders`"),
            "partitions": N_PARTITIONS,
            "orders_per_partition": part_counts,
            "symbols_per_partition": sym_counts,
            "drive": {
                "mode": "open-loop" if args.rate > 0 else "closed-loop",
                "rate_per_sec": args.rate if args.rate > 0 else None,
                "batch_n": args.drive_batch,
                "scheduler": ("gome_tpu_torch.obs.capacity.OpenLoopSchedule"
                              if args.rate > 0 else None),
                "note": ("orders_per_sec in this verdict reflects the chosen "
                         "offered drive rate, not fleet capacity; the "
                         "measured knee lives in CAPACITY_CUDA_r01.json"),
            },
            "engine": {"n_slots": args.symbols, "max_t": 32, "cap": 256,
                       "max_fills": 16, "dtype": args.dtype,
                       "device": args.device},
        },
        "table": table,
        "rollup": rollup,
        "stitch": {
            "traces": stitch["traces"],
            "joined": stitch["joined"],
            "per_partition": per_part_stitched,
            "offsets_s": {k: round(v, 6)
                          for k, v in stitch["offsets"].items()},
        },
        "merge": {
            "families": len(merged),
            "roundtrip_identical": merge_roundtrip_ok,
            "orders_consumed_total": {
                "merged": merged_consumed,
                "sum_of_members": member_consumed,
                "grpc_accepted": accepted,
            },
        },
        "seq": {"partitions": audits},
        "members": {name: {"exit_code": r.get("exit_code"),
                           "role": r.get("role"),
                           "partition": r.get("partition"),
                           "stderr": r.get("stderr")}
                    for name, r in results.items()},
        "checks": checks,
        "pass": all(checks.values()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--orders", type=int, default=DRILL_ORDERS,
                    help="the flow's first orders to drive")
    ap.add_argument("--symbols", type=int, default=SYMBOLS)
    ap.add_argument("--rate", type=float, default=600.0,
                    help="open-loop offered rate, aggregate orders/s "
                         "(0 = closed loop)")
    ap.add_argument("--drive-batch", type=int, default=0,
                    help="orders per DoOrderBatch (default: 64 "
                         "rate-controlled, 1024 closed-loop)")
    ap.add_argument("--dtype", default="int64")
    ap.add_argument("--device", default=None,
                    help="the consumers' device (default: the CUDA card)")
    ap.add_argument("--out", default="FLEET_CUDA_r01.json")
    ap.add_argument("--workdir", default="")
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"]:  # a member, started by fleet_members
        return run_worker(argv[1], argv[2:])
    args = ap.parse_args(argv)
    args.device = require_device(args.device)
    if not args.drive_batch:
        args.drive_batch = 64 if args.rate > 0 else DRIVE_BATCH_N
    verdict = run_parent(args)
    write_json(args.out, verdict)
    t = verdict["table"]
    print(f"fleet: {'PASS' if verdict['pass'] else 'FAIL'} -> {args.out}: "
          f"{t['fleet']['orders']} measured orders, "
          f"{t['fleet']['orders_per_sec']} orders/s, imbalance "
          f"{t['imbalance']['max_over_min_orders']}, e2e p50 "
          f"{t['e2e_latency_ms']['p50']} ms")
    for name, ok in verdict["checks"].items():
        print(f"  [{'ok' if ok else 'BREACH'}] {name}")
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
