"""Fleet chaos soak: seeded kill/restart cycles against a LIVE 2x2 fleet
with a machine-checked fault-tolerance verdict (the port of
scripts/fleet_chaos.py).

The chaos drill (scripts.chaos) answers "does one consumer recover
bit-exactly?" against a pre-seeded queue with no service in the loop.
This drill answers the fleet-level question: when real processes die
UNDER LIVE gRPC DRIVE — a consumer killed mid-frame, a gateway killed
mid-admit, the bus "disconnected" under the gateway's feet — does the
deployment as a whole keep the invariants it advertises?

    - every death is an injected one (exit code 86, nothing else dies),
    - clients never lose an entry: gateway deaths are resubmitted
      duplicate-free (gateway.emit fires PRE-publish, so a killed chunk
      was never half-published), bus disconnects surface as the
      retryable status and the driver's backoff path absorbs them,
    - each partition's final book is BIT-EXACT against an uninterrupted
      oracle replay of the same order log (the chaos drill's worker is
      the oracle: same consumer code, same engine geometry),
    - the fleet-wide match stream is exactly-once (per-partition seq
      audit anchored at first_seq=0, zero dupes, zero gaps),
    - recovery is bounded (p99 over all death->caught-up measurements),
    - aggregate accept throughput while a member is down stays above a
      floor (the reference's 100 orders/s),
    - consumer failover rides the router tier: the dead member's
      partitions are reassigned (PartitionMap epoch bump via
      FailoverController) only AFTER the standby's durable-state
      recovery (Persister.restore_latest + WAL catch-up) completes.

Topology (the parent drives everything; 4 long-lived children +
respawns):

    parent                              children (this module, --worker)
    ------                              -----------------------------
    record sim GCO frames               gw0, gw1: OrderGateway + gRPC
    route via fleet.partition_of            (+ admission controller,
    drive rounds of namespaced               gateway.emit fault point)
      DoOrderBatch chunks, retrying    c0, c1: consumer + Persister +
      transport errors + code 14           MatchFeed over the partition
    kill cycles: rotate fault class        file bus (snapshots + WAL)
    failover via fleet router           oracle per partition:
    verdict -> --out                       the chaos drill's worker

Kill rotation (cycle c, 1-indexed): the fault class cycles through
consumer-kill / gateway-kill / bus-disconnect, the victim partition
alternates. Faults are armed by restarting the victim with a FaultPlan
(the restart itself is part of the soak); ``at=(K,)`` counts events of
THAT lifetime, so the schedule is pinned in the verdict.

The drive is paced rounds of the recorded sim flow with a per-round oid
namespace (keys never collide, cancels stay paired with their round's
adds), so the oracle needs no request list: it replays whatever the
gateways durably published. The defaults are the reference's (16 lanes,
--seconds 30: 240 sim steps, chunks of 128 = 16 lanes x 8 bins). The
card's drill runs at the main path's width:

    python -m gome_tpu_torch.scripts.fleet_chaos --lanes 10240 \
        --bins 1024 --seconds 8 \
        --out FLEET_CHAOS_CUDA_r01.json
    python -m gome_tpu_torch.scripts.fleet_chaos --device cpu
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import shutil
import sys
import threading
import time

from ..utils.faults import EXIT_CODE, FaultPlan, FaultSpec
from . import chaos
from .common import expected_launches, provenance, require_device, \
    write_json
from .fleet_drill import (DRIVE_BATCH_N, N_PARTITIONS, SIM_FLOW, Worker,
                          audit_seqs, pctl, record_sim_frames,
                          requests_from_frames, rusage_self)

SCHEMA = "gome-fleet-chaos-verdict-v1"

CLASSES = ("consumer-kill", "gateway-kill", "bus-disconnect")

#: Orders per DoOrderBatch chunk: the reference's N_LANES * T_BINS (one
#: engine dispatch per published frame at 16 lanes).
DRIVE_CHUNK = 128
#: Pause between chunks: paces each partition's drive so a degraded
#: window holds live traffic without drowning the consumers.
PACE_S = 0.3
#: Event index (per victim lifetime) at which the armed fault fires.
HIT_K = 3
EVERY_N = 8  # snapshot cadence in committed consumer batches
SNAP_KEEP = 16

CODE_RETRYABLE = 14  # service.gateway.CODE_RETRYABLE
RETRY_AFTER_RE = re.compile(r"retry-after=([0-9.]+)s")


# -- workers -----------------------------------------------------------------
#
# Same protocol as fleet_drill's members: one "READY ..." line on stdout
# once serving, then block on stdin; any line (or EOF) is the stop
# signal. Injected exit-mode faults hard-exit with EXIT_CODE first.


def _await_stop() -> None:
    try:
        sys.stdin.readline()
    except Exception:
        pass


def run_gateway_worker(args) -> int:
    """One partition's front door: OrderGateway + admission controller
    over the partition file bus. Arms the cycle's FaultPlan (if any)
    and registers the "disconnect" call-handler: a gateway.emit hit in
    call mode raises ConnectionError PRE-publish, which the batch funnel
    converts to CODE_RETRYABLE with accepted=0 — the client's retry path
    absorbs it with zero loss and zero duplicates."""
    from ..bus import make_bus
    from ..config import BusConfig, Config, GrpcConfig
    from ..engine.prepool import RespPrePool, make_marker
    from ..persist.resp import RespClient
    from ..service.admission import AdmissionController
    from ..service.gateway import OrderGateway, serve_gateway
    from ..utils.faults import FAULTS

    bus = make_bus(
        BusConfig(backend="file", dir=args.bus_dir, match_wire="frame")
    )

    def _disconnect() -> None:
        raise ConnectionError("injected bus disconnect (fleet_chaos)")

    FAULTS.handler("disconnect", _disconnect)
    if args.plan:
        with open(args.plan) as f:
            FAULTS.install(FaultPlan.from_json(f.read()))
    admission = AdmissionController(
        bus.order_queue.depth, max_depth=args.max_depth
    )
    # Split-process marker store: marks must land in the partition's RESP
    # server BEFORE publish, or the consumer's admission drops the ADDs as
    # unmarked (the pre-pool contract).
    pool = RespPrePool(RespClient(port=args.resp_port))
    gateway = OrderGateway(
        bus, accuracy=0, mark=make_marker(pool), admission=admission,
        mark_frame=pool.mark_frame, unmark_frame=pool.unmark_frame,
    )
    server = serve_gateway(
        gateway, Config(grpc=GrpcConfig(host="127.0.0.1", port=0))
    )
    print(f"READY ops=0 grpc={server.bound_port}", flush=True)
    _await_stop()
    result = {
        "role": "gateway",
        "partition": args.partition,
        "published": {"doOrder": bus.order_queue.end_offset()},
        "faults": FAULTS.report() if args.plan else None,
        "rusage": rusage_self(),
    }
    write_json(args.result, result)
    server.stop(grace=1).wait()
    return 0


def run_consumer_worker(args, keep=None, finish=None) -> int:
    """One partition's engine half for one process lifetime: restore
    durable state, (optionally) arm the cycle's FaultPlan, then consume
    live under the threaded consumer until told to stop. The graceful
    final lifetime writes the book digest the oracle comparison pins.
    The READY line carries boot_ms (interpreter up to the engine built)
    and restore_ms (restore_latest). `keep` and `finish(kept, result)`
    as in chaos.run_worker."""
    import contextlib

    t_enter = time.monotonic()
    from ..bus import make_bus
    from ..config import BusConfig, PersistConfig
    from ..engine.prepool import RespPrePool
    from ..ops.match_step import batch_step
    from ..persist import Persister
    from ..persist.resp import RespClient
    from ..service import MatchFeed, OrderConsumer
    from ..utils.faults import FAULTS

    bus = make_bus(
        BusConfig(backend="file", dir=args.bus_dir, match_wire="frame")
    )
    engine = chaos.build_engine(args.device, args.lanes)
    # Same RESP store the partition's gateway marks into: consumption at
    # admission is the cross-process half of the exactly-once contract.
    # Assigned before attach/restore — restore_latest() rebuilds marks
    # into this pool in place (clear + update + WAL-tail reconstruct).
    engine.pre_pool = RespPrePool(RespClient(port=args.resp_port))
    persist = Persister(PersistConfig(
        enabled=True, dir=args.snap_dir, every_n_batches=EVERY_N,
        keep=SNAP_KEEP,
    ))
    consumer = OrderConsumer(
        engine, bus, batch_n=4, batch_wait_s=0.02,
        on_batch=persist.on_batch, match_wire="frame",
    )
    feed = MatchFeed(bus, log_events=False)
    persist.attach(engine, bus, consumer=consumer)
    pre_committed = bus.order_queue.committed()
    t0 = time.monotonic()
    persist.restore_latest()
    t1 = time.monotonic()
    # Arm AFTER restore (the chaos drill's discipline): restore-time
    # replay must not consume fault hits, so at=(K,) indexes the K-th
    # frame THIS lifetime consumes live.
    if args.plan:
        with open(args.plan) as f:
            FAULTS.install(FaultPlan.from_json(f.read()))
    batch_step.launches = 0
    with (keep() if keep else contextlib.nullcontext(None)) as kept:
        consumer.start()
        feed.start()
        print(f"READY ops=0 grpc=0 boot_ms={round((t0 - t_enter) * 1e3)} "
              f"restore_ms={round((t1 - t0) * 1e3)}", flush=True)
        _await_stop()
        consumer.stop()
        consumer.drain()  # any frames between the last poll and the stop
        launches = batch_step.launches
    feed.stop()
    feed.drain()
    oq, mq = bus.order_queue, bus.match_queue
    result = {
        "role": "consumer",
        "partition": args.partition,
        "pre_committed": pre_committed,
        "restore": persist.probe(),
        "book_digest": chaos.book_digest(engine),
        "match_seq": consumer.match_seq,
        "feed": feed.seq_state(),
        "faults": FAULTS.report() if args.plan else None,
        "oq": {"end": oq.end_offset(), "committed": oq.committed()},
        "mq": {"end": mq.end_offset(), "committed": mq.committed()},
        "rusage": rusage_self(),
        "launches": launches,
        "expected_launches": expected_launches(engine),
        "cap": engine.config.cap,
    }
    if finish is not None:
        finish(kept, result)
    write_json(args.result, result)
    return 0


# -- parent: fault plans -----------------------------------------------------


def drive_chunk(lanes: int, bins: int) -> int:
    """Orders per DoOrderBatch chunk: a sim step's bins over every lane,
    as the reference's DRIVE_CHUNK (16 lanes x 8 bins), and at most
    fleet_drill.DRIVE_BATCH_N a request (1,024 at the card's 10,240 x
    1,024)."""
    return min(lanes * bins, DRIVE_BATCH_N)


def class_for_cycle(cycle: int) -> tuple[str, int]:
    """(fault class, victim partition) for 1-indexed cycle: the class
    rotates through all three, the partition alternates."""
    return CLASSES[(cycle - 1) % 3], (cycle - 1) % N_PARTITIONS


def plan_for_cycle(cycle: int, seed: int, klass: str) -> FaultPlan:
    if klass == "consumer-kill":
        spec = FaultSpec("consumer.frame", mode="exit", at=(HIT_K,))
    elif klass == "gateway-kill":
        spec = FaultSpec("gateway.emit", mode="exit", at=(HIT_K,))
    else:  # bus-disconnect: three consecutive emit attempts fail soft
        spec = FaultSpec(
            "gateway.emit", mode="call", handler="disconnect",
            at=(HIT_K, HIT_K + 1, HIT_K + 2),
        )
    return FaultPlan(seed=seed * 1000 + cycle, faults=(spec,))


# -- parent: chaos-aware drive -----------------------------------------------


class DriveCtl:
    """Shared state between the parent and the per-partition driver
    threads: live gateway targets (the parent repoints a partition after
    a restart), per-partition tallies, and timestamped cumulative-accept
    samples for degraded-window throughput."""

    def __init__(self, drive_chunk: int = DRIVE_CHUNK) -> None:
        self.lock = threading.Lock()
        self.drive_chunk = drive_chunk
        self.targets: dict[int, str] = {}
        # Health-gated shedding, parent-side: while a partition's member is
        # down its driver parks between chunks (the router tier would shed
        # RouteUnavailable; the drill sheds at the source). `idle[p]` acks
        # that no chunk is in flight — the standby's restore can then
        # rebuild the shared mark store without racing live marking.
        self.pause = {p: threading.Event() for p in range(N_PARTITIONS)}
        self.idle = {p: threading.Event() for p in range(N_PARTITIONS)}
        self.stats = {
            p: {
                "accepted": 0, "rejected": 0, "aborted": 0,
                "transport_retries": 0, "shed_retries": 0,
                "disconnect_retries": 0,
            }
            for p in range(N_PARTITIONS)
        }
        # [(monotonic_t, cumulative_accepted)]  guarded by self.lock
        self.samples: dict[int, list] = {p: [] for p in range(N_PARTITIONS)}

    def stat(self, p: int, key: str) -> int:
        with self.lock:
            return self.stats[p][key]


def _ns_requests(base: list, ns: str) -> list:
    """Re-key one round of the recorded flow under a fresh oid namespace:
    (symbol, uuid, oid) keys never collide across rounds, and cancels
    stay paired with their own round's adds (both get the prefix)."""
    from ..api import order_pb2 as pb

    out = []
    for is_cancel, r in base:
        q = pb.OrderRequest()
        q.CopyFrom(r)
        q.oid = f"{ns}.{r.oid}"
        out.append((is_cancel, q))
    return out


def _send_chunk(ctl: DriveCtl, p: int, chunk: list) -> None:
    """Deliver one chunk come what may: transport errors mean the
    gateway is down or restarting — the in-flight batch was NOT
    published (gateway.emit fires pre-publish), so resubmitting the
    whole chunk to the restarted gateway is duplicate-free. CODE_RETRYABLE
    means shed or disconnected: resubmit the unconsumed tail after the
    server's retry-after hint (the remainder contract)."""
    import grpc

    from ..api import order_pb2 as pb
    from ..api.service import OrderStub

    while chunk:
        target = ctl.targets[p]
        breq = pb.OrderBatchRequest(
            orders=[r for _, r in chunk],
            cancel=[c for c, _ in chunk],
        )
        try:
            with grpc.insecure_channel(target) as channel:
                resp = OrderStub(channel).DoOrderBatch(breq, timeout=30)
        except grpc.RpcError:
            with ctl.lock:
                ctl.stats[p]["transport_retries"] += 1
            time.sleep(0.25)
            continue
        # Consumed prefix contract: every entry before an abort point was
        # either accepted or per-entry rejected (clients/doorder.py).
        consumed = resp.accepted + len(resp.reject_index)
        with ctl.lock:
            st = ctl.stats[p]
            st["accepted"] += resp.accepted
            st["rejected"] += len(resp.reject_index)
            ctl.samples[p].append((time.monotonic(), st["accepted"]))
        if resp.code == CODE_RETRYABLE:
            msg = resp.message or ""
            key = (
                "disconnect_retries" if "batch aborted" in msg
                else "shed_retries"
            )
            with ctl.lock:
                ctl.stats[p][key] += 1
            chunk = chunk[consumed:]
            m = RETRY_AFTER_RE.search(msg)
            time.sleep(max(float(m.group(1)) if m else 0.0, 0.2))
            continue
        if consumed < len(chunk):  # permanent abort: count, don't hide
            with ctl.lock:
                ctl.stats[p]["aborted"] += len(chunk) - consumed
        return


def _drive_partition(
    ctl: DriveCtl, p: int, base: list, phase: str, done: threading.Event,
    min_rounds: int,
) -> None:
    r = 0
    step = ctl.drive_chunk
    while r < min_rounds or not done.is_set():
        reqs = _ns_requests(base, f"{phase}.r{r}")
        for i in range(0, len(reqs), step):
            if ctl.pause[p].is_set():
                ctl.idle[p].set()
                while ctl.pause[p].is_set() and not done.is_set():
                    time.sleep(0.05)
                ctl.idle[p].clear()
            _send_chunk(ctl, p, reqs[i : i + step])
            time.sleep(PACE_S)
        r += 1


def drive_burst(
    ctl: DriveCtl, parts: list, phase: str, done: threading.Event,
    min_rounds: int = 1,
) -> list:
    threads = [
        threading.Thread(
            target=_drive_partition,
            args=(ctl, p, [(c, r) for _, c, r in parts[p]], phase, done,
                  min_rounds),
            daemon=True,
        )
        for p in range(N_PARTITIONS)
    ]
    for t in threads:
        t.start()
    return threads


def window_rate(ctl: DriveCtl, t0: float, t1: float) -> dict:
    """Aggregate fleet accept throughput inside [t0, t1] from the
    cumulative samples (nearest sample at or before each edge)."""
    total = 0
    with ctl.lock:
        samples = {p: list(ctl.samples[p]) for p in range(N_PARTITIONS)}
    for p in range(N_PARTITIONS):
        a0 = a1 = 0
        for t, a in samples[p]:
            if t <= t0:
                a0 = a
            if t <= t1:
                a1 = a
            else:
                break
        total += a1 - a0
    dur = max(1e-9, t1 - t0)
    return {
        "orders": total,
        "window_s": round(t1 - t0, 3),
        "orders_per_s": round(total / dur, 1),
    }


# -- parent: durable-offset polling (sidecar reads, never FileQueue opens:
# opening a live queue from a second process could truncate a mid-append
# tail the writer is still fsyncing) --------------------------------------

_OFF_RE = re.compile(rb"\s*(\d+)")


def log_end(bus_dir: str) -> int:
    """Record count of the order log — the same unit the committed
    sidecar carries (FileQueue offsets are record indexes). Walks the
    4-byte-BE length prefixes; an incomplete tail record (live writer
    mid-append) is not counted, matching FileQueue's own tail rule."""
    path = os.path.join(bus_dir, "doOrder.log")
    n = 0
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            pos = 0
            while pos + 4 <= size:
                ln = int.from_bytes(f.read(4), "big")
                if pos + 4 + ln > size:
                    break  # torn/live tail: not yet a record
                f.seek(ln, os.SEEK_CUR)
                pos += 4 + ln
                n += 1
    except OSError:
        return 0
    return n


def committed(bus_dir: str) -> int:
    try:
        with open(os.path.join(bus_dir, "doOrder.offset"), "rb") as f:
            m = _OFF_RE.match(f.read())
        return int(m.group(1)) if m else 0
    except OSError:
        return 0


def await_committed(bus_dir: str, target: int, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if committed(bus_dir) >= target:
            return True
        time.sleep(0.2)
    return False


# -- parent ------------------------------------------------------------------


def default_launcher(role: str) -> list:
    """A member's command: this module's --worker <role>."""
    return [sys.executable, "-m", "gome_tpu_torch.scripts.fleet_chaos",
            "--worker", role]


class Fleet:
    """Process bookkeeping: current worker per slot plus the full
    lifetime ledger (every spawn's armed class + observed exit code —
    the injected-deaths-only check reads this)."""

    def __init__(
        self, work: str, bus_dirs: list, snap_dirs: list, resp_ports: list,
        device: str = "cuda", lanes: int = chaos.N_LANES,
        max_depth: int = 16384, launcher=default_launcher,
    ):
        self.work = work
        self.bus_dirs = bus_dirs
        self.snap_dirs = snap_dirs
        self.resp_ports = resp_ports
        self.device = device
        self.lanes = lanes
        self.max_depth = max_depth
        self.launcher = launcher
        self.current: dict[str, Worker] = {}
        self.lifetimes: list[dict] = []
        self._n = 0

    def start(self, role: str, p: int, plan_path: str | None = None,
              armed: str | None = None) -> Worker:
        """Start one member (not waiting for READY)."""
        name = ("gw" if role == "gateway" else "c") + str(p)
        self._n += 1
        result = os.path.join(self.work, f"{name}_L{self._n}.json")
        cmd = [
            *self.launcher(role),
            "--bus-dir", self.bus_dirs[p],
            "--partition", str(p),
            "--result", result,
            "--resp-port", str(self.resp_ports[p]),
            "--device", self.device, "--lanes", str(self.lanes),
            "--max-depth", str(self.max_depth),
        ]
        if role == "consumer":
            cmd += ["--snap-dir", self.snap_dirs[p]]
        if plan_path:
            cmd += ["--plan", plan_path]
        w = Worker(name, cmd, err=result + ".err")
        w.t_start = time.monotonic()
        self.current[name] = w
        self.lifetimes.append({
            "name": name, "role": role, "partition": p, "lifetime": self._n,
            "armed": armed, "result": result, "exit_code": None,
        })
        w.ledger = self.lifetimes[-1]
        return w

    def await_ready(self, w: Worker, timeout_s: float = 300.0) -> Worker:
        """Wait for w's READY line; its lifetime records the seconds from
        its start and the boot and restore times it reported."""
        w.await_ready(timeout_s=timeout_s)
        w.ledger["ready_s"] = round(time.monotonic() - w.t_start, 3)
        for key in ("boot_ms", "restore_ms"):
            if key in w.ports:
                w.ledger[key] = w.ports[key]
        return w

    def spawn(
        self, role: str, p: int, plan_path: str | None = None,
        armed: str | None = None,
    ) -> Worker:
        return self.await_ready(self.start(role, p, plan_path, armed))

    def note_exit(self, w: Worker, rc: int) -> None:
        w.ledger["exit_code"] = rc

    def stop(self, name: str) -> int:
        w = self.current.pop(name, None)
        if w is None:
            return 0
        rc = w.stop(timeout_s=90.0)
        self.note_exit(w, rc)
        return rc

    def result_of(self, name: str) -> dict:
        for lt in reversed(self.lifetimes):
            if lt["name"] == name:
                try:
                    with open(lt["result"]) as f:
                        return json.load(f)
                except (OSError, ValueError):
                    return {}
        return {}


def run_oracle(work: str, bus_dir: str, p: int, device: str, lanes: int,
               launcher=chaos.default_launcher) -> tuple[int, dict, str]:
    """Uninterrupted replay of partition p's durable order log through
    the chaos drill's worker (same consumer code path, same engine
    geometry, fresh snapshot dir) — the bit-exactness baseline."""
    obus = os.path.join(work, f"oracle{p}", "bus")
    osnap = os.path.join(work, f"oracle{p}", "snaps")
    os.makedirs(obus, exist_ok=True)
    os.makedirs(osnap, exist_ok=True)
    # Copy ONLY the log: no offset sidecar, so the oracle consumes from 0.
    shutil.copyfile(
        os.path.join(bus_dir, "doOrder.log"),
        os.path.join(obus, "doOrder.log"),
    )
    out = os.path.join(work, f"oracle{p}_result.json")
    rc, _ = chaos.run_child(obus, osnap, out, device=device, lanes=lanes,
                            launcher=launcher, timeout_s=1200.0)
    return rc, chaos.read_result(out) or {}, obus


def run_parent(args, launcher=default_launcher,
               oracle_launcher=chaos.default_launcher) -> dict:
    """The whole soak; returns the verdict (main() writes it). The final
    consumer lifetimes' and the oracles' results (K1 launches and, under
    chip_smoke, kept-input files) ride along under ``workers``, which
    the verdict file leaves out."""
    import tempfile

    from ..fleet import FailoverController, HealthGate, PartitionMap
    from .fleet_drill import start_respserver

    work = args.workdir or tempfile.mkdtemp(prefix="gome-fleet-chaos-")
    os.makedirs(work, exist_ok=True)
    n_steps = max(32, min(480, args.seconds * 8))
    print(f"fleet-chaos: recording {n_steps} sim steps (seed {args.seed}, "
          f"{args.lanes} lanes x {args.bins} bins on {args.device})...",
          flush=True)
    frames = record_sim_frames(args.seed, n_steps, args.lanes, args.device,
                               args.bins)
    parts = requests_from_frames(frames)
    base_counts = [len(p) for p in parts]
    print(f"fleet-chaos: {len(frames)} frames -> base round "
          f"{base_counts} orders/partition in {work}", flush=True)

    bus_dirs, snap_dirs = [], []
    for i in range(N_PARTITIONS):
        bus_dirs.append(os.path.join(work, f"p{i}", "bus"))
        snap_dirs.append(os.path.join(work, f"p{i}", "snaps"))
        os.makedirs(bus_dirs[i], exist_ok=True)
        os.makedirs(snap_dirs[i], exist_ok=True)

    # One marker store per partition (never a kill target). Per-partition
    # keeps the book digest honest — pre-pool iteration is store-wide.
    resp_procs: list[dict] = [{} for _ in range(N_PARTITIONS)]
    resp_ports = [start_respserver(procs) for procs in resp_procs]
    print(f"fleet-chaos: marker stores on ports {resp_ports}", flush=True)

    fleet = Fleet(work, bus_dirs, snap_dirs, resp_ports, args.device,
                  args.lanes, args.max_depth, launcher)
    chunk = drive_chunk(args.lanes, args.bins)
    ctl = DriveCtl(chunk)

    # Router tier state the failover drill runs over: consumer members
    # own partitions; health is ground truth from the parent's process
    # monitoring (mark_down on an observed death).
    pmap = PartitionMap(
        N_PARTITIONS, {i: f"m{i}" for i in range(N_PARTITIONS)}
    )
    gate = HealthGate()
    fc = FailoverController(pmap, gate)

    cycles: list[dict] = []
    recoveries: list[float] = []
    all_ready = False
    drained_final = [False] * N_PARTITIONS
    t_run0 = time.monotonic()
    boot_s = warm_s = None

    def now() -> float:
        return round(time.monotonic() - t_run0, 3)

    try:
        # Every member boots at once; each is awaited in turn.
        started = []
        for i in range(N_PARTITIONS):
            started.append(fleet.start("consumer", i))
            started.append(fleet.start("gateway", i))
        for w in started:
            fleet.await_ready(w)
        for i in range(N_PARTITIONS):
            ctl.targets[i] = f"127.0.0.1:{fleet.current[f'gw{i}'].ports['grpc']}"
        all_ready = True
        boot_s = now()
        for i in range(N_PARTITIONS):
            gate.record(f"m{i}", True)
            gate.record(f"gw{i}", True)
        print(f"fleet-chaos: 2x2 fleet up at t={boot_s}s "
              f"(targets {sorted(ctl.targets.items())})", flush=True)

        # Warm round: the consumers' first device dispatches (the CUDA
        # context's first launches, the kernel's load) happen here, so
        # cycle recovery times measure recovery, not cold-start skew.
        done = threading.Event()
        done.set()
        for t in drive_burst(ctl, parts, "warm", done, min_rounds=1):
            t.join(timeout=300)
        for i in range(N_PARTITIONS):
            await_committed(bus_dirs[i], log_end(bus_dirs[i]), 240.0)
        warm_s = round(now() - boot_s, 3)
        print(f"fleet-chaos: warm round done at t={now()}s "
              f"(accepted {[ctl.stat(p, 'accepted') for p in range(2)]})",
              flush=True)

        for c in range(1, args.kills + 1):
            klass, p = class_for_cycle(c)
            plan = plan_for_cycle(c, args.seed, klass)
            plan_path = os.path.join(work, f"plan_{c}.json")
            with open(plan_path, "w") as f:
                f.write(plan.to_json())
            victim_name = ("c" if klass == "consumer-kill" else "gw") + str(p)
            cyc: dict = {
                "cycle": c, "class": klass, "partition": p,
                "victim": victim_name, "plan": plan.to_dict(),
                "t_armed": now(),
            }
            print(f"fleet-chaos: cycle {c} [{klass}] partition {p} "
                  f"-> arming {victim_name}", flush=True)

            # Re-arm by restart: graceful stop, spawn with the plan. No
            # drive is in flight between bursts, so the stop is clean.
            fleet.stop(victim_name)
            victim = fleet.spawn(
                "consumer" if klass == "consumer-kill" else "gateway",
                p, plan_path=plan_path, armed=klass,
            )
            if klass != "consumer-kill":
                ctl.targets[p] = f"127.0.0.1:{victim.ports['grpc']}"

            done = threading.Event()
            threads = drive_burst(ctl, parts, f"c{c}", done, min_rounds=1)
            try:
                if klass == "bus-disconnect":
                    # No death: the armed gateway soft-fails three emits
                    # (CODE_RETRYABLE); wait until the drivers' retry
                    # tallies show all three absorbed.
                    base_disc = ctl.stat(p, "disconnect_retries")
                    deadline = time.monotonic() + 180.0
                    while time.monotonic() < deadline:
                        if ctl.stat(p, "disconnect_retries") - base_disc >= 3:
                            break
                        time.sleep(0.25)
                    cyc["disconnect_retries"] = (
                        ctl.stat(p, "disconnect_retries") - base_disc
                    )
                    cyc["recovery_s"] = None
                    print(f"fleet-chaos: cycle {c} absorbed "
                          f"{cyc['disconnect_retries']} disconnects",
                          flush=True)
                else:
                    rc = victim.proc.wait(timeout=360)
                    t_death = time.monotonic()
                    fleet.note_exit(victim, rc)
                    fleet.current.pop(victim_name, None)
                    cyc["victim_exit"] = rc
                    cyc["t_death"] = now()
                    if rc != EXIT_CODE:
                        cyc["victim_stderr"] = victim.stderr_tail()
                    print(f"fleet-chaos: cycle {c} {victim_name} died "
                          f"rc={rc} at t={cyc['t_death']}s", flush=True)
                    if klass == "consumer-kill":
                        dead = pmap.owner(p)
                        gate.mark_down(dead)
                        standby = f"m{p}s{c}"
                        # Park p's driver (health-gated shed) and wait for
                        # the in-flight chunk to land: the standby's restore
                        # rebuilds the shared mark store from the durable
                        # log, which must not race live gateway marking.
                        ctl.pause[p].set()
                        ctl.idle[p].wait(timeout=120.0)
                        target = log_end(bus_dirs[p])
                        parts_of_recovery = {}

                        def recover(dead_member, partitions):
                            t_spawn = time.monotonic()
                            w = fleet.spawn("consumer", p)
                            t_ready = time.monotonic()
                            if not await_committed(
                                bus_dirs[p], target,
                                args.recovery_timeout,
                            ):
                                raise RuntimeError(
                                    f"standby for {dead_member} never "
                                    f"caught up to {target}"
                                )
                            parts_of_recovery.update(
                                park_s=round(t_spawn - t_death, 3),
                                ready_s=round(t_ready - t_spawn, 3),
                                boot_s=w.ports.get("boot_ms", 0) / 1e3,
                                restore_s=w.ports.get("restore_ms", 0)
                                / 1e3,
                                catch_up_s=round(
                                    time.monotonic() - t_ready, 3),
                                target=target)

                        # Reassignment ONLY after durable recovery: the
                        # claim->recover->commit protocol under test.
                        try:
                            epoch = fc.failover(dead, standby, recover)
                        finally:
                            ctl.pause[p].clear()
                        rec_s = time.monotonic() - t_death
                        gate.record(standby, True)
                        cyc["failover"] = {
                            "dead": dead, "standby": standby,
                            "epoch": epoch,
                        }
                        cyc["recovery_parts"] = parts_of_recovery
                    else:  # gateway-kill
                        gate.mark_down(f"gw{p}")
                        gw = fleet.spawn("gateway", p)
                        ctl.targets[p] = f"127.0.0.1:{gw.ports['grpc']}"
                        rec_s = time.monotonic() - t_death
                        gate.record(f"gw{p}", True)
                    cyc["recovery_s"] = round(rec_s, 3)
                    recoveries.append(rec_s)
                    cyc["degraded"] = window_rate(
                        ctl, t_death, t_death + rec_s
                    )
                    print(f"fleet-chaos: cycle {c} recovered in "
                          f"{rec_s:.1f}s (degraded window "
                          f"{cyc['degraded']['orders_per_s']} orders/s)",
                          flush=True)
            finally:
                done.set()
            for t in threads:
                t.join(timeout=300)
            cyc["t_done"] = now()
            cycles.append(cyc)

        # -- final drain: gateways are idle, ends are stable ------------
        for i in range(N_PARTITIONS):
            backlog = log_end(bus_dirs[i]) - committed(bus_dirs[i])
            drained_final[i] = await_committed(
                bus_dirs[i], log_end(bus_dirs[i]),
                120.0 + backlog / 4096.0,
            )
        print(f"fleet-chaos: final drain={drained_final} at t={now()}s",
              flush=True)
    finally:
        for name in [f"gw{i}" for i in range(N_PARTITIONS)] + [
            f"c{i}" for i in range(N_PARTITIONS)
        ]:
            fleet.stop(name)
        # Any stragglers (distinct lifetimes) die hard.
        for w in list(fleet.current.values()):
            w.kill()
        # Marker stores outlive the consumers: the final graceful stop
        # reads the pool (book digest) through them.
        for procs in resp_procs:
            if "respserver" in procs:
                procs["respserver"].kill()
    t_drive_end = now()

    # -- oracle replays + durable audits (everyone is dead now) ---------
    with concurrent.futures.ThreadPoolExecutor(N_PARTITIONS) as pool:
        oracles = list(pool.map(
            lambda i: run_oracle(work, bus_dirs[i], i, args.device,
                                 args.lanes, oracle_launcher),
            range(N_PARTITIONS)))
    partitions = []
    finals = []
    for i in range(N_PARTITIONS):
        final = fleet.result_of(f"c{i}")
        finals.append(final)
        orc, oracle, obus = oracles[i]
        fleet_lines, fleet_seqs = chaos.read_match_stream(bus_dirs[i])
        oracle_lines, _ = chaos.read_match_stream(obus)
        partitions.append({
            "partition": i,
            "events": len(fleet_lines),
            "stamped": len(fleet_seqs),
            "seq_audit": audit_seqs(fleet_seqs),
            "book_digest": final.get("book_digest"),
            "oracle_digest": oracle.get("book_digest"),
            "digest_match": (
                bool(final.get("book_digest"))
                and final.get("book_digest") == oracle.get("book_digest")
            ),
            "match_stream_identical": (
                len(fleet_lines) > 0 and fleet_lines == oracle_lines
            ),
            "match_seq": final.get("match_seq"),
            "oracle_match_seq": oracle.get("match_seq"),
            "feed": final.get("feed"),
            "oracle_exit": orc,
            "orders_committed": (final.get("oq") or {}).get("committed"),
        })
        print(f"fleet-chaos: partition {i} digest "
              f"{'MATCH' if partitions[-1]['digest_match'] else 'MISMATCH'} "
              f"({len(fleet_lines)} events)", flush=True)

    # -- verdict --------------------------------------------------------
    death_cycles = [c for c in cycles if c["class"] != "bus-disconnect"]
    disc_cycles = [c for c in cycles if c["class"] == "bus-disconnect"]
    stats = {str(p): dict(ctl.stats[p]) for p in range(N_PARTITIONS)}
    checks = {
        "all_members_ready": all_ready,
        "injected_deaths_only": bool(fleet.lifetimes) and all(
            lt["exit_code"] == (
                EXIT_CODE
                if lt["armed"] in ("consumer-kill", "gateway-kill")
                else 0
            )
            for lt in fleet.lifetimes
        ),
        "covered_fault_classes": (
            {c["class"] for c in cycles} >= set(CLASSES)
        ),
        "disconnect_absorbed": bool(disc_cycles) and all(
            c.get("disconnect_retries", 0) >= 3 for c in disc_cycles
        ),
        "no_lost_entries": all(
            s["aborted"] == 0 for s in stats.values()
        ),
        "all_partitions_drained": all(drained_final),
        "book_digest_match": all(p["digest_match"] for p in partitions),
        "match_stream_identical": all(
            p["match_stream_identical"] for p in partitions
        ),
        "exactly_once_fleet": all(
            p["seq_audit"]["dupes"] == 0 and p["seq_audit"]["gaps"] == 0
            and (p["feed"] or {}).get("dupes") == 0
            and (p["feed"] or {}).get("gaps") == 0
            for p in partitions
        ),
        "failover_after_recovery": all(
            (c.get("failover") or {}).get("epoch") is not None
            for c in cycles if c["class"] == "consumer-kill"
        ) and any(c["class"] == "consumer-kill" for c in cycles),
        "recovery_measured": len(recoveries) == len(death_cycles),
        "recovery_bounded": (
            bool(recoveries)
            and pctl(recoveries, 99) <= args.recovery_bound
        ),
        "throughput_floor_degraded": bool(death_cycles) and all(
            c["degraded"]["orders_per_s"] >= args.floor
            for c in death_cycles
        ),
        "oracle_clean_exit": all(
            p["oracle_exit"] == 0 for p in partitions
        ),
    }
    departures = chaos.departures(args)
    if chunk != DRIVE_CHUNK:
        departures.append(f"DoOrderBatch chunks of {chunk} (the "
                          f"reference's {DRIVE_CHUNK} = 16 lanes x 8 bins)")
    verdict = {
        "schema": SCHEMA,
        "artifact": os.path.splitext(os.path.basename(args.out))[0],
        "provenance": provenance(args.device),
        "config": {
            "seed": args.seed,
            "seconds": args.seconds,
            "kills": args.kills,
            "n_steps": n_steps,
            "base_orders_per_partition": base_counts,
            "partitions": N_PARTITIONS,
            "drive_chunk": chunk,
            "pace_s": PACE_S,
            "hit_k": HIT_K,
            "floor_orders_per_s": args.floor,
            "recovery_bound_s": args.recovery_bound,
            "admission_max_depth": args.max_depth,
            "every_n_batches": EVERY_N,
            "engine": dict(chaos.engine_geometry(args.lanes),
                           auto_grow=True, device=args.device),
            "sim": dict(SIM_FLOW, n_lanes=args.lanes, t_bins=args.bins,
                        recorded_on=args.device),
            "departures": departures,
        },
        "timing": {
            "boot_s": boot_s, "warm_round_s": warm_s,
            "drive_end_s": t_drive_end, "total_s": now(),
        },
        "cycles": cycles,
        "recovery": {
            "samples_s": [round(r, 3) for r in recoveries],
            "p50_s": pctl(recoveries, 50),
            "p99_s": pctl(recoveries, 99),
        },
        "throughput": {
            "degraded_windows": {
                str(c["cycle"]): c["degraded"] for c in death_cycles
            },
            "floor_orders_per_s": args.floor,
            "fleet_cuda_r01_orders_per_s": fleet_artifact_rate(),
        },
        "drivers": stats,
        "router": {
            "map": pmap.snapshot(),
            "failovers": fc.history(),
            "health": gate.snapshot(),
        },
        "partitions": partitions,
        "lifetimes": [
            {k: lt.get(k) for k in
             ("name", "role", "partition", "lifetime", "armed", "exit_code",
              "ready_s", "boot_ms", "restore_ms")}
            for lt in fleet.lifetimes
        ],
        "checks": checks,
        "pass": all(checks.values()),
    }
    verdict["workers"] = {"finals": finals,
                          "oracles": [o[1] for o in oracles]}
    return verdict


def fleet_artifact_rate() -> float | None:
    """FLEET_CUDA_r01.json's measured fleet orders/s (the 2 x 2 fleet on
    the card with no member down), or None without the file."""
    from .common import REPO

    try:
        with open(os.path.join(REPO, "FLEET_CUDA_r01.json")) as f:
            return json.load(f)["table"]["fleet"]["orders_per_sec"]
    except (OSError, ValueError, KeyError):
        return None


def print_verdict(verdict: dict, out: str) -> None:
    print(f"fleet-chaos: {'PASS' if verdict['pass'] else 'FAIL'} -> {out}")
    for name, ok in verdict["checks"].items():
        print(f"  [{'ok' if ok else 'BREACH'}] {name}")


def worker_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bus-dir", required=True)
    ap.add_argument("--result", required=True)
    ap.add_argument("--snap-dir", default="")
    ap.add_argument("--plan", default="")
    ap.add_argument("--device", default="cuda")
    for name, default in (("--partition", 0), ("--resp-port", 0),
                          ("--lanes", chaos.N_LANES),
                          ("--max-depth", 16384)):
        ap.add_argument(name, type=int, default=default)
    return ap.parse_args(argv)


def run_worker(role: str, argv, consumer=run_consumer_worker) -> int:
    args = worker_args(argv)
    return (consumer if role == "consumer" else run_gateway_worker)(args)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"]:  # a member, started by Fleet.start
        return run_worker(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=int, default=30,
                    help="soak scale knob: sim steps = seconds*8 (clamped)")
    ap.add_argument("--kills", type=int, default=3,
                    help="kill/restart cycles (fault class rotates)")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--lanes", type=int, default=chaos.N_LANES,
                    help="the consumers' lanes and the sim's")
    ap.add_argument("--bins", type=int, default=chaos.T_BINS,
                    help="the sim's bins a step (the reference's 8)")
    ap.add_argument("--device", default=None,
                    help="the consumers' and the recording's device "
                         "(default: the CUDA card)")
    ap.add_argument("--out", default="FLEET_CHAOS_CUDA_r01.json",
                    help="verdict JSON path")
    ap.add_argument("--workdir", default="",
                    help="scratch dir (default: fresh tempdir)")
    ap.add_argument("--floor", type=float, default=100.0,
                    help="degraded-window aggregate floor, orders/sec")
    ap.add_argument("--recovery-bound", type=float, default=150.0,
                    help="p99 recovery ceiling, seconds")
    ap.add_argument("--recovery-timeout", type=float, default=300.0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--max-depth", type=int, default=16384,
                    help="gateway admission depth ceiling")
    args = ap.parse_args(argv)
    args.device = require_device(args.device)
    verdict = run_parent(args)
    verdict.pop("workers")
    write_json(args.out, verdict)
    print_verdict(verdict, args.out)
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
