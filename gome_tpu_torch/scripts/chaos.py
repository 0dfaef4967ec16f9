"""Chaos soak: seeded kill/restart cycles with a machine-checked verdict
(the port of scripts/chaos.py).

The question this script answers: after N real process deaths injected at
the nastiest points we know (mid-frame, inside the at-least-once window,
torn sidecar writes, torn snapshot manifests, torn log appends), does
recovery produce the EXACT state and event stream an uninterrupted run
produces?

Topology (everything file-backed, no gateway, no threads):

    parent                          worker child (this module, --worker)
    ------                          -----------------------------------
    record sim GCO frames  ──────>  doOrder FileQueue (pre-published)
    oracle child: clean run (its    boot -> Persister.restore_latest()
      own queue, beside the cycles)
    kill cycle c = 1..N:            -> arm FAULTS from the cycle's plan
      write FaultPlan JSON          -> consume synchronously until the
      run child, expect exit 86        injected fault kills the process
    final child: clean run, exit 0     (exit EXIT_CODE) or queue drains
    compare: book digest,           -> MatchFeed.drain() + book digest
      match stream bytes,           -> result JSON (progressive write at
      seq audit, recovery p50/p99      WAL catch-up, full at completion)

Determinism: the worker is single-threaded (batch_n=1, per-message
commit), the fault registry is armed AFTER restore_latest() so a plan's
``at=(K,)`` indexes positions in THIS run's replay stream, and the sim
flow never reuses a (symbol, uuid, oid) key — so the recovery-time
DEL-suppression in Persister._reconstruct_marks cannot diverge replay from
the oracle.

The engine geometry is the reference's (cap 64 with auto_grow, K 8,
``max_t`` 8, int64) at ``--lanes`` lanes: 16 by default, the reference's
own configuration; the card's drill runs at the main path's 10,240. The
sim flow keeps the reference's rates and dt; it holds at most one event a
bin, so its orders follow ``--bins`` (bins a step: the reference's 8 by
default, bench.py's 1,024 at 10,240 lanes on the card), not the lanes. A
CUDA generator's bits are not a CPU one's, so frames, counts and digests
follow the recording device; what the verdict compares is always the
oracle run against the recovered run on the same frames.

The verdict (schema ``gome-chaos-verdict-v1``, the reference's keys and
nine checks, plus the run's provenance) goes to --out:

    python -m gome_tpu_torch.scripts.chaos --kills 5 --lanes 10240 \
        --bins 1024 --out CHAOS_CUDA_r01.json
    python -m gome_tpu_torch.scripts.chaos --device cpu --kills 5
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

from ..utils.faults import EXIT_CODE, FaultPlan, FaultSpec
from .common import REPO, provenance, require_device, write_json
from .fleet_drill import (CARD_BINS, SIM_FLOW, audit_seqs, pctl,
                          record_sim_frames)

SCHEMA = "gome-chaos-verdict-v1"

# The reference's worker geometry (n_slots >= n_lanes, max_t >= t_bins).
N_LANES = 16
T_BINS = 8
CAP = 64
MAX_FILLS = 8
#: The card's drill: the main path's width, every other number the
#: reference's.
CARD_LANES = 10_240
EVERY_N = 2  # snapshot cadence in committed batches (= messages here)
SNAP_KEEP = 8  # torn snapshots accumulate; keep enough good history
#: A worker's wall-clock limit in the parent.
CHILD_TIMEOUT_S = 300.0


# -- shared by parent and worker --------------------------------------------

def engine_geometry(lanes: int = N_LANES) -> dict:
    return {"n_slots": lanes, "max_t": T_BINS, "cap": CAP,
            "max_fills": MAX_FILLS, "dtype": "int64"}


def build_engine(device: str, lanes: int = N_LANES):
    import torch

    from ..engine import BookConfig, MatchEngine

    return MatchEngine(
        BookConfig(cap=CAP, max_fills=MAX_FILLS, dtype=torch.int64),
        n_slots=lanes, max_t=T_BINS, auto_grow=True, kernel="scan",
        device=device,
    )


def book_digest(engine) -> str:
    """sha256 over the full exported engine state (every book leaf,
    padding included, with dtype and shape; interners; geometry) and the
    sorted pre-pool — the bit-for-bit equality the verdict asserts
    between the oracle and the recovered run."""
    import numpy as np

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


# -- worker ------------------------------------------------------------------

def worker_stack(args):
    """The worker's engine (build_engine at args.lanes on args.device), its
    file bus, a Persister every EVERY_N batches and an
    OrderConsumer(batch_n=1, match_wire="frame"), attached."""
    from ..bus import make_bus
    from ..config import BusConfig, PersistConfig
    from ..persist import Persister
    from ..service import OrderConsumer

    bus = make_bus(
        BusConfig(backend="file", dir=args.bus_dir, match_wire="frame")
    )
    engine = build_engine(args.device, args.lanes)
    persist = Persister(PersistConfig(
        enabled=True, dir=args.snap_dir, every_n_batches=EVERY_N,
        keep=SNAP_KEEP,
    ))
    # batch_n=1: one message per step, commit per message — fault hit
    # counters then index individual frames, reproducibly.
    consumer = OrderConsumer(
        engine, bus, batch_n=1, batch_wait_s=0.0,
        on_batch=persist.on_batch, match_wire="frame",
    )
    persist.attach(engine, bus, consumer=consumer)
    return engine, bus, persist, consumer


def _restore(persist) -> dict:
    persist.restore_latest()
    return persist.probe()


def run_worker(args, keep=None, finish=None, stack=worker_stack,
               restore=_restore, result: dict | None = None) -> int:
    """One consumer-process lifetime: boot, restore, (optionally) arm the
    fault plan, consume the order queue synchronously, drain the feed,
    digest the book. An injected fault hard-exits with EXIT_CODE before
    this function returns. The result JSON at args.out is rewritten as
    the run goes (after the restore, at the catch-up to the pre-crash
    position, at the end), so a death keeps what was known.

    `stack(args)` builds (engine, bus, persist, consumer); `restore(persist)`
    restores and returns what the result records of it; `result` holds
    the caller's own keys (a hook may rewrite the file with them);
    `keep` (a context manager factory yielding kept kernel inputs) wraps
    the consume loop; `finish(kept, result)` runs after a completed run,
    before the last write."""
    entered = time.time()
    t_enter = time.monotonic()
    from ..ops.match_step import batch_step
    from ..service import MatchFeed
    from ..utils.faults import FAULTS
    from .common import expected_launches

    engine, bus, persist, consumer = stack(args)
    feed = MatchFeed(bus, log_events=False)
    oq = bus.order_queue
    result = {} if result is None else result
    result.update({
        "pre_committed": oq.committed(),  # the crashed predecessor's
        "completed": False,
        "device": args.device,
        "entered_unix": entered,
    })
    pre_committed = result["pre_committed"]
    t0 = time.monotonic()
    result["boot_s"] = round(t0 - t_enter, 4)
    result["restore"] = restore(persist)

    # Arm AFTER restore: restore-time sidecar writes must not consume
    # fault hits, so a plan's at=(K,) means "the K-th <point> of THIS
    # run" — reproducible from the verdict artifact alone.
    if args.plan:
        with open(args.plan) as f:
            FAULTS.install(FaultPlan.from_json(f.read()))

    def write_result() -> None:
        write_json(args.out, result)

    # recovery_s = restore + WAL catch-up back to the pre-crash position
    # (the interpreter's start and the engine's build are boot_s). Written
    # as soon as it is known so a later injected death cannot lose it.
    caught_up = oq.committed() >= pre_committed
    if caught_up:
        result["recovery_s"] = persist.last_recovery_seconds
    write_result()
    batch_step.launches = 0
    with (keep() if keep else contextlib.nullcontext(None)) as kept:
        while oq.committed() < oq.end_offset():
            consumer.run_once()
            if not caught_up and oq.committed() >= pre_committed:
                caught_up = True
                result["recovery_s"] = time.monotonic() - t0
                write_result()
        launches = batch_step.launches
    feed.drain()
    result.update({
        "completed": True,
        "seconds": time.monotonic() - t0,
        "book_digest": book_digest(engine),
        "match_seq": consumer.match_seq,
        "feed": feed.seq_state(),
        "delivered": feed.events_seen,
        "faults": FAULTS.report() if args.plan else None,
        "oq": {"end": oq.end_offset(), "committed": oq.committed()},
        "mq": {
            "end": bus.match_queue.end_offset(),
            "committed": bus.match_queue.committed(),
        },
        "launches": launches,
        "device_calls": engine.stats.device_calls,
        "expected_launches": expected_launches(engine),
        "cap": engine.config.cap,
    })
    if finish is not None:
        finish(kept, result)
    write_result()
    return 0


# -- parent ------------------------------------------------------------------

def plan_for_cycle(cycle: int, seed: int) -> FaultPlan:
    """The kill rotation. Cycle 1 always dies inside the at-least-once
    window at offset 0 (match events published, NOTHING committed, no
    snapshot yet — the stale-match-tail case); later cycles rotate
    through the remaining fault classes at hit K, chosen past the replay
    window (<= EVERY_N messages) so every cycle makes net progress."""
    k = EVERY_N + 2 + ((cycle - 1) % 3)  # 4..6
    if cycle == 1:
        spec = FaultSpec("consumer.commit", mode="exit", at=(1,))
    else:
        rot = (cycle - 2) % 4
        if rot == 0:
            spec = FaultSpec("consumer.frame", mode="exit", at=(k,))
        elif rot == 1:
            spec = FaultSpec("filelog.offset", mode="torn", at=(k,))
        elif rot == 2:
            # 2nd snapshot of the run: published torn, then death —
            # load_latest must fall back to the previous snapshot.
            spec = FaultSpec("snapshot.rename", mode="torn", at=(2,))
        else:
            spec = FaultSpec("filelog.append", mode="torn", at=(k,))
    return FaultPlan(seed=seed * 1000 + cycle, faults=(spec,))


def seed_queue(bus_dir: str, frames: list[bytes]) -> None:
    from ..bus.filelog import FileQueue

    q = FileQueue("doOrder", os.path.join(bus_dir, "doOrder"))
    for fr in frames:
        q.publish(fr)
    q.close()


def read_match_stream(bus_dir: str) -> tuple[list[bytes], list[int]]:
    """The durable queue-level record: every event as its canonical JSON
    line (seq included) plus the raw seq sequence for the audit."""
    from ..bus.colwire import decode_event_frame
    from ..bus.filelog import FileQueue

    q = FileQueue("matchOrder", os.path.join(bus_dir, "matchOrder"))
    lines: list[bytes] = []
    seqs: list[int] = []
    for m in q.read_from(0, q.end_offset()):
        batch = decode_event_frame(m.body)
        lines.extend(batch.to_json_lines())
        for r in batch.to_results():
            if r.seq is not None:
                seqs.append(r.seq)
    q.close()
    return lines, seqs


def default_launcher() -> list:
    return [sys.executable, "-m", "gome_tpu_torch.scripts.chaos", "--worker"]


def run_child(
    bus_dir: str, snap_dir: str, out: str, plan_path: str | None = None,
    device: str = "cuda", lanes: int = N_LANES, launcher=default_launcher,
    timeout_s: float = CHILD_TIMEOUT_S,
) -> tuple[int, float]:
    """One worker as a fresh interpreter (never a fork of a CUDA
    process); returns its exit code and wall seconds. Its stderr goes to
    out + ".err"."""
    cmd = [*launcher(), "--bus-dir", bus_dir, "--snap-dir", snap_dir,
           "--out", out, "--device", device, "--lanes", str(lanes)]
    if plan_path:
        cmd += ["--plan", plan_path]
    t0 = time.monotonic()
    with open(out + ".err", "w") as err:
        proc = subprocess.run(cmd, timeout=timeout_s, cwd=REPO,
                              stdout=subprocess.DEVNULL, stderr=err)
    return proc.returncode, time.monotonic() - t0


def read_result(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def stderr_tail(out: str) -> str:
    try:
        with open(out + ".err") as f:
            return f.read()[-2000:]
    except OSError:
        return ""


def run_parent(args, launcher=default_launcher) -> dict:
    """The oracle beside the kill cycles, then the final clean run, then
    the verdict (returned; main() writes it). Worker results (with each
    worker's K1 launches and, under chip_smoke, its kept-input file)
    ride along under ``workers``, which the verdict file leaves out."""
    import concurrent.futures
    import tempfile

    from ..bus.colwire import decode_order_frame

    work = args.workdir or tempfile.mkdtemp(prefix="gome-chaos-")
    os.makedirs(work, exist_ok=True)
    n_steps = max(16, min(160, max(args.seconds, 8 * args.kills)))
    print(f"chaos: recording {n_steps} sim steps (seed {args.seed}, "
          f"{args.lanes} lanes x {args.bins} bins on {args.device})...",
          flush=True)
    t_rec = time.monotonic()
    frames = record_sim_frames(args.seed, n_steps, args.lanes, args.device,
                               args.bins)
    record_s = time.monotonic() - t_rec
    n_orders = sum(int(decode_order_frame(fr)["n"]) for fr in frames)
    print(f"chaos: {len(frames)} frames / {n_orders} orders -> {work}",
          flush=True)

    dirs = {}
    for run in ("oracle", "chaos"):
        dirs[run] = {
            "bus": os.path.join(work, run, "bus"),
            "snaps": os.path.join(work, run, "snaps"),
        }
        os.makedirs(dirs[run]["bus"], exist_ok=True)
        os.makedirs(dirs[run]["snaps"], exist_ok=True)
        seed_queue(dirs[run]["bus"], frames)

    def child(run, out, plan_path=None):
        return run_child(dirs[run]["bus"], dirs[run]["snaps"], out,
                         plan_path, args.device, args.lanes, launcher)

    # -- oracle: one uninterrupted run, in a process of its own beside the
    # kill cycles (its own queue and snapshot directory) ------------------
    oracle_out = os.path.join(work, "oracle_result.json")
    cycles = []
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        oracle_run = pool.submit(child, "oracle", oracle_out)

        # -- chaos: N killed cycles, then one clean run to completion ---
        for c in range(1, args.kills + 1):
            plan = plan_for_cycle(c, args.seed)
            plan_path = os.path.join(work, f"plan_{c}.json")
            with open(plan_path, "w") as f:
                f.write(plan.to_json())
            out_c = os.path.join(work, f"chaos_result_{c}.json")
            rc, wall = child("chaos", out_c, plan_path)
            res = read_result(out_c) or {}
            spec = plan.faults[0]
            rec = res.get("recovery_s")
            print(f"chaos: cycle {c} [{spec.point}/{spec.mode}@{spec.at}] "
                  f"rc={rc} wall={wall:.1f}s recovery="
                  f"{-1 if rec is None else rec:.3f}s", flush=True)
            cycles.append({
                "cycle": c,
                "plan": plan.to_dict(),
                "exit_code": rc,
                "wall_s": round(wall, 3),
                "pre_committed": res.get("pre_committed"),
                "recovery_s": rec,
                "restore": res.get("restore"),
                "boot_s": res.get("boot_s"),
            })
            if rc != EXIT_CODE:
                cycles[-1]["stderr"] = stderr_tail(out_c)
        final_out = os.path.join(work, "chaos_result_final.json")
        final_rc, final_wall = child("chaos", final_out)
        oracle_rc, oracle_wall = oracle_run.result()
    oracle = read_result(oracle_out) or {}
    final = read_result(final_out) or {}
    print(f"chaos: oracle rc={oracle_rc} wall={oracle_wall:.1f}s "
          f"digest={(oracle.get('book_digest') or '?')[:12]}...", flush=True)
    print(f"chaos: final rc={final_rc} wall={final_wall:.1f}s "
          f"digest={(final.get('book_digest') or '?')[:12]}...", flush=True)

    # -- verdict --------------------------------------------------------
    oracle_lines, oracle_seqs = read_match_stream(dirs["oracle"]["bus"])
    chaos_lines, chaos_seqs = read_match_stream(dirs["chaos"]["bus"])
    seq_audit = audit_seqs(chaos_seqs)
    oracle_audit = audit_seqs(oracle_seqs)

    # Recovery samples: every boot that followed an injected death
    # (cycles 2..N and the final run). Cycle 1 boots fresh.
    recoveries = [
        c["recovery_s"] for c in cycles[1:] if c["recovery_s"] is not None
    ]
    if final.get("recovery_s") is not None:
        recoveries.append(final["recovery_s"])
    wal_frames = sum(
        (c["restore"] or {}).get("wal_replay_frames", 0) for c in cycles[1:]
    ) + (final.get("restore") or {}).get("wal_replay_frames", 0)
    total_rec = sum(recoveries)

    feed_state = final.get("feed") or {}
    checks = {
        "oracle_clean_exit": oracle_rc == 0,
        "all_kills_injected": all(
            c["exit_code"] == EXIT_CODE for c in cycles
        ),
        "final_clean_exit": final_rc == 0,
        "book_digest_match": (
            bool(oracle.get("book_digest"))
            and oracle.get("book_digest") == final.get("book_digest")
        ),
        "match_stream_identical": (
            len(oracle_lines) > 0 and oracle_lines == chaos_lines
        ),
        "queue_seq_no_dupes": seq_audit["dupes"] == 0,
        "queue_seq_no_gaps": seq_audit["gaps"] == 0,
        "feed_exactly_once": (
            feed_state.get("dupes") == 0 and feed_state.get("gaps") == 0
        ),
        "recovery_measured": len(recoveries) >= args.kills,
    }
    verdict = {
        "schema": SCHEMA,
        "artifact": os.path.splitext(os.path.basename(args.out))[0],
        "provenance": provenance(args.device),
        "config": {
            "seed": args.seed,
            "seconds": args.seconds,
            "kills": args.kills,
            "n_steps": n_steps,
            "frames": len(frames),
            "orders": n_orders,
            "every_n_batches": EVERY_N,
            "engine": dict(engine_geometry(args.lanes), auto_grow=True,
                           device=args.device),
            "sim": dict(SIM_FLOW, n_lanes=args.lanes, t_bins=args.bins,
                        recorded_on=args.device,
                        record_s=round(record_s, 3)),
            "departures": departures(args),
        },
        "oracle": {
            "exit_code": oracle_rc,
            "wall_s": round(oracle_wall, 3),
            "book_digest": oracle.get("book_digest"),
            "events": len(oracle_lines),
            "match_seq": oracle.get("match_seq"),
            "seq_audit": oracle_audit,
        },
        "cycles": cycles,
        "final": {
            "exit_code": final_rc,
            "wall_s": round(final_wall, 3),
            "book_digest": final.get("book_digest"),
            "events": len(chaos_lines),
            "match_seq": final.get("match_seq"),
            "feed": feed_state,
        },
        "matchfeed": {
            "events": len(chaos_lines),
            "stamped": len(chaos_seqs),
            "seq_audit": seq_audit,
        },
        "recovery": {
            "samples_s": [round(r, 4) for r in recoveries],
            "p50_s": pctl(recoveries, 50),
            "p99_s": pctl(recoveries, 99),
            "wal_replay_frames_total": wal_frames,
            "wal_replay_frames_per_s": (
                round(wal_frames / total_rec, 2) if total_rec > 0 else None
            ),
            "boot_s": [c["boot_s"] for c in cycles[1:]]
            + [final.get("boot_s")],
        },
        "checks": checks,
        "pass": all(checks.values()),
    }
    if final_rc != 0:
        verdict["final"]["stderr"] = stderr_tail(final_out)
    if oracle_rc != 0:
        verdict["oracle"]["stderr"] = stderr_tail(oracle_out)
    verdict["workers"] = {"oracle": oracle, "final": final}
    return verdict


def departures(args) -> list[str]:
    """What the run changed of the reference's configuration."""
    out = []
    if args.lanes != N_LANES:
        out.append(f"n_slots and the sim's n_lanes {args.lanes} (the "
                   f"reference's {N_LANES})")
    if args.bins != T_BINS:
        out.append(f"the sim's t_bins {args.bins} a step (the reference's "
                   f"{T_BINS}; the engine's max_t stays {T_BINS}): the "
                   "flow holds at most one event a bin, so at 8 bins a "
                   "step the orders do not grow with the lanes")
    return out


def print_verdict(verdict: dict, out: str) -> None:
    print(f"chaos: {'PASS' if verdict['pass'] else 'FAIL'} -> {out}")
    for name, ok in verdict["checks"].items():
        print(f"  [{'ok' if ok else 'BREACH'}] {name}")


def worker_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    for name in ("--bus-dir", "--snap-dir", "--out"):
        ap.add_argument(name, required=True)
    ap.add_argument("--plan", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=N_LANES)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"]:  # one lifetime, started by run_child
        return run_worker(worker_args(argv[1:]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=int, default=30,
                    help="soak scale knob: sim steps to record (clamped)")
    ap.add_argument("--kills", type=int, default=3,
                    help="injected process deaths before the clean run")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--lanes", type=int, default=N_LANES,
                    help="engine lanes and sim lanes (the reference's 16; "
                         f"the card's drill runs {CARD_LANES})")
    ap.add_argument("--bins", type=int, default=T_BINS,
                    help="the sim's bins a step (the reference's 8; the "
                         f"card's drill records {CARD_BINS})")
    ap.add_argument("--device", default=None,
                    help="the workers' and the recording's device "
                         "(default: the CUDA card)")
    ap.add_argument("--out", default="CHAOS_CUDA_r01.json",
                    help="verdict JSON path")
    ap.add_argument("--workdir", default="",
                    help="scratch dir (default: fresh tempdir)")
    args = ap.parse_args(argv)
    args.device = require_device(args.device)
    verdict = run_parent(args)
    verdict.pop("workers")
    write_json(args.out, verdict)
    print_verdict(verdict, args.out)
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
