"""Capacity sweep: drive the matching engine to its knee with an
open-loop offered-rate ladder and say where the time goes (the port of
scripts/capacity.py).

A closed loop waits for the service before it sends the next order, so
under saturation the arrival process slows down and queueing delay never
reaches the percentiles (coordinated omission). Here each order has an
intended send time from a fixed :class:`obs.capacity.OpenLoopSchedule`
at the offered rate, the driver sends on that clock (at once when behind:
the backlog is charged to latency, never forgiven), and every per-order
latency is ``completion - intended`` in a mergeable
:class:`obs.capacity.LogHistogram`.

Two targets, one verdict schema (``gome-capacity-verdict-v1``):

  * default — the single-process service stack (gateway step -> memory
    bus -> OrderConsumer on the frame wire -> the engine on the card)
    with exact per-frame completion times: run_single_sweep.
  * ``--fleet`` — the 2-gateway x 2-consumer subprocess fleet of
    fleet_drill (the same members, file bus + RESP marker store), driven
    per partition over DoOrderBatch streams routed by
    fleet.partition_of; completion times come from polling each
    consumer's ``gome_orders_consumed_total`` (per-partition FIFO
    inverts the counter into per-order completions, interpolated between
    samples): run_fleet_sweep. ``CAPACITY_CUDA_r01.json`` is this mode.

Each ladder point records offered vs delivered rate, corrected and
closed-loop percentiles, an exactly-once audit (match-queue seq dupes
and gaps, conservation) and an attribution table: the driver's own
measurements (arrival accumulation, send backlog, the admit RPC or the
gateway step) and the consumers' ``gome_stage_seconds`` deltas. The
wait on the bus is the residual of the measured in-pipeline time in the
single process, and Little's law on the sampled ``gome_bus_depth`` in
the fleet (the residual rides beside it as ``residual_s``, unchecked),
as the reference has them. The knee is the first point where delivered/offered < 0.98
or the corrected p99 passes its budget; the verdict names the saturated
stage there.

    python -m gome_tpu_torch.scripts.capacity --seconds 10
    python -m gome_tpu_torch.scripts.capacity --fleet --points 7 --out CAPACITY_CUDA_r01.json
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import threading
import time

import numpy as np

from ..obs.capacity import (SCHEMA, LogHistogram, OpenLoopSchedule,
                            attribution_check, find_knee, monotone_ladder,
                            saturated_stage)
from . import fleet_drill as fd
from .common import gateway_step, provenance, require_device, svc_warmup, \
    write_json

#: Histogram geometry shared by every recorder of one sweep (merge needs
#: identical params; 1% relative error, 1 us .. 10 min).
HIST_KW = dict(rel_err=0.01, min_value=1e-6, max_value=600.0)
#: Tracer stages that measure waiting (overlapping across in-flight
#: orders), not a resource being busy: never the saturated stage.
_WAIT_STAGES = frozenset({"ingress", "enqueue", "batch_wait", "bus_transit"})
UUIDS = [f"u{i}" for i in range(256)]
#: Each fleet member's trace ring: a whole ladder's journeys stay joinable.
FLEET_TRACE_KEEP = 1 << 16
#: The ladder's span over the closed-loop calibration: the reference's
#: 0.3-1.6x in the single process; 0.3-3x in the fleet, whose closed-loop
#: calibration (batches of 32) reads low and unevenly, so 1.6x did not
#: always reach the knee on the H100.
SINGLE_SPAN = (0.30, 1.60)
FLEET_SPAN = (0.30, 3.00)


class CrossingFlow:
    """Bounded-book sweep flow: round-robin symbols, alternating buy/sell
    limit pairs at one price, so every pair trades and resting depth
    stays at most 1 a symbol. A capacity sweep holds frame geometry
    stationary: a depth walk would ratchet the packed-book shape
    mid-ladder and fake a knee."""

    def __init__(self, n_symbols: int):
        self.n_symbols = n_symbols
        self.names = [f"sym{i}" for i in range(n_symbols)]
        self.i0 = 0

    def frame(self, n: int) -> dict:
        i = self.i0 + np.arange(n, dtype=np.int64)
        self.i0 += n
        return dict(
            n=n,
            action=np.ones(n, np.uint8),
            side=((i // self.n_symbols) % 2).astype(np.uint8),
            kind=np.zeros(n, np.uint8),
            price=np.full(n, 100_000_000, np.int64),
            volume=np.ones(n, np.int64),
            symbols=self.names,
            symbol_idx=(i % self.n_symbols).astype(np.uint32),
            uuids=UUIDS,
            uuid_idx=(i % 256).astype(np.uint32),
            oids=np.char.add("o", i.astype("U12")).astype("S"),
        )


def steady_delivered(done_t: list, window_end: float, batch_n: int,
                     t0: float) -> float:
    """Delivered rate in steady state: completions per second between the
    first and last in-window completion (the pipeline's fill ramp and
    in-flight tail are not charged against throughput)."""
    in_win = [d for d in done_t if d <= window_end]
    if len(in_win) >= 3 and in_win[-1] > in_win[0]:
        return (len(in_win) - 1) * batch_n / (in_win[-1] - in_win[0])
    return len(in_win) * batch_n / max(window_end - t0, 1e-9)


def _hist() -> LogHistogram:
    return LogHistogram(**HIST_KW)


def geometric_ladder(lo: float, hi: float, k: int) -> list[float]:
    """k strictly increasing rates from lo to hi, geometric spacing."""
    if k < 2:
        return [hi]
    f = (hi / lo) ** (1.0 / (k - 1))
    return [lo * f**i for i in range(k)]


def _lat_summary(h: LogHistogram) -> dict:
    return h.summary(qs=(0.5, 0.9, 0.99, 0.999))


def build_verdict(mode: str, config: dict, points: list[dict],
                  delivered_floor: float, p99_budget_s: float,
                  extra_checks: dict | None = None,
                  min_points: int = 5) -> dict:
    knee_idx, knee_reason = find_knee(
        points, delivered_floor=delivered_floor, p99_budget_s=p99_budget_s)
    knee: dict = {"found": knee_idx is not None}
    if knee_idx is not None:
        kp = points[knee_idx]
        knee.update({
            "index": knee_idx,
            "reason": knee_reason,
            "offered_per_sec": kp["offered_per_sec"],
            "delivered_per_sec": kp["delivered_per_sec"],
            "corrected_p99_s": kp["corrected"]["p99_s"],
            "saturated_stage": saturated_stage(kp["attribution"]["rows"]),
            "attribution_frac_err": kp["attribution"]["frac_err"],
        })
    checks = {
        "monotone_ladder": monotone_ladder(points),
        f"ladder_has_{min_points}_points": len(points) >= min_points,
        "knee_found": knee_idx is not None,
        "exactly_once_all_points": all(
            p["exactly_once"]["dupes"] == 0
            and p["exactly_once"]["gaps"] == 0
            and p["exactly_once"]["drained"] for p in points),
        "corrected_recorded_all_points": all(
            p["corrected"]["count"] == p["sent"] for p in points),
        "attribution_rows_nonempty": all(
            p["attribution"]["rows"] for p in points),
        "attribution_within_tol_at_knee": (
            knee_idx is not None
            and points[knee_idx]["attribution"]["within_tol"]),
    }
    checks.update(extra_checks or {})
    return {
        "schema": SCHEMA,
        "mode": mode,
        "config": config,
        "ladder": points,
        "knee": knee,
        "checks": checks,
        "pass": all(checks.values()),
    }


def print_verdict(verdict: dict, out: str) -> None:
    print(f"capacity: {'PASS' if verdict['pass'] else 'FAIL'} -> {out}")
    for p in verdict["ladder"]:
        print(f"  offered {p['offered_per_sec']:10.1f}/s  delivered "
              f"{p['delivered_per_sec']:10.1f}/s ({p['delivered_frac']:.3f})"
              f"  corrected p50 {p['corrected']['p50_s'] * 1e3:8.2f}ms  "
              f"p99 {p['corrected']['p99_s'] * 1e3:9.2f}ms  attribution "
              f"err {p['attribution']['frac_err']:.4f}")
    knee = verdict["knee"]
    if knee.get("found"):
        print(f"  knee @ {knee['offered_per_sec']:.1f}/s offered "
              f"({knee['reason']}); saturated stage: "
              f"{knee['saturated_stage']}")
    for name, ok in verdict["checks"].items():
        print(f"  [{'ok' if ok else 'BREACH'}] {name}")


# ===========================================================================
# single-process mode
# ===========================================================================


def _counter(name: str) -> int:
    from ..utils.metrics import REGISTRY

    return int(REGISTRY.counter(name).value())


def _stage_snapshot() -> dict:
    """{stage: (count, sum_s)} from the armed tracer's histograms."""
    from ..utils.trace import TRACER

    return {s: (v["count"], v["sum"])
            for s, v in TRACER.stage_summary().items()}


def run_single_point(engine, bus, consumer, flow, rate: float,
                     window_s: float, batch_n: int, audit: dict) -> dict:
    """One open-loop load point against the in-process pipeline. The
    consumer is co-operative (no thread of its own): while the driver is
    ahead of schedule it drains completions; when it falls behind it
    publishes at once and the backlog lands in the corrected latency.
    `audit` carries the sweep's seq tracker, sent frames and events."""
    from ..bus.colwire import decode_event_frame

    n_frames = max(2, int(rate * window_s) // batch_n)
    frames = [flow.frame(batch_n) for _ in range(n_frames)]
    n_point = n_frames * batch_n

    stage0 = _stage_snapshot()
    fail0 = _counter("gome_consumer_step_failures_total")
    ev_off = bus.match_queue.end_offset()

    corrected, closed = _hist(), _hist()
    sched = OpenLoopSchedule(rate, t0=time.perf_counter())
    pub_t: list[float] = []
    done_t: list[float] = []
    backlog: list[float] = []
    gw_wall = 0.0

    def drain_step() -> int:
        n = consumer.run_once()
        if n:
            now = time.perf_counter()
            done_t.extend([now] * (n // batch_n))
        return n

    for fi, cols in enumerate(frames):
        due = sched.batch_due(fi * batch_n, batch_n)
        while True:
            now = time.perf_counter()
            if now >= due:
                break
            if not drain_step():
                time.sleep(min(0.0005, due - now))
        actual = time.perf_counter()
        backlog.append(actual - due)
        pub_t.append(actual)
        gateway_step(engine, bus.order_queue, cols)
        gw_wall += time.perf_counter() - actual
        drain_step()
    window_end = time.perf_counter()

    deadline = time.monotonic() + 120.0
    while len(done_t) < n_frames and time.monotonic() < deadline:
        if not drain_step():
            time.sleep(0.0005)
    drained = len(done_t) >= n_frames

    # Per-order latency: FIFO frames; order j of frame f was intended at
    # sched.intended(f*batch_n + j) and completed at done_t[f].
    done_n = min(len(done_t), n_frames)
    for f in range(done_n):
        d = done_t[f]
        for j in range(batch_n):
            corrected.record(max(d - sched.intended(f * batch_n + j), 0.0))
        closed.record(max(d - pub_t[f], 0.0), count=batch_n)

    delivered_per_sec = steady_delivered(done_t, window_end, batch_n,
                                         sched.t0)
    busy_s = max(done_t[-1] if done_t else window_end, window_end) - sched.t0

    # -- exactly-once: conservation + the seq audit ----------------------
    tracker = audit["tracker"]
    dupes0, gaps0 = tracker.dupes, tracker.gaps
    events = 0
    for m in bus.match_queue.read_from(ev_off, 1 << 20):
        for r in decode_event_frame(m.body).to_results():
            events += 1
            if r.seq is not None:
                tracker.observe(r.seq)
            audit["events"].append(r)
    audit["frames"].extend(frames)
    bus.match_queue.commit(bus.match_queue.end_offset())
    bus.match_queue.compact()
    bus.order_queue.compact()
    step_failures = _counter("gome_consumer_step_failures_total") - fail0
    consumed = len(done_t) * batch_n
    exactly_once = {
        "method": "conservation+seq",
        "sent": n_point,
        "consumed": consumed,
        "events": events,
        "dupes": tracker.dupes - dupes0,
        "gaps": (tracker.gaps - gaps0) + (n_point - consumed) + step_failures,
        "drained": drained and step_failures == 0,
    }

    # -- attribution -----------------------------------------------------
    stage1 = _stage_snapshot()
    mean_backlog = sum(backlog) / len(backlog) if backlog else 0.0
    in_pipeline = [done_t[f] - pub_t[f] for f in range(done_n)]
    in_pipeline_mean = sum(in_pipeline) / len(in_pipeline) \
        if in_pipeline else 0.0
    rows = [
        {"stage": "arrival_accumulation",
         "seconds_per_order": sched.accumulation_mean(batch_n),
         "utilization": None,
         "source": "analytic (batch_n-1)/(2*rate)"},
        {"stage": "send_backlog",
         "seconds_per_order": mean_backlog,
         "utilization": None,
         "source": "driver (actual publish - intended last-of-frame)"},
        {"stage": "gateway_step",
         "seconds_per_order": gw_wall / max(n_frames, 1),
         "utilization": gw_wall / busy_s if busy_s > 0 else 0.0,
         "source": "driver (publish call wall per frame)"},
    ]
    stage_total = 0.0
    for stage in sorted(set(stage0) | set(stage1)):
        c0, s0 = stage0.get(stage, (0, 0.0))
        c1, s1 = stage1.get(stage, (0, 0.0))
        dc, ds = c1 - c0, s1 - s0
        if dc <= 0:
            continue
        per_order = ds / dc  # an order rides its whole frame's span
        stage_total += per_order
        busy_like = stage not in _WAIT_STAGES
        rows.append({
            "stage": stage,
            "seconds_per_order": per_order,
            "utilization": ((ds / busy_s if busy_s > 0 else 0.0)
                            if busy_like else None),
            "source": "tracer gome_stage_seconds delta / spans",
        })
    rows.append({
        "stage": "bus_wait",
        "seconds_per_order": max(
            in_pipeline_mean - gw_wall / max(n_frames, 1) - stage_total, 0.0),
        "utilization": None,
        "source": "residual (in-pipeline mean minus processing stages)",
    })
    attr = attribution_check(rows, corrected.mean(), tol=0.05)
    attr["rows"] = rows
    return {
        "offered_per_sec": rate,
        "delivered_per_sec": round(delivered_per_sec, 2),
        "delivered_frac": round(delivered_per_sec / rate if rate > 0
                                else 0.0, 4),
        "sent": n_point,
        "frames": n_frames,
        "batch_n": batch_n,
        "window_s": round(window_end - sched.t0, 3),
        "send_backlog_s_mean": round(mean_backlog, 6),
        "corrected": _lat_summary(corrected),
        "closed_loop": _lat_summary(closed),
        "exactly_once": exactly_once,
        "attribution": attr,
    }


def oracle_check(audit: dict, skip_frames: int) -> dict:
    """The ladder's match stream against the oracle: every frame the run
    published (warm-up and calibration first) goes through OracleEngine
    in order; the events of the ladder's frames must equal the stream's,
    seqs aside."""
    import dataclasses

    from ..engine.frames import orders_from_frame
    from ..oracle import OracleEngine

    t0 = time.perf_counter()
    oracle = OracleEngine()
    for cols in audit["frames"][:skip_frames]:
        for o in orders_from_frame(cols):
            oracle.submit(o)
    oracle.drain()
    orders = 0
    for cols in audit["frames"][skip_frames:]:
        for o in orders_from_frame(cols):
            oracle.submit(o)
            orders += 1
    want = oracle.drain()
    got = [dataclasses.replace(e, seq=None) for e in audit["events"]]
    return {"orders": orders, "events": len(got), "oracle_events": len(want),
            "equal": got == want,
            "seconds": round(time.perf_counter() - t0, 3)}


def run_single_sweep(device: str = "cuda", seconds: float = 10.0,
                     points: int = 6, symbols: int = 32, cap: int = 128,
                     batch_n: int = 256, pipeline: int = 2,
                     delivered_floor: float = 0.98,
                     p99_budget_s: float = 1.0,
                     rates: list[float] | None = None,
                     dtype: str = "int32") -> dict:
    """The smoke ladder: warm, calibrate, sweep, verdict (obs_snapshot
    and chip_smoke.py's phase 17 call this in-process)."""
    import torch

    from ..bus import MemoryQueue, QueueBus
    from ..engine import BookConfig, MatchEngine
    from ..service import OrderConsumer
    from ..service.matchfeed import SeqTracker
    from ..utils.metrics import Registry
    from ..utils.trace import TRACER, FlightRecorder

    engine = MatchEngine(
        BookConfig(cap=cap, max_fills=16, dtype=getattr(torch, dtype)),
        n_slots=symbols, max_t=32, device=device)
    bus = QueueBus(MemoryQueue("doOrder"), MemoryQueue("matchOrder"))
    consumer = OrderConsumer(engine, bus, batch_n=1, batch_wait_s=0,
                             match_wire="frame", pipeline_depth=pipeline)
    flow = CrossingFlow(symbols)
    sent: list = []

    def make_frame():
        sent.append(flow.frame(batch_n))
        return sent[-1]

    t0 = time.perf_counter()
    svc_warmup(engine, consumer, bus, make_frame)
    warm_s = time.perf_counter() - t0

    # Private registry: the sweep's stage histograms neither pollute nor
    # are polluted by anything else in the process.
    TRACER.install(FlightRecorder(keep_n=8), registry=Registry())
    try:
        cal_frames = [make_frame() for _ in range(24)]
        t0 = time.perf_counter()
        done = 0
        for cols in cal_frames:
            gateway_step(engine, bus.order_queue, cols)
            done += consumer.run_once()
        done += consumer.drain()
        cal_s = time.perf_counter() - t0
        cal_rate = done / cal_s
        bus.match_queue.commit(bus.match_queue.end_offset())
        bus.match_queue.compact()
        bus.order_queue.compact()
        if rates is None:
            rates = geometric_ladder(SINGLE_SPAN[0] * cal_rate,
                                     SINGLE_SPAN[1] * cal_rate, points)
        window_s = seconds / len(rates)
        audit = dict(tracker=SeqTracker(), events=[], frames=list(sent))
        skip = len(sent)
        ladder = [run_single_point(engine, bus, consumer, flow, rate=r,
                                   window_s=window_s, batch_n=batch_n,
                                   audit=audit)
                  for r in rates]
    finally:
        TRACER.disable()
    engine.batch.verify_books()
    oracle = oracle_check(audit, skip)
    seq = audit["tracker"].state()
    config = {
        "seconds": seconds,
        "points": len(rates),
        "window_s": round(window_s, 3),
        "batch_n": batch_n,
        "symbols": symbols,
        "cap": cap,
        "max_fills": 16,
        "dtype": dtype,
        "pipeline_depth": pipeline,
        "device": str(engine.batch.device),
        "warmup_s": round(warm_s, 3),
        "calibration_orders_per_sec": round(cal_rate, 1),
        "delivered_floor": delivered_floor,
        "p99_budget_s": p99_budget_s,
        "histogram": HIST_KW,
        "arrival_model": ("open-loop fixed schedule: intended_i = t0 + "
                          "(i+1)/rate; latency charged from intended time"),
    }
    verdict = build_verdict(
        "single", config, ladder, delivered_floor, p99_budget_s,
        extra_checks={
            "events_equal_oracle": oracle["equal"],
            "seq_audit_exact": seq["dupes"] == 0 and seq["gaps"] == 0,
            "attribution_within_tol_all_points": all(
                p["attribution"]["within_tol"] for p in ladder),
        }, min_points=min(5, len(rates)))
    verdict["oracle"] = oracle
    verdict["seq"] = seq
    return verdict


# ===========================================================================
# fleet mode (the 2x2 subprocess fleet; CAPACITY_CUDA_r01.json)
# ===========================================================================


def synth_requests(n: int, base: int, n_symbols: int) -> list[list]:
    """Bounded-book crossing flow, routed like production: order i takes
    symbol i % n_symbols, and successive orders on one symbol alternate
    buy/sale at one price so each pair trades and the book stays ~empty.
    Returns per-partition lists of (point rank, False, OrderRequest),
    fleet_drill.drive_partition's shape (no cancels); the rank keeps the
    open-loop schedule's arrival order."""
    from ..api import order_pb2 as pb
    parts: list[list] = [[] for _ in range(fd.N_PARTITIONS)]
    for i in range(base, base + n):
        s = i % n_symbols
        symbol = f"cap{s:05d}"
        req = pb.OrderRequest(uuid=f"u{s % 256:03d}", oid=f"o{i:010d}",
                              symbol=symbol,
                              transaction=(i // n_symbols) % 2,
                              price=100.0, volume=1.0, kind=0)
        parts[fd.partition_of(symbol)].append((i - base, False, req))
    return parts


_CONSUMED_RE = re.compile(
    r"^gome_orders_consumed_total\S* ([0-9eE+.\-]+)$", re.MULTILINE)
_DEPTH_RE = re.compile(
    r'gome_bus_depth\{[^}]*queue="doOrder"[^}]*\} ([0-9eE+.\-]+)')
_STAGE_SUM_RE = re.compile(
    r'gome_stage_seconds_sum\{[^}]*stage="([^"]+)"[^}]*\} ([0-9eE+.\-]+)')
_STAGE_CNT_RE = re.compile(
    r'gome_stage_seconds_count\{[^}]*stage="([^"]+)"[^}]*\} ([0-9eE+.\-]+)')


def _parse_consumed(text: str) -> int:
    m = _CONSUMED_RE.search(text)
    return int(float(m.group(1))) if m else 0


def _parse_depth(text: str) -> float:
    m = _DEPTH_RE.search(text)
    return float(m.group(1)) if m else 0.0


def _parse_stages(text: str) -> dict:
    sums = {m.group(1): float(m.group(2))
            for m in _STAGE_SUM_RE.finditer(text)}
    cnts = {m.group(1): float(m.group(2))
            for m in _STAGE_CNT_RE.finditer(text)}
    return {s: (cnts.get(s, 0.0), sums[s]) for s in sums}


class ConsumerSampler(threading.Thread):
    """Polls each consumer's /metrics on one thread, recording (t, orders
    consumed, doOrder bus depth): the completion inversion and the
    Little's-law feed of one load point."""

    def __init__(self, urls: dict, interval_s: float = 0.025):
        super().__init__(name="capacity-sampler", daemon=True)
        self.urls = urls
        self.interval_s = interval_s
        self.samples: dict = {name: [] for name in urls}  # single-writer: run()
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.is_set():
            for name, url in self.urls.items():
                try:
                    text = fd.fetch_text(url + "/metrics", timeout_s=2.0)
                except OSError:
                    continue
                self.samples[name].append((time.perf_counter(),
                                           _parse_consumed(text),
                                           _parse_depth(text)))
            self._halt.wait(self.interval_s)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=10)


def _completion_times(samples: list, c_base: int, n: int) -> list[float]:
    """Invert the consumed counter into per-order completion times:
    per-partition FIFO means order rank r completes when the counter
    crosses c_base + r + 1; interpolate within each sample interval."""
    comp = [0.0] * n
    prev_t, prev_c = samples[0][0], samples[0][1]
    for t, c, _ in samples[1:]:
        if c > prev_c:
            for k in range(max(prev_c, c_base), min(c, c_base + n)):
                frac = (k - prev_c + 0.5) / (c - prev_c)
                comp[k - c_base] = prev_t + frac * (t - prev_t)
        prev_t, prev_c = t, c
    last_t = samples[-1][0]
    return [c if c else last_t for c in comp]


def _timeline_tail(url: str) -> dict:
    try:
        samples = json.loads(fd.fetch_text(url + "/timeline")).get(
            "samples") or []
    except (OSError, ValueError):
        return {}
    if not samples:
        return {}
    last = samples[-1]
    return {k: last.get(k) for k in ("rss_bytes", "nivcsw", "cpu_utime_s")}


def _drive_all(ctx: dict, parts: list, sched, batch_n: int) -> dict:
    """Open-loop drive of every partition at once (fleet_drill's
    drive_partition, a thread each): batches of a partition's orders,
    each sent at the intended time of its last order."""
    drive = {i: {} for i in range(fd.N_PARTITIONS)}
    threads = [threading.Thread(
        target=fd.drive_partition,
        args=(ctx["gw_targets"][i], parts[i], drive[i]),
        kwargs=dict(sched=sched, batch_n=batch_n))
        for i in range(fd.N_PARTITIONS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return drive


def _await_drained(ctx: dict, expect: dict, timeout_s: float) -> bool:
    """Every consumer has committed its expected (cumulative) order count
    and its feed every event (fleet_drill.await_drained)."""
    deadline = time.monotonic() + timeout_s
    return all(fd.await_drained(url, expect[name],
                                max(deadline - time.monotonic(), 0.0))
               for name, url in ctx["consumers"].items())


def fleet_attribution(parts: list, drive: dict, sched, comps: dict,
                      little_wait: list, stages0: dict, stages1: dict,
                      members: list, busy_s: float,
                      e2e_mean_s: float) -> dict:
    """The fleet point's attribution table, the reference's rows: arrival
    accumulation (batch due minus each order's intended time), send
    backlog (batch send minus due), admit (the DoOrderBatch wall, an
    order charged its mean slot (n+1)/2n of it), bus_wait by Little's law
    on the sampled doOrder depth (`little_wait`: (orders, depth mean /
    throughput) a partition) and the consumers' stage spans. Their sum is
    held against the measured corrected mean; bus_wait is an estimate of
    its own, so the check can fail. The wait left once the other rows are
    taken from the measured admit-to-completion time rides on the
    bus_wait row as `residual_s`, for reading only."""
    all_batches = [(i, b) for i in range(fd.N_PARTITIONS)
                   for b in drive[i].get("batches", [])]
    n_sent = sum(b["n"] for _, b in all_batches) or 1
    accum = backlog = admit = post_admit = 0.0
    for i, b in all_batches:
        wall = b["t_ret"] - b["t_send"]
        backlog += (b["t_send"] - b["due"]) * b["n"]
        admit += wall * (b["n"] + 1) / 2
        for k, r in enumerate(range(b["first_rank"],
                                    b["first_rank"] + b["n"])):
            accum += b["due"] - sched.intended(parts[i][r][0])
            if i in comps:
                post_admit += comps[i][r] - (b["t_send"]
                                             + wall * (k + 1) / b["n"])
    accum, backlog = accum / n_sent, backlog / n_sent
    admit, post_admit = admit / n_sent, post_admit / n_sent
    admit_busy = [sum(b["t_ret"] - b["t_send"]
                      for j, b in all_batches if j == i)
                  for i in range(fd.N_PARTITIONS)]
    rows = [
        {"stage": "arrival_accumulation", "seconds_per_order": accum,
         "utilization": None,
         "source": "exact (batch due - per-order intended)"},
        {"stage": "send_backlog", "seconds_per_order": backlog,
         "utilization": None, "source": "driver (batch send - batch due)"},
        {"stage": "admit", "seconds_per_order": admit,
         "utilization": max(w / busy_s for w in admit_busy),
         "source": "driver (DoOrderBatch RPC wall, mean-slot share)"},
        {"stage": "bus_wait",
         "seconds_per_order": ((sum(n * w for n, w in little_wait)
                                / sum(n for n, _ in little_wait))
                               if little_wait else 0.0),
         "utilization": None,
         "source": "Little's law on sampled gome_bus_depth{doOrder}"},
    ]
    stage_total = 0.0
    for stage in sorted({s for d in stages1.values() for s in d}):
        dc = ds = 0.0
        per_member_busy = []
        for name in members:
            c0, s0 = stages0.get(name, {}).get(stage, (0.0, 0.0))
            c1, s1 = stages1.get(name, {}).get(stage, (0.0, 0.0))
            dc += c1 - c0
            ds += s1 - s0
            per_member_busy.append((s1 - s0) / busy_s)
        if dc <= 0:
            continue
        # Wait-like stages overlap across in-flight orders: their span sum
        # over wall is occupancy of nothing, so they never saturate.
        busy_like = stage not in _WAIT_STAGES
        stage_total += ds / dc
        rows.append({
            "stage": stage,
            "seconds_per_order": ds / dc,
            "utilization": max(per_member_busy) if busy_like else None,
            "source": "consumer gome_stage_seconds delta / spans",
        })
    rows[3]["residual_s"] = post_admit - stage_total
    attr = attribution_check(rows, e2e_mean_s, tol=0.05)
    attr["rows"] = rows
    attr["note"] = ("bus_wait (Little's law) and the consumer stage spans "
                    "overlap by up to one in-flight batch; the sum check "
                    "tolerates it at 5%")
    return attr


def run_fleet_point(ctx: dict, rate: float, window_s: float, batch_n: int,
                    oid_base: int) -> tuple[dict, int]:
    """One open-loop load point against the live 2x2 fleet. Returns the
    ladder point and the next oid base."""
    n_point = max(batch_n * fd.N_PARTITIONS, int(rate * window_s))
    parts = synth_requests(n_point, oid_base, ctx["symbols"])
    consumers = ctx["consumers"]
    text0 = {name: fd.fetch_text(url + "/metrics")
             for name, url in consumers.items()}
    consumed0 = {name: _parse_consumed(t) for name, t in text0.items()}
    stages0 = {name: _parse_stages(t) for name, t in text0.items()}

    sampler = ConsumerSampler(consumers, interval_s=0.025)
    sampler.start()
    time.sleep(0.08)  # at least one pre-drive sample a member
    sched = OpenLoopSchedule(rate, t0=time.perf_counter())
    drive = _drive_all(ctx, parts, sched, batch_n)
    window_end = sched.t0 + n_point / rate
    expect = {f"c{i}": consumed0[f"c{i}"] + len(parts[i])
              for i in range(fd.N_PARTITIONS)}
    drained = _await_drained(ctx, expect, timeout_s=max(120.0, 4 * window_s))
    time.sleep(0.1)  # the sampler catches the final counter value
    sampler.stop()

    # -- per-order latency by counter inversion -------------------------
    corrected, closed = _hist(), _hist()
    per_part = []
    delivered_rates, little_wait, comps = [], [], {}
    depth_means = {}
    for i in range(fd.N_PARTITIONS):
        name = f"c{i}"
        samples = sampler.samples[name]
        if not samples or not parts[i]:
            continue
        comp = _completion_times(samples, consumed0[name], len(parts[i]))
        comps[i] = comp
        pc, pl = _hist(), _hist()
        send_t = {}
        for b in drive[i].get("batches", []):
            for r in range(b["first_rank"], b["first_rank"] + b["n"]):
                send_t[r] = b["t_send"]
        for r, (gi, _cancel, _req) in enumerate(parts[i]):
            pc.record(max(comp[r] - sched.intended(gi), 0.0))
            pl.record(max(comp[r] - send_t.get(r, sched.t0), 0.0))
        per_part.append(pc)
        corrected.merge(pc)
        closed.merge(pl)
        # Steady-state delivered: the consumed counter's slope between its
        # first and last increase.
        inc = [k for k in range(1, len(samples))
               if samples[k][1] > samples[k - 1][1]]
        if (len(inc) >= 2 and samples[inc[-1]][1] > samples[inc[0]][1]
                and samples[inc[-1]][0] > samples[inc[0]][0]):
            delivered_rates.append(
                (samples[inc[-1]][1] - samples[inc[0]][1])
                / (samples[inc[-1]][0] - samples[inc[0]][0]))
        else:
            delivered_rates.append(
                len(parts[i]) / max(comp[-1] - sched.t0, 1e-9))
        depths = [d for (t, _c, d) in samples if t <= comp[-1]]
        depth_means[name] = sum(depths) / len(depths) if depths else 0.0
        span = max(comp[-1] - sched.t0, 1e-9)
        little_wait.append((len(parts[i]),
                            depth_means[name] / (len(parts[i]) / span)))
    # Cross-process merge proof: the merged recorder equals the sum of its
    # parts (integer-count state makes this exact).
    merge_lossless = corrected.count == sum(pc.count for pc in per_part)
    delivered_per_sec = sum(delivered_rates)

    # -- exactly-once: cumulative match-queue seq audit -------------------
    audits = []
    for i in range(fd.N_PARTITIONS):
        events = fd.read_match_events(ctx["bus_dirs"][i])
        seqs = [e.seq for e in events if e.seq is not None]
        a = fd.audit_seqs(seqs)
        audits.append({"partition": i, "events": len(events),
                       "stamped": len(seqs), "dupes": a.get("dupes", 0),
                       "gaps": a.get("gaps", 0)})
    accepted = sum(drive[i].get("accepted", 0)
                   for i in range(fd.N_PARTITIONS))
    exactly_once = {
        "method": "matchfeed seq audit (cumulative) + conservation",
        "sent": n_point,
        "accepted": accepted,
        "events": sum(a["events"] for a in audits),
        "dupes": sum(a["dupes"] for a in audits),
        "gaps": sum(a["gaps"] for a in audits),
        "drained": drained and accepted == n_point,
        "partitions": audits,
    }

    # -- attribution -------------------------------------------------------
    stages1 = {name: _parse_stages(fd.fetch_text(url + "/metrics"))
               for name, url in consumers.items()}
    busy_end = max((c[-1] for c in comps.values()), default=window_end)
    attr = fleet_attribution(parts, drive, sched, comps, little_wait,
                             stages0, stages1, list(consumers),
                             busy_s=max(busy_end - sched.t0, 1e-9),
                             e2e_mean_s=corrected.mean())
    backlog = next(r["seconds_per_order"] for r in attr["rows"]
                   if r["stage"] == "send_backlog")
    point = {
        "offered_per_sec": rate,
        "delivered_per_sec": round(delivered_per_sec, 2),
        "delivered_frac": round(delivered_per_sec / rate, 4),
        "sent": n_point,
        "orders_per_partition": [len(p) for p in parts],
        "batch_n": batch_n,
        "window_s": round(window_end - sched.t0, 3),
        "send_backlog_s_mean": round(backlog, 6),
        "corrected": _lat_summary(corrected),
        "closed_loop": _lat_summary(closed),
        "merge_lossless": merge_lossless,
        "exactly_once": exactly_once,
        "attribution": attr,
        "host": {name: _timeline_tail(url)
                 for name, url in consumers.items()},
        "bus_depth_mean": {k: round(v, 2) for k, v in depth_means.items()},
    }
    return point, oid_base + n_point


def run_fleet_sweep(args) -> dict:
    """Start the 2x2 fleet (fleet_drill's members), warm it, calibrate,
    run the ladder, and assemble the verdict."""
    import tempfile

    work = tempfile.mkdtemp(prefix="capacity-", dir=args.workdir or None)
    procs, errs = {}, {}
    try:
        resp_port = fd.start_respserver(procs)
        ports = fd.fleet_members(work, resp_port, args.symbols, args.device,
                                 procs, errs, dtype=args.dtype,
                                 trace_keep=FLEET_TRACE_KEEP)
        ctx = {
            "symbols": args.symbols,
            "bus_dirs": [f"{work}/p{i}" for i in range(fd.N_PARTITIONS)],
            "gw_targets": {i: f"127.0.0.1:{ports[f'gw{i}'][1]}"
                           for i in range(fd.N_PARTITIONS)},
            "consumers": {f"c{i}": f"http://127.0.0.1:{ports[f'c{i}'][0]}"
                          for i in range(fd.N_PARTITIONS)},
        }
        # Warm-up: the consumers' first combos off the ladder.
        oid_base = 0
        warm = synth_requests(args.warm, oid_base, args.symbols)
        oid_base += args.warm
        _drive_all(ctx, warm, OpenLoopSchedule(1e9, t0=time.perf_counter()),
                   args.batch_n)
        expect = {f"c{i}": len(warm[i]) for i in range(fd.N_PARTITIONS)}
        if not _await_drained(ctx, expect, 240.0):
            raise RuntimeError("the fleet did not drain its warm-up")
        # Closed-loop calibration burst: the ladder needs a scale.
        cal = synth_requests(args.calibrate, oid_base, args.symbols)
        oid_base += args.calibrate
        t0 = time.perf_counter()
        _drive_all(ctx, cal, OpenLoopSchedule(1e9, t0=t0), args.batch_n)
        expect = {f"c{i}": expect[f"c{i}"] + len(cal[i])
                  for i in range(fd.N_PARTITIONS)}
        if not _await_drained(ctx, expect, 240.0):
            raise RuntimeError("the fleet did not drain its calibration")
        cal_rate = args.calibrate / (time.perf_counter() - t0)
        print(f"capacity: calibration {cal_rate:.0f} orders/s closed loop",
              flush=True)
        rates = ([float(r) for r in args.rates.split(",")] if args.rates
                 else geometric_ladder(FLEET_SPAN[0] * cal_rate,
                                       FLEET_SPAN[1] * cal_rate, args.points))
        ladder = []
        for r in rates:
            point, oid_base = run_fleet_point(
                ctx, rate=r, window_s=args.window, batch_n=args.batch_n,
                oid_base=oid_base)
            ladder.append(point)
            print(f"capacity: offered {r:9.1f}/s delivered "
                  f"{point['delivered_per_sec']:9.1f}/s corrected p99 "
                  f"{point['corrected']['p99_s'] * 1e3:.1f} ms, attribution "
                  f"err {point['attribution']['frac_err']:.4f}", flush=True)
            time.sleep(0.5)  # settle between points
    finally:
        results = fd.stop_members(procs, work, errs)
        shutil.rmtree(work, ignore_errors=True)
    config = {
        "partitions": fd.N_PARTITIONS,
        "symbols": args.symbols,
        "batch_n": args.batch_n,
        "window_s": args.window,
        "points": len(rates),
        "ladder_span": list(FLEET_SPAN),
        "warmup_orders": args.warm,
        "calibration_orders": args.calibrate,
        "calibration_orders_per_sec": round(cal_rate, 1),
        "delivered_floor": args.delivered_floor,
        "p99_budget_s": args.p99_budget_s,
        "histogram": HIST_KW,
        "engine": {"n_slots": args.symbols, "max_t": 32, "cap": 256,
                   "max_fills": 16, "dtype": args.dtype,
                   "device": args.device},
        "drive": ("per-partition DoOrderBatch over gRPC, routed by "
                  "fleet.partition_of; gateways run with the tracer armed, "
                  "so admission takes the per-order scalar path (the members "
                  "of fleet_drill)"),
        "completion_source": ("gome_orders_consumed_total polled at 25 ms, "
                              "inverted via per-partition FIFO with linear "
                              "interpolation"),
        "arrival_model": ("open-loop fixed schedule: intended_i = t0 + "
                          "(i+1)/rate; latency charged from intended time"),
    }
    extra = {
        "merge_lossless_all_points": all(p.get("merge_lossless")
                                         for p in ladder),
        "all_members_exited_clean": all(r.get("exit_code") == 0
                                        for r in results.values()),
    }
    verdict = build_verdict("fleet", config, ladder, args.delivered_floor,
                            args.p99_budget_s, extra_checks=extra)
    verdict["members"] = {n: {"exit_code": r.get("exit_code"),
                              "k1_launches": r.get("launches"),
                              "stderr": r.get("stderr")}
                          for n, r in results.items()}
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fleet", action="store_true",
                    help="sweep the 2x2 subprocess fleet (default: the "
                         "single-process service stack)")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="single mode: total ladder budget (window = "
                         "budget / points)")
    ap.add_argument("--window", type=float, default=4.0,
                    help="fleet mode: offered window a ladder point (s)")
    ap.add_argument("--points", type=int, default=6)
    ap.add_argument("--rates", default="",
                    help="comma list of offered rates (orders/s); default "
                         "geometric over the calibration, 0.3-1.6x single, "
                         "0.3-3x fleet")
    ap.add_argument("--batch-n", type=int, default=0,
                    help="orders a DoOrderBatch / frame (default: 256 "
                         "single, 32 fleet)")
    ap.add_argument("--symbols", type=int, default=0,
                    help="engine symbol slots (default: 32 single, "
                         "10,240 fleet)")
    ap.add_argument("--cap", type=int, default=128, help="single: book cap")
    ap.add_argument("--pipeline", type=int, default=2,
                    help="single: consumer pipeline depth")
    ap.add_argument("--dtype", default="int32")
    ap.add_argument("--warm", type=int, default=2048,
                    help="fleet: warm-up orders")
    ap.add_argument("--calibrate", type=int, default=4096,
                    help="fleet: closed-loop calibration orders")
    ap.add_argument("--delivered-floor", type=float, default=0.98)
    ap.add_argument("--p99-budget-s", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--out", default="",
                    help="verdict path (default: CAPACITY_CUDA_r01.json "
                         "with --fleet, capacity_smoke.json otherwise)")
    args = ap.parse_args(argv)
    args.device = require_device(args.device)
    out = args.out or ("CAPACITY_CUDA_r01.json" if args.fleet
                       else "capacity_smoke.json")
    args.batch_n = args.batch_n or (32 if args.fleet else 256)
    args.symbols = args.symbols or (10_240 if args.fleet else 32)
    if args.fleet:
        verdict = run_fleet_sweep(args)
    else:
        verdict = run_single_sweep(
            args.device, seconds=args.seconds, points=args.points,
            symbols=args.symbols, cap=args.cap, batch_n=args.batch_n,
            pipeline=args.pipeline,
            delivered_floor=args.delivered_floor,
            p99_budget_s=args.p99_budget_s, dtype=args.dtype,
            rates=([float(r) for r in args.rates.split(",")]
                   if args.rates else None))
    verdict["artifact"] = out.rsplit("/", 1)[-1].removesuffix(".json")
    verdict["provenance"] = provenance(args.device)
    write_json(out, verdict)
    print_verdict(verdict, out)
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
