"""Observability snapshot: run a small traced order drill through the
in-process service stack on the card and dump the operator surfaces to
files (the port of scripts/obs_snapshot.py):

  <out_dir>/metrics.txt     the /metrics exposition (gome_stage_seconds,
                            gome_compile_seconds, the obs/ gauges)
  <out_dir>/trace.json      one flight-recorder dump as Chrome trace JSON
  <out_dir>/cost.json       the /cost payload: compile journal (fed by a
                            frame through the fast path), live buffers,
                            the cost model and its donation report
  <out_dir>/compile_journal.json  the journal in its GL906 wire form,
                            checked against the committed combo universe
  <out_dir>/timeline.json   the /timeline payload, sampled around the drill
  <out_dir>/profile.json    the /profile payload: the measured roofline
                            from a bounded torch.profiler capture
  <out_dir>/profile_trace.json.gz  the capture's Chrome trace
  <out_dir>/hostprof.json   the /hostprof payload (the admit drill) plus
                            the columnar admit drill under
                            "columnar_drill" (>= 90% stage coverage, the
                            stage rows summing to >= 90% of the window)
  <out_dir>/hostprof_collapsed.txt  the collapsed stacks
  <out_dir>/HOSTPROF_CUDA_r02.json  a copy of the committed columnar
                            admit artifact
  <out_dir>/fleet.json      the /fleet payload over a scripted
                            two-member view of this process
  <out_dir>/capacity.json   the /capacity payload: capacity.py's
                            single-process smoke ladder run here and
                            installed into CAPACITY (attribution within
                            5% at every point, exactly-once, the events
                            equal to the oracle's)
  <out_dir>/placement.json  the /placement payload: the sketch fed by the
                            drill's admits, the ledger, the attribution,
                            and the port's committed verdict
  <out_dir>/PLACEMENT_CUDA_r01.json  a copy of that verdict

Every surface is checked as it is captured; a broken one raises.

    python -m gome_tpu_torch.scripts.obs_snapshot [out_dir=obs-artifacts]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

from .common import REPO, require_device

#: The capacity smoke ladder obs_snapshot runs by default (the reference's).
CAPACITY_SMOKE = dict(seconds=10.0, points=5, symbols=16, cap=64,
                      batch_n=256)


def need(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"obs_snapshot: {what}")


def _order_frame(n: int, symbols: list, seed: int):
    """One deterministic ORDER-frame column dict (the fast-path shape), so
    the compile journal sees real first-seen dispatch combos."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return dict(
        n=n,
        action=np.ones(n, np.int64),
        side=rng.integers(0, 2, n).astype(np.int64),
        kind=np.zeros(n, np.int64),
        price=rng.integers(99_000, 101_000, n).astype(np.int64),
        volume=rng.integers(1, 10, n).astype(np.int64),
        symbols=symbols,
        symbol_idx=rng.integers(0, len(symbols), n).astype(np.int64),
        uuids=["u0"],
        uuid_idx=np.zeros(n, np.int64),
        oids=np.char.add("f", np.arange(n).astype("U6")).astype("S"),
    )


def _dump(out_dir: str, name: str, doc) -> None:
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(doc, f, indent=1, default=str)


def _copy_artifact(out_dir: str, name: str) -> None:
    src = os.path.join(REPO, name)
    if os.path.exists(src):
        shutil.copyfile(src, os.path.join(out_dir, name))


def snapshot(out_dir: str = "obs-artifacts", device: str = "cuda",
             capacity: dict | None = None) -> dict:
    """Capture every surface into out_dir; returns a summary (the capacity
    verdict included)."""
    from ..analysis.surface import journal_escapes, load_universe
    from ..api import order_pb2 as pb
    from ..config import Config, EngineConfig, OpsConfig
    from ..engine import frames
    from ..obs import hostprof as hostprof_mod
    from ..obs.capacity import CAPACITY
    from ..obs.compile_journal import JOURNAL
    from ..obs.fleet import FLEET
    from ..obs.hostprof import HOSTPROF
    from ..obs.placement import PLACEMENT, default_verdict
    from ..obs.profiler import PROFILER
    from ..obs.timeline import TIMELINE
    from ..service.app import EngineService
    from ..service.ops import OpsServer
    from ..utils.metrics import REGISTRY, parse_exposition, render_exposition
    from ..utils.trace import TRACER
    from . import capacity as cap_mod

    os.makedirs(out_dir, exist_ok=True)
    # The drill's order.log is an artifact: the file handler writes into
    # out_dir (utils.logging reads GOME_LOG_DIR) for the snapshot's span.
    log_dir = os.environ.get("GOME_LOG_DIR")
    os.environ["GOME_LOG_DIR"] = out_dir
    cfg = Config(
        engine=EngineConfig(cap=32, n_slots=16, max_t=8, dtype="int32"),
        # ops.enabled arms the tracer and every obs/ surface; the HTTP
        # server is not started: the payloads are read in-process.
        ops=OpsConfig(enabled=True, trace=True, trace_keep=32),
    )
    svc = EngineService(cfg, device=None if device == "cuda" else device)
    try:
        TIMELINE.sample()
        # Crossing and cancelled orders so every surface has data: fills,
        # a cancel notice, complete ingress->publish journeys.
        for i in range(8):
            side = pb.SALE if i % 2 == 0 else pb.BUY
            r = svc.gateway.DoOrder(pb.OrderRequest(
                uuid=f"u{i}", oid=f"o{i}", symbol="eth2usdt",
                transaction=side, price=1.0, volume=2.0), None)
            need(r.code == 0, f"DoOrder answered {r}")
        svc.gateway.DeleteOrder(pb.OrderRequest(
            uuid="u6", oid="o6", symbol="eth2usdt", transaction=pb.SALE,
            price=1.0, volume=2.0), None)
        svc.pump()
        # One ORDER frame through the engine's fast path: first-seen
        # combos (and gome_compile_seconds samples) for the journal.
        frames.apply_frame_fast(svc.engine.batch, _order_frame(
            64, [f"sym{i}" for i in range(4)], seed=5))

        metrics = REGISTRY.render()
        need("gome_stage_seconds" in metrics, "stage histograms missing")
        need("gome_compile_seconds" in metrics, "compile histograms missing")
        dump = TRACER.recorder.chrome_trace()
        need(bool(dump["traceEvents"]), "flight recorder captured no journeys")
        _dump(out_dir, "trace.json", dump)

        ops = OpsServer(svc)
        cost = ops.cost_payload()
        need(bool(cost["compile_journal"]["entries"]),
             "compile journal is empty")
        need(bool(cost["cost_model"].get("entries")),
             f"cost model empty: {cost['cost_model']}")
        need(cost["live_buffers"]["total"]["count"] > 0, "no live buffers")
        _dump(out_dir, "cost.json", cost)
        journal_doc = JOURNAL.export()
        _dump(out_dir, "compile_journal.json", journal_doc)
        universe = load_universe(os.path.join(
            REPO, "gome_tpu_torch", "analysis", "combo_universe.json"))
        need(universe is not None, "no committed combo universe")
        escapes = journal_escapes(journal_doc["entries"], universe)
        need(not escapes, f"combos escaped the static universe: {escapes}")

        TIMELINE.sample()
        timeline = ops.timeline_payload()
        need(timeline["enabled"], "ops.timeline did not arm the sampler")
        need(len(timeline["samples"]) >= 2, "timeline captured no series")
        need(bool(timeline["samples"][-1]["engine"]["geometry_hash"]),
             "timeline sample without a geometry hash")
        _dump(out_dir, "timeline.json", timeline)
        need("gome_timeline_rss_bytes" in metrics, "timeline gauges missing")

        profile = ops.profile_payload(refresh=True)
        need(profile["enabled"], "ops.profile did not arm the profiler")
        rep = profile["report"]
        need(bool(rep and rep["entries"]), "profile report is empty")
        measured = [r for r in rep["entries"].values()
                    if "error" not in r and r.get("device_us_per_call", 0) > 0]
        need(bool(measured), f"no measured entries in the profile: {rep}")
        _dump(out_dir, "profile.json", profile)
        trace_out = None
        if rep.get("perfetto_trace") and os.path.exists(rep["perfetto_trace"]):
            trace_out = os.path.join(out_dir, "profile_trace.json.gz")
            shutil.copyfile(rep["perfetto_trace"], trace_out)

        # /placement, captured before the admit drills below push their
        # own flow through the same gateway hook.
        placement_doc = ops.placement_payload()
        need(placement_doc["enabled"], "ops.placement did not arm")
        pl_top = placement_doc["top"]
        need(bool(pl_top) and pl_top[0]["symbol"] == "eth2usdt",
             f"heavy-hitter table missed the drill flow: {pl_top}")
        pl_attr = placement_doc["attribution"]
        need(pl_attr["reconciliation"]["within_tol"],
             f"placement attribution does not reconcile: {pl_attr}")
        need(placement_doc["verdict"] == default_verdict(),
             "/placement serves another verdict than the committed one")
        need("gome_placement_admits_total" in REGISTRY.render(),
             "placement gauges missing")
        _dump(out_dir, "placement.json", placement_doc)
        _copy_artifact(out_dir, "PLACEMENT_CUDA_r01.json")

        hostprof_doc = ops.hostprof_payload(run_drill=True)
        need(hostprof_doc["enabled"], "ops.hostprof did not arm HOSTPROF")
        drill = hostprof_doc["drill"]
        need(bool(drill) and drill["sampler"]["samples"] > 0,
             f"hostprof drill captured no samples: {hostprof_doc}")
        need(bool(drill["stages"]), "hostprof drill attributed no stages")
        # A traced RPC takes the scalar path, so the columnar drill runs
        # with the tracer parked. 200 samples (the reference takes 32):
        # at 32 the coverage swings by several points from run to run.
        recorder = TRACER.recorder
        TRACER.disable()
        try:
            cdrill = hostprof_mod.gateway_drill(
                n_orders=16_384, seed=11, min_samples=200, max_rounds=48,
                path="columnar", batch_n=1024)
        finally:
            TRACER.install(recorder)
        need(cdrill["coverage_pct"] >= 90.0,
             f"columnar drill stage coverage {cdrill['coverage_pct']}% < 90%")
        stage_sum = sum(row["ns_per_order"] for row in cdrill["stages"].values())
        need(stage_sum >= 0.9 * cdrill["admit_ns_per_order"],
             f"stage taxonomy sums to {stage_sum:.1f} ns/order, window is "
             f"{cdrill['admit_ns_per_order']} ns/order")
        hostprof_doc["columnar_drill"] = cdrill
        _dump(out_dir, "hostprof.json", hostprof_doc)
        _copy_artifact(out_dir, "HOSTPROF_CUDA_r02.json")
        collapsed = HOSTPROF.collapsed()
        need(";" in collapsed, f"no collapsed stacks: {collapsed[:200]}")
        with open(os.path.join(out_dir, "hostprof_collapsed.txt"), "w") as f:
            f.write(collapsed)

        metrics = REGISTRY.render()
        need("gome_profile_device_us" in metrics, "profile gauges missing")
        need("gome_hostprof_" in metrics, "hostprof gauges missing")
        with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
            f.write(metrics)

        # /fleet over a scripted two-member view of this process: fetch is
        # injected, so no socket is bound.
        surfaces = {
            "/metrics": lambda: REGISTRY.render(),
            "/healthz": lambda: json.dumps(ops.monitor.check().as_dict(),
                                           default=str),
            "/durability": lambda: json.dumps(ops.durability_payload(),
                                              default=str),
            "/timeline": lambda: json.dumps(ops.timeline_payload(),
                                            default=str),
            "/trace?format=journeys": lambda: json.dumps(
                TRACER.recorder.export()),
        }

        def in_process_fetch(url: str, timeout_s: float) -> str:
            for suffix, fn in surfaces.items():
                if url.endswith(suffix):
                    return fn()
            raise ValueError(f"unexpected fleet fetch: {url}")

        FLEET.install({"alpha": "inproc://alpha", "beta": "inproc://beta"},
                      fetch=in_process_fetch)
        try:
            FLEET.poll()
            fleet_doc = FLEET.payload()
        finally:
            FLEET.disable()
        need(fleet_doc["enabled"], "fleet aggregator did not arm")
        fleet_metrics = fleet_doc["metrics"]
        need("error" not in fleet_metrics, str(fleet_metrics.get("error")))
        merged_text = fleet_metrics["exposition"]
        need(render_exposition(parse_exposition(merged_text)) == merged_text,
             "merged exposition does not re-render scrape-identically")
        need('proc="alpha"' in merged_text, "gauge union lost the proc label")
        _dump(out_dir, "fleet.json", fleet_doc)

        # /capacity: the single-process smoke ladder, installed into the
        # CAPACITY singleton. It builds its own engine and arms a private
        # tracer, so this process's recorder is parked around it.
        kw = dict(CAPACITY_SMOKE, **(capacity or {}))
        recorder = TRACER.recorder
        TRACER.disable()
        t_cap = time.perf_counter()
        try:
            cap_verdict = cap_mod.run_single_sweep(device, **kw)
        finally:
            TRACER.install(recorder)
        capacity_s = time.perf_counter() - t_cap
        ladder = cap_verdict["ladder"]
        need(len(ladder) >= kw["points"], f"ladder {ladder}")
        for pt in ladder:
            attr = pt["attribution"]
            need(bool(attr["rows"]),
                 f"empty attribution at {pt['offered_per_sec']}/s")
            need(attr["within_tol"],
                 f"attribution misses e2e latency at {pt['offered_per_sec']}"
                 f"/s: frac_err={attr['frac_err']}")
        need(cap_verdict["checks"]["exactly_once_all_points"],
             f"capacity exactly-once: {[p['exactly_once'] for p in ladder]}")
        need(cap_verdict["checks"]["events_equal_oracle"],
             f"capacity events against the oracle: {cap_verdict['oracle']}")
        need(cap_verdict["checks"]["monotone_ladder"],
             "offered rates do not increase along the ladder")
        CAPACITY.install(cap_verdict)
        try:
            capacity_doc = ops.capacity_payload()
            need(capacity_doc["enabled"], "capacity verdict did not arm")
            need(capacity_doc["verdict"]["schema"] == cap_verdict["schema"],
                 "capacity payload schema")
            need("gome_capacity_points" in REGISTRY.render(),
                 "capacity gauges missing")
            _dump(out_dir, "capacity.json", capacity_doc)
        finally:
            CAPACITY.disable()
    finally:
        for single in (JOURNAL, TIMELINE, PROFILER, HOSTPROF, PLACEMENT,
                       TRACER):
            single.disable()
        if log_dir is None:
            os.environ.pop("GOME_LOG_DIR", None)
        else:
            os.environ["GOME_LOG_DIR"] = log_dir
    journeys = {ev["args"]["trace_id"] for ev in dump["traceEvents"]
                if ev.get("ph") == "X"}
    return dict(
        out_dir=out_dir, metrics_bytes=len(metrics),
        trace_events=len(dump["traceEvents"]), journeys=len(journeys),
        compiles=len(cost["compile_journal"]["entries"]),
        cost_entries=len(cost["cost_model"]["entries"]),
        timeline_samples=len(timeline["samples"]),
        profile_entries=len(measured), profile_trace=trace_out,
        host_samples=drill["sampler"]["samples"],
        scalar_admit_ns=drill["admit_ns_per_order"],
        columnar_admit_ns=cdrill["admit_ns_per_order"],
        columnar_coverage=cdrill["coverage_pct"],
        fleet_members=len(fleet_doc["members"]),
        fleet_families=len(fleet_metrics["families"]),
        placement_admits=placement_doc["admits"],
        placement_top=pl_top[0], placement=placement_doc,
        capacity=cap_verdict, capacity_s=capacity_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir", nargs="?", default="obs-artifacts")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    s = snapshot(args.out_dir, require_device(args.device))
    knee = s["capacity"]["knee"]
    print(f"wrote {s['out_dir']}: metrics.txt ({s['metrics_bytes']} bytes), "
          f"trace.json ({s['trace_events']} events, {s['journeys']} "
          f"journeys), cost.json ({s['compiles']} journaled compiles, "
          f"{s['cost_entries']} cost-model entries), timeline.json "
          f"({s['timeline_samples']} samples), profile.json "
          f"({s['profile_entries']} measured entries), hostprof.json "
          f"({s['host_samples']} host samples, {s['scalar_admit_ns']} "
          f"ns/order scalar admit, {s['columnar_admit_ns']} ns/order "
          f"columnar at {s['columnar_coverage']}% coverage), fleet.json "
          f"({s['fleet_members']} members, {s['fleet_families']} merged "
          f"families), capacity.json ({len(s['capacity']['ladder'])} ladder "
          f"points, knee "
          + (f"at {knee['offered_per_sec']:.0f}/s offered"
             if knee.get("found") else "not reached")
          + f"), placement.json ({s['placement_admits']} admits sketched, top "
          f"{s['placement_top']['symbol']} at "
          f"{s['placement_top']['share']:.0%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
