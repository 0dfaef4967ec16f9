"""The observability plane wired into the port's engine and service, on the
CPU against gome_tpu's: the same Zipf frames through both BatchEngines
give the same occupancy ledger, the same gome_dispatched_rows_per_live_lane
observations, the same recorded combos and the same geometry hash; an
EngineService with the `ops:` defaults (cost and profile off) constructs,
serves /timeline, /placement, /capacity and /hostprof with the
reference's keys, and its gome_stage_seconds carries the engine stages."""

import json
import urllib.request

import pytest

import gome_tpu.engine.batch as jbatch
import gome_tpu.obs.compile_journal as jjournal
import gome_tpu.obs.hostprof as jhostprof
import gome_tpu.obs.placement as jplacement
import gome_tpu.obs.timeline as jtimeline
import gome_tpu.utils.trace as jtrace
import gome_tpu_torch.engine.batch as tbatch
import gome_tpu_torch.obs.compile_journal as tjournal
import gome_tpu_torch.obs.hostprof as thostprof
import gome_tpu_torch.obs.placement as tplacement
import gome_tpu_torch.obs.timeline as ttimeline
import gome_tpu_torch.utils.trace as ttrace
from gome_tpu.engine import frames as jframes
from gome_tpu.utils.metrics import Registry as JRegistry
from gome_tpu.utils.streams import multi_symbol_stream
from gome_tpu_torch.engine import frames as tframes
from gome_tpu_torch.utils.metrics import Registry as TRegistry
from test_torch_frames import assert_batches_equal, batch_pair, frame_of
from test_torch_obs import strip_baselines

SINGLETONS = (jtimeline.TIMELINE, ttimeline.TIMELINE, jhostprof.HOSTPROF,
              thostprof.HOSTPROF, jplacement.PLACEMENT, tplacement.PLACEMENT,
              jjournal.JOURNAL, tjournal.JOURNAL, jtrace.TRACER,
              ttrace.TRACER)


@pytest.fixture(autouse=True)
def disarmed():
    """Every singleton here is process-wide: each test starts and ends
    with all of them disarmed (an armed TRACER would pin later tests'
    gateways to the scalar loop)."""
    for s in SINGLETONS:
        s.disable()
    yield
    for s in SINGLETONS:
        s.disable()


class Recorder:
    def __init__(self):
        self.seen = []

    def observe(self, v):
        self.seen.append(v)


#: The recorded combo's fields (frames.submit_frame's tuple order).
COMBO_FIELDS = ("n_rows", "t_grid", "cap", "dense", "m_pad", "k_rec",
                "e_fills", "e_cancels", "totals_len")


def zipf_frames(n=1200, chunk=400, seed=7):
    orders = multi_symbol_stream(n=n, n_symbols=96, zipf_a=1.2,
                                 cancel_prob=0.3, seed=seed)
    return [frame_of(orders[i:i + chunk]) for i in range(0, n, chunk)]


def test_zipf_frames_feed_the_same_telemetry(monkeypatch):
    """Cap 128: two cap classes (64, 128), so the frames split by class
    and the dense floors are keyed by both."""
    rec = {}
    for side, mod, obs, tl, jr, reg in (
            ("j", jbatch, jplacement.PLACEMENT, jtimeline.TIMELINE,
             jjournal.JOURNAL, JRegistry),
            ("t", tbatch, tplacement.PLACEMENT, ttimeline.TIMELINE,
             tjournal.JOURNAL, TRegistry)):
        rec[side] = Recorder()
        monkeypatch.setattr(mod, "_rows_per_live_lane", rec[side])
        obs.install(topk=16, row_bytes=28 * 8, partitions=4, registry=reg())
        tl.install(interval_s=1.0, keep_n=8, registry=reg())
        jr.install(keep_n=64, registry=reg())
    j, t = batch_pair(128, 4, 256, 8)
    frames = zipf_frames()
    for cols in frames:
        for obs in (tplacement.PLACEMENT, jplacement.PLACEMENT):
            obs.note_admit_frame(cols["symbols"], cols["symbol_idx"])
        assert_batches_equal(tframes.apply_frame_fast(t, cols),
                             jframes.apply_frame_fast(j, cols))
    got, want = rec["t"].seen, rec["j"].seen
    assert len(got) >= len(frames) and got == want
    tp, jp = tplacement.PLACEMENT.payload(), jplacement.PLACEMENT.payload()
    assert strip_baselines(tp) == strip_baselines(jp)
    # The port's baselines: its own mesh and fleet artifacts.
    attr = tp["attribution"]
    assert attr["components"][0]["baseline"] == \
        tplacement.shard_skew_baseline()
    assert attr["hash_partition"]["baseline"] == \
        tplacement.partition_imbalance_baseline()
    assert tp["occupancy"]["frames"] == len(got)
    assert tp["attribution"]["reconciliation"]["within_tol"]
    assert tp["top"][0]["symbol"] == "sym0"
    # The recorded combos: equal on every field, so the shape manifest
    # and the timeline's geometry hash are equal too.
    tc, jc = t.combos(), j.combos()
    assert {len(c) for c in tc} == {len(COMBO_FIELDS)}
    assert tc == [tuple(c) for c in jc] and len(tc) > 1
    assert {c[2] for c in tc} == {64, 128}  # both cap classes ran
    assert t.combo_count() == j.combo_count()
    assert t.geometry_floors() == j.geometry_floors()
    assert (ttimeline.geometry_manifest_hash(t)
            == jtimeline.geometry_manifest_hash(j))
    assert not t.record_combo(tc[0]) and t.combo_seen(tc[0])
    # The journal: one frame_dispatch entry per first-seen combo, in
    # dispatch order, with the same detail block bar the two fields
    # test_torch_obs.test_frame_combo_detail_matches names.
    te, je = tjournal.JOURNAL.entries(), jjournal.JOURNAL.entries()
    assert [e["key"] for e in te] == [e["key"] for e in je]
    assert sorted(e["key"] for e in te) == tc
    for g, w in zip(te, je):
        assert g["entry"] == w["entry"] == "frame_dispatch"
        for d in (g["detail"], w["detail"]):
            d.pop("scatter_jaxpr_eqns"), d.pop("upload_bytes")
        assert g["detail"] == w["detail"]
    # Timeline flow counters: once per applied frame on both.
    ts, js = ttimeline.TIMELINE.sample(), jtimeline.TIMELINE.sample()
    assert (ts["frames"], ts["orders"]) == (js["frames"], js["orders"]) \
        == (len(frames), 1200)


def service_config(side_config):
    """The `ops:` defaults, cost and profile off (their routes are held by
    test_torch_service_parts), gRPC and the ops endpoint on ephemeral
    ports."""
    c = side_config
    return c.Config(
        grpc=c.GrpcConfig(host="127.0.0.1", port=0),
        engine=c.EngineConfig(cap=16, max_fills=4, n_slots=64, max_t=8),
        ops=c.OpsConfig(port=0, enabled=True, cost=False, profile=False,
                        timeline_interval_s=60.0))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


def drive(svc, pb, n=300):
    """A seeded flow through the gateway (DoOrderBatch, cancels in the
    mask; scalar DoOrder and DeleteOrder), then one synchronous pump."""
    from gome_tpu.utils.streams import multi_symbol_stream as stream

    orders = stream(n=n, n_symbols=12, zipf_a=1.2, cancel_prob=0.25, seed=3)
    reqs, cancel = [], []
    for o in orders:
        reqs.append(pb.OrderRequest(
            uuid=o.uuid, oid=o.oid, symbol=o.symbol,
            transaction=pb.BUY if o.side == 0 else pb.SALE,
            price=o.price / 1e8, volume=max(o.volume, 1) / 1e8))
        cancel.append(o.action == 2)
    resp = svc.gateway.DoOrderBatch(
        pb.OrderBatchRequest(orders=reqs, cancel=cancel), None)
    assert resp.code == 0 and resp.accepted == n
    assert svc.gateway.DoOrder(reqs[0], None).code == 0
    assert svc.gateway.DeleteOrder(reqs[0], None).code == 0
    svc.pump()


def serve(side):
    """Build, drive and scrape one package's service; returns the four
    routes' JSON, /metrics and /hostprof?format=collapsed."""
    import logging

    for name in ("gome_tpu.matchfeed", "gome_tpu_torch.matchfeed"):
        logging.getLogger(name).setLevel(logging.WARNING)
    if side == "t":
        import gome_tpu_torch.config as config
        from gome_tpu_torch.api import order_pb2 as pb
        from gome_tpu_torch.service import EngineService

        svc = EngineService(service_config(config), device="cpu")
        timeline = ttimeline.TIMELINE
    else:
        import gome_tpu.config as config
        from gome_tpu.api import order_pb2 as pb
        from gome_tpu.service import EngineService

        svc = EngineService(service_config(config))
        timeline = jtimeline.TIMELINE
    svc.ops.start()
    try:
        drive(svc, pb)
        for _ in range(4):
            timeline.sample()
        port = svc.ops.port
        out = {r: json.loads(_get(port, f"/{r}")[1])
               for r in ("timeline", "placement", "capacity", "hostprof")}
        out["drill"] = json.loads(_get(port, "/hostprof?drill=1")[1])
        out["collapsed"] = _get(port, "/hostprof?format=collapsed")
        out["metrics"] = _get(port, "/metrics")[1]
    finally:
        svc.ops.stop()
    return out


def keys(x, depth):
    if depth == 0 or not isinstance(x, dict):
        return type(x).__name__
    return {k: keys(v, depth - 1) for k, v in x.items()}


def test_service_with_default_ops_serves_the_obs_routes():
    t = serve("t")
    for s in SINGLETONS:
        s.disable()
    j = serve("j")
    for route in ("timeline", "placement", "capacity", "hostprof"):
        assert t[route].keys() == j[route].keys(), route
    assert t["capacity"] == j["capacity"] == {"enabled": False}
    # The reference serves its TPU run's what-if verdict, the port its own
    # (PLACEMENT_CUDA_r01.json, written on the card).
    verdict = t["placement"].pop("verdict")
    assert verdict == tplacement.default_verdict()
    assert verdict["artifact"] == "PLACEMENT_CUDA_r01"
    assert verdict["schema"] == jplacement.SCHEMA
    assert j["placement"].pop("verdict")["schema"] == jplacement.SCHEMA
    assert keys(t["placement"], 2) == keys(j["placement"], 2)
    assert t["placement"]["admits"] == j["placement"]["admits"] == 302
    assert t["placement"]["top"] == j["placement"]["top"]
    assert t["placement"]["sketch"] == j["placement"]["sketch"]
    # The timeline's samples: the reference's probes and fields, the live
    # probe in the port's allocator form (count/bytes + per device).
    ts, js = t["timeline"]["samples"], j["timeline"]["samples"]
    assert len(ts) == len(js) == 4
    assert ts[-1].keys() == js[-1].keys()
    assert keys(ts[-1]["engine"], 1) == keys(js[-1]["engine"], 1)
    assert ts[-1]["engine"]["orders_total"] == js[-1]["engine"][
        "orders_total"]
    live = ts[-1]["live"]
    assert live["bytes"] >= live["devices"]["cpu"]["allocated_bytes"] > 0
    assert {"count", "bytes"} <= js[-1]["live"].keys()
    assert ts[-1]["frames"] == js[-1]["frames"]
    assert ts[-1]["placement"] == js[-1]["placement"]
    # /hostprof: the reference's keys; the drill carries "prepool" too.
    assert keys(t["hostprof"], 1) == keys(j["hostprof"], 1)
    assert t["drill"]["drill"].pop("prepool") in ("native", "local")
    assert t["drill"]["drill"].keys() == j["drill"]["drill"].keys()
    assert t["collapsed"][0] == j["collapsed"][0] == 200
    # The engine stages on /metrics (ops.trace on by default).
    for stage in ("ingress", "enqueue", "pad_pack", "device_execute",
                  "decode", "publish"):
        for side in (t, j):
            line = next(ln for ln in side["metrics"].splitlines() if
                        ln.startswith(f'gome_stage_seconds_count{{stage="'
                                      f'{stage}"}}'))
            assert float(line.rsplit(" ", 1)[1]) > 0, (stage, line)
    for name in ("gome_dispatched_rows_per_live_lane_p50",
                 "gome_hbm_resident_bytes", "gome_live_array_bytes",
                 "gome_timeline_frames_total", "gome_placement_topk_share",
                 "gome_hostprof_samples_total"):
        assert f"# TYPE {name} " in t["metrics"], name
