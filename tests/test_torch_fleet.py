"""The port's fleet tier against gome_tpu's. The routing tier
(gome_tpu_torch/fleet/router.py): the same partition for every symbol, and
the same PartitionMap / HealthGate / PartitionRouter / FailoverController
transitions over one scripted sequence. The fleet aggregator
(gome_tpu_torch/obs/fleet.py, tests/test_fleet.py's cases bar the TPU
artifact's pin): the exposition merge, trace stitching, and the same
scripted members served to both aggregators giving equal payloads at
every step (down, stale, recovered). Exact equality."""

import json
import os
import struct
import sys
import threading

import numpy as np
import pytest

import gome_tpu.config as jconfig
import gome_tpu.obs.fleet as jfleet
import gome_tpu.utils.metrics as jmetrics
import gome_tpu_torch.config as tconfig
import gome_tpu_torch.obs.fleet as tfleet
import gome_tpu_torch.utils.metrics as tmetrics
from gome_tpu.fleet import router as jrouter
from gome_tpu_torch.fleet import router as trouter
from gome_tpu_torch.obs.placement import SpaceSaving

SIDES = (jrouter, trouter)


def symbols(n: int, seed: int = 3) -> list[str]:
    rng = np.random.default_rng(seed)
    out = [f"sym{i}" for i in range(n // 2)]
    # Random byte strings as well, multi-byte UTF-8 included.
    for _ in range(n - len(out)):
        cps = rng.integers(0x21, 0x2FF, size=int(rng.integers(1, 12)))
        out.append("".join(chr(int(c)) for c in cps))
    return out


@pytest.mark.parametrize("p", [1, 2, 3, 8, 64])
def test_partition_of_matches(p):
    syms = symbols(10_000)
    got = [trouter.partition_of(s, p) for s in syms]
    assert got == [jrouter.partition_of(s, p) for s in syms]
    assert set(got) <= set(range(p))
    if p > 1:
        assert len(set(got)) == p


def test_partition_of_rejects_like_the_reference():
    for mod in SIDES:
        with pytest.raises(ValueError, match="n_partitions must be positive"):
            mod.partition_of("x", 0)


def script(mod) -> list:
    """One scripted run of every transition: bootstrap, routing, debounced
    health, a failover race (lost claim, failed recovery, committed
    handoff), a rebalance that voids a stale claim, and the errors."""
    log = []
    pmap = mod.PartitionMap.even(8, ["m0", "m1", "m2"])
    gate = mod.HealthGate(suspect_after=2, down_after=3)
    router = mod.PartitionRouter(pmap, gate)
    ctl = mod.FailoverController(pmap, gate, lock=threading.Lock())
    log.append(("snapshot", pmap.snapshot(), pmap.members()))
    syms = [f"sym{i}" for i in range(40)]
    log.append(("route", [router.route(s) for s in syms],
                [router.partition(s) for s in syms]))
    for healthy in (False, True, False, False, False, False):
        log.append(("health", gate.record("m1", healthy)))
    log.append(("gate", gate.snapshot(), gate.is_down("m1"), gate.state("zz")))
    try:
        for s in syms:
            router.route(s)
    except mod.RouteUnavailable as e:
        log.append(("unavailable", e.symbol, e.partition, e.member, str(e)))
    log.append(("claim up", ctl.claim("m0", "s1")))
    c = ctl.claim("m1", "s1")
    log.append(("claim", c.standby, c.epoch, c.state, c.partitions))
    log.append(("second claim", ctl.claim("m1", "s2")))
    ctl.release("m1", "s2")  # not the holder: no effect
    log.append(("commit other", ctl.commit("m1", "s2")))
    ctl.release("m1", "s1")

    def boom(dead, parts):
        raise RuntimeError(f"restore of {dead} {parts} failed")

    with pytest.raises(RuntimeError, match="restore of m1"):
        ctl.failover("m1", "s2", boom)
    seen = []
    epoch = ctl.failover("m1", "s3", lambda d, ps: seen.append((d, ps)))
    log.append(("failover", epoch, seen, pmap.snapshot(), ctl.history()))
    log.append(("route after", [router.route(s) for s in syms]))
    gate.mark_down("m2")
    c = ctl.claim("m2", "s4")
    pmap.reassign([0], "m0")  # a rebalance under the claim
    log.append(("stale commit", c.epoch, ctl.commit("m2", "s4"),
                pmap.epoch, pmap.partitions_of("m2")))
    log.append(("nothing left", ctl.claim("m1", "s5")))
    for bad in (lambda: mod.PartitionMap(2, {0: "a"}),
                lambda: mod.PartitionMap(2, {0: "a", 1: "b", 2: "c"}),
                lambda: mod.PartitionMap(1, {0: ""}),
                lambda: mod.PartitionMap.even(2, []),
                lambda: mod.HealthGate(3, 2),
                lambda: pmap.reassign([99], "m0"),
                lambda: pmap.reassign([0], "")):
        try:
            bad()
        except (ValueError, KeyError) as e:
            log.append(("error", type(e).__name__, str(e)))
    return log


def test_scripted_transitions_match():
    got, want = script(trouter), script(jrouter)
    assert len(got) == len(want) > 20
    for g, w in zip(got, want):
        assert g == w


# -- the fleet aggregator (obs/fleet.py) and its exposition merge ------------

#: (metrics module, fleet module) of each package.
FLEETS = {"j": (jmetrics, jfleet), "t": (tmetrics, tfleet)}


def member_registry(metrics, orders, rss, queue_depth):
    """One member's metric surface (tests/test_fleet.py's): a counter, a
    labeled gauge, a plain gauge, and a labeled histogram."""
    reg = metrics.Registry()
    c = reg.counter("gome_orders_consumed_total", "orders drained")
    for _ in range(orders):
        c.inc()
    reg.gauge("gome_rss_bytes", "resident set size").set(rss)
    reg.gauge("gome_bus_depth", "queue depth",
              labels={"queue": "doOrder"}).set(queue_depth)
    h = reg.histogram("gome_stage_seconds", "per-stage latency",
                      buckets=(0.001, 0.01, 0.1), labels={"stage": "ingress"})
    for v in (0.0005, 0.005, 0.05, 0.5):
        h.observe(v)
    return reg


@pytest.mark.parametrize("side", FLEETS)
def test_exposition_roundtrip_and_merge(side):
    metrics = FLEETS[side][0]
    text = member_registry(metrics, 7, 12345678.0, 3).render()
    fams = metrics.parse_exposition(text)
    assert metrics.render_exposition(fams) == text
    a = member_registry(metrics, 10, 100.0, 2).render()
    b = member_registry(metrics, 32, 200.0, 5).render()
    merged = metrics.merge_expositions({"gw0": a, "c0": b})
    assert metrics.family_total(merged["gome_orders_consumed_total"]) == 42
    assert {s.labels["proc"]: s.value
            for s in merged["gome_rss_bytes"].samples} == {
        "gw0": 100.0, "c0": 200.0}
    out = metrics.render_exposition(merged)
    assert metrics.render_exposition(metrics.parse_exposition(out)) == out
    # The two packages' merges render the same document.
    assert out == jmetrics.render_exposition(
        jmetrics.merge_expositions({"gw0": a, "c0": b}))
    ra, rb = metrics.Registry(), metrics.Registry()
    ra.histogram("h", "x", buckets=(1.0, 2.0)).observe(1.5)
    rb.histogram("h", "x", buckets=(1.0, 4.0)).observe(1.5)
    with pytest.raises(ValueError, match="bucket"):
        metrics.merge_expositions({"a": ra.render(), "b": rb.render()})
    rc, rd = metrics.Registry(), metrics.Registry()
    rc.counter("m", "x").inc()
    rd.gauge("m", "x").set(1.0)
    with pytest.raises(ValueError, match="conflicting types"):
        metrics.merge_expositions({"a": rc.render(), "b": rd.render()})
    with pytest.raises(ValueError):
        metrics.parse_exposition("not a metric line at all {{{\n")


def two_process(offset=100.0, transit=0.002):
    """tests/test_fleet.py's gateway + consumer exports on clocks that
    differ by a known offset."""
    gw = {"pid": 101, "journeys": [
        {"trace_id": "t1", "open": True,
         "spans": [["ingress", 1.000, 1.001, None],
                   ["enqueue", 1.001, 1.002, None]]},
        {"trace_id": "t2", "open": True,
         "spans": [["ingress", 2.000, 2.001, None],
                   ["enqueue", 2.001, 2.002, None]]},
    ]}
    con = {"pid": 202, "journeys": [
        {"trace_id": "t1", "open": False,
         "spans": [["bus_transit", 1.002, 1.002 + transit + offset, None],
                   ["device_execute", 1.010 + offset, 1.015 + offset,
                    None]]},
        {"trace_id": "t2", "open": False,
         "spans": [["bus_transit", 2.002, 2.002 + transit + offset + 0.001,
                    None],
                   ["device_execute", 2.010 + offset, 2.014 + offset,
                    None]]},
    ]}
    return {"gw": gw, "con": con}


def test_stitching_matches():
    exports = two_process()
    got = tfleet.stitch_journeys(exports)
    assert got == jfleet.stitch_journeys(exports)
    assert tfleet.estimate_offsets(exports) == jfleet.estimate_offsets(
        exports) == {("gw", "con"): pytest.approx(100.002)}
    assert got["traces"] == got["joined"] == 2
    j1 = next(j for j in got["journeys"] if j["trace_id"] == "t1")
    assert j1["duration_s"] == pytest.approx(0.013, abs=1e-6)
    assert tfleet.stitched_chrome_trace(got) == jfleet.stitched_chrome_trace(
        got)
    del exports["con"]["journeys"][0]  # t1 now gateway-only
    single = tfleet.stitch_journeys(exports)
    assert single == jfleet.stitch_journeys(exports)
    assert single["joined"] == 1


def test_disabled_poll_is_zero_alloc():
    agg = tfleet.FleetAggregator()
    assert not agg.enabled

    def drill(n):
        i = 0
        while i < n:
            if agg.poll() is not None:
                raise AssertionError("unreachable")
            i += 1

    drill(64)
    before = sys.getallocatedblocks()
    drill(200)
    after = sys.getallocatedblocks()
    assert after - before <= 2, f"disabled poll() allocated {after - before}"


def sketch_hex(counts):
    sk = SpaceSaving(8)
    for sym, n in counts.items():
        sk.note(sym, n)
    return sk.to_bytes().hex()


def scripted_fetch(down: set, placement: bool = True):
    """Members a and b (tests/test_fleet.py's surfaces), each with a
    placement observatory; a member in `down` refuses connections."""
    texts = {"a": member_registry(tmetrics, 3, 1.0, 0).render(),
             "b": member_registry(tmetrics, 4, 2.0, 1).render()}
    flows = {"a": {"sym0": 5, "sym1": 2}, "b": {"sym0": 1, "sym2": 9}}

    def fetch(url, timeout_s):
        proc, _, path = url.partition("://")[2].partition("/")
        if proc in down:
            raise ConnectionError("connection refused")
        path = "/" + path
        if path == "/metrics":
            return texts[proc]
        if path == "/healthz":
            return json.dumps({"healthy": True, "detail": {}})
        if path == "/durability":
            return json.dumps({"matchfeed": {
                "last_seq": 6, "observed": 7, "dupes": 0, "gaps": 0}})
        if path.startswith("/timeline"):
            return json.dumps({"samples": [{"t": 1.0}]})
        if path == "/placement":
            if not placement:
                raise ConnectionError("no placement")
            return json.dumps({
                "enabled": True, "admits": sum(flows[proc].values()),
                "sketch": {"bytes_hex": sketch_hex(flows[proc])}})
        raise AssertionError(url)

    return fetch


def drive_aggregator(side):
    """One scripted sequence through one package's aggregator: polls,
    a member going down, staleness, recovery; every payload and gauge
    text along the way."""
    metrics, fleet = FLEETS[side]
    now = [100.0]
    down: set = set()
    reg = metrics.Registry()
    agg = fleet.FleetAggregator()
    log = []
    agg.install({"a": "inproc://a", "b": "inproc://b"}, interval_s=1.0,
                stale_after_s=5.0, clock=lambda: now[0],
                fetch=scripted_fetch(down), registry=reg)
    try:
        log.append(("age", agg.poll_age_s("a"), agg.member_up("a")))
        for step in ("up", "b down", "b stale", "b back"):
            if step == "b down":
                down.add("b")
                now[0] += 3.0
            elif step == "b stale":
                now[0] += 3.0
            elif step == "b back":
                down.discard("b")
                now[0] += 1.0
            agg.poll()
            log.append((step, agg.payload(), agg.rollup(),
                        agg.partition_imbalance(),
                        sorted(ln for ln in reg.render().splitlines()
                               if ln.startswith("gome_fleet_"))))
    finally:
        agg.disable()
    assert agg.poll() is None
    return log


def test_scripted_members_give_equal_payloads():
    got, want = drive_aggregator("t"), drive_aggregator("j")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g == w
    up = got[1][1]
    assert up["enabled"] and set(up["members"]) == {"a", "b"}
    assert up["seq"]["fleet"]["observed"] == 14
    assert up["metrics"]["families"]["gome_orders_consumed_total"][
        "total"] == 7
    flow = up["placement"]["flow"]
    assert flow["total"] == 17 and flow["top"][0]["symbol"] == "sym2"
    # admits 7 and 10: max over mean
    assert up["placement"]["partition_imbalance_max_over_mean"] == \
        pytest.approx(10 / 8.5)
    assert got[2][1]["unreachable"] == ["b"]
    assert got[3][1]["members"]["b"]["stale"] is True
    assert got[4][1]["unreachable"] == []


@pytest.mark.parametrize("side", FLEETS)
def test_aggregator_validation(side):
    fleet = FLEETS[side][1]
    agg = fleet.FleetAggregator()
    for kw, match in (({"stale_after_s": 0.0}, "stale_after_s"),
                      ({"interval_s": 0}, "interval_s"),
                      ({"timeout_s": -1}, "timeout_s")):
        with pytest.raises(ValueError, match=match):
            agg.install({"a": "inproc://a"}, **kw)
    with pytest.raises(ValueError, match="non-empty"):
        agg.install({})
    with pytest.raises(RuntimeError, match="install"):
        agg.start()
    agg.install({"a": "inproc://a"}, interval_s=2.0,
                registry=FLEETS[side][0].Registry(),
                fetch=scripted_fetch(set(), placement=False))
    try:
        assert agg.stale_after_s == 6.0
        assert agg.payload()["placement"] is None
    finally:
        agg.disable()


@pytest.mark.parametrize("config", [jconfig, tconfig])
def test_fleet_config_member_map(config):
    fc = config.FleetConfig(
        enabled=True, members=("gw0=http://h:1", {"c0": "http://h:2"}))
    assert fc.member_map() == {"gw0": "http://h:1", "c0": "http://h:2"}
    with pytest.raises(ValueError, match="duplicate"):
        config.FleetConfig(enabled=True, members=(
            "x=http://h:1", "x=http://h:2")).member_map()
    with pytest.raises(ValueError):
        config.FleetConfig(enabled=True, members=())
    with pytest.raises(ValueError):
        config.FleetConfig(members=("nourl",))


def test_filelog_reader_tails_external_appends(tmp_path):
    from gome_tpu_torch.bus.filelog import FileQueue

    base = str(tmp_path / "doOrder")
    reader = FileQueue("doOrder", base)
    writer = FileQueue("doOrder", base)
    assert reader.end_offset() == 0
    writer.publish(b"one")
    writer.publish(b"two")
    assert reader.end_offset() == 2
    msgs = reader.read_from(0, 10)
    assert [(m.offset, m.body) for m in msgs] == [(0, b"one"), (1, b"two")]
    writer.publish(b"three")
    assert [m.body for m in reader.read_from(2, 10)] == [b"three"]
    # A torn tail mid-append is skipped, never truncated.
    with open(base + ".log", "ab") as f:
        f.write(struct.pack(">I", 6) + b"par")
    assert reader.end_offset() == 3
    size = os.path.getsize(base + ".log")
    with open(base + ".log", "ab") as f:
        f.write(b"tia")
    assert os.path.getsize(base + ".log") == size + 3
    assert reader.end_offset() == 4
    assert reader.read_from(3, 1)[0].body == b"partia"
    writer.close()
    reader.close()


def test_queue_depth_gauges_export():
    from gome_tpu_torch.bus.base import export_queue_metrics
    from gome_tpu_torch.bus.memory import MemoryQueue

    reg = tmetrics.Registry()
    q = MemoryQueue("doOrder")
    export_queue_metrics(q, registry=reg)
    q.publish(b"a")
    q.publish(b"b")
    q.commit(1)
    text = reg.render()
    assert 'gome_bus_depth{queue="doOrder"} 1' in text
    assert 'gome_bus_end_offset{queue="doOrder"} 2' in text
    assert 'gome_bus_committed_offset{queue="doOrder"} 1' in text
