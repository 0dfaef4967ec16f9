"""The port's fleet fault tolerance and its fleet chaos drill
(gome_tpu_torch/service/admission.py, service/batcher.py's adaptive
sizing, fleet/router.py's failover protocol under the interleaver,
obs/fleet.py's liveness, gome_tpu_torch/scripts/fleet_chaos.py) against
gome_tpu's: tests/test_fleet_chaos.py's cases that no other test twins,
run on both packages with their results compared exactly, and the
drill's pure parts against scripts/fleet_chaos.py's. The whole drill runs
on the card (chip_smoke.py phase 18 (b)); its committed verdict
(FLEET_CHAOS_CUDA_r01.json) is pinned at the end."""

import importlib.util
import json
import os
import threading
import types

import pytest

import gome_tpu.analysis.interleave as jinterleave
import gome_tpu.clients.doorder as jdoorder
import gome_tpu.fleet.router as jrouter
import gome_tpu.obs.fleet as jfleet
import gome_tpu.service.admission as jadmission
import gome_tpu.service.batcher as jbatcher
import gome_tpu.utils.metrics as jmetrics
import gome_tpu_torch.analysis.interleave as tinterleave
import gome_tpu_torch.clients.doorder as tdoorder
import gome_tpu_torch.fleet.router as trouter
import gome_tpu_torch.obs.fleet as tfleet
import gome_tpu_torch.service.admission as tadmission
import gome_tpu_torch.service.batcher as tbatcher
import gome_tpu_torch.utils.metrics as tmetrics
from gome_tpu.types import Action as JAction
from gome_tpu.types import Order as JOrder
from gome_tpu.types import Side as JSide
from gome_tpu_torch.scripts import fleet_chaos
from gome_tpu_torch.types import Action as TAction
from gome_tpu_torch.types import Order as TOrder
from gome_tpu_torch.types import Side as TSide

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKG = {
    "j": types.SimpleNamespace(
        admission=jadmission, batcher=jbatcher, router=jrouter,
        fleet=jfleet, metrics=jmetrics, interleave=jinterleave,
        doorder=jdoorder, Order=JOrder, Side=JSide, Action=JAction),
    "t": types.SimpleNamespace(
        admission=tadmission, batcher=tbatcher, router=trouter,
        fleet=tfleet, metrics=tmetrics, interleave=tinterleave,
        doorder=tdoorder, Order=TOrder, Side=TSide, Action=TAction),
}


def both(fn):
    """fn(package) on each package: (the port's result, gome_tpu's)."""
    return fn(PKG["t"]), fn(PKG["j"])


def load_reference_fleet_chaos():
    """scripts/fleet_chaos.py of the reference, loaded from its file (it
    puts scripts/ on sys.path for its own chaos and fleet_drill)."""
    spec = importlib.util.spec_from_file_location(
        "reference_fleet_chaos", os.path.join(REPO, "scripts",
                                              "fleet_chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- AdmissionController -----------------------------------------------------


def admission(p, depth, **kw):
    kw.setdefault("cache_s", 0.0)  # sample depth_fn on every admit
    kw.setdefault("registry", p.metrics.Registry())
    return p.admission.AdmissionController(depth, **kw)


def decision(d) -> tuple:
    return (d.ok, d.reason, d.depth, d.retry_after_s,
            None if d.ok else d.message())


def test_admission_admits_below_ceiling():
    def run(p):
        a = admission(p, lambda: 10, max_depth=100)
        return decision(a.admit(5)), decision(a.admit(90))

    got, want = both(run)
    assert got == want
    assert got[0][0] and got[0][2] == 10 and got[1][0]


def test_admission_sheds_on_depth_with_scaled_hint():
    def run(p):
        a = admission(p, lambda: 200, max_depth=100, retry_after_s=0.05,
                      retry_after_max_s=2.0)
        d = a.admit(1)
        m = p.doorder.RETRY_AFTER_RE.search(d.message())
        return decision(d), float(m.group(1))

    got, want = both(run)
    assert got == want
    (ok, reason, depth, hint, msg), parsed = got
    assert not ok and reason == "depth" and depth == 200
    assert hint == pytest.approx(0.05 * 201 / 100)
    assert parsed == pytest.approx(hint, abs=1e-3)
    assert "queue depth 200" in msg


def test_admission_hint_clamps_to_max():
    def run(p):
        a = admission(p, lambda: 10_000_000, max_depth=100,
                      retry_after_s=0.05, retry_after_max_s=2.0)
        b = admission(p, lambda: 0, max_depth=100, retry_after_s=0.05)
        return a.admit(1).retry_after_s, b._hint(0)

    got, want = both(run)
    assert got == want == (2.0, 0.05)


def test_admission_sheds_on_tight_deadline_first():
    def run(p):
        a = admission(p, lambda: 0, max_depth=100, min_deadline_s=0.5)
        return [decision(a.admit(1, time_remaining_s=t))
                for t in (0.1, 0.5, None)]

    got, want = both(run)
    assert got == want
    assert not got[0][0] and got[0][1] == "deadline"
    assert "deadline too tight" in got[0][4]
    assert got[1][0] and got[2][0]


def test_admission_counters_and_validation():
    def run(p):
        reg = p.metrics.Registry()
        a = p.admission.AdmissionController(lambda: 101, max_depth=100,
                                            cache_s=0.0, registry=reg)
        a.admit(3)
        a.admit(2, time_remaining_s=-1.0)
        text = reg.render()
        errors = []
        for kw in ({"max_depth": 0},
                   {"retry_after_s": 0.5, "retry_after_max_s": 0.1}):
            with pytest.raises(ValueError) as e:
                admission(p, lambda: 0, **kw)
            errors.append(str(e.value))
        return sorted(ln for ln in text.splitlines()
                      if ln.startswith("gome_gateway_")), errors

    got, want = both(run)
    assert got == want
    text = "\n".join(got[0])
    assert 'gome_gateway_shed_total{reason="depth"} 3' in text
    assert 'gome_gateway_shed_total{reason="deadline"} 2' in text
    assert "gome_gateway_admission_depth 101" in text


def test_admission_depth_cache_window():
    def run(p):
        calls = []

        def depth():
            calls.append(1)
            return 0

        a = p.admission.AdmissionController(
            depth, max_depth=100, cache_s=60.0,
            registry=p.metrics.Registry())
        return [a.admit(1).ok for _ in range(5)], len(calls)

    got, want = both(run)
    assert got == want == ([True] * 5, 1)


# -- FrameBatcher adaptive sizing --------------------------------------------


class Sink:
    def __init__(self):
        self.frames: list[bytes] = []

    def publish(self, data, headers=None):
        self.frames.append(data)
        return len(self.frames)


def order(p, i):
    return p.Order(uuid="u", oid=f"o{i}", symbol="btc2usdt",
                   side=p.Side.BUY, price=100 + i, volume=5,
                   action=p.Action.ADD)


def adaptive(p, depth_fn, **kw):
    kw.setdefault("max_n", 100)
    kw.setdefault("min_n", 10)
    kw.setdefault("depth_low", 100)
    kw.setdefault("depth_high", 1100)
    kw.setdefault("resize_interval_s", 0.0)  # resample every call
    kw.setdefault("max_wait_s", 60.0)
    return p.batcher.FrameBatcher(Sink(), depth_fn=depth_fn, **kw)


def test_adaptive_bound_interpolates_and_clamps():
    def run(p):
        depth = [0]
        b = adaptive(p, lambda: depth[0])
        try:
            bounds = []
            for d in (0, 100, 600, 1100, 10**9, -50):
                depth[0] = d
                bounds.append(b.effective_max_n())
            st = b.stats()
            return bounds, st["adaptive"], st["effective_max_n"]
        finally:
            b.close()

    got, want = both(run)
    assert got == want == ([10, 10, 55, 100, 100, 10], True, 10)


def test_adaptive_depth_fn_failure_falls_back_to_max_n():
    def run(p):
        def boom():
            raise RuntimeError("bus gone")

        b = adaptive(p, boom)
        try:
            return b.effective_max_n()
        finally:
            b.close()

    got, want = both(run)
    assert got == want == 100


def test_adaptive_flushes_at_effective_bound():
    def run(p):
        depth = [0]
        b = adaptive(p, lambda: depth[0], max_n=8, min_n=2, depth_low=10,
                     depth_high=20)
        counts = []
        try:
            for i in range(4):
                b.submit(order(p, i))
            counts.append(len(b.queue.frames))
            depth[0] = 1000
            for i in range(4, 10):
                b.submit(order(p, i))
            counts.append(len(b.queue.frames))
            b.submit(order(p, 10))
            b.submit(order(p, 11))
            counts.append(len(b.queue.frames))
            return counts, list(b.queue.frames)
        finally:
            b.close()

    got, want = both(run)
    assert got == want
    assert got[0] == [2, 2, 3]


def test_adaptive_validation_and_fixed_mode():
    def run(p):
        errors = []
        for kw in ({"min_n": 0}, {"min_n": 101, "max_n": 100},
                   {"depth_low": 5, "depth_high": 5}):
            with pytest.raises(ValueError) as e:
                adaptive(p, lambda: 0, **kw)
            errors.append(str(e.value))
        b = p.batcher.FrameBatcher(Sink(), max_n=7, min_n=3, max_wait_s=60.0)
        try:
            return errors, b.effective_max_n(), b.stats()["adaptive"]
        finally:
            b.close()

    got, want = both(run)
    assert got == want
    assert got[1:] == (7, False)
    assert "1 <= min_n <= max_n" in got[0][0]
    assert "depth_low < depth_high" in got[0][2]


# -- FailoverController under the interleaver --------------------------------


def dead_fleet(p):
    pmap = p.router.PartitionMap.even(2, ["m0", "m1"])
    gate = p.router.HealthGate()
    gate.mark_down("m0")
    return pmap, gate


def test_failover_protocol_matches():
    """The reference's four protocol cases in sequence: the claim is
    exclusive and gated, a commit voids when the epoch moves under it, the
    full protocol reassigns after recovery, a failed recovery releases
    the claim."""
    def run(p):
        log = []
        pmap, gate = dead_fleet(p)
        fc = p.router.FailoverController(pmap, gate)
        c = fc.claim("m0", "s0")
        log += [fc.claim("m1", "s0"), c.partitions, fc.claim("m0", "s1")]
        fc.release("m0", "s1")
        log.append(fc.claim("m0", "s1"))
        fc.release("m0", "s0")
        log.append(fc.claim("m0", "s1") is not None)

        pmap, gate = dead_fleet(p)
        fc = p.router.FailoverController(pmap, gate)
        fc.claim("m0", "s0")
        pmap.reassign([0], "rebalanced")
        log += [fc.commit("m0", "s0"), pmap.owner(0), fc.history()]

        pmap, gate = dead_fleet(p)
        fc = p.router.FailoverController(pmap, gate)
        seen = []
        log += [fc.failover("m0", "s0", lambda d, ps: seen.append((d, ps))),
                seen, pmap.owner(0), fc.history(),
                fc.failover("m0", "s1", lambda d, ps: None)]

        pmap, gate = dead_fleet(p)
        fc = p.router.FailoverController(pmap, gate)

        def bad(dead, parts):
            raise RuntimeError("snapshot restore failed")

        with pytest.raises(RuntimeError, match="restore failed"):
            fc.failover("m0", "s0", bad)
        log += [pmap.owner(0), pmap.epoch,
                fc.failover("m0", "s1", lambda d, ps: None), pmap.owner(0)]
        return log

    got, want = both(run)
    assert got == want
    assert got[0] is None and got[1] == (0,) and got[2] is None
    assert got[3] is None and got[4] is True
    assert got[5:8] == [None, "rebalanced", []]
    assert got[8] == 1 and got[9] == [("m0", (0,))] and got[10] == "s0"
    assert got[12] is None and got[13:] == ["m0", 0, 1, "s1"]


def race_failover(p, seed: int):
    """Two standbys race claim/recover/commit for the same dead member
    under one seeded schedule; recovery replays a fake WAL above the
    exactly-once cursor and yields mid-recovery."""
    pmap = p.router.PartitionMap.even(2, ["m0", "m1"])
    gate = p.router.HealthGate()
    gate.mark_down("m0")
    it = p.interleave.Interleaver(seed=seed, timeout_s=30.0)
    fc = p.router.FailoverController(
        pmap, gate, lock=p.interleave.SteppingLock(it.step))
    wal = [(s, f"order{s}") for s in range(1, 9)]
    cursor = 3
    replayed: dict[str, list[int]] = {}

    def contender(name):
        def recover(dead, parts):
            out = replayed.setdefault(name, [])
            for s, _ in wal:
                it.step()
                if s <= cursor:
                    continue
                out.append(s)

        def fn(step):
            step()
            return fc.failover("m0", name, recover)

        return fn

    it.run(contender("s0"), contender("s1"))
    assert it.errors == [None, None]
    return (list(it.results), fc.history(), replayed, pmap.snapshot(),
            list(it.trace))


@pytest.mark.parametrize("seed", range(8))
def test_interleaved_failover_exactly_one_winner(seed):
    got, want = both(lambda p: race_failover(p, seed))
    assert got == want  # the same schedule, winner and replay
    results, history, replayed, snap, _ = got
    winners = [r for r in results if r is not None]
    assert winners == [1]
    (h,) = history
    assert list(replayed) == [h["standby"]]
    assert replayed[h["standby"]] == [4, 5, 6, 7, 8]
    assert snap["assignments"] == {"0": h["standby"], "1": "m1"}


def test_interleaved_failover_replay_identical_across_schedules():
    def run(p):
        replays = set()
        for seed in range(12):
            _, history, replayed, _, _ = race_failover(p, seed)
            (h,) = history
            replays.add(tuple(replayed[h["standby"]]))
        return replays

    got, want = both(run)
    assert got == want == {(4, 5, 6, 7, 8)}


# -- fleet aggregator liveness -----------------------------------------------


def scripted_fetch(down: set):
    def fetch(url, timeout_s):
        proc, _, path = url.partition("://")[2].partition("/")
        if proc in down:
            raise ConnectionError("connection refused")
        path = "/" + path
        if path == "/healthz":
            return json.dumps({"healthy": True, "detail": {}})
        if path == "/metrics":
            return "# empty\n"
        if path == "/durability":
            return json.dumps({"matchfeed": {
                "last_seq": 1, "observed": 2, "dupes": 0, "gaps": 0}})
        if path.startswith("/timeline"):
            return json.dumps({"samples": []})
        if path.startswith("/placement"):
            return json.dumps({"enabled": False})
        raise AssertionError(url)

    return fetch


def test_aggregator_staleness_and_member_up():
    """tests/test_fleet_chaos.py's liveness sequence (never scraped, up,
    b unreachable, b stale, b back) through both aggregators: the same
    ages, member_up answers, payload members and member_up gauges."""
    def run(p):
        now = [100.0]
        down: set = set()
        reg = p.metrics.Registry()
        agg = p.fleet.FleetAggregator()
        agg.install({"a": "inproc://a", "b": "inproc://b"}, interval_s=1.0,
                    stale_after_s=5.0, clock=lambda: now[0],
                    fetch=scripted_fetch(down), registry=reg)
        log = [(agg.poll_age_s("a"), agg.member_up("a"))]
        try:
            for step, dt in (("up", 0.0), ("b down", 3.0),
                             ("b stale", 3.0), ("b back", 1.0)):
                if step == "b down":
                    down.add("b")
                if step == "b back":
                    down.discard("b")
                now[0] += dt
                agg.poll()
                payload = agg.payload()
                log.append((
                    step, agg.poll_age_s("a"), agg.poll_age_s("b"),
                    agg.member_up("a"), agg.member_up("b"),
                    payload["unreachable"], payload["stale_after_s"],
                    {m: (v["up"], v["stale"], v["poll_age_s"],
                         v["error"] is not None)
                     for m, v in payload["members"].items()},
                    sorted(ln for ln in reg.render().splitlines()
                           if ln.startswith("gome_fleet_member_up"))))
        finally:
            agg.disable()
        return log

    got, want = both(run)
    assert got == want
    assert got[0] == (None, False)
    assert got[2][5] == ["b"] and got[2][2] == 3.0
    assert got[3][7]["b"][1] is True and got[3][2] == 6.0
    assert got[4][4] is True and got[4][5] == []


# -- the drill's pure parts --------------------------------------------------


def test_rotation_and_plans_match_the_reference():
    ref = load_reference_fleet_chaos()
    assert fleet_chaos.CLASSES == ref.CLASSES
    for name in ("PACE_S", "HIT_K", "EVERY_N", "SNAP_KEEP", "DRIVE_CHUNK",
                 "CODE_RETRYABLE", "SCHEMA"):
        assert getattr(fleet_chaos, name) == getattr(ref, name), name
    for seed in (17, 5):
        for cycle in range(1, 10):
            klass, part = fleet_chaos.class_for_cycle(cycle)
            assert (klass, part) == ref.class_for_cycle(cycle)
            assert fleet_chaos.plan_for_cycle(cycle, seed, klass).to_json() \
                == ref.plan_for_cycle(cycle, seed, klass).to_json()
    assert {fleet_chaos.class_for_cycle(c)[0] for c in (1, 2, 3)} == \
        set(fleet_chaos.CLASSES)
    # A chunk is a step's bins over every lane, as the reference's 16 x 8,
    # and one fleet_drill request at most at the card's 10,240 x 1,024.
    assert fleet_chaos.drive_chunk(fleet_chaos.chaos.N_LANES,
                                   fleet_chaos.chaos.T_BINS) == \
        ref.DRIVE_CHUNK
    assert fleet_chaos.drive_chunk(10_240, 1024) == 1024


def test_ns_requests_match_the_reference():
    """One round of recorded requests re-keyed under a namespace: the same
    OrderRequest bytes and cancel flags in both packages."""
    ref = load_reference_fleet_chaos()
    from gome_tpu.api import order_pb2 as jpb
    from gome_tpu_torch.api import order_pb2 as tpb

    def base(pb):
        return [(i % 3 == 2, pb.OrderRequest(
            uuid=f"u{i % 4}", oid=f"o{i}", symbol=f"s{i % 5}",
            transaction=i % 2, price=float(100 + i), volume=float(1 + i),
            kind=0)) for i in range(12)]

    got = fleet_chaos._ns_requests(base(tpb), "c2.r1")
    want = ref._ns_requests(base(jpb), "c2.r1")
    assert [(c, r.SerializeToString()) for c, r in got] == \
        [(c, r.SerializeToString()) for c, r in want]
    assert got[0][1].oid == "c2.r1.o0"


def test_window_rate_matches_the_reference():
    ref = load_reference_fleet_chaos()
    samples = {0: [(1.0, 100), (2.0, 250), (3.5, 400), (5.0, 420)],
               1: [(0.5, 10), (2.5, 90), (4.0, 300)]}
    out = []
    for mod in (fleet_chaos, ref):
        ctl = mod.DriveCtl()
        for p, s in samples.items():
            ctl.samples[p] = list(s)
        out.append([mod.window_rate(ctl, t0, t1) for t0, t1 in
                    ((0.0, 6.0), (1.5, 3.6), (2.0, 2.0), (4.5, 9.0))])
    assert out[0] == out[1]
    assert out[0][0]["orders"] == 720


@pytest.mark.parametrize("writer", ["t", "j"])
def test_log_end_and_committed_on_either_package_bus(tmp_path, writer):
    """log_end and committed read a file bus written by either package,
    the same as the reference's readers, a torn tail record left out."""
    ref = load_reference_fleet_chaos()
    filelog = (__import__("gome_tpu_torch.bus.filelog",
                          fromlist=["FileQueue"]) if writer == "t"
               else __import__("gome_tpu.bus.filelog",
                               fromlist=["FileQueue"]))
    bus = tmp_path / "bus"
    bus.mkdir()
    q = filelog.FileQueue("doOrder", str(bus / "doOrder"))
    for i in range(7):
        q.publish(bytes([i]) * (i + 3))
    q.commit(5)
    q.close()
    reads = []
    for mod in (fleet_chaos, ref):
        reads.append((mod.log_end(str(bus)), mod.committed(str(bus))))
    with open(bus / "doOrder.log", "ab") as f:
        f.write((40).to_bytes(4, "big") + b"half")  # a live writer's tail
    for mod in (fleet_chaos, ref):
        reads.append((mod.log_end(str(bus)), mod.committed(str(bus))))
    assert reads == [(7, 5)] * 4
    assert (fleet_chaos.log_end(str(tmp_path / "none")),
            fleet_chaos.committed(str(tmp_path / "none"))) == (0, 0)


def test_drive_ctl_parks_and_acks():
    """The pause and idle handshake: a parked driver acks idle between
    chunks and sends nothing until released."""
    from gome_tpu_torch.api import order_pb2 as pb

    ctl = fleet_chaos.DriveCtl(drive_chunk=2)
    sent = []
    fleet_chaos_send = fleet_chaos._send_chunk
    try:
        fleet_chaos._send_chunk = lambda c, p, chunk: sent.append(len(chunk))
        ctl.pause[0].set()
        done = threading.Event()
        t = threading.Thread(target=fleet_chaos._drive_partition,
                             args=(ctl, 0, [(False, pb.OrderRequest())] * 4,
                                   "x", done, 1))
        t.start()
        assert ctl.idle[0].wait(5.0)
        assert sent == []
        ctl.pause[0].clear()
        done.set()
        t.join(10.0)
    finally:
        fleet_chaos._send_chunk = fleet_chaos_send
    assert sent == [2, 2]


#: A stand-in member for fleet_drill's launcher: READY with two ports,
#: then its result JSON to --out once a stop line arrives.
FAKE_MEMBER = """
import json, sys
args = sys.argv[1:]
out = args[args.index("--out") + 1]
part = int(args[args.index("--partition") + 1])
print(f"READY ops={7000 + part} grpc={8000 + part}", flush=True)
sys.stdin.readline()
with open(out, "w") as f:
    json.dump({"role": args[0], "partition": part}, f)
"""


def test_one_launcher_starts_and_stops_members(tmp_path):
    """fleet_drill's members, its marker server and fleet_chaos's Fleet go
    through one launcher (Worker): every member READY with its ports,
    stopped by a line on stdin, its result and exit code read back; the
    marker server answers on the port it announced."""
    import sys

    from gome_tpu_torch.persist.resp import RespClient
    from gome_tpu_torch.scripts import fleet_drill

    procs = {}
    try:
        port = fleet_drill.start_respserver(procs)
        assert isinstance(procs["respserver"], fleet_drill.Worker)
        client = RespClient(port=port)
        client.execute_command("HSET", "h", "k", "v")
        assert client.execute_command("HGET", "h", "k") in ("v", b"v")
        ports = fleet_drill.fleet_members(
            str(tmp_path), port, 16, "cpu", procs,
            launcher=lambda role: [sys.executable, "-c", FAKE_MEMBER, role])
    finally:
        results = fleet_drill.stop_members(procs, str(tmp_path))
    assert ports == {"c0": (7000, 8000), "gw0": (7000, 8000),
                     "c1": (7001, 8001), "gw1": (7001, 8001)}
    assert results == {
        name: {"role": role, "partition": p, "exit_code": 0}
        for p in range(2)
        for name, role in ((f"c{p}", "consumer"), (f"gw{p}", "gateway"))}
    assert procs["respserver"].proc.poll() is not None


def test_fleet_chaos_cuda_verdict_pinned_green():
    """FLEET_CHAOS_CUDA_r01.json, the fleet chaos drill on the H100 at
    10,240 lanes over 2 partitions: one cycle of each class, every check
    true, each partition's book equal to its oracle's, exactly once.
    Regenerate it with the driver; a red verdict is never committed."""
    from test_torch_chaos import check_provenance

    with open(os.path.join(REPO, "FLEET_CHAOS_CUDA_r01.json")) as f:
        doc = json.load(f)
    assert doc["schema"] == "gome-fleet-chaos-verdict-v1"
    assert doc["pass"] is True and len(doc["checks"]) == 14
    assert all(doc["checks"].values()), doc["checks"]
    check_provenance(doc)
    assert doc["config"]["engine"]["n_slots"] == 10_240
    assert doc["config"]["partitions"] == 2
    # The reference's own step count from the recorded --seconds.
    assert doc["config"]["n_steps"] == max(
        32, min(480, doc["config"]["seconds"] * 8))
    cycles = doc["cycles"]
    assert len(cycles) == doc["config"]["kills"] == 3
    assert [c["class"] for c in cycles] == list(fleet_chaos.CLASSES)
    for part in doc["partitions"]:
        assert part["seq_audit"]["dupes"] == 0
        assert part["seq_audit"]["gaps"] == 0
        assert part["book_digest"] == part["oracle_digest"]
        assert part["match_stream_identical"] is True
    kills = [c for c in cycles if c["class"] != "bus-disconnect"]
    assert len(doc["recovery"]["samples_s"]) == len(kills) == 2
    assert doc["recovery"]["p99_s"] <= doc["config"]["recovery_bound_s"]
    for w in doc["throughput"]["degraded_windows"].values():
        assert w["orders_per_s"] >= doc["throughput"]["floor_orders_per_s"]
    assert len(doc["router"]["failovers"]) == 1
