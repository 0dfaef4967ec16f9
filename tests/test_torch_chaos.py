"""The port's crash-consistency pieces and its chaos drill
(gome_tpu_torch/utils/faults.py, the file queue's torn-write hardening,
the seq wire, SeqTracker and the feed's suppression, the faults: config,
gome_tpu_torch/scripts/chaos.py) against gome_tpu's: tests/test_chaos.py's
cases run on both packages with their results compared exactly (those
test_torch_persist.py, test_torch_bus.py and test_torch_amqp.py already
twin are left to them), the kill rotation against scripts/chaos.py's,
the worker on the reference's own recorded frames, and the port's parent
at the reference's geometry. The committed card verdict
(CHAOS_CUDA_r01.json) is pinned at the end."""

import importlib.util
import json
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest

import gome_tpu.bus as jbus
import gome_tpu.bus.colwire as jcolwire
import gome_tpu.bus.filelog as jfilelog
import gome_tpu.config as jconfig
import gome_tpu.service as jservice
import gome_tpu.service.matchfeed as jmatchfeed
import gome_tpu.utils.faults as jfaults
import gome_tpu_torch.bus as tbus
import gome_tpu_torch.bus.colwire as tcolwire
import gome_tpu_torch.bus.filelog as tfilelog
import gome_tpu_torch.config as tconfig
import gome_tpu_torch.service as tservice
import gome_tpu_torch.service.matchfeed as tmatchfeed
import gome_tpu_torch.utils.faults as tfaults
from gome_tpu.engine import BookConfig as JBookConfig
from gome_tpu.engine import MatchEngine as JMatchEngine
from gome_tpu.types import Action as JAction
from gome_tpu.types import Order as JOrder
from gome_tpu.types import Side as JSide
from gome_tpu.utils.streams import mixed_stream as jmixed
from gome_tpu_torch.engine import BookConfig as TBookConfig
from gome_tpu_torch.engine import MatchEngine as TMatchEngine
from gome_tpu_torch.scripts import chaos
from gome_tpu_torch.types import Action as TAction
from gome_tpu_torch.types import Order as TOrder
from gome_tpu_torch.types import Side as TSide
from gome_tpu_torch.utils.streams import mixed_stream as tmixed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKG = {
    "j": types.SimpleNamespace(
        faults=jfaults, filelog=jfilelog, colwire=jcolwire, bus=jbus,
        config=jconfig, service=jservice, matchfeed=jmatchfeed,
        Order=JOrder, Side=JSide, Action=JAction, mixed=jmixed,
        engine=lambda **kw: JMatchEngine(config=JBookConfig(cap=8,
                                                            max_fills=4),
                                         **kw),
        svc=lambda cfg: jservice.EngineService(cfg)),
    "t": types.SimpleNamespace(
        faults=tfaults, filelog=tfilelog, colwire=tcolwire, bus=tbus,
        config=tconfig, service=tservice, matchfeed=tmatchfeed,
        Order=TOrder, Side=TSide, Action=TAction, mixed=tmixed,
        engine=lambda **kw: TMatchEngine(TBookConfig(cap=8, max_fills=4),
                                         device="cpu", **kw),
        svc=lambda cfg: tservice.EngineService(cfg, device="cpu")),
}


def both(fn):
    """fn(package) on each package: (the port's result, gome_tpu's)."""
    return fn(PKG["t"]), fn(PKG["j"])


@pytest.fixture(autouse=True)
def _disarm_faults():
    """Neither FAULTS singleton may leak an armed plan across tests."""
    yield
    jfaults.FAULTS.disable()
    tfaults.FAULTS.disable()


def load_reference_chaos():
    """scripts/chaos.py of the reference, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "reference_chaos", os.path.join(REPO, "scripts", "chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- fault registry ----------------------------------------------------------


@pytest.mark.parametrize("side", ["t", "j"])
def test_disabled_fire_is_zero_alloc(side):
    """The disabled hot path is one attribute check, zero allocations, in
    both packages."""
    r = PKG[side].faults.FaultRegistry()  # never installed
    assert not r.enabled

    def drill(n):
        i = 0
        while i < n:
            if r.fire("consumer.frame") != 0:
                raise AssertionError("unreachable")
            i += 1

    drill(64)  # warm lazy caches
    before = sys.getallocatedblocks()
    drill(200)
    after = sys.getallocatedblocks()
    assert after - before <= 2, f"disabled fire() allocated {after - before}"


def test_fault_spec_validation():
    def errors(p):
        out = []
        for kw in ({"point": "p", "mode": "explode"},
                   {"point": "p", "mode": "call"},
                   {"point": ""}):
            with pytest.raises(ValueError) as e:
                p.faults.FaultSpec(**kw)
            out.append(str(e.value))
        return out

    got, want = both(errors)
    assert got == want and len(got) == 3


def test_fault_plan_json_roundtrip():
    def plan(p):
        f = p.faults
        return f.FaultPlan(seed=42, faults=(
            f.FaultSpec("consumer.commit", mode="exit", at=(1, 5)),
            f.FaultSpec("filelog.offset", mode="torn", every=3, times=2),
            f.FaultSpec("bus.step", mode="call", prob=0.5,
                        handler="broker.kill"),
        ))

    got, want = both(plan)
    assert got.to_json() == want.to_json()
    assert tfaults.FaultPlan.from_json(got.to_json()) == got
    # Either package reads the other's plan.
    assert tfaults.FaultPlan.from_json(want.to_json()) == got
    assert jfaults.FaultPlan.from_json(got.to_json()) == want


def test_trigger_semantics_at_every_times():
    def run(p):
        f = p.faults
        r = f.FaultRegistry()
        r.install(f.FaultPlan(seed=1, faults=(
            f.FaultSpec("a", mode="raise", at=(3,)),
            f.FaultSpec("b", mode="raise", every=2, times=2),
        )))
        fired = []
        for point in ["a"] * 4 + ["b"] * 6:
            try:
                fired.append(r.fire(point))
            except f.FaultInjected:
                fired.append("raised")
        return fired, r.report()

    (got, got_report), (want, want_report) = both(run)
    assert got == want == [0, 0, "raised", 0, 0, "raised", 0, "raised", 0, 0]
    assert got_report == want_report
    assert got_report["hits"] == {"a": 4, "b": 6}
    assert [f["hit"] for f in got_report["fired"]
            if f["point"] == "b"] == [2, 4]


def test_exit_mode_uses_injected_exit():
    def run(p):
        f = p.faults
        r = f.FaultRegistry()
        died = []
        r._exit = died.append
        r.install(f.FaultPlan(faults=(f.FaultSpec("x", mode="exit",
                                                  at=(1,)),)))
        r.fire("x")
        r.hard_exit()
        return died, f.EXIT_CODE

    got, want = both(run)
    assert got == want == ([86, 86], 86)


def test_torn_cuts_deterministic_across_installs():
    def cuts(p, seed=7):
        f = p.faults
        plan = f.FaultPlan(seed=seed, faults=(
            f.FaultSpec("filelog.append", mode="torn", every=1),))
        r = f.FaultRegistry()
        r.install(plan)
        return [r.fire("filelog.append") for _ in range(8)]

    got, want = both(cuts)
    assert got == want == cuts(PKG["t"])  # seeded per spec, process-stable
    assert all(c > 0 for c in got)
    assert cuts(PKG["t"], seed=8) == cuts(PKG["j"], seed=8) != got


def test_call_mode_resp_restart_handler():
    """A counted fault point restarts the RESP store on schedule and the
    supervised client recovers, in both packages."""
    def run(p):
        name = "gome_tpu_torch" if p is PKG["t"] else "gome_tpu"
        resp = importlib.import_module(f"{name}.persist.resp")
        server = importlib.import_module(f"{name}.persist.respserver")
        FAULTS = p.faults.FAULTS
        with server.FakeRedisServer() as srv:
            client = resp.SupervisedRespClient("127.0.0.1", srv.port,
                                               name="t:chaos")
            ok = [client.ping()]
            restarts = []
            FAULTS.handler("resp.restart",
                           lambda: restarts.append(srv.restart()))
            FAULTS.install(p.faults.FaultPlan(faults=(
                p.faults.FaultSpec("store.op", mode="call", at=(2,),
                                   handler="resp.restart"),)))
            fired = [FAULTS.fire("store.op"), FAULTS.fire("store.op")]
            ok.append(client.ping())  # the session survived the restart
            report = FAULTS.report()
            client.close()
            FAULTS.disable()
        return ok, fired, len(restarts), report["fired"]

    got, want = both(run)
    assert got == want
    assert got[0] == [True, True] and got[1] == [0, 0] and got[2] == 1


# -- torn-write hardening (FileQueue) ----------------------------------------


def test_filequeue_recovers_from_random_torn_tail_and_sidecar(tmp_path):
    """Random truncation of the log tail and the offset sidecar recovers to
    the same consistent prefix in both packages, and each package's queue
    reopens the other's files to the same state."""
    def trials(p, root):
        rng = random.Random(11)
        out = []
        for trial in range(25):
            base = str(root / f"q{trial}" / "doOrder")
            q = p.filelog.FileQueue("doOrder", base)
            bodies = [bytes([trial % 251, i]) * (1 + rng.randrange(40))
                      for i in range(12)]
            for b in bodies:
                q.publish(b)
            q.commit(rng.randrange(len(bodies) + 1))
            q.close()
            log_path = base + ".log"
            with open(log_path, "rb+") as f:
                f.truncate(rng.randrange(os.path.getsize(log_path) + 1))
            off_path = base + ".offset"
            with open(off_path, "rb") as f:
                side = f.read()
            with open(off_path, "wb") as f:
                f.write(side[: rng.randrange(len(side) + 1)])
            q2 = p.filelog.FileQueue("doOrder", base)
            end, committed = q2.end_offset(), q2.committed()
            assert 0 <= committed <= end <= len(bodies)
            read = [m.body for m in q2.read_from(0, end)]
            assert read == bodies[:end]
            q2.publish(b"post-recovery")
            read.append(q2.read_from(end, 1)[0].body)
            q2.close()
            out.append((end, committed, read))
        return out

    got = trials(PKG["t"], tmp_path / "t")
    want = trials(PKG["j"], tmp_path / "j")
    assert got == want
    # Cross-open: each package's recovered files reopen alike in either
    # package's queue.
    for trial in range(len(want)):
        states = []
        for side in ("t", "j"):
            for p in (PKG["t"], PKG["j"]):
                q = p.filelog.FileQueue(
                    "doOrder", str(tmp_path / side / f"q{trial}" / "doOrder"))
                states.append((q.end_offset(), q.committed(),
                               [m.body for m in
                                q.read_from(0, q.end_offset())]))
                q.close()
        assert all(st == states[0] for st in states), trial
        assert states[0][2] == want[trial][2]


def test_sidecar_garbage_and_overrun_clamped(tmp_path):
    def run(p, root):
        base = str(root / "doOrder")
        q = p.filelog.FileQueue("doOrder", base)
        q.publish(b"one")
        q.publish(b"two")
        q.commit(2)
        q.close()
        out = []
        with open(base + ".offset", "w") as f:
            f.write("not-a-number")  # garbage -> full replay from 0
        q2 = p.filelog.FileQueue("doOrder", base)
        out.append((q2.committed(), q2.end_offset()))
        q2.close()
        with open(base + ".offset", "w") as f:
            f.write("999")  # ahead of the log -> clamped to its end
        q3 = p.filelog.FileQueue("doOrder", base)
        out.append((q3.committed(), q3.end_offset()))
        q3.close()
        return out

    got, want = run(PKG["t"], tmp_path / "t"), run(PKG["j"], tmp_path / "j")
    assert got == want == [(0, 2), (2, 2)]


# -- seq wire format ---------------------------------------------------------


def crossing_batch(p):
    eng = p.engine(n_slots=4, max_t=4)
    o = p.Order
    orders = [
        o(uuid="u1", oid="a", symbol="s0", side=p.Side.BUY, price=100,
          volume=5),
        o(uuid="u2", oid="b", symbol="s0", side=p.Side.SALE, price=100,
          volume=3),
        o(uuid="u1", oid="a", symbol="s0", side=p.Side.BUY, price=100,
          volume=0, action=p.Action.DEL),
    ]
    for order in orders:
        eng.mark(order)
    return eng.process_columnar(orders)


def test_gce2_roundtrip_and_gce1_compat():
    def run(p):
        cw = p.colwire
        batch = crossing_batch(p)
        stamped = cw.encode_event_frame(batch, seq0=7)
        plain = cw.encode_event_frame(batch)
        out, unstamped = cw.decode_event_frame(stamped), \
            cw.decode_event_frame(plain)
        assert stamped[:4] == cw.EVENT_MAGIC_SEQ
        assert plain[:4] == cw.EVENT_MAGIC
        assert out.seq0 == 7 and unstamped.seq0 is None
        assert [r.seq for r in out.to_results()] == list(
            range(7, 7 + len(batch)))
        assert all(r.seq is None for r in unstamped.to_results())
        # seq is metadata, not identity
        assert unstamped.to_results() == out.to_results()
        return (len(batch), stamped, plain, out.to_json_lines(),
                unstamped.to_json_lines())

    got, want = both(run)
    assert got == want
    assert got[0] >= 2  # a fill and a cancel
    assert all(b'"Seq":' in ln for ln in got[3])
    assert all(b'"Seq"' not in ln for ln in got[4])
    # Each package decodes the other's stamped frame to the same lines.
    assert tcolwire.decode_event_frame(want[1]).to_json_lines() == want[3]
    assert jcolwire.decode_event_frame(got[1]).to_json_lines() == got[3]


def test_json_wire_carries_trailing_seq():
    def run(p):
        batch = crossing_batch(p)
        lines = batch.to_json_lines(seq0=3)
        seqs = [p.bus.decode_match_result(ln).seq for ln in lines]
        return lines, seqs, batch.to_json_lines()

    got, want = both(run)
    assert got == want
    lines, seqs, plain = got
    assert seqs == [3 + i for i in range(len(lines))]
    assert [json.loads(ln)["Seq"] for ln in lines] == seqs
    assert all(b'"Seq"' not in ln for ln in plain)


# -- SeqTracker / feed suppression -------------------------------------------


def test_seq_tracker_semantics():
    def run(p):
        t = p.matchfeed.SeqTracker()  # mid-stream attach
        seen = [t.observe(s) for s in (5, 6, 6, 2, 9)]
        t0 = p.matchfeed.SeqTracker(first_seq=0)  # anchored audit
        return seen, t.state(), t0.observe(1), t0.gaps, t0.state()

    got, want = both(run)
    assert got == want
    assert got[0] == [True, True, False, False, True]
    assert got[1] == {"last_seq": 9, "observed": 5, "dupes": 2, "gaps": 2}
    assert got[2] is True and got[3] == 1


def test_feed_suppresses_replayed_seqs():
    """A queue-level duplicate (the at-least-once replay window) carries
    the same seqs; the feed suppresses it before fan-out, alike."""
    def run(p):
        c = p.config
        svc = p.svc(c.Config(bus=c.BusConfig(match_wire="frame"),
                             engine=c.EngineConfig(cap=16, n_slots=4,
                                                   max_t=4)))
        batch = crossing_batch(p)
        frame = p.colwire.encode_event_frame(batch, seq0=0)
        svc.bus.match_queue.publish(frame)
        svc.bus.match_queue.publish(frame)  # replayed duplicate
        svc.feed.drain()
        return (len(batch), svc.feed.events_seen, svc.feed.suppressed,
                svc.feed.seq_state())

    got, want = both(run)
    assert got == want
    n = got[0]
    assert got[1:3] == (n, n)
    assert got[3]["dupes"] == n and got[3]["gaps"] == 0


def test_failed_step_replays_with_identical_seqs(tmp_path):
    """A raise-mode fault in the at-least-once window (after publish,
    before commit): the replay regenerates the SAME seqs, and the feed
    suppresses the duplicate — the same stream in both packages."""
    def run(p, root):
        c = p.config
        svc = p.svc(c.Config(
            bus=c.BusConfig(backend="file", dir=str(root / "bus"),
                            match_wire="frame"),
            engine=c.EngineConfig(cap=32, n_slots=8, max_t=8)))
        for o in p.mixed(n=40, seed=13, cancel_prob=0.25):
            svc.engine.mark(o)
            svc.bus.order_queue.publish(p.bus.encode_order(o))
        p.faults.FAULTS.install(p.faults.FaultPlan(faults=(
            p.faults.FaultSpec("consumer.commit", mode="raise", at=(1,)),)))
        failed = svc.consumer.step_with_policy()
        rolled_back = svc.consumer.match_seq
        p.faults.FAULTS.disable()
        svc.consumer.drain()
        mq = svc.bus.match_queue
        seqs, lines = [], []
        for m in mq.read_from(0, mq.end_offset()):
            b = p.colwire.decode_event_frame(m.body)
            seqs.extend(range(b.seq0, b.seq0 + len(b)))
            lines.extend(b.to_json_lines())
        svc.feed.drain()
        return (failed, rolled_back, seqs, lines, svc.feed.suppressed,
                svc.feed.seq_state(), svc.feed.events_seen)

    got = run(PKG["t"], tmp_path / "t")
    want = run(PKG["j"], tmp_path / "j")
    assert got == want
    failed, rolled_back, seqs, _, suppressed, state, seen = got
    assert failed == 0 and rolled_back == 0 and seqs[0] == 0
    dupes = len(seqs) - len(set(seqs))
    assert dupes > 0 and sorted(set(seqs)) == list(range(len(set(seqs))))
    assert suppressed == dupes and state["gaps"] == 0
    assert seen == len(set(seqs))


# -- faults config block -----------------------------------------------------


def test_faults_config_defaults_off_and_inline_points(tmp_path):
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(
        "faults:\n"
        "  seed: 5\n"
        "  points:\n"
        "    - {point: consumer.commit, mode: raise, at: [2]}\n"
    )

    def run(p):
        c = p.config
        cfg = c.load_config(str(cfg_path))
        plan = cfg.faults.fault_plan()
        with pytest.raises(ValueError) as e:
            c.FaultsConfig(plan="x.json", points=({"point": "a"},))
        return (c.Config().faults.enabled, cfg.faults.enabled,
                plan.to_json(), str(e.value))

    got, want = both(run)
    assert got == want
    assert got[:2] == (False, True)
    assert tfaults.FaultPlan.from_json(got[2]) == tfaults.FaultPlan(
        seed=5, faults=(tfaults.FaultSpec("consumer.commit", mode="raise",
                                          at=(2,)),))


def test_service_arms_faults_from_config():
    def run(p):
        c = p.config
        svc = p.svc(c.Config(
            engine=c.EngineConfig(cap=16, n_slots=4, max_t=4),
            faults=c.FaultsConfig(enabled=True, seed=3, points=(
                {"point": "consumer.frame", "mode": "raise", "at": [1]},))))
        armed = p.faults.FAULTS.enabled
        svc.bus.order_queue.publish(p.bus.encode_order(p.Order(
            uuid="u", oid="o1", symbol="s", side=p.Side.BUY, price=100,
            volume=1)))
        stepped = svc.consumer.step_with_policy()  # injected, absorbed
        report = p.faults.FAULTS.report()
        p.faults.FAULTS.disable()
        return armed, stepped, report

    got, want = both(run)
    assert got == want
    assert got[0] is True and got[1] == 0 and got[2]["fired"]


# -- the chaos drill (gome_tpu_torch/scripts/chaos.py) -----------------------


@pytest.mark.parametrize("seed", [11, 17, 1234])
def test_plan_for_cycle_matches_the_reference(seed):
    ref = load_reference_chaos()
    for cycle in range(1, 13):
        assert chaos.plan_for_cycle(cycle, seed).to_json() == \
            ref.plan_for_cycle(cycle, seed).to_json()
    # Five kills cover the five fault classes.
    assert {(chaos.plan_for_cycle(c, seed).faults[0].point,
             chaos.plan_for_cycle(c, seed).faults[0].mode)
            for c in range(1, 6)} == {
        ("consumer.commit", "exit"), ("consumer.frame", "exit"),
        ("filelog.offset", "torn"), ("snapshot.rename", "torn"),
        ("filelog.append", "torn")}


def capture_engines(module, monkeypatch) -> list:
    """Keep every engine module.build_engine builds."""
    built = []
    inner = module.build_engine

    def build(*args, **kw):
        built.append(inner(*args, **kw))
        return built[-1]

    monkeypatch.setattr(module, "build_engine", build)
    return built


def test_worker_matches_the_reference_on_its_frames(tmp_path, monkeypatch):
    """scripts/chaos.py's own recorded frames (record_sim_frames(11, 40))
    seeded into a file queue for each package and run uninterrupted
    through each package's worker: the match-stream lines byte-equal, the
    feed's seq state and match_seq equal, and export_state() equal leaf
    by leaf (and so the book digest)."""
    ref = load_reference_chaos()
    frames = ref.record_sim_frames(11, 40)
    results, engines = {}, {}
    for side, module in (("t", chaos), ("j", ref)):
        bus, snaps = tmp_path / side / "bus", tmp_path / side / "snaps"
        bus.mkdir(parents=True)
        snaps.mkdir()
        module.seed_queue(str(bus), frames)
        built = capture_engines(module, monkeypatch)
        out = str(tmp_path / f"{side}.json")
        ns = types.SimpleNamespace(bus_dir=str(bus), snap_dir=str(snaps),
                                   out=out, plan="", device="cpu",
                                   lanes=chaos.N_LANES)
        assert module.run_worker(ns) == 0
        with open(out) as f:
            results[side] = json.load(f)
        (engines[side],) = built
    lines = {side: chaos.read_match_stream(str(tmp_path / side / "bus"))
             for side in results}
    assert lines["t"] == lines["j"]
    assert len(lines["t"][0]) > 0
    # The reference's reader reads the port's stream to the same lines.
    assert ref.read_match_stream(str(tmp_path / "t" / "bus")) == lines["j"]
    for key in ("match_seq", "feed", "oq", "mq", "completed"):
        assert results["t"][key] == results["j"][key], key
    a = engines["t"].batch.export_state()
    b = engines["j"].batch.export_state()
    assert a.keys() == b.keys()
    for key in a:
        if key == "books":
            assert a[key].keys() == b[key].keys()
            for leaf in a[key]:
                assert a[key][leaf].dtype == b[key][leaf].dtype, leaf
                assert np.array_equal(a[key][leaf], b[key][leaf]), leaf
        else:
            assert a[key] == b[key], key
    assert results["t"]["book_digest"] == results["j"]["book_digest"]
    assert results["t"]["launches"] >= 0


def test_parent_at_the_reference_geometry(tmp_path):
    """`python -m gome_tpu_torch.scripts.chaos --device cpu --kills 5`
    (16 lanes, the reference's configuration, seed 11): five injected
    deaths, one of each class, and every check of the verdict true."""
    out = tmp_path / "chaos.json"
    proc = subprocess.run(
        [sys.executable, "-m", "gome_tpu_torch.scripts.chaos", "--device",
         "cpu", "--kills", "5", "--seed", "11", "--out", str(out),
         "--workdir", str(tmp_path / "work")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    v = json.loads(out.read_text())
    assert v["schema"] == "gome-chaos-verdict-v1" and v["pass"] is True
    assert all(v["checks"].values()) and len(v["checks"]) == 9
    assert v["config"]["engine"]["n_slots"] == 16
    assert v["config"]["departures"] == []
    assert [c["exit_code"] for c in v["cycles"]] == [86] * 5
    assert v["oracle"]["book_digest"] == v["final"]["book_digest"]
    ref_keys = json.loads(
        (open(os.path.join(REPO, "CHAOS_r01.json")).read()))
    assert set(ref_keys) <= set(v)
    for section in ("config", "oracle", "final", "matchfeed", "recovery",
                    "checks"):
        assert set(ref_keys[section]) <= set(v[section]), section


# -- the committed card verdict ----------------------------------------------

CHAOS_CLASSES = {("consumer.commit", "exit"), ("consumer.frame", "exit"),
                 ("filelog.offset", "torn"), ("snapshot.rename", "torn"),
                 ("filelog.append", "torn")}


def check_provenance(doc: dict) -> None:
    """A card verdict names an NVIDIA card and a package tree the repo's
    git resolves (when the checkout has its git directory)."""
    import re

    prov = doc["provenance"]
    assert "NVIDIA" in prov["card"] and prov["device"] == "cuda"
    m = re.search(r"gome_tpu_torch tree ([0-9a-f]{40})", prov["commit"])
    assert m, prov["commit"]
    assert prov["command"].startswith("python -m gome_tpu_torch.scripts.")
    if os.path.isdir(os.path.join(REPO, ".git")):
        kind = subprocess.run(["git", "cat-file", "-t", m.group(1)],
                              cwd=REPO, capture_output=True, text=True)
        assert kind.stdout.strip() == "tree", kind.stderr


def test_chaos_cuda_verdict_pinned_green():
    """CHAOS_CUDA_r01.json, the chaos drill on the H100 at 10,240 lanes:
    five injected deaths, one of each fault class, every check true, the
    recovered book digest equal to the oracle's. Regenerate it with the
    driver, never by hand."""
    with open(os.path.join(REPO, "CHAOS_CUDA_r01.json")) as f:
        v = json.load(f)
    assert v["schema"] == "gome-chaos-verdict-v1"
    assert v["pass"] is True and len(v["checks"]) == 9
    assert all(v["checks"].values()), v["checks"]
    check_provenance(v)
    assert v["config"]["engine"]["n_slots"] == 10_240
    assert v["config"]["kills"] == len(v["cycles"]) == 5
    assert {(c["plan"]["faults"][0]["point"], c["plan"]["faults"][0]["mode"])
            for c in v["cycles"]} == CHAOS_CLASSES
    assert all(c["exit_code"] == 86 for c in v["cycles"])
    assert v["oracle"]["book_digest"] == v["final"]["book_digest"]
    assert v["oracle"]["book_digest"]
    audit = v["matchfeed"]["seq_audit"]
    assert audit["dupes"] == 0 and audit["gaps"] == 0
    assert v["matchfeed"]["stamped"] == v["matchfeed"]["events"] > 0
    rec = v["recovery"]
    assert len(rec["samples_s"]) >= 5 and rec["p99_s"] is not None
    assert rec["wal_replay_frames_total"] > 0
