"""The port's gomerace dynamic prong (gome_tpu_torch.analysis.racecheck,
.interleave, .runtime): every case of tests/test_race.py against the
port's detector, interleaver and services, the same seeds giving the same
interleaver traces as gome_tpu's, the GOME_RACECHECK=1 hook on the port's
EngineService, and chip_smoke.race_drill on the CPU at a small size.

The injected-race goldens mirror the three classic shapes the detector
must catch — unguarded counter, check-then-act, publish-without-lock —
plus their properly-locked twins, which must stay silent. The disabled
path is held to the same zero-allocation contract as the tracer,
compile journal, and fault registry.
"""

from __future__ import annotations

import sys
import threading

import pytest

from gome_tpu_torch.analysis.interleave import (
    Interleaver,
    SteppingEvent,
    SteppingLock,
)
from gome_tpu_torch.analysis.racecheck import (
    RACECHECK,
    RaceCheck,
    TrackedLock,
    watch,
)


@pytest.fixture(autouse=True)
def _fresh_detector():
    """Each test gets a clean process-wide detector and leaves it
    disabled (other tests rely on the zero-cost disabled path)."""
    RACECHECK.reset()
    yield
    RACECHECK.disable()
    RACECHECK.reset()


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump_unlocked(self):
        self.n = self.n + 1

    def bump_locked(self):
        with self._lock:
            self.n = self.n + 1


# -- interleaving driver ----------------------------------------------------


def test_interleaver_same_seed_same_trace():
    def make_worker(log, me):
        def worker(step):
            for _ in range(5):
                log.append(me)
                step()

        return worker

    runs = []
    for _ in range(2):
        log: list[str] = []
        il = Interleaver(seed=42)
        trace = il.run(make_worker(log, "a"), make_worker(log, "b"))
        runs.append((trace, log))
    assert runs[0] == runs[1]
    # Both workers actually ran to completion.
    assert runs[0][1].count("a") == 5 and runs[0][1].count("b") == 5


def test_interleaver_seeds_explore_distinct_schedules():
    def worker(step):
        for _ in range(6):
            step()

    traces = set()
    for seed in range(8):
        il = Interleaver(seed=seed)
        traces.add(tuple(il.run(worker, worker)))
    assert len(traces) > 1


def test_interleaver_collects_worker_exceptions():
    def ok(step):
        return "fine"

    def boom(step):
        raise ValueError("expected")

    il = Interleaver(seed=0)
    il.run(ok, boom)
    assert il.results[0] == "fine"
    assert isinstance(il.errors[1], ValueError)


def test_stepping_lock_schedules_through_contention():
    """A worker blocked on a SteppingLock yields instead of wedging the
    cooperative scheduler: both critical sections complete, mutually
    excluded, on every seed."""
    for seed in range(6):
        il = Interleaver(seed=seed)
        lock = SteppingLock(il.step)
        inside = []

        def worker(step, lock=lock, inside=inside):
            with lock:
                inside.append("enter")
                step()  # deschedule while HOLDING the lock
                inside.append("exit")

        il.run(worker, worker)
        assert inside == ["enter", "exit", "enter", "exit"]


# -- injected-race goldens --------------------------------------------------


def _hammer(fn, n_threads=2, iters=200):
    """Free-running (non-interleaved) concurrent driver: the detector
    must catch discipline violations without a cooperative schedule.
    The barrier keeps all workers alive simultaneously — a worker that
    finished before the next one spawned could hand its (OS-reused)
    thread ident to the successor, and same-ident accesses never look
    shared to the detector."""
    barrier = threading.Barrier(n_threads)

    def run():
        barrier.wait()
        for _ in range(iters):
            fn()

    threads = [
        threading.Thread(target=run) for _ in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_unguarded_counter_is_reported():
    c = watch(Counter(), ("n",), label="UnguardedCounter")
    RACECHECK.enable()
    _hammer(c.bump_unlocked)
    RACECHECK.disable()
    reports = RACECHECK.reports()
    # The read and the write of `self.n = self.n + 1` share a source
    # line, so the dedup fingerprint collapses them into one report —
    # whichever side fired first.
    assert any(
        r.label == "UnguardedCounter" and r.attr == "n" for r in reports
    )
    # Both sides of the race are in the report.
    r = reports[0]
    assert r.site_here and r.site_prev
    assert any("bump_unlocked" in f for f in r.site_here)


def test_locked_counter_is_silent():
    c = watch(Counter(), ("n",), label="LockedCounter")
    RACECHECK.enable()
    _hammer(c.bump_locked)
    RACECHECK.disable()
    assert RACECHECK.reports() == []
    assert c.n == 400  # TrackedLock still mutually excludes


def test_publish_without_lock_is_reported():
    """One side writes under the lock, the other publishes bare: the
    candidate lockset empties and the inconsistency is reported even
    though *most* accesses were disciplined."""
    c = watch(Counter(), ("n",), label="MixedCounter")
    RACECHECK.enable()
    t = threading.Thread(
        target=lambda: [c.bump_locked() for _ in range(200)]
    )
    t.start()
    for _ in range(200):
        c.bump_unlocked()
    t.join()
    RACECHECK.disable()
    assert any(
        r.label == "MixedCounter" and r.attr == "n"
        for r in RACECHECK.reports()
    )


def test_check_then_act_is_reported_and_loses_update():
    """The classic window: `if slot is None: slot = me` with a forced
    deschedule between check and act. The interleaver proves the lost
    update (both workers observe None) and the detector reports the
    unguarded write."""

    class Holder:
        def __init__(self):
            self.slot = None

    RACECHECK.enable()
    lost_update_seeds = []
    for seed in range(16):
        h = watch(Holder(), ("slot",), lock_attrs=(), label="Holder")
        il = Interleaver(seed=seed)
        winners = []

        def claim(step, me, h=h, winners=winners):
            if h.slot is None:
                step()  # the race window
                h.slot = me
                winners.append(me)

        il.run(
            lambda step: claim(step, "a"), lambda step: claim(step, "b")
        )
        if len(winners) == 2:  # both passed the check: lost update
            lost_update_seeds.append(seed)
    RACECHECK.disable()
    # The seed sweep deterministically finds schedules that lose the
    # update, and the detector reported the unguarded write.
    assert lost_update_seeds
    assert any(r.attr == "slot" for r in RACECHECK.reports())


def test_reports_dedupe_and_suppress():
    c = watch(Counter(), ("n",), label="DedupeCounter")
    RACECHECK.enable()
    _hammer(c.bump_unlocked, iters=500)
    RACECHECK.disable()
    reports = RACECHECK.reports()
    fingerprints = [r.fingerprint for r in reports]
    assert len(fingerprints) == len(set(fingerprints))
    for r in reports:
        RACECHECK.suppress(r.fingerprint)
    assert RACECHECK.reports() == []
    assert RACECHECK.reports(include_suppressed=True) == reports
    # label.attr suppression works too
    RACECHECK.reset()
    RACECHECK.enable()
    _hammer(c.bump_unlocked, iters=500)
    RACECHECK.disable()
    assert RACECHECK.reports()
    RACECHECK.suppress("DedupeCounter.n")
    assert RACECHECK.reports() == []


def test_exclusive_then_read_only_sharing_is_silent():
    """Init-then-publish: one thread initializes bare, others only read.
    The Eraser EXCLUSIVE->SHARED refinement must not report it."""

    class Config:
        def __init__(self):
            self.value = 0

    cfg = watch(Config(), ("value",), lock_attrs=(), label="Config")
    RACECHECK.enable()
    cfg.value = 7  # main thread, exclusive
    seen = []
    _hammer(lambda: seen.append(cfg.value), n_threads=3, iters=50)
    RACECHECK.disable()
    assert RACECHECK.reports() == []
    assert set(seen) == {7}


# -- disabled-path contract -------------------------------------------------


@pytest.mark.skipif(
    not hasattr(sys, "getallocatedblocks"),
    reason="CPython-only allocation accounting",
)
def test_disabled_path_is_zero_alloc():
    """Disabled note_access is one attribute check and zero allocations
    (the TRACER/JOURNAL/FAULTS contract)."""
    note = RACECHECK.note_access

    def drill(n):
        i = 0
        while i < n:
            note("Warm", "attr", True)
            i += 1

    drill(64)  # warm lazy caches
    before = sys.getallocatedblocks()
    drill(1000)
    after = sys.getallocatedblocks()
    assert after - before <= 2, f"disabled note_access allocated {after - before}"


def test_tracked_lock_plain_when_disabled():
    lock = TrackedLock()
    with lock:
        assert lock.held_by_me()
    assert not lock.locked()
    assert RACECHECK._held_stack() == []


# -- service integration ----------------------------------------------------


def test_maybe_arm_is_env_gated(monkeypatch):
    from gome_tpu_torch.analysis.racecheck import maybe_arm

    monkeypatch.delenv("GOME_RACECHECK", raising=False)
    assert maybe_arm(object()) is False
    assert RACECHECK.enabled is False


def test_arm_service_watches_feed_and_consumer():
    from gome_tpu_torch.analysis.racecheck import arm_service
    from gome_tpu_torch.bus import MemoryQueue, QueueBus
    from gome_tpu_torch.service.matchfeed import MatchFeed

    class FakeSvc:
        pass

    svc = FakeSvc()
    bus = QueueBus(MemoryQueue("doOrder"), MemoryQueue("matchOrder"))
    svc.feed = MatchFeed(bus, log_events=False)
    watched = arm_service(svc)
    assert svc.feed in watched and svc.feed.seq in watched
    # The feed's own locks became tracked, its counters became watched
    # properties, and the feed still works.
    assert isinstance(svc.feed._lock, TrackedLock)
    RACECHECK.enable()
    assert svc.feed.run_once() == 0
    RACECHECK.disable()


# -- the double-start lifecycle race (fixed this round) ---------------------


def _double_start(seed: int):
    """Two workers race MatchFeed.start() under one seeded schedule,
    with the exact pre-fix window — the `_stop.clear()` between the
    already-started check and the thread assignment — turned into a
    schedule point."""
    from gome_tpu_torch.bus import MemoryQueue, QueueBus
    from gome_tpu_torch.service.matchfeed import MatchFeed

    bus = QueueBus(MemoryQueue("doOrder"), MemoryQueue("matchOrder"))
    feed = MatchFeed(bus, log_events=False)
    il = Interleaver(seed=seed)
    # _life must step (a worker holding it descheduled mid-start would
    # otherwise wedge the schedule); _stop.clear() IS the race window.
    feed._life = SteppingLock(il.step)
    feed._stop = SteppingEvent(il.step)
    il.run(lambda step: feed.start(), lambda step: feed.start())
    try:
        live = [
            t for t in threading.enumerate() if t.name == "match-feed"
        ]
        return il, live
    finally:
        feed.stop()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 1234])
def test_matchfeed_double_start_is_serialized(seed):
    """Regression for the watchdog-vs-operator double start: before the
    _life lock, a schedule that deschedules worker A between the
    `_thread is None` check and the assignment let both workers spawn a
    fan-out loop (double delivery, lost join). Post-fix, EVERY seeded
    schedule yields exactly one winner, one RuntimeError loser, one
    live feed thread."""
    il, live = _double_start(seed)
    errors = [e for e in il.errors if e is not None]
    assert len(errors) == 1, f"trace {il.trace}: errors {il.errors}"
    assert isinstance(errors[0], RuntimeError)
    assert len(live) == 1, f"trace {il.trace}: {live}"


def test_consumer_double_start_is_serialized():
    """Same lifecycle contract on the order consumer (its start() got
    the same _life serialization this round)."""
    from gome_tpu_torch.bus import MemoryQueue, QueueBus
    from gome_tpu_torch.engine import BookConfig
    from gome_tpu_torch.engine.orchestrator import MatchEngine
    from gome_tpu_torch.service.consumer import OrderConsumer

    engine = MatchEngine(
        config=BookConfig(cap=16, max_fills=4), n_slots=16, max_t=4,
        device="cpu",
    )
    bus = QueueBus(MemoryQueue("doOrder"), MemoryQueue("matchOrder"))
    consumer = OrderConsumer(engine, bus, batch_n=16, batch_wait_s=0)
    il = Interleaver(seed=5)
    consumer._life = SteppingLock(il.step)
    il.run(
        lambda step: consumer.start(), lambda step: consumer.start()
    )
    try:
        errors = [e for e in il.errors if e is not None]
        assert len(errors) == 1 and isinstance(errors[0], RuntimeError)
        live = [
            t
            for t in threading.enumerate()
            if t.name == "order-consumer"
        ]
        assert len(live) == 1
    finally:
        consumer.stop()


def test_private_detector_instances_are_independent():
    """Tests may build private RaceCheck instances without touching the
    process-wide singleton's state."""
    rc = RaceCheck()
    rc.enable()
    rc.note_access("X", "y", True)
    assert RACECHECK._vars == {}
    rc.disable()


# -- against gome_tpu's -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 5, 42, 1234])
def test_interleaver_trace_equals_the_reference(seed):
    """The same seed and workers give gome_tpu's interleaver and the
    port's the same schedule trace, and the same worker order."""
    from gome_tpu.analysis.interleave import Interleaver as JInterleaver

    def run(cls):
        log = []

        def make(me, n):
            def worker(step):
                for _ in range(n):
                    log.append(me)
                    step()
            return worker

        il = cls(seed=seed)
        return il.run(make("a", 4), make("b", 6), make("c", 3)), log

    assert run(Interleaver) == run(JInterleaver)


def test_arm_service_watches_the_reference_attributes():
    """arm_service watches, on the port's objects, the attributes
    gome_tpu's does (MatchFeed, SeqTracker, OrderConsumer, FrameBatcher,
    Persister), and they exist there."""
    from gome_tpu_torch.analysis.racecheck import arm_service
    from gome_tpu_torch.bus import MemoryQueue, QueueBus
    from gome_tpu_torch.config import PersistConfig
    from gome_tpu_torch.engine import BookConfig
    from gome_tpu_torch.engine.orchestrator import MatchEngine
    from gome_tpu_torch.persist import Persister
    from gome_tpu_torch.service.batcher import FrameBatcher
    from gome_tpu_torch.service.consumer import OrderConsumer
    from gome_tpu_torch.service.matchfeed import MatchFeed

    class FakeSvc:
        pass

    class FakeGateway:
        pass

    svc = FakeSvc()
    bus = QueueBus(MemoryQueue("doOrder"), MemoryQueue("matchOrder"))
    svc.feed = MatchFeed(bus, log_events=False)
    engine = MatchEngine(config=BookConfig(cap=16, max_fills=4), n_slots=8,
                         max_t=4, device="cpu")
    svc.consumer = OrderConsumer(engine, bus, batch_n=16, batch_wait_s=0)
    svc.gateway = FakeGateway()
    svc.gateway._batcher = FrameBatcher(MemoryQueue("doOrder"), max_n=2,
                                        max_wait_s=60)
    svc.persist = Persister(PersistConfig(enabled=True, dir="unused"))
    try:
        watched = arm_service(svc)
        labels = [type(o)._racecheck_label for o in watched]
        assert labels == ["MatchFeed", "SeqTracker", "OrderConsumer",
                          "FrameBatcher", "Persister"]
        for obj in watched:
            for name, value in vars(type(obj)).items():
                if isinstance(value, property):
                    getattr(obj, name)  # present on the port's object
        assert isinstance(svc.consumer._life, TrackedLock)
        assert isinstance(svc.gateway._batcher._lock, TrackedLock)
    finally:
        svc.gateway._batcher.close()


def test_hook_is_environment_gated_on_the_ports_service():
    """Without GOME_RACECHECK=1 the port's EngineService neither imports
    nor arms the detector; with it, the detector is armed over the feed
    and the consumer."""
    import json
    import os
    import subprocess

    code = (
        "import json, sys\n"
        "from gome_tpu_torch.config import Config, OpsConfig\n"
        "from gome_tpu_torch.service import EngineService\n"
        "svc = EngineService(Config(ops=OpsConfig(enabled=False)), "
        "device='cpu')\n"
        "mod = sys.modules.get('gome_tpu_torch.analysis.racecheck')\n"
        "print(json.dumps(dict(imported=mod is not None, "
        "armed=bool(mod and mod.RACECHECK.enabled), "
        "feed=type(svc.feed).__name__, "
        "consumer=type(svc.consumer).__name__)))\n")
    base = {k: v for k, v in os.environ.items() if k != "GOME_RACECHECK"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = {}
    for flag in (None, "0", "1"):
        env = dict(base) if flag is None else dict(base, GOME_RACECHECK=flag)
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, env=env, cwd=root, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        runs[flag] = json.loads(r.stdout.strip().splitlines()[-1])
    for flag in (None, "0"):
        assert runs[flag] == dict(imported=False, armed=False,
                                  feed="MatchFeed", consumer="OrderConsumer")
    assert runs["1"] == dict(imported=True, armed=True,
                             feed="MatchFeed@racecheck",
                             consumer="OrderConsumer@racecheck")


def test_race_drill_on_the_cpu():
    """chip_smoke.race_drill, phase 15 (a)'s drill, at a small size: orders
    flow through the real handlers, no race is reported, the events
    equal the oracle's over the order queue, and the service's K1 inputs
    were kept for the plain-version check (made on the card)."""
    import chip_smoke
    from gome_tpu_torch.config import EngineConfig

    v = chip_smoke.race_drill(
        "cpu", seconds=0.25, threads=2,
        engine=EngineConfig(cap=16, max_fills=4, n_slots=8, max_t=8))
    assert v["orders_accepted"] > 0 and v["events"] > 0
    assert v["race_reports"] == []
    assert v["orders_queued"] >= v["orders_accepted"]
    assert v["kept_grids"] > 0
    assert RACECHECK.enabled is False
