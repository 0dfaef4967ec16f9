"""The port's service parts on the CPU against gome_tpu's: make_bus over
the memory, file and native file backends, MatchEngine.process_one,
AdmissionController decisions (an injected clock), HealthMonitor and
Watchdog verdicts, and the OpsServer (/healthz, /metrics, /durability,
/trace, and 404 on the reference's obs/ routes the port has not yet).
Exact equality across the two packages."""

import contextlib
import functools
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import gome_tpu.bus as jbus
import gome_tpu.config as jconfig
import gome_tpu.service.admission as jadmission
import gome_tpu.service.health as jhealth
import gome_tpu.utils.faults as jfaults
import gome_tpu.utils.resilience as jresilience
import gome_tpu.utils.trace as jtrace
import gome_tpu_torch.bus as tbus
import gome_tpu_torch.config as tconfig
import gome_tpu_torch.service.admission as tadmission
import gome_tpu_torch.service.health as thealth
import gome_tpu_torch.utils.faults as tfaults
import gome_tpu_torch.utils.resilience as tresilience
import gome_tpu_torch.utils.trace as ttrace
from gome_tpu.engine.orchestrator import MatchEngine as JEngine
from gome_tpu.service.app import EngineService as JService
from gome_tpu.utils.metrics import Registry as JRegistry
from gome_tpu.utils.streams import mixed_stream
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.service.app import EngineService as TService
from gome_tpu_torch.utils.metrics import Registry as TRegistry
from test_torch_bus import plain, port_order

J, T = "gome_tpu", "port"


@contextlib.contextmanager
def time_limit(seconds: float):
    """Raise TimeoutError in the test if the block runs past `seconds`
    (SIGALRM; tests run on the main thread of their process)."""
    def fire(signum, frame):
        raise TimeoutError(f"over the test's {seconds} s limit")

    old = signal.signal(signal.SIGALRM, fire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def limited(seconds: float):
    """A test that starts a server gets a time limit of its own."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with time_limit(seconds):
                return fn(*args, **kw)
        return run
    return wrap


@pytest.fixture(autouse=True)
def no_tracer():
    """Both packages' TRACERs are process-wide, and an earlier test in this
    process may have armed one: an armed tracer pins a gateway to its
    scalar loop (other doOrder bodies) and fills /trace. Tests of the
    service parts run with both disarmed."""
    jtrace.TRACER.disable()
    ttrace.TRACER.disable()
    yield


PKG = {
    J: dict(bus=jbus, config=jconfig, admission=jadmission, health=jhealth,
            resilience=jresilience, registry=JRegistry),
    T: dict(bus=tbus, config=tconfig, admission=tadmission, health=thealth,
            resilience=tresilience, registry=TRegistry),
}
OBS_FLAGS = ("cost", "timeline", "profile", "hostprof", "placement")


# -- make_bus -----------------------------------------------------------------

def bus_run(side, backend, root):
    cfg = PKG[side]["config"].BusConfig(backend=backend, dir=str(root))
    bus = PKG[side]["bus"].make_bus(cfg)
    out = []
    for q in (bus.order_queue, bus.match_queue):
        offsets = [q.publish(b"body-%d" % i) for i in range(5)]
        q.commit(3)
        out.append((q.name, offsets, q.end_offset(), q.committed(),
                    [(m.offset, m.body) for m in q.read_from(0, 10)],
                    [(m.offset, m.body) for m in q.poll_batch(10, 0)]))
        if hasattr(q, "close"):
            q.close()
    return out


def dir_bytes(root):
    files = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


@pytest.mark.parametrize("backend", ["memory", "file", "cfile"])
def test_make_bus_matches(backend, tmp_path):
    runs = {side: bus_run(side, backend, tmp_path / side) for side in (J, T)}
    assert runs[T] == runs[J]
    assert [r[0] for r in runs[T]] == ["doOrder", "matchOrder"]
    if backend != "memory":
        files = {side: dir_bytes(tmp_path / side) for side in (J, T)}
        assert files[T] == files[J] and files[T]


def test_make_bus_file_logs_reopen_across_packages(tmp_path):
    """A log written through the port's make_bus reopens in gome_tpu's."""
    bus_run(T, "cfile", tmp_path)
    q = jbus.FileQueue("doOrder", str(tmp_path / "doOrder"))
    assert [m.body for m in q.read_from(0, 10)] == [
        b"body-%d" % i for i in range(5)]
    assert q.committed() == 3
    q.close()


# -- process_one ------------------------------------------------------------------

def test_process_one_matches():
    orders = mixed_stream(n=60, seed=5, cancel_prob=0.3)
    engines = {J: JEngine(**_book(J), n_slots=8, max_t=8),
               T: MatchEngine(**_book(T), n_slots=8, max_t=8, device="cpu")}
    events = {J: [], T: []}
    for o in orders:
        for side, conv in ((J, lambda x: x), (T, port_order)):
            engines[side].mark(conv(o))
            events[side].append(plain(engines[side].process_one(conv(o))))
    assert events[T] == events[J]
    assert sum(map(len, events[T])) > 10
    engines[T].batch.verify_books()


def _book(side):
    if side == J:
        from gome_tpu.engine import BookConfig as JBook

        return dict(config=JBook(cap=32, max_fills=8))
    return dict(config=BookConfig(cap=32, max_fills=8))


# -- admission ----------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


# (depth, n, time_remaining_s, seconds to advance before the call)
ADMIT_SEQ = [
    (0, 1, None, 0.0), (100, 50, None, 0.0), (100, 60, None, 0.001),
    (200, 1, None, 0.01), (250, 8, 0.5, 0.0), (250, 8, 0.05, 0.0),
    (900, 1, None, 0.02), (900, 300, None, 0.0), (3000, 1, 2.0, 0.02),
    (10, 256, None, 0.02), (10, 247, None, 0.0), (0, 1, 0.099, 0.02),
]


def admission_run(side, monkeypatch):
    mod = PKG[side]["admission"]
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=clock.monotonic))
    depth = [0]
    registry = PKG[side]["registry"]()
    ctl = mod.AdmissionController(
        lambda: depth[0], max_depth=256, min_deadline_s=0.1,
        retry_after_s=0.05, retry_after_max_s=0.5, cache_s=0.005,
        registry=registry)
    out = []
    for d, n, remaining, advance in ADMIT_SEQ:
        depth[0] = d
        clock.now += advance
        dec = ctl.admit(n, remaining)
        out.append((dec.ok, dec.reason, dec.retry_after_s, dec.depth,
                    dec.message()))
    return out, registry.render()


def test_admission_decisions_match(monkeypatch):
    (jd, jtext), (td, ttext) = (admission_run(s, monkeypatch)
                                for s in (J, T))
    assert td == jd
    assert ttext == jtext
    assert {d[1] for d in td} == {"", "depth", "deadline"}


def test_admission_rejects_bad_arguments_alike():
    for kw in (dict(max_depth=0), dict(retry_after_s=0),
               dict(retry_after_s=1.0, retry_after_max_s=0.5)):
        msgs = []
        for side in (J, T):
            with pytest.raises(ValueError) as e:
                PKG[side]["admission"].AdmissionController(
                    lambda: 0, registry=PKG[side]["registry"](), **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# -- health and watchdog -----------------------------------------------------------

class _Q:
    def __init__(self, end, committed):
        self.end, self.com = end, committed

    def end_offset(self):
        return self.end

    def committed(self):
        return self.com


class _Component:
    """A consumer/feed stand-in: start() gives it a live thread until
    kill(); stop()/start() are counted."""

    def __init__(self):
        self._thread = None
        self.calls = []
        self._done = threading.Event()

    def start(self):
        self.calls.append("start")
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._done.wait, daemon=True)
        self._thread.start()

    def stop(self):
        self.calls.append("stop")
        self.kill()

    def kill(self):
        self._done.set()
        if self._thread is not None:
            self._thread.join()


class _Batcher:
    def __init__(self, degraded):
        self.degraded = degraded

    def stats(self):
        return dict(degraded=self.degraded, spill_depth=int(self.degraded))


def stub_service(order_lag, batcher=None):
    ns = types.SimpleNamespace
    stats = ns(orders=7, cap_escalations=1, device_calls=3)
    return ns(
        consumer=_Component(), feed=_Component(),
        bus=ns(order_queue=_Q(10 + order_lag, 10), match_queue=_Q(4, 2)),
        engine=ns(batch=ns(symbols={"a": 1, "b": 2}, max_slots=8,
                           stats=stats)),
        gateway=ns(_batcher=batcher) if batcher else ns())


# scenario: (order lag, threads started, beat age, batcher, connections)
CONN_OPEN = {"drill:conn": {"breaker": "open", "connects_total": 1}}
HEALTH_CASES = {
    "not started": (0, False, 0.0, None, {}),
    "running": (0, True, 0.0, None, {}),
    "lag, fresh beat": (5, True, 1.0, None, {}),
    "stalled": (5, True, 60.0, None, {}),
    "stale beat, no lag": (0, True, 60.0, None, {}),
    "spill degraded": (0, True, 0.0, _Batcher(True), {}),
    "spill healthy": (0, True, 0.0, _Batcher(False), {}),
    "breaker open": (0, True, 0.0, None, CONN_OPEN),
}


@pytest.mark.parametrize("case", list(HEALTH_CASES))
def test_health_verdicts_match(case, monkeypatch):
    lag, started, age, batcher, conns = HEALTH_CASES[case]
    verdicts = {}
    for side in (J, T):
        monkeypatch.setattr(PKG[side]["resilience"], "resilience_snapshot",
                            lambda conns=conns: conns)
        svc = stub_service(lag, batcher)
        if started:
            svc.consumer.start()
            svc.feed.start()
        mon = PKG[side]["health"].HealthMonitor(svc, stall_after_s=30.0)
        mon._beat = time.monotonic() - age
        h = mon.check().as_dict()
        svc.consumer.kill()
        svc.feed.kill()
        assert h.pop("heartbeat_age_s") >= age
        verdicts[side] = h
    assert verdicts[T] == verdicts[J]


def watchdog_run(side):
    svc = stub_service(0)
    svc.consumer.start()
    svc.feed.start()
    dog = PKG[side]["health"].Watchdog(svc, max_restarts=2, window_s=60)
    trail = []
    for kill in ("consumer", "consumer", "feed", None, "feed"):
        if kill:
            getattr(svc, kill).kill()
        h = dog.check_once()
        trail.append((kill, h.consumer_alive, h.feed_alive, dog.gave_up,
                      list(svc.consumer.calls), list(svc.feed.calls)))
    svc.consumer.kill()
    svc.feed.kill()
    return trail


def test_watchdog_verdicts_match():
    trail = watchdog_run(T)
    assert trail == watchdog_run(J)
    assert trail[-1][3]  # gave up after max_restarts in the window


def test_watchdog_thread_starts_and_stops():
    svc = stub_service(0)
    dog = thealth.Watchdog(svc, interval_s=0.01)
    dog.start()
    with pytest.raises(RuntimeError):
        dog.start()
    dog.stop()
    assert dog._thread is None


# -- the ops endpoint ----------------------------------------------------------

UNPORTED_ROUTES = ("/cost", "/timeline", "/profile", "/hostprof", "/fleet",
                   "/capacity", "/placement")


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def quiet_ops_config(side):
    c = PKG[side]["config"]
    return c.Config(engine=c.EngineConfig(cap=16, max_fills=4, n_slots=4,
                                          max_t=4),
                    ops=c.OpsConfig(port=0, enabled=True, trace=False,
                                    **dict.fromkeys(OBS_FLAGS, False)))


def _plain_json(x):
    return json.loads(json.dumps(x, default=str))


def metric_names(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def key_tree(x):
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items() if k != "connections"}
    return type(x).__name__


def test_ops_server_matches():
    """Both packages' metric REGISTRYs are process-wide, and a service that
    an earlier test in this worker built leaves its names there. The
    comparison runs in a fresh process, where both start as imports leave
    them, so /metrics is compared exactly whatever ran before."""
    code = ("import sys; sys.path.insert(0, 'tests')\n"
            "import conftest, test_torch_service_parts as m\n"
            "m.compare_ops_servers()\n"
            "print('compared')\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=pathlib.Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "compared", proc.stdout


def compare_ops_servers():
    """The OpsServer of each package's EngineService, started with the
    threads not running: equal /healthz, /durability, /trace and 404s,
    and no /metrics name in the port's that gome_tpu's lacks."""
    from gome_tpu.bus import encode_order
    from gome_tpu.types import Order, Side

    got = {}
    for side in (J, T):
        svc = (JService(quiet_ops_config(J)) if side == J else
               TService(quiet_ops_config(T), device="cpu"))
        svc.ops.start()
        try:
            for i, s in enumerate((Side.SALE, Side.BUY)):
                o = Order(uuid="u", oid=str(i), symbol="s", side=s,
                          price=100, volume=5)
                o = o if side == J else port_order(o)
                svc.engine.mark(o)
                svc.bus.order_queue.publish(encode_order(o))
            svc.pump()
            port = svc.ops.port
            health = _get(port, "/healthz")
            got[side] = dict(
                health_code=health[0],
                health=key_tree(json.loads(health[1])),
                durability=json.loads(_get(port, "/durability")[1]),
                trace=_get(port, "/trace"),
                nope=_get(port, "/nope"),
                metrics=metric_names(_get(port, "/metrics")[1]),
                unported=[_get(port, r)[0] for r in UNPORTED_ROUTES],
            )
        finally:
            svc.ops.stop()
    j, t = got[J], got[T]
    assert t["health_code"] == j["health_code"] == 503  # threads not started
    assert t["health"] == j["health"]
    # Each serves its own process-wide FAULTS registry's report (which
    # keeps what earlier tests in the process fired); the rest is equal.
    assert t["durability"].pop("faults") == _plain_json(tfaults.FAULTS.report())
    assert j["durability"].pop("faults") == _plain_json(jfaults.FAULTS.report())
    assert t["durability"] == j["durability"]
    assert t["durability"]["queues"]["order_queue"] == {"end": 2,
                                                      "committed": 2}
    # Each serves its own process-wide TRACER's recorder (none armed by
    # the port; gome_tpu's may hold one from an earlier test).
    for side, tracer in ((T, ttrace.TRACER), (J, jtrace.TRACER)):
        rec = tracer.recorder
        assert got[side]["trace"] == (200, json.dumps(
            rec.chrome_trace() if rec is not None else {"traceEvents": []}))
    assert t["trace"] == (200, '{"traceEvents": []}')
    assert t["nope"] == j["nope"] == (404, "not found\n")
    assert t["unported"] == [404] * len(UNPORTED_ROUTES)
    assert t["metrics"] <= j["metrics"]
    assert {"gome_orders_consumed_total", "gome_bus_depth",
            "gome_matchfeed_dupes_total"} <= t["metrics"]


@limited(120)
def test_ops_healthy_when_running():
    svc = TService(quiet_ops_config(T), device="cpu")
    svc.consumer.start()
    svc.feed.start()
    svc.ops.start()
    try:
        status, body = _get(svc.ops.port, "/healthz")
        assert status == 200, body
        assert json.loads(body)["healthy"] is True
    finally:
        svc.stop()
