"""tests/test_resilience.py's 14 cases and tests/test_fleet_chaos.py's
three send_batch_retrying cases, each run on gome_tpu's and on the port's
copy (gome_tpu_torch.utils.resilience, gome_tpu_torch.clients.doorder):
backoff/jitter bounds, retry budgets, circuit-breaker transitions (fake
clock, no sleeping), the Supervised connection's reconnect, re-setup hooks
and retries, and the batch client's resubmission of the unconsumed tail.
The same seeds give both packages the same backoff schedules."""

import importlib
import random
from types import SimpleNamespace

import pytest

PACKAGES = ("gome_tpu", "gome_tpu_torch")


@pytest.fixture(params=PACKAGES)
def R(request):
    """The package's utils.resilience module."""
    return importlib.import_module(f"{request.param}.utils.resilience")


@pytest.fixture
def pkg(R):
    return R.__name__.split(".")[0]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# --- backoff --------------------------------------------------------------


def test_backoff_delays_within_bounds(R):
    pol = R.BackoffPolicy(base_s=0.05, max_s=2.0, max_retries=50)
    rng = random.Random(7)
    delays = list(R.backoff_delays(pol, rng))
    assert len(delays) == 50
    assert delays[0] == pol.base_s
    for d in delays:
        assert pol.base_s <= d <= pol.max_s


def test_backoff_decorrelated_jitter_growth(R):
    """Each delay is Uniform(base, 3*prev) clamped — so the sequence can
    grow past a pure-exponential schedule's early steps but never past
    max_s, and two seeds give different schedules (that is the point)."""
    pol = R.BackoffPolicy(base_s=0.1, max_s=10.0, max_retries=20)
    a = list(R.backoff_delays(pol, random.Random(1)))
    b = list(R.backoff_delays(pol, random.Random(2)))
    assert a != b
    for prev, nxt in zip(a, a[1:]):
        assert nxt <= max(3.0 * prev, pol.base_s) + 1e-9


def test_backoff_policy_validation(R):
    with pytest.raises(ValueError):
        R.BackoffPolicy(base_s=0)
    with pytest.raises(ValueError):
        R.BackoffPolicy(base_s=1.0, max_s=0.5)
    with pytest.raises(ValueError):
        R.BackoffPolicy(max_retries=0)


# --- retry budget ---------------------------------------------------------


def test_retry_budget_spends_and_refills(R):
    clock = FakeClock()
    b = R.RetryBudget(rate=1.0, burst=2.0, clock=clock)
    assert b.try_spend() and b.try_spend()
    assert not b.try_spend()  # empty
    clock.advance(1.0)  # one token accrues
    assert b.try_spend()
    assert not b.try_spend()
    clock.advance(100.0)  # caps at burst
    assert b.tokens() == pytest.approx(2.0)


# --- circuit breaker ------------------------------------------------------


def test_breaker_full_cycle(R):
    clock = FakeClock()
    br = R.CircuitBreaker(
        failure_threshold=3, reset_timeout_s=5.0, clock=clock
    )
    assert br.state == R.CLOSED and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == R.CLOSED  # under threshold
    br.record_failure()
    assert br.state == R.OPEN
    assert not br.allow()  # fail fast while open
    clock.advance(4.9)
    assert not br.allow()
    clock.advance(0.2)  # cooldown elapsed
    assert br.state == R.HALF_OPEN
    assert br.allow()  # one probe admitted
    assert not br.allow()  # half_open_max=1: second probe refused
    br.record_failure()  # probe failed -> re-open, cooldown restarts
    assert br.state == R.OPEN
    clock.advance(5.1)
    assert br.allow()
    br.record_success()  # probe succeeded -> closed
    assert br.state == R.CLOSED
    assert (R.CLOSED, R.OPEN) in br.transitions
    assert (R.HALF_OPEN, R.CLOSED) in br.transitions
    assert br.opened_total == 2


def test_breaker_success_resets_failure_streak(R):
    br = R.CircuitBreaker(failure_threshold=2, clock=FakeClock())
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == R.CLOSED  # streak broken; not 2 consecutive


# --- Supervised -----------------------------------------------------------


class FlakyConn:
    def __init__(self, fail_ops=0):
        self.fail_ops = fail_ops
        self.ops = 0
        self.closed = False

    def op(self):
        self.ops += 1
        if self.fail_ops > 0:
            self.fail_ops -= 1
            raise ConnectionError("flaky op")
        return "ok"

    def close(self):
        self.closed = True


def _sup(R, name, factory, clock=None, **kw):
    clock = clock or FakeClock()
    kw.setdefault("policy", R.BackoffPolicy(base_s=0.001, max_s=0.01,
                                            max_retries=5, budget_s=100))
    return R.Supervised(
        name, factory, clock=clock, sleep=lambda s: None,
        rng=random.Random(3), **kw
    )


def test_supervised_reconnects_and_retries_op(R):
    conns = []

    def factory():
        c = FlakyConn()
        conns.append(c)
        return c

    sup = _sup(R, "t:retry", factory)
    first = sup.get()
    first.fail_ops = 1  # next op faults once
    assert sup.call(lambda c: c.op()) == "ok"
    assert len(conns) == 2  # faulted conn replaced
    assert conns[0].closed  # torn down, not leaked
    assert sup.retries_total == 1
    sup.close()


def test_supervised_retry_op_false_reraises_but_reconnects(R):
    conns = []

    def factory():
        c = FlakyConn()
        conns.append(c)
        return c

    sup = _sup(R, "t:noretry", factory)
    sup.get().fail_ops = 1
    with pytest.raises(ConnectionError):
        sup.call(lambda c: c.op(), retry_op=False)
    # the NEXT call runs on a fresh connection
    assert sup.call(lambda c: c.op()) == "ok"
    assert len(conns) == 2
    sup.close()


def test_supervised_on_reconnect_hooks_fire(R):
    seen = []

    sup = _sup(R, "t:hooks", FlakyConn, on_reconnect=[seen.append])
    c1 = sup.get()
    assert seen == [c1]  # prime runs hooks too
    sup.invalidate()
    c2 = sup.get()
    assert seen == [c1, c2] and c2 is not c1
    sup.close()


def test_supervised_dial_failure_exhausts_backoff(R):
    attempts = []

    def factory():
        attempts.append(1)
        raise ConnectionRefusedError("nobody home")

    sup = _sup(R, "t:down", factory)
    with pytest.raises(R.RetryBudgetExceeded):
        sup.get()
    assert len(attempts) > 1  # actually retried under backoff
    sup.close()


def test_supervised_breaker_opens_and_fails_fast(R):
    clock = FakeClock()
    breaker = R.CircuitBreaker(
        failure_threshold=2, reset_timeout_s=60.0, clock=clock
    )

    def factory():
        raise ConnectionRefusedError("down hard")

    sup = _sup(R, "t:breaker", factory, clock=clock, breaker=breaker)
    with pytest.raises(ConnectionError):
        sup.get()
    assert breaker.state == R.OPEN
    # breaker open: the next get fails in one shot, no dial attempts
    with pytest.raises(R.CircuitOpenError):
        sup.get()
    # cooldown -> half-open probe is admitted again (and fails -> open)
    clock.advance(61.0)
    with pytest.raises(ConnectionError):
        sup.get()
    assert breaker.state == R.OPEN
    sup.close()


def test_supervised_snapshot_and_registry(R):
    sup = _sup(R, "t:snap", FlakyConn)
    sup.get()
    snap = sup.snapshot()
    assert snap["breaker"] == R.CLOSED
    assert snap["connected"] and snap["connects_total"] == 1
    assert "t:snap" in R.resilience_snapshot()
    sup.close()
    assert "t:snap" not in R.resilience_snapshot()


def test_supervised_metrics_exported(R, pkg):
    REGISTRY = importlib.import_module(f"{pkg}.utils.metrics").REGISTRY

    sup = _sup(R, "t:metrics", FlakyConn)
    sup.get()
    text = REGISTRY.render()
    assert "gome_conn_breaker_state_t_metrics" in text
    assert "gome_conn_reconnects_total_t_metrics" in text
    sup.close()


def test_supervised_retry_count_mutates_under_lock(R):
    """Regression (found by gomelint GL401): Supervised.call() bumped
    retries_total OUTSIDE self._lock — a read-modify-write racing every
    concurrent caller (lost updates), while snapshot() reads the counter
    under the lock expecting the true value. The instrumentation below is
    deterministic: an owner-tracking lock + a __setattr__ probe raise at
    the exact off-lock write, instead of hoping a thread hammer happens
    to interleave."""
    import threading

    class OwnedRLock:
        def __init__(self):
            self._rlock = threading.RLock()
            self._owner = None
            self._depth = 0

        def acquire(self, blocking=True, timeout=-1):
            got = self._rlock.acquire(blocking, timeout)
            if got:
                self._owner = threading.get_ident()
                self._depth += 1
            return got

        def release(self):
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
            self._rlock.release()

        def __enter__(self):
            self.acquire()
            return self

        def __exit__(self, *exc):
            self.release()
            return False

        def held_by_me(self):
            return self._owner == threading.get_ident()

    conns = []

    def factory():
        c = FlakyConn()
        conns.append(c)
        return c

    sup = _sup(R, "t:retry-lock", factory)
    lock = OwnedRLock()
    object.__setattr__(sup, "_lock", lock)

    violations = []

    class Probe(type(sup)):
        def __setattr__(self, name, value):
            if name == "retries_total" and not lock.held_by_me():
                violations.append(name)
            super().__setattr__(name, value)

    object.__setattr__(sup, "__class__", Probe)

    first = sup.get()
    first.fail_ops = 1  # one fault -> one reconnect -> one retry
    assert sup.call(lambda c: c.op()) == "ok"
    assert sup.retries_total == 1
    assert violations == [], (
        f"retries_total written off-lock {len(violations)} time(s)"
    )
    sup.close()


def test_backoff_schedules_equal_across_packages():
    """The port's copy draws the reference's schedule for the same seed."""
    schedules = []
    for name in PACKAGES:
        R = importlib.import_module(f"{name}.utils.resilience")
        pol = R.BackoffPolicy(base_s=0.05, max_s=2.0, max_retries=30)
        schedules.append(list(R.backoff_delays(pol, random.Random(11))))
    assert schedules[0] == schedules[1]


# --- clients.doorder.send_batch_retrying (tests/test_fleet_chaos.py) -------


@pytest.fixture
def D(pkg):
    """The package's clients.doorder module."""
    return importlib.import_module(f"{pkg}.clients.doorder")


def _resp(code=0, accepted=0, reject_index=(), message=""):
    return SimpleNamespace(
        code=code, accepted=accepted, reject_index=list(reject_index),
        message=message,
    )


def test_send_batch_retrying_resubmits_only_the_tail(R, D):
    orders = [f"o{i}" for i in range(6)]
    cancels = [f"c{i}" for i in range(6)]
    seen = []
    sleeps = []
    script = [
        _resp(code=D.CODE_RETRYABLE, accepted=2, reject_index=[2],
              message="overloaded, queue depth 9 (retry-after=0.123s)"),
        _resp(code=0, accepted=3),
    ]

    def send(orders, cancel):
        seen.append((list(orders), list(cancel)))
        return script.pop(0)

    out = D.send_batch_retrying(
        send, orders, cancels,
        policy=R.BackoffPolicy(base_s=0.001, max_s=0.001),
        rng=random.Random(0), sleep=sleeps.append,
    )
    assert out == {"ok": 5, "rejected": 1, "aborted": 0, "retries": 1}
    # The consumed prefix is accepted + len(reject_index): the retry sends
    # exactly the unconsumed tail of both lists.
    assert seen[1] == (["o3", "o4", "o5"], ["c3", "c4", "c5"])
    assert len(sleeps) == 1
    assert sleeps[0] >= 0.123  # the server's hint floors the jitter


def test_send_batch_retrying_budget_exhaustion_aborts_tail(R, D):
    def send(orders, cancel):
        return _resp(code=D.CODE_RETRYABLE, accepted=1,
                     message="overloaded, queue depth 9 (retry-after=0.001s)")

    out = D.send_batch_retrying(
        send, [f"o{i}" for i in range(10)], None,
        policy=R.BackoffPolicy(base_s=0.0001, max_s=0.0001, max_retries=2),
        rng=random.Random(0), sleep=lambda s: None,
    )
    # Three sends (the first and two retries), one accepted each; the
    # rest aborts.
    assert out["ok"] == 3 and out["retries"] == 2 and out["aborted"] == 7


def test_send_batch_retrying_permanent_abort_not_resubmitted(D):
    sends = []

    def send(orders, cancel):
        sends.append(len(orders))
        return _resp(code=3, accepted=2, message="batch aborted at entry 2")

    out = D.send_batch_retrying(send, [f"o{i}" for i in range(5)], None,
                                sleep=lambda s: None)
    assert sends == [5]  # a permanent code is never resubmitted
    assert out == {"ok": 2, "rejected": 0, "aborted": 3, "retries": 0}
