"""Connection resilience — supervised reconnect with backoff, bounded retry
budgets, and circuit breakers for every external dependency.

The reference simply dies on transport faults (SURVEY §5: log.Fatalf on MQ
errors, per-message AMQP connections, no error recovery), and the first cut
of this port only guaranteed clients *fail loudly* — bus/amqp.py fails the
connection on any protocol desync and documents "callers reconnect fresh",
but no caller did. This module is that caller, shared by every external
connection (AMQP bus, RESP marker/snapshot store):

  backoff_delays  — exponential backoff with DECORRELATED jitter
                    (the AWS-architecture-blog variant: each delay is
                    uniform in [base, prev*3], clamped to max). Decorrelated
                    beats full jitter here because reconnect storms against
                    a just-restarted broker are the failure mode — a fleet
                    of consumers must not re-dial in lockstep.
  RetryBudget     — a bounded token budget for retries so a hard-down
                    dependency degrades to fail-fast instead of every
                    caller burning its full backoff schedule.
  CircuitBreaker  — the classic three-state machine (CLOSED → OPEN after
                    N consecutive failures; OPEN → HALF_OPEN after a
                    cooldown; HALF_OPEN admits probe calls and goes CLOSED
                    on success, back OPEN on failure). While OPEN, calls
                    fail in microseconds with CircuitOpenError instead of
                    stacking up behind connect timeouts.
  Supervised      — a connection supervisor owning one live connection of
                    type T behind a factory: call() runs an operation,
                    classifies ConnectionError/OSError as connection
                    faults, tears the connection down, reconnects under
                    backoff + breaker, fires on-reconnect re-setup hooks,
                    and retries the operation. Per-connection state
                    (breaker state, retry/reconnect counts, time degraded)
                    is registered in utils.metrics.REGISTRY and in a
                    module-level table that service/health.py snapshots
                    into /healthz.

Everything is deterministic under test: the clock, sleeper, and RNG are
injectable (tests drive breaker cooldowns and jitter bounds without real
sleeping).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from .logging import get_logger
from .metrics import REGISTRY

log = get_logger("resilience")

__all__ = [
    "BackoffPolicy",
    "backoff_delays",
    "RetryBudget",
    "RetryBudgetExceeded",
    "CircuitBreaker",
    "CircuitOpenError",
    "Supervised",
    "resilience_snapshot",
    "CONNECTION_FAULTS",
]

#: Exception types every supervisor treats as "the connection is gone" —
#: socket-layer faults and the protocol clients' documented ConnectionError
#: surface (amqp.py / resp.py raise nothing rawer than these).
CONNECTION_FAULTS = (ConnectionError, OSError)


class RetryBudgetExceeded(ConnectionError):
    """Retries exhausted their budget; the dependency is treated as down."""


class CircuitOpenError(ConnectionError):
    """Fail-fast reject: the breaker is OPEN and the cooldown has not
    elapsed. Subclasses ConnectionError so callers' existing fault
    handling (gateway rejects, consumer replay) applies unchanged."""


@dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with decorrelated jitter, bounded by a budget.

    base_s/max_s bound each individual delay; max_retries and budget_s
    bound the whole schedule (whichever trips first) — a supervisor never
    blocks a caller longer than ~budget_s before declaring the dependency
    down and failing fast."""

    base_s: float = 0.05
    max_s: float = 2.0
    max_retries: int = 8
    budget_s: float = 15.0

    def __post_init__(self):
        if self.base_s <= 0 or self.max_s < self.base_s:
            raise ValueError("need 0 < base_s <= max_s")
        if self.max_retries < 1 or self.budget_s <= 0:
            raise ValueError("max_retries and budget_s must be positive")


def backoff_delays(policy: BackoffPolicy, rng: random.Random | None = None):
    """Yield up to policy.max_retries delays with decorrelated jitter:
    d0 = base; d(n+1) ~ Uniform(base, 3*d(n)), clamped to max_s. Every
    delay is guaranteed within [base_s, max_s]."""
    rng = rng or random
    prev = policy.base_s
    for _ in range(policy.max_retries):
        yield prev
        prev = min(policy.max_s, rng.uniform(policy.base_s, prev * 3.0))


class RetryBudget:
    """Token-bucket retry budget (Finagle-style): `rate` tokens accrue per
    second up to `burst`; each retry spends one. When empty, try_spend()
    refuses — callers fail fast instead of amplifying load on a dependency
    that is hard-down. Thread-safe."""

    def __init__(
        self, rate: float = 10.0, burst: float = 20.0, clock=time.monotonic
    ):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = rate
        self.burst = burst
        self._clock = clock
        self._tokens = burst  # guarded by self._lock
        self._last = clock()  # guarded by self._lock
        self._lock = threading.Lock()

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def tokens(self) -> float:
        with self._lock:
            now = self._clock()
            return min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )


# Breaker states (exported as the gauge value — keep the encoding stable,
# dashboards key on it).
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Three-state circuit breaker. Thread-safe; clock injectable.

    CLOSED:    calls flow; `failure_threshold` CONSECUTIVE failures trip
               it OPEN (a success resets the streak).
    OPEN:      allow() refuses until `reset_timeout_s` elapses, then the
               next allow() transitions to HALF_OPEN and admits probes.
    HALF_OPEN: up to `half_open_max` concurrent probes; one success closes
               the breaker, one failure re-opens it (cooldown restarts).
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_s: float = 5.0,
        half_open_max: int = 1,
        clock=time.monotonic,
        on_transition=None,
    ):
        if failure_threshold < 1 or half_open_max < 1:
            raise ValueError("thresholds must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max = half_open_max
        self._clock = clock
        self._on_transition = on_transition  # callable(old, new) | None
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded by self._lock
        self._failures = 0  # guarded by self._lock (consecutive, CLOSED)
        self._opened_at = 0.0  # guarded by self._lock
        self._probes = 0  # guarded by self._lock (in-flight HALF_OPEN probes)
        self.transitions: list[tuple[str, str]] = []  # guarded by self._lock
        self.opened_total = 0  # guarded by self._lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_locked()

    def _peek_locked(self) -> str:
        """Current state with the OPEN→HALF_OPEN cooldown applied (read
        path must see the same state allow() would act on)."""
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            return HALF_OPEN
        return self._state

    def _transition_locked(self, new: str) -> None:
        old, self._state = self._state, new
        if old != new:
            if len(self.transitions) < 64:  # bounded: tests/healthz only
                self.transitions.append((old, new))
            if new == OPEN:
                self.opened_total += 1
                self._opened_at = self._clock()
            if new == HALF_OPEN:
                self._probes = 0
            if new == CLOSED:
                self._failures = 0
            cb = self._on_transition
            if cb is not None:
                try:
                    cb(old, new)
                except Exception:
                    log.exception("breaker transition callback failed")

    def allow(self) -> bool:
        """May a call proceed right now? HALF_OPEN admission counts the
        caller as a probe — pair every allow()==True with exactly one
        record_success()/record_failure()."""
        with self._lock:
            state = self._peek_locked()
            if state != self._state:
                self._transition_locked(state)
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                if self._probes < self.half_open_max:
                    self._probes += 1
                    return True
                return False
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state == HALF_OPEN:
                self._transition_locked(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            state = self._peek_locked()
            if state != self._state:
                self._transition_locked(state)
            if self._state == HALF_OPEN:
                self._transition_locked(OPEN)
            elif self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._transition_locked(OPEN)
            else:  # OPEN: failure while open restarts nothing; stays open
                pass

    def state_code(self) -> int:
        return _STATE_CODE[self.state]


# Module-level supervisor table: service/health.py snapshots this into
# /healthz so every supervised connection in the process self-reports.
_SUPERVISORS: dict[str, "Supervised"] = {}
_SUPERVISORS_LOCK = threading.Lock()


def resilience_snapshot() -> dict:
    """{name: state-dict} for every live Supervised in this process."""
    with _SUPERVISORS_LOCK:
        sups = list(_SUPERVISORS.values())
    return {s.name: s.snapshot() for s in sups}


def _metric_name(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name.lower())


class Supervised:
    """One supervised connection of type T behind a zero-arg factory.

    call(fn) runs fn(conn) against the live connection. A CONNECTION_FAULTS
    exception tears the connection down and, breaker and retry budget
    permitting, reconnects under the backoff policy, fires every
    on-reconnect hook with the fresh connection (topology re-declare,
    AUTH/SELECT replay, consume resume), and retries fn ONCE per fresh
    connection. Exhausted backoff/budget or an open breaker surfaces as a
    ConnectionError subclass, so callers keep their existing fault
    handling.

    retry_op=False turns off the operation retry (reconnect still
    happens): for non-idempotent operations the caller owns replay —
    e.g. a bus commit whose at-least-once contract already covers it.
    """

    def __init__(
        self,
        name: str,
        factory,
        policy: BackoffPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        budget: RetryBudget | None = None,
        on_reconnect=(),
        close=lambda conn: conn.close(),
        clock=time.monotonic,
        sleep=time.sleep,
        rng: random.Random | None = None,
    ):
        self.name = name
        self.factory = factory
        self.policy = policy or BackoffPolicy()
        self.breaker = breaker or CircuitBreaker(clock=clock)
        self.budget = budget or RetryBudget(clock=clock)
        self.on_reconnect = list(on_reconnect)
        self._close = close
        self._clock = clock
        self._sleep = sleep
        self._rng = rng
        self._lock = threading.RLock()
        self._conn = None  # guarded by self._lock
        self.connects_total = 0  # guarded by self._lock (successful dials)
        self.retries_total = 0  # guarded by self._lock (op retries)
        self.faults_total = 0  # guarded by self._lock (faults observed)
        self._degraded_since: float | None = None  # guarded by self._lock
        self.degraded_seconds_total = 0.0  # guarded by self._lock
        with _SUPERVISORS_LOCK:
            _SUPERVISORS[name] = self
        m = _metric_name(name)
        self._g_state = REGISTRY.gauge(
            f"gome_conn_breaker_state_{m}",
            f"breaker state for {name} (0 closed, 1 half-open, 2 open)",
        )
        self._c_reconnects = REGISTRY.counter(
            f"gome_conn_reconnects_total_{m}", f"reconnects for {name}"
        )
        self._c_retries = REGISTRY.counter(
            f"gome_conn_retries_total_{m}", f"operation retries for {name}"
        )
        self._g_degraded = REGISTRY.gauge(
            f"gome_conn_degraded_seconds_{m}",
            f"seconds {name} has been degraded (0 when healthy)",
        )

    # -- state -------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            degraded_s = (
                now - self._degraded_since if self._degraded_since else 0.0
            )
            return dict(
                breaker=self.breaker.state,
                connected=self._conn is not None,
                connects_total=self.connects_total,
                retries_total=self.retries_total,
                faults_total=self.faults_total,
                degraded_s=degraded_s,
                degraded_seconds_total=self.degraded_seconds_total
                + degraded_s,
                breaker_opened_total=self.breaker.opened_total,
            )

    def _enter_degraded_locked(self) -> None:
        if self._degraded_since is None:
            self._degraded_since = self._clock()

    def _exit_degraded_locked(self) -> None:
        if self._degraded_since is not None:
            self.degraded_seconds_total += (
                self._clock() - self._degraded_since
            )
            self._degraded_since = None
        self._g_degraded.set(0.0)

    def _export_locked(self) -> None:
        self._g_state.set(self.breaker.state_code())
        if self._degraded_since is not None:
            self._g_degraded.set(self._clock() - self._degraded_since)

    # -- connection lifecycle ----------------------------------------------
    def get(self):
        """The live connection, dialing (under backoff + breaker) if there
        is none. Raises a ConnectionError subclass when the dependency is
        down/refused."""
        with self._lock:
            if self._conn is not None:
                return self._conn
            return self._reconnect_locked()

    def prime(self):
        """Dial ONCE, no backoff: boot-time construction wants a fast
        loud failure (make_bus falls back to the memory backend on it),
        not a full reconnect schedule. Runs the on-reconnect hooks so a
        primed connection is indistinguishable from a reconnected one."""
        with self._lock:
            if self._conn is not None:
                return self._conn
            conn = self.factory()
            self.breaker.record_success()
            self.connects_total += 1
            self._c_reconnects.inc()
            self._exit_degraded_locked()
            self._conn = conn
            self._export_locked()
            for hook in self.on_reconnect:
                hook(conn)
            return conn

    def invalidate(self, exc: BaseException | None = None) -> None:
        """Tear the current connection down (observed dead elsewhere, e.g.
        a background reader). The next call()/get() reconnects."""
        with self._lock:
            self._fault_locked(exc)

    def _fault_locked(self, exc) -> None:
        self.faults_total += 1
        self.breaker.record_failure()
        self._enter_degraded_locked()
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                self._close(conn)
            except Exception:
                pass
        self._export_locked()
        if exc is not None:
            log.warning("%s: connection fault: %s", self.name, exc)

    def _reconnect_locked(self):
        """Dial a fresh connection under the backoff schedule. Every
        attempt passes through the breaker; an OPEN breaker fails fast."""
        last: BaseException | None = None
        deadline = self._clock() + self.policy.budget_s
        for i, delay in enumerate(
            backoff_delays(self.policy, self._rng)
        ):
            if not self.breaker.allow():
                raise CircuitOpenError(
                    f"{self.name}: circuit open (dependency down; "
                    f"retry after ~{self.breaker.reset_timeout_s:.1f}s)"
                )
            if i > 0 and not self.budget.try_spend():
                raise RetryBudgetExceeded(
                    f"{self.name}: retry budget exhausted"
                )
            try:
                conn = self.factory()
            except CONNECTION_FAULTS as e:
                last = e
                self.breaker.record_failure()
                self.faults_total += 1
                self._enter_degraded_locked()
                self._export_locked()
                if self._clock() + delay > deadline:
                    break
                self._sleep(delay)
                continue
            self.breaker.record_success()
            self.connects_total += 1
            self._c_reconnects.inc()
            self._exit_degraded_locked()
            self._conn = conn
            self._export_locked()
            for hook in self.on_reconnect:
                try:
                    hook(conn)
                except CONNECTION_FAULTS as e:
                    # Hook hit a dead connection: treat like a dial fault
                    # and keep backing off.
                    last = e
                    self._fault_locked(e)
                    break
            else:
                if self.connects_total > 1:
                    log.info(
                        "%s: reconnected (attempt %d)", self.name, i + 1
                    )
                return conn
        raise RetryBudgetExceeded(
            f"{self.name}: reconnect failed after backoff budget "
            f"({self.policy.max_retries} tries/{self.policy.budget_s}s): "
            f"{last}"
        ) from last

    # -- the operation surface ---------------------------------------------
    def call(self, fn, retry_op: bool = True):
        """Run fn(conn) with supervised reconnect. One retry per fresh
        connection, bounded overall by the backoff budget (reconnect
        itself does the waiting). With retry_op=False a connection fault
        still tears down + reconnects but the original exception is
        re-raised — callers whose contract already replays (at-least-once
        consumers) keep exactly-one-application semantics."""
        attempts = self.policy.max_retries + 1
        for attempt in range(attempts):
            conn = self.get()
            try:
                out = fn(conn)
            except CONNECTION_FAULTS as e:
                with self._lock:
                    # Only fault the connection fn actually used — a
                    # concurrent caller may already have reconnected.
                    if self._conn is conn:
                        self._fault_locked(e)
                if not retry_op or attempt + 1 >= attempts:
                    raise
                with self._lock:
                    # Unlocked, concurrent callers' += lost updates (the
                    # read-modify-write interleaves); snapshot() reads it
                    # under the lock and deserves the true count.
                    self.retries_total += 1
                self._c_retries.inc()
                continue
            self.breaker.record_success()
            with self._lock:
                self._export_locked()
            return out

    def close(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
            if conn is not None:
                try:
                    self._close(conn)
                except Exception:
                    pass
        with _SUPERVISORS_LOCK:
            if _SUPERVISORS.get(self.name) is self:
                del _SUPERVISORS[self.name]
