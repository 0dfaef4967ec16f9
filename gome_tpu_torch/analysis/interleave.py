"""Deterministic seeded interleaving driver (race regression harness).

The port of ``gome_tpu/analysis/interleave.py`` (a copy: the same seed
gives the same schedule trace).

A race report is only actionable if the schedule that exposed it can be
replayed. This module runs N worker callables under a *cooperative*
scheduler: exactly one worker executes at a time, and every context
switch happens at an explicit yield point — a ``step()`` call made by
the worker itself or by an instrumented primitive (:class:`SteppingLock`,
:class:`SteppingEvent`) dropped into the code under test. The next
worker is drawn from a seeded RNG, so

  * the full schedule is captured as a trace (list of worker indices),
  * the same seed replays the same schedule, bit for bit — a seed that
    exposes a race goes straight into a regression test,
  * sweeping seeds explores distinct interleavings deterministically.

This is the regression-side companion of analysis.racecheck: the lockset
detector *finds* a race under free-running threads; the interleaver
*pins* the offending schedule so the fix's test can prove the window is
closed on the exact interleaving that used to lose.

Blocking under a cooperative scheduler
--------------------------------------
A descheduled worker holds whatever real locks it holds. If the
scheduled worker then blocks on one of them, nobody ever yields again —
the classic cooperative-scheduler deadlock. The rule: any primitive a
worker can block on inside the explored region must be *stepping*:

  * :class:`SteppingLock` converts a blocking acquire into a
    try-acquire/yield/retry poll, so contention becomes schedule points
    instead of an invisible block;
  * :class:`SteppingEvent` yields around the mutating calls (``set`` /
    ``clear``), making a check-then-act window that spans one of them
    explorable.

Threads spawned *by* the code under test (e.g. a service loop) are not
scheduled: ``step()`` from an unregistered thread is a no-op, so the
spawned thread free-runs while the workers stay deterministic. A worker
that stays blocked anyway trips the watchdog and the run fails with
:class:`InterleaveDeadlock` naming the stuck worker.
"""

from __future__ import annotations

import random
import threading
import time


class InterleaveDeadlock(RuntimeError):
    """The scheduled worker made no progress within the watchdog window
    (it is almost certainly blocked on a non-stepping primitive held by
    a descheduled worker)."""


class Interleaver:
    """One seeded schedule over N workers. Single-use: build, ``run``,
    inspect ``trace`` / ``results`` / ``errors``."""

    def __init__(self, seed: int = 0, timeout_s: float = 10.0):
        self.seed = seed
        self.timeout_s = timeout_s
        self._rng = random.Random(seed)
        self._cv = threading.Condition()
        self._ident = threading.local()  # .idx on registered workers
        self.trace: list[int] = []  # guarded by self._cv (schedule order)
        self._alive: list[int] = []  # guarded by self._cv
        self._turn: int | None = None  # guarded by self._cv
        self.results: list[object] = []  # guarded by self._cv (per worker)
        self.errors: list[BaseException | None] = []  # guarded by self._cv

    # -- yield point (the public hook) ----------------------------------
    def step(self) -> None:
        """Yield to the scheduler: pick the next worker (possibly this
        one) and block until rescheduled. No-op from threads the driver
        did not spawn, so instrumented primitives are safe to leave in
        place while service loops run."""
        idx = getattr(self._ident, "idx", None)
        if idx is None:
            return
        with self._cv:
            self._pick_locked()
            self._wait_turn_locked(idx)

    # -- internals ------------------------------------------------------
    def _pick_locked(self) -> None:
        if self._alive:
            self._turn = self._rng.choice(self._alive)
            self.trace.append(self._turn)
            self._cv.notify_all()

    def _wait_turn_locked(self, idx: int) -> None:
        deadline = time.monotonic() + self.timeout_s
        while self._turn != idx:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._cv.wait(remaining):
                raise InterleaveDeadlock(
                    f"worker {idx} starved waiting for its turn (turn is "
                    f"{self._turn}; a descheduled worker likely holds a "
                    f"non-stepping lock)"
                )

    def _worker(self, idx: int, fn) -> None:
        self._ident.idx = idx
        try:
            with self._cv:
                self._wait_turn_locked(idx)
            result = fn(self.step)
            with self._cv:
                self.results[idx] = result
        except BaseException as e:  # workers report, the driver decides
            with self._cv:
                self.errors[idx] = e
        finally:
            with self._cv:
                self._alive.remove(idx)
                self._turn = None
                self._pick_locked()

    # -- driver ---------------------------------------------------------
    def run(self, *fns) -> list[int]:
        """Run the workers to completion under one seeded schedule.

        Each ``fn`` is called as ``fn(step)`` — workers thread the yield
        callable into whatever they drive. Worker exceptions are
        *collected*, not raised (a regression test often EXPECTS one
        loser to raise); read ``errors[i]`` / ``results[i]``. Returns
        the schedule trace."""
        if not fns:
            return []
        with self._cv:
            self._alive = list(range(len(fns)))
            self.results = [None] * len(fns)
            self.errors = [None] * len(fns)
            self._pick_locked()
        threads = [
            threading.Thread(
                target=self._worker,
                args=(i, fn),
                name=f"interleave-{self.seed}-{i}",
                daemon=True,
            )
            for i, fn in enumerate(fns)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout_s + 5.0)
            if t.is_alive():
                raise InterleaveDeadlock(
                    f"{t.name} never finished (schedule wedged)"
                )
        with self._cv:  # join() is the happens-before; the lock is form
            return list(self.trace)


class SteppingLock:
    """``threading.Lock`` drop-in whose blocking acquire polls: try, and
    on contention yield to the scheduler and retry. A worker blocked on
    a lock held by a descheduled worker thereby keeps yielding until the
    holder is scheduled and releases — contention becomes schedule
    points instead of a cooperative deadlock."""

    def __init__(self, step):
        self._lock = threading.Lock()
        self._step = step

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not blocking:
            return self._lock.acquire(False)
        while not self._lock.acquire(False):
            self._step()
        return True

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class SteppingEvent:
    """``threading.Event`` wrapper that yields to the scheduler before
    the mutating calls. Dropping one into an object under test turns a
    ``clear()`` (or ``set()``) inside a suspected race window into an
    explicit schedule point — the exact spot a seeded schedule can
    deschedule one worker mid-window."""

    def __init__(self, step):
        self._event = threading.Event()
        self._step = step

    def set(self) -> None:
        self._step()
        self._event.set()

    def clear(self) -> None:
        self._step()
        self._event.clear()

    def is_set(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)
