"""Eraser-style dynamic lockset race detection (the dynamic prong of
gomerace; the static prong is analysis/threads.py's GL7xx family).

The port of ``gome_tpu/analysis/racecheck.py``: the same detector, and
``arm_service`` watches the same attributes of the port's MatchFeed,
SeqTracker, OrderConsumer, FrameBatcher and Persister.

The static checker reasons about *declared* contracts; this module
observes *actual* executions. It implements the classic lockset
algorithm (Savage et al., "Eraser", SOSP '97) over watched attributes:

  * every :class:`TrackedLock` records, per thread, the set of locks
    that thread currently holds;
  * each watched variable carries a *candidate lockset* — the locks
    held at EVERY access so far once the variable is shared between
    threads;
  * a write to a shared variable whose candidate set has emptied means
    no single lock consistently protected it: a race report, with the
    current access site AND the previous one (both sides of the race),
    deduplicated by a stable fingerprint.

State machine per variable (the Eraser refinement that avoids
init-then-publish false positives): EXCLUSIVE while only the first
thread has touched it (no tracking cost, no reports — single-threaded
init is fine); SHARED once a second thread reads it (candidate refines,
nothing reported — read-only sharing after init is fine); SHARED_MOD
once any thread writes it post-sharing (candidate refines and an empty
set reports).

Armament mirrors the tracer/faults contract: the module-level
:data:`RACECHECK` singleton is disabled by default, ``note_access`` is
one attribute check and zero allocations when disabled, and nothing in
the production paths imports this module except the ``GOME_RACECHECK=1``
hook in service/app.py (a local import behind an env check).

``watch(obj, attrs)`` rebinds an instance to a dynamic subclass exposing
each watched attribute as a data property feeding the detector — both
reads and writes, unlike analysis.runtime.instrument (which asserts on
writes only). ``arm_service(svc)`` applies it to the cross-thread
hotspots of a running EngineService; ``chip_smoke.race_drill`` drives
real gateway→bus→consumer→matchfeed traffic under it (on the CPU or the
card).

Known limits (by design, documented not hidden): container mutation via
method call (``list.append``) is an attribute *read* to the detector;
the GIL serializes the detector's own bookkeeping, so this finds
*discipline* violations (no consistent lock), not torn reads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import threading
import traceback

from .runtime import OwnedLock

#: Frames from these files are machinery, not race sites — dropped from
#: captured stacks so reports lead with the code under test.
_OWN_FILES = ("racecheck.py", "interleave.py", "runtime.py")

_EXCLUSIVE, _SHARED, _SHARED_MOD = 0, 1, 2

_labels = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class RaceReport:
    """One deduplicated lockset violation (both access sites)."""

    label: str  # watch() label, usually the class name
    attr: str
    kind: str  # "write/write" or "read/write"
    threads: tuple[str, str]  # (previous, current) thread names
    site_prev: tuple[str, ...]  # short stack, innermost last
    site_here: tuple[str, ...]
    fingerprint: str  # stable id (class.attr + both top frames)

    def format(self) -> str:
        here = self.site_here[-1] if self.site_here else "?"
        prev = self.site_prev[-1] if self.site_prev else "?"
        return (
            f"RACE {self.fingerprint} {self.label}.{self.attr} "
            f"[{self.kind}] {self.threads[1]} at {here} vs "
            f"{self.threads[0]} at {prev}"
        )


class _VarState:
    __slots__ = (
        "state", "owner", "candidate", "prev_site", "prev_thread",
    )

    def __init__(self, owner: int):
        self.state = _EXCLUSIVE
        self.owner = owner
        self.candidate: frozenset | None = None
        self.prev_site: tuple[str, ...] = ()
        self.prev_thread = ""


class _HeldLocal(threading.local):
    """Per-thread held-lock stack (threading.local: each thread sees its
    own ``locks`` list, so no cross-thread sharing to guard)."""

    def __init__(self):
        self.locks: list = []


def _short_stack(limit: int = 12) -> tuple[str, ...]:
    out = []
    for fr in traceback.extract_stack(limit=limit):
        fname = os.path.basename(fr.filename)
        if fname in _OWN_FILES:
            continue
        out.append(f"{fname}:{fr.lineno} in {fr.name}")
    return tuple(out[-6:])


class RaceCheck:
    """The lockset detector. One process-wide instance (:data:`RACECHECK`
    below); tests may build private ones."""

    def __init__(self):
        self._lock = threading.Lock()
        # The ONLY attribute the disabled hot path reads — see
        # note_access(); everything else is cold-path state.
        self.enabled = False  # guarded by self._lock
        self._vars: dict = {}  # guarded by self._lock ((label, attr) -> _VarState)
        self._reports: list[RaceReport] = []  # guarded by self._lock
        self._fingerprints: set[str] = set()  # guarded by self._lock
        self._suppressed: set[str] = set()  # guarded by self._lock
        self._held = _HeldLocal()

    # -- lifecycle -------------------------------------------------------
    def enable(self) -> "RaceCheck":
        """Arm the detector with fresh per-variable state (reports and
        suppressions persist across enable/disable cycles)."""
        with self._lock:
            self._vars = {}
            self.enabled = True
        return self

    def disable(self) -> None:
        with self._lock:
            self.enabled = False

    def reset(self) -> None:
        """Drop everything: variable state, reports, suppressions."""
        with self._lock:
            self._vars = {}
            self._reports = []
            self._fingerprints = set()
            self._suppressed = set()

    def suppress(self, key: str) -> None:
        """Silence reports whose ``label.attr`` or fingerprint equals
        ``key`` (the drill's allowlist for documented benign races; an
        entry here should cite WHY at the call site)."""
        with self._lock:
            self._suppressed.add(key)

    def reports(self, include_suppressed: bool = False) -> list[RaceReport]:
        with self._lock:
            reports = list(self._reports)
            suppressed = set(self._suppressed)
        if include_suppressed:
            return reports
        return [
            r for r in reports
            if r.fingerprint not in suppressed
            and f"{r.label}.{r.attr}" not in suppressed
        ]

    # -- lock tracking (TrackedLock calls these) -------------------------
    def _held_stack(self) -> list:
        return self._held.locks

    # -- the algorithm ---------------------------------------------------
    def note_access(self, label: str, attr: str, is_write: bool) -> None:
        """Feed one access. The disabled path is one attribute check and
        zero allocations (same contract as TRACER/JOURNAL/FAULTS —
        the tests hold it to getallocatedblocks)."""
        # gomelint: disable=GL402 — benign stale read: a bool load is one
        # bytecode under the GIL (merely stale, never torn); enable()
        # happens-before the first armed access in every harness.
        if not self.enabled:  # gomelint: hotpath  # gomelint: disable=GL402
            return
        tid = threading.get_ident()
        held = frozenset(self._held.locks)
        with self._lock:
            key = (label, attr)
            var = self._vars.get(key)
            if var is None:
                self._vars[key] = _VarState(tid)
                return
            if var.state == _EXCLUSIVE:
                if tid == var.owner:
                    return
                # Second thread: the variable is now shared. Candidate
                # lockset starts as what THIS access holds.
                var.state = _SHARED_MOD if is_write else _SHARED
                var.candidate = held
            else:
                var.candidate &= held
                if is_write:
                    var.state = _SHARED_MOD
            site = _short_stack()
            thread_name = threading.current_thread().name
            if (
                var.state == _SHARED_MOD
                and not var.candidate
                and var.prev_site
            ):
                self._report_locked(
                    label, attr, is_write, var, site, thread_name
                )
            var.prev_site = site
            var.prev_thread = thread_name

    def _report_locked(self, label, attr, is_write, var, site, thread_name):
        kind = "write/write" if is_write else "read/write"
        top_here = site[-1] if site else "?"
        top_prev = var.prev_site[-1] if var.prev_site else "?"
        base = label.split("#", 1)[0]  # instance counter is not stable
        fingerprint = hashlib.sha1(
            f"{base}.{attr}|{top_prev}|{top_here}".encode()
        ).hexdigest()[:12]
        if fingerprint in self._fingerprints:
            return
        self._fingerprints.add(fingerprint)
        self._reports.append(RaceReport(
            label=base,
            attr=attr,
            kind=kind,
            threads=(var.prev_thread, thread_name),
            site_prev=var.prev_site,
            site_here=site,
            fingerprint=fingerprint,
        ))


#: Process-wide detector, disabled by default (tracer/faults contract).
RACECHECK = RaceCheck()


class TrackedLock(OwnedLock):
    """An OwnedLock that feeds the detector's per-thread held set. Drops
    into any ``with self._lock:`` site; when the detector is disabled it
    behaves exactly like its parent (no bookkeeping)."""

    def __init__(self, name: str = "lock"):
        super().__init__()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = super().acquire(blocking, timeout)
        if got and RACECHECK.enabled:
            RACECHECK._held_stack().append(self)
        return got

    def release(self) -> None:
        if RACECHECK.enabled:
            stack = RACECHECK._held_stack()
            if self in stack:
                stack.remove(self)
        super().release()


def watch(obj, attrs, lock_attrs=("_lock",), label: str | None = None):
    """Arm lockset tracking on ``obj`` for the named attributes.

    Each named lock attribute (that exists) is replaced by a
    :class:`TrackedLock` — same interface, so the object's own ``with
    self._lock:`` sites work unchanged but become visible to the
    detector. The instance is then rebound to a one-off subclass where
    every watched attribute is a data property: reads and writes flow
    through :meth:`RaceCheck.note_access` while values stay in the
    instance ``__dict__``. Returns ``obj`` (re-watching an instance
    rebuilds the subclass from the original class)."""
    if isinstance(lock_attrs, str):
        lock_attrs = (lock_attrs,)
    for la in lock_attrs:
        cur = getattr(obj, la, None)
        if cur is not None and not isinstance(cur, TrackedLock):
            object.__setattr__(
                obj, la, TrackedLock(name=f"{type(obj).__name__}.{la}")
            )
    cls = type(obj)
    base = getattr(cls, "_racecheck_base", cls)
    if label is None:
        label = f"{base.__name__}#{next(_labels)}"
    ns: dict = {"_racecheck_label": label, "_racecheck_base": base}
    for attr in attrs:
        ns[attr] = _tracked_property(attr)
    sub = type(f"{base.__name__}@racecheck", (base,), ns)
    object.__setattr__(obj, "__class__", sub)
    return obj


def _tracked_property(name: str) -> property:
    def fget(self):
        RACECHECK.note_access(type(self)._racecheck_label, name, False)
        try:
            return self.__dict__[name]
        except KeyError:
            raise AttributeError(name) from None

    def fset(self, value):
        RACECHECK.note_access(type(self)._racecheck_label, name, True)
        self.__dict__[name] = value

    return property(fget, fset)


# -- service integration ---------------------------------------------------


def arm_service(svc) -> list:
    """Instrument the cross-thread hotspots of an EngineService: the
    matchfeed counters + SeqTracker, the consumer's seq frontier, and
    (when the gateway batches) the batcher's degraded-mode state. The
    attribute lists mirror the ``# guarded by`` / ``# single-writer``
    contracts those modules declare — the drill checks the contracts
    hold under real traffic. Returns the watched objects."""
    watched = []
    feed = getattr(svc, "feed", None)
    if feed is not None:
        watch(
            feed, ("events_seen", "suppressed"),
            lock_attrs=("_lock", "_life"), label="MatchFeed",
        )
        watch(
            feed.seq, ("last_seq", "dupes", "gaps", "observed"),
            lock_attrs=(), label="SeqTracker",
        )
        watched += [feed, feed.seq]
    consumer = getattr(svc, "consumer", None)
    if consumer is not None:
        watch(
            consumer,
            ("match_seq", "_seq_committed", "_fail_count",
             "_last_step_failed"),
            lock_attrs=("_life",), label="OrderConsumer",
        )
        watched.append(consumer)
    gateway = getattr(svc, "gateway", None)
    batcher = getattr(gateway, "_batcher", None)
    if batcher is not None:
        watch(
            batcher,
            ("degraded_seconds_total", "_degraded_since", "_oldest",
             "_stop"),
            lock_attrs=("_lock",), label="FrameBatcher",
        )
        watched.append(batcher)
    persist = getattr(svc, "persist", None)
    if persist is not None:
        watch(
            persist,
            ("snapshots_taken", "last_snapshot_unix",
             "last_snapshot_bytes"),
            lock_attrs=(), label="Persister",
        )
        watched.append(persist)
    return watched


def maybe_arm(svc) -> bool:
    """The ``GOME_RACECHECK=1`` hook (service/app.py calls this behind
    its own env check, via a local import — zero cost, zero imports in
    a normal boot). Enables the process-wide detector and instruments
    the service; returns whether it armed."""
    if os.environ.get("GOME_RACECHECK") != "1":
        return False
    RACECHECK.enable()
    arm_service(svc)
    return True
