"""Deterministic, seeded fault injection for crash-consistency testing
(the port's copy of ``gome_tpu/utils/faults.py``, with its own FAULTS).

The registry follows the tracer/journal contract (see utils/trace.py):
a module-level ``FAULTS`` singleton that is disabled by default, where
the hot-path hook — ``FAULTS.fire("point")`` — costs one attribute
check and ZERO allocations when no plan is installed.  Production code
threads named injection points through the service and persist layers;
tests and ``scripts/chaos.py`` arm the registry with a ``FaultPlan``
(seed + schedule) so every crash is a reproducible artifact.

Injection points are plain strings.  The catalogue lives in
ARCHITECTURE.md ("Crash consistency & fault injection"); the load-bearing
ones are:

    consumer.frame    -- fired once per consumed order message; ``exit``
                         mode here is the classic kill-between-frames.
    consumer.commit   -- fired between matchfeed publish and order-queue
                         commit: the at-least-once window.
    filelog.append    -- fired at the top of FileQueue.publish; ``torn``
                         mode writes a prefix of the record and hard-exits.
    filelog.offset    -- fired in FileQueue._write_offset; ``torn`` mode
                         leaves a truncated decimal in the sidecar.
    snapshot.rename   -- fired before SnapshotStore's atomic rename;
                         ``exit`` crashes pre-publish, ``torn`` publishes
                         a snapshot with a truncated manifest.

Trigger semantics per spec: the hit counter for a point is 1-based and
monotonic for the life of the plan; a spec triggers when the hit is in
``at``, or ``every`` divides it, or a seeded coin with ``prob`` comes up.
``times`` bounds how often a spec may trigger (-1 = unbounded).  Modes:

    exit   -- os._exit(EXIT_CODE): a real, unclean process death.  No
              atexit handlers, no flushes — the point.
    raise  -- raise FaultInjected (for in-process tests).
    torn   -- return a seeded positive int; the call site interprets it
              as a cut position (``cut % len(payload)``) and performs
              its own torn write + hard exit.  fire() returning 0 means
              "no fault"; call sites must treat 0 as the clean path.
    call   -- invoke a handler registered via FAULTS.handler(name, fn);
              ties counted points to environmental faults like broker
              kill_connections or RESP restarts.

Determinism: every spec gets its own ``random.Random`` seeded from
``plan.seed ^ crc32(point:index)`` — stable across processes (unlike
``hash``, which is salted per interpreter).
"""

from __future__ import annotations

import json
import os
import random
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Callable

# Chaos children exit with this code on an injected death so the parent
# can tell an injected kill from a genuine crash (which would be a bug).
EXIT_CODE = 86

_MODES = ("exit", "raise", "torn", "call")


class FaultInjected(RuntimeError):
    """Raised by ``raise``-mode faults."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault at one named injection point."""

    point: str
    mode: str = "exit"
    at: tuple[int, ...] = ()
    every: int = 0
    prob: float = 0.0
    times: int = -1
    handler: str = ""

    def __post_init__(self) -> None:
        if self.mode not in _MODES:
            raise ValueError(f"fault mode must be one of {_MODES}: {self.mode!r}")
        if self.mode == "call" and not self.handler:
            raise ValueError("call-mode fault needs a handler name")
        if not self.point:
            raise ValueError("fault point must be non-empty")

    def to_dict(self) -> dict[str, Any]:
        return {
            "point": self.point,
            "mode": self.mode,
            "at": list(self.at),
            "every": self.every,
            "prob": self.prob,
            "times": self.times,
            "handler": self.handler,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultSpec":
        return cls(
            point=str(d["point"]),
            mode=str(d.get("mode", "exit")),
            at=tuple(int(x) for x in d.get("at", ())),
            every=int(d.get("every", 0)),
            prob=float(d.get("prob", 0.0)),
            times=int(d.get("times", -1)),
            handler=str(d.get("handler", "")),
        )


@dataclass(frozen=True)
class FaultPlan:
    """A reproducible fault schedule: seed + specs.

    The whole plan round-trips through JSON so a chaos run can pin the
    exact schedule it executed into its verdict artifact.
    """

    seed: int = 0
    faults: tuple[FaultSpec, ...] = ()

    def to_dict(self) -> dict[str, Any]:
        return {"seed": self.seed, "faults": [f.to_dict() for f in self.faults]}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultPlan":
        return cls(
            seed=int(d.get("seed", 0)),
            faults=tuple(FaultSpec.from_dict(f) for f in d.get("faults", ())),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))


@dataclass
class _Armed:
    """Mutable per-spec trigger state (exists only while a plan is live)."""

    spec: FaultSpec
    rng: random.Random
    fired: int = 0


class FaultRegistry:
    """Module singleton; see module docstring for the contract.

    ``fire(point) -> int`` returns 0 on the clean path.  A positive
    return is a torn-mode cut hint.  ``exit`` mode never returns.
    """

    def __init__(self) -> None:
        # The ONLY attribute the disabled hot path reads — see fire().
        self.enabled = False  # guarded by self._lock
        self._lock = threading.Lock()
        self._plan: FaultPlan | None = None  # guarded by self._lock
        self._by_point: dict[str, list[_Armed]] = {}  # guarded by self._lock
        self._hits: dict[str, int] = {}  # guarded by self._lock
        self._fired_log: list[dict[str, Any]] = []  # guarded by self._lock
        self._handlers: dict[str, Callable[[], None]] = {}  # guarded by self._lock
        # Injectable for tests; chaos children die through this.
        self._exit: Callable[[int], None] = os._exit

    # -- arming ---------------------------------------------------------

    def install(self, plan: FaultPlan) -> None:
        with self._lock:
            self._plan = plan
            self._by_point = {}
            self._hits = {}
            self._fired_log = []
            for i, spec in enumerate(plan.faults):
                salt = zlib.crc32(f"{spec.point}:{i}".encode())
                armed = _Armed(spec=spec, rng=random.Random(plan.seed ^ salt))
                self._by_point.setdefault(spec.point, []).append(armed)
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._plan = None
            self._by_point = {}

    def handler(self, name: str, fn: Callable[[], None]) -> None:
        """Register (or replace) a call-mode handler. Safe while disabled."""
        with self._lock:
            self._handlers[name] = fn

    # -- hot path -------------------------------------------------------

    def fire(self, point: str) -> int:
        # gomelint: disable=GL402 — benign stale read: a bool load is one
        # bytecode under the GIL (merely stale, never torn), and install()
        # happens-before the first armed fire in every harness.
        if not self.enabled:  # gomelint: hotpath  # gomelint: disable=GL402
            return 0
        return self._fire_armed(point)

    def _fire_armed(self, point: str) -> int:
        with self._lock:
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            pending: list[_Armed] = []
            for armed in self._by_point.get(point, ()):
                spec = armed.spec
                if spec.times >= 0 and armed.fired >= spec.times:
                    continue
                trig = (
                    hit in spec.at
                    or (spec.every > 0 and hit % spec.every == 0)
                    or (spec.prob > 0.0 and armed.rng.random() < spec.prob)
                )
                if trig:
                    armed.fired += 1
                    self._fired_log.append(
                        {"point": point, "mode": spec.mode, "hit": hit}
                    )
                    pending.append(armed)
            handlers = [
                self._handlers.get(a.spec.handler)
                for a in pending
                if a.spec.mode == "call"
            ]
        # Act outside the lock: handlers may call back into the bus, and
        # exit/raise must not hold it.
        cut = 0
        for armed in pending:
            mode = armed.spec.mode
            if mode == "exit":
                self._exit(EXIT_CODE)
            elif mode == "raise":
                raise FaultInjected(f"{point} (hit {hit})")
            elif mode == "torn":
                cut = 1 + armed.rng.randrange(1 << 20)
        for fn in handlers:
            if fn is not None:
                fn()
        return cut

    # -- helpers for call sites ----------------------------------------

    def hard_exit(self) -> None:
        """Die now, uncleanly (used by torn-write call sites after the cut)."""
        self._exit(EXIT_CODE)

    # -- introspection --------------------------------------------------

    def report(self) -> dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "plan": self._plan.to_dict() if self._plan is not None else None,
                "hits": dict(self._hits),
                "fired": list(self._fired_log),
            }


FAULTS = FaultRegistry()
