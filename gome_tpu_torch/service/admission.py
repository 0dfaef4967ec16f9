"""Gateway admission control — end-to-end overload protection (round 12).

The batcher's Backpressure (spill full) only fires once the *bus* is
down; a healthy bus in front of a slow consumer accepts frames forever
while the committed-offset gap — `gome_bus_depth`, the real end-to-end
lag — grows without bound. This controller closes that loop: the
gateway asks `admit()` before marking/emitting, and when consumer lag
crosses the depth ceiling (or the caller's gRPC deadline is already too
tight to survive the queue), the order is shed with the established
RETRYABLE status (code 14) plus a machine-parseable retry-after hint
that scales with overload — clients with utils.resilience back off
instead of hammering a drowning fleet (CoinTossX's flow-control stance:
shed early at the edge, never collapse in the middle).

Depth is sampled through a cached `depth_fn` read: admission sits on the
per-RPC hot path, and the committed-offset gap moves at frame cadence,
not per order — a `cache_s` stale read is indistinguishable from racing
the consumer's next commit.

The port of ``gome_tpu/service/admission.py``, decision for decision.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

from ..utils.metrics import REGISTRY

#: retry-after hints are embedded in the reject message as
#: `retry-after=<seconds>s`; clients parse with RETRY_AFTER_RE (the
#: wire OrderResponse has no header field to carry it — reference shape).
RETRY_AFTER_FMT = "retry-after={:.3f}s"


@dataclass(frozen=True)
class Decision:
    """One admission verdict. `ok` admits; otherwise `reason` is
    "depth" (queue over the ceiling) or "deadline" (caller's remaining
    gRPC deadline cannot survive current lag) and `retry_after_s` is the
    backoff hint for the reject message."""

    ok: bool
    reason: str = ""
    retry_after_s: float = 0.0
    depth: int = 0

    def message(self) -> str:
        hint = RETRY_AFTER_FMT.format(self.retry_after_s)
        if self.reason == "deadline":
            return f"overloaded, deadline too tight ({hint})"
        return f"overloaded, queue depth {self.depth} ({hint})"


class AdmissionController:
    """Depth- and deadline-based load shedding for the order gateway.

    depth_fn        () -> int: consumer lag for the order path — wire
                    `bus.order_queue.depth` (published minus committed,
                    the gap `gome_bus_depth` exports).
    max_depth       admit while depth < max_depth; at/above it new
                    orders are shed retryable. The ceiling bounds
                    worst-case queueing delay: max_depth / drain-rate.
    min_deadline_s  shed when the caller's remaining gRPC deadline is
                    below this — the reply would be DEADLINE_EXCEEDED
                    garbage anyway, so spend zero pipeline work on it.
    retry_after_s   base hint at the ceiling; the hint scales linearly
                    with overshoot (2x ceiling -> 2x hint) and clamps at
                    `retry_after_max_s`, so a deeply backed-up fleet
                    pushes retries further out instead of inviting a
                    synchronized stampede.
    cache_s         depth_fn sample cache window (see module docstring).
    """

    def __init__(
        self,
        depth_fn: Callable[[], int],
        max_depth: int = 16384,
        min_deadline_s: float = 0.0,
        retry_after_s: float = 0.05,
        retry_after_max_s: float = 2.0,
        cache_s: float = 0.005,
        registry=REGISTRY,
    ):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if retry_after_s <= 0 or retry_after_max_s < retry_after_s:
            raise ValueError(
                "need 0 < retry_after_s <= retry_after_max_s"
            )
        self.depth_fn = depth_fn
        self.max_depth = max_depth
        self.min_deadline_s = min_deadline_s
        self.retry_after_s = retry_after_s
        self.retry_after_max_s = retry_after_max_s
        self.cache_s = cache_s
        self._lock = threading.Lock()
        self._cached_depth = 0  # guarded by self._lock
        self._cached_at = -1.0  # guarded by self._lock
        self._shed_depth = registry.counter(
            "gome_gateway_shed_total",
            "orders shed at admission (by reason)",
            labels={"reason": "depth"},
        )
        self._shed_deadline = registry.counter(
            "gome_gateway_shed_total",
            "orders shed at admission (by reason)",
            labels={"reason": "deadline"},
        )
        registry.callback_gauge(
            "gome_gateway_admission_depth",
            "last consumer-lag sample the admission controller acted on",
            lambda: self._cached_depth,  # gomelint: disable=GL402 — stale read is the design
        )

    def depth(self) -> int:
        """Cached consumer-lag sample (refreshes after cache_s)."""
        now = time.monotonic()
        with self._lock:
            if now - self._cached_at >= self.cache_s:
                self._cached_depth = int(self.depth_fn())
                self._cached_at = now
            return self._cached_depth

    def _hint(self, depth: int) -> float:
        over = depth / self.max_depth if self.max_depth else 1.0
        return min(
            max(self.retry_after_s * over, self.retry_after_s),
            self.retry_after_max_s,
        )

    def admit(
        self, n: int = 1, time_remaining_s: float | None = None
    ) -> Decision:  # gomelint: hotpath
        """Admission verdict for `n` incoming orders. `time_remaining_s`
        is the caller's remaining gRPC deadline (context.time_remaining();
        None = no deadline set)."""
        if (
            time_remaining_s is not None
            and time_remaining_s < self.min_deadline_s
        ):
            self._shed_deadline.inc(n)
            d = self.depth()
            return Decision(
                ok=False, reason="deadline",
                retry_after_s=self._hint(d), depth=d,
            )
        d = self.depth()
        if d + n > self.max_depth:
            self._shed_depth.inc(n)
            return Decision(
                ok=False, reason="depth",
                retry_after_s=self._hint(d + n), depth=d,
            )
        return Decision(ok=True, depth=d)
