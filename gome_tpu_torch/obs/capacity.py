"""Capacity observatory: coordinated-omission-safe latency.

The port of ``gome_tpu/obs/capacity.py`` (stdlib only there and here).
A closed-loop client sends an order, waits for it to finish, sends the
next: under saturation that loop slows the arrival process down to
whatever the service can absorb, so queueing delay never shows up in the
percentiles (coordinated omission). This module is the instrument that
fixes it, in three cooperating pieces:

  * :class:`LogHistogram` — an HDR-style log-bucketed latency histogram
    with a bounded relative error per bucket, a sparse count map, an
    associative :meth:`~LogHistogram.merge`, and a byte-stable
    :meth:`~LogHistogram.to_bytes` / :meth:`~LogHistogram.from_bytes`
    wire form so per-process recorders can be merged losslessly into one
    fleet histogram.
  * :class:`OpenLoopSchedule` — the *intended* arrival clock. An
    open-loop client derives each order's intended send time from the
    offered rate alone; latency is charged from the intended time, so an
    order delayed in the client's own send queue still pays for the wait.
  * ladder helpers — :func:`find_knee` (first offered-rate point where
    delivered/offered drops below the floor or the corrected p99 blows
    its budget), :func:`monotone_ladder`, :func:`attribution_check`
    (do the per-stage "where the order spends its time" rows sum to the
    measured e2e mean?), and :func:`saturated_stage`.

``CAPACITY`` is the process-global singleton that serves an installed
sweep verdict (schema ``gome-capacity-verdict-v1``) as the ops
``/capacity`` payload + ``gome_capacity_*`` gauges — same
disabled-singleton contract as ``HOSTPROF``/``PLACEMENT``: unarmed it is
one attribute check and serves ``{"enabled": False}``. Nothing here reads
a verdict file on its own: the reference's committed verdict was measured
on a TPU and is not the port's, so the port's payload carries no verdict
until a sweep on the card installs one (``install(load_verdict(path))``).

The existing ``utils.metrics.Histogram`` (fixed buckets, exposition
format) stays for /metrics; latency *claims* belong here. Stdlib-only on
purpose: load generators import it without paying a torch import.
"""

from __future__ import annotations

import json
import math
import struct
import threading

__all__ = [
    "LogHistogram",
    "OpenLoopSchedule",
    "CAPACITY",
    "CapacityObservatory",
    "find_knee",
    "monotone_ladder",
    "attribution_check",
    "saturated_stage",
    "load_verdict",
    "SCHEMA",
]

SCHEMA = "gome-capacity-verdict-v1"

_MAGIC = b"GCH1"
_HEADER = struct.Struct("<4sdddQI")  # magic, rel_err, min, max, count, npairs
_PAIR = struct.Struct("<iq")  # bucket index (int32), count (int64)


class LogHistogram:
    """Log-bucketed latency histogram with bounded relative error.

    Bucket boundaries grow geometrically by ``g = (1 + rel_err)**2``;
    a value is reported as the geometric mean of its bucket, so every
    estimate ``e`` of a recorded value ``v`` in ``[min_value, max_value)``
    satisfies ``1/(1+rel_err) < e/v <= (1+rel_err)`` (the property test
    in tests/test_capacity.py pins this). Values below ``min_value``
    land in a single underflow bucket (index 0, estimated at
    ``min_value/2``); values at or above ``max_value`` saturate into the
    top bucket. Counts are a sparse dict so an idle histogram costs a
    few hundred bytes regardless of the dynamic range.

    The entire state is the integer count map — the mean, like the
    percentiles, is derived from bucket estimates (same bounded relative
    error). That makes ``merge`` exactly associative and commutative:
    recording a stream in one process, or a split of the same stream in
    two processes then merging, produce identical state — and identical
    ``to_bytes`` output, which is the cross-process contract the fleet
    sweep relies on.
    """

    __slots__ = (
        "rel_err", "min_value", "max_value",
        "_growth", "_log_growth", "_log_min", "_top_index",
        "_lock", "_counts", "_count",
    )

    def __init__(self, rel_err: float = 0.01,
                 min_value: float = 1e-6, max_value: float = 600.0):
        if not (0.0 < rel_err < 1.0):
            raise ValueError(f"rel_err out of range: {rel_err}")
        if not (0.0 < min_value < max_value):
            raise ValueError(
                f"need 0 < min_value < max_value, got {min_value}, {max_value}"
            )
        self.rel_err = float(rel_err)
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self._growth = (1.0 + self.rel_err) ** 2
        self._log_growth = math.log(self._growth)
        self._log_min = math.log(self.min_value)
        # Bucket i >= 1 covers [min*g^(i-1), min*g^i); the top bucket is
        # the one containing max_value — larger values clamp into it.
        self._top_index = self._raw_index(self.max_value)
        self._lock = threading.Lock()
        self._counts: dict[int, int] = {}  # guarded by self._lock
        self._count = 0  # guarded by self._lock

    # -- bucket geometry -------------------------------------------------

    def _raw_index(self, value: float) -> int:
        # floor() on the log ratio, then nudge across float edges so the
        # half-open [lo, hi) contract holds exactly (the relative-error
        # property test walks bucket boundaries directly).
        i = 1 + int(math.floor(
            (math.log(value) - self._log_min) / self._log_growth
        ))
        if i < 1:
            i = 1
        while value < self.min_value * self._growth ** (i - 1):
            i -= 1
        while value >= self.min_value * self._growth ** i:
            i += 1
        return i

    def index(self, value: float) -> int:
        """Bucket index for ``value``: 0 underflow, else 1.._top_index."""
        if value != value or value < 0.0:  # NaN / negative: charge underflow
            return 0
        if value < self.min_value:
            return 0
        i = self._raw_index(value)
        return self._top_index if i > self._top_index else i

    def bucket_bounds(self, index: int) -> tuple[float, float]:
        """[lo, hi) covered by ``index`` (underflow reports [0, min))."""
        if index <= 0:
            return 0.0, self.min_value
        return (
            self.min_value * self._growth ** (index - 1),
            self.min_value * self._growth ** index,
        )

    def bucket_estimate(self, index: int) -> float:
        """Representative value: the geometric mean of the bucket."""
        if index <= 0:
            return self.min_value / 2.0
        lo, hi = self.bucket_bounds(index)
        return math.sqrt(lo * hi)

    # -- recording -------------------------------------------------------

    def record(self, value: float, count: int = 1) -> None:
        if count <= 0:
            return
        i = self.index(value)
        with self._lock:
            self._counts[i] = self._counts.get(i, 0) + count
            self._count += count

    def record_corrected(self, value: float, expected_interval: float) -> None:
        """Record ``value`` plus HDR-style coordinated-omission back-fill.

        When a *closed-loop* client measures ``value`` but was supposed
        to issue one request every ``expected_interval`` seconds, the
        requests it failed to send while stalled would each have seen a
        progressively smaller wait: synthesize them at value - k*interval
        down to the interval. Open-loop clients with true intended times
        (OpenLoopSchedule) don't need this — they record the real wait.
        """
        self.record(value)
        if expected_interval <= 0.0:
            return
        missing = value - expected_interval
        while missing >= expected_interval:
            self.record(missing)
            missing -= expected_interval

    # -- read side -------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def mean(self) -> float:
        """Bucket-estimate mean (same bounded relative error as the
        percentiles — sums of per-bucket geometric means, not raw
        values, so the mean survives merge/serialize exactly)."""
        with self._lock:
            items = list(self._counts.items())
            total = self._count
        if not total:
            return 0.0
        return math.fsum(
            c * self.bucket_estimate(i) for i, c in items
        ) / total

    def percentile(self, q: float) -> float:
        return self.percentiles((q,))[0]

    def percentiles(self, qs=(0.5, 0.9, 0.99, 0.999)) -> list[float]:
        """Bucket-estimate quantiles (one lock, one sorted walk)."""
        with self._lock:
            total = self._count
            items = sorted(self._counts.items())
        out = []
        for q in qs:
            if total == 0:
                out.append(0.0)
                continue
            rank = max(1.0, q * total)
            cum = 0
            est = self.bucket_estimate(items[-1][0])
            for idx, c in items:
                cum += c
                if cum >= rank:
                    est = self.bucket_estimate(idx)
                    break
            out.append(est)
        return out

    def summary(self, qs=(0.5, 0.9, 0.99, 0.999)) -> dict:
        ps = self.percentiles(qs)
        d = {"count": self.count, "mean_s": self.mean()}
        for q, p in zip(qs, ps):
            digits = f"{q:g}".split(".")[1]
            if len(digits) == 1:
                digits += "0"  # 0.5 -> p50, 0.999 -> p999
            d[f"p{digits}_s"] = p
        return d

    # -- merge + wire ----------------------------------------------------

    def _same_geometry(self, other: "LogHistogram") -> bool:
        return (
            self.rel_err == other.rel_err
            and self.min_value == other.min_value
            and self.max_value == other.max_value
        )

    def merge(self, other: "LogHistogram") -> None:
        if not self._same_geometry(other):
            raise ValueError(
                "merge across histogram geometries: "
                f"({self.rel_err}, {self.min_value}, {self.max_value}) vs "
                f"({other.rel_err}, {other.min_value}, {other.max_value})"
            )
        with other._lock:
            items = list(other._counts.items())
            n = other._count
        with self._lock:
            for idx, c in items:
                self._counts[idx] = self._counts.get(idx, 0) + c
            self._count += n

    def to_bytes(self) -> bytes:
        """Byte-stable wire form: same recorded state -> same bytes."""
        with self._lock:
            items = sorted(self._counts.items())
            n = self._count
        head = _HEADER.pack(
            _MAGIC, self.rel_err, self.min_value, self.max_value,
            n, len(items),
        )
        return head + b"".join(_PAIR.pack(i, c) for i, c in items)

    @classmethod
    def from_bytes(cls, data: bytes) -> "LogHistogram":
        if len(data) < _HEADER.size:
            raise ValueError(f"short histogram blob: {len(data)} bytes")
        magic, rel_err, mn, mx, n, npairs = _HEADER.unpack_from(data, 0)
        if magic != _MAGIC:
            raise ValueError(f"bad histogram magic: {magic!r}")
        want = _HEADER.size + npairs * _PAIR.size
        if len(data) != want:
            raise ValueError(
                f"histogram blob length {len(data)} != expected {want}"
            )
        h = cls(rel_err=rel_err, min_value=mn, max_value=mx)
        off = _HEADER.size
        counts = {}
        for _ in range(npairs):
            idx, c = _PAIR.unpack_from(data, off)
            off += _PAIR.size
            counts[idx] = c
        if sum(counts.values()) != n:
            raise ValueError("histogram blob count != sum of bucket counts")
        # single-writer: h is private to this frame until returned
        h._counts = counts
        h._count = n
        return h


class OpenLoopSchedule:
    """Intended arrival times for a constant offered rate (open loop).

    Order ``i`` (0-based) is *intended* to arrive at ``t0 + (i+1)/rate``
    regardless of how far behind the client has fallen — that fixed
    clock is what makes the corrected latency ``completion - intended``
    immune to coordinated omission. ``batch_due(first, n)`` is the send
    deadline for a batch holding orders ``first..first+n-1``: the
    intended time of its *last* order (a batch is modeled as a front-end
    accumulator flushing when its newest order arrives).
    """

    __slots__ = ("rate", "t0", "interval")

    def __init__(self, rate: float, t0: float = 0.0):
        if rate <= 0.0:
            raise ValueError(f"rate must be positive: {rate}")
        self.rate = float(rate)
        self.t0 = float(t0)
        self.interval = 1.0 / self.rate

    def intended(self, i: int) -> float:
        return self.t0 + (i + 1) * self.interval

    def batch_due(self, first: int, n: int) -> float:
        return self.intended(first + n - 1)

    def accumulation_mean(self, n: int) -> float:
        """Mean wait an order spends in an n-order accumulator: for
        uniform spacing the j-th order of the batch waits
        (n-1-j)/rate, averaging (n-1)/(2*rate) exactly."""
        return (n - 1) / (2.0 * self.rate) if n > 1 else 0.0


# -- ladder analysis -----------------------------------------------------


def monotone_ladder(points: list) -> bool:
    """Offered rates strictly increase along the ladder."""
    rates = [p["offered_per_sec"] for p in points]
    return all(b > a for a, b in zip(rates, rates[1:]))


def find_knee(points: list, delivered_floor: float = 0.98,
              p99_budget_s: float | None = None):
    """First ladder point where the service stops keeping up.

    A point is past the knee when delivered/offered < ``delivered_floor``
    or (when a budget is given) the corrected p99 exceeds
    ``p99_budget_s``. Returns ``(index, reason)`` or ``(None, None)``.
    """
    for i, p in enumerate(points):
        offered = p["offered_per_sec"]
        delivered = p["delivered_per_sec"]
        if offered > 0 and delivered / offered < delivered_floor:
            return i, (
                f"delivered/offered {delivered / offered:.4f} "
                f"< {delivered_floor}"
            )
        if p99_budget_s is not None:
            p99 = p.get("corrected", {}).get("p99_s")
            if p99 is not None and p99 > p99_budget_s:
                return i, f"corrected p99 {p99:.4f}s > budget {p99_budget_s}s"
    return None, None


def attribution_check(rows: list, e2e_mean_s: float, tol: float = 0.05) -> dict:
    """Do the per-stage seconds/order rows sum to the measured e2e mean?

    Means add linearly across pipeline stages, so the honest check is
    sum(rows) vs the corrected histogram's mean — not a percentile.
    """
    total = sum(r["seconds_per_order"] for r in rows)
    frac = abs(total - e2e_mean_s) / e2e_mean_s if e2e_mean_s > 0 else 1.0
    return {
        "sum_s": total,
        "e2e_mean_s": e2e_mean_s,
        "frac_err": frac,
        "within_tol": bool(rows) and frac <= tol,
        "tol": tol,
    }


def saturated_stage(rows: list) -> str | None:
    """Name the busiest *server* stage (max utilization; queue rows carry
    utilization=None and never win)."""
    best, best_u = None, -1.0
    for r in rows:
        u = r.get("utilization")
        if u is not None and u > best_u:
            best, best_u = r["stage"], u
    return best


def load_verdict(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {doc.get('schema')!r} != {SCHEMA!r}"
        )
    return doc


# -- process-global singleton -------------------------------------------


class CapacityObservatory:
    """Serves the committed capacity verdict as ops payload + gauges.

    Same disabled-singleton contract as FLEET/HOSTPROF: module import
    costs nothing, ``payload()`` unarmed is ``{"enabled": False}``, and
    ``install(verdict)`` arms the ``/capacity`` payload plus the
    ``gome_capacity_*`` callback gauges on the given registry.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._verdict: dict | None = None  # guarded by self._lock

    @property
    def enabled(self) -> bool:
        return self._verdict is not None  # gomelint: disable=GL402 - off-lock fast check, worst case one stale payload

    def install(self, verdict: dict, registry=None) -> None:
        if verdict.get("schema") != SCHEMA:
            raise ValueError(
                f"capacity verdict schema {verdict.get('schema')!r} "
                f"!= {SCHEMA!r}"
            )
        with self._lock:
            self._verdict = verdict
        self._export(registry)

    def disable(self) -> None:
        with self._lock:
            self._verdict = None

    def _knee_point(self) -> dict | None:
        with self._lock:
            v = self._verdict
        if not v:
            return None
        knee = v.get("knee") or {}
        idx = knee.get("index")
        ladder = v.get("ladder") or []
        if idx is None or not (0 <= idx < len(ladder)):
            return None
        return ladder[idx]

    def _gauge(self, key: str) -> float:
        p = self._knee_point()
        if p is None:
            return 0.0
        if key == "offered":
            return float(p.get("offered_per_sec", 0.0))
        if key == "delivered":
            return float(p.get("delivered_per_sec", 0.0))
        if key == "p99":
            return float(p.get("corrected", {}).get("p99_s", 0.0))
        return 0.0

    def _export(self, registry=None) -> None:
        if registry is None:
            from ..utils.metrics import REGISTRY
            registry = REGISTRY
        registry.callback_gauge(
            "gome_capacity_points",
            "load-sweep ladder points in the installed capacity verdict",
            lambda: float(len((self._verdict or {}).get("ladder", []))),  # gomelint: disable=GL402 - gauge read, snapshot semantics
        )
        registry.callback_gauge(
            "gome_capacity_knee_offered_per_sec",
            "offered rate at the detected saturation knee",
            lambda: self._gauge("offered"),
        )
        registry.callback_gauge(
            "gome_capacity_knee_delivered_per_sec",
            "delivered rate at the detected saturation knee",
            lambda: self._gauge("delivered"),
        )
        registry.callback_gauge(
            "gome_capacity_corrected_p99_s_at_knee",
            "coordinated-omission-corrected p99 at the knee",
            lambda: self._gauge("p99"),
        )

    def payload(self) -> dict:
        with self._lock:
            v = self._verdict
        if v is None:
            return {"enabled": False}
        knee = v.get("knee") or {}
        return {
            "enabled": True,
            "schema": v.get("schema"),
            "mode": v.get("mode"),
            "pass": v.get("pass"),
            "points": len(v.get("ladder", [])),
            "knee": knee,
            "checks": v.get("checks", {}),
            "verdict": v,
        }


CAPACITY = CapacityObservatory()
