"""Metrics — counters, gauges, and latency histograms with a Prometheus-style
text exposition. The port's own copy of ``gome_tpu/utils/metrics.py``: its
own REGISTRY, under the same metric names.

The reference has no metrics at all (SURVEY §5.5 — logging only); the
BASELINE.json throughput metric (orders/sec matched across N symbols) needs
first-class instrumentation. Kept dependency-free and cheap: a metric update
is a dict lookup + add under a lock shared per-registry.

Labeled series: `counter(name, labels={"stage": "ingress"})` returns one
child of a FAMILY registered under `name` — every child renders into the
same exposition family (`name{stage="ingress"} 3`), which is how per-stage
/ per-symbol series avoid the `stage_x_latency` name-mangling a flat
registry forces. A name is either flat or a family, never both.
"""

from __future__ import annotations

import bisect
import re
import threading
import time


def _label_str(labels: dict | None, extra: dict | None = None) -> str:
    """'{k="v",...}' with sorted keys (deterministic exposition), or ''.
    `extra` pairs (e.g. histogram `le`) render after the sorted labels,
    matching Prometheus convention."""
    items = sorted((labels or {}).items())
    if extra:
        items += list(extra.items())
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}  # guarded by self._lock

    def counter(
        self, name: str, help: str = "", labels: dict | None = None
    ) -> "Counter":
        if labels is None:
            return self._get(name, lambda: Counter(name, help))
        fam = self._family(
            name, help, "counter", lambda lb: Counter(name, help, labels=lb)
        )
        return fam.child(labels)

    def gauge(
        self, name: str, help: str = "", labels: dict | None = None
    ) -> "Gauge":
        if labels is None:
            return self._get(name, lambda: Gauge(name, help))
        fam = self._family(name, help, "gauge", lambda lb: Gauge(name, help, labels=lb))
        return fam.child(labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: tuple = None,
        labels: dict | None = None,
    ) -> "Histogram":
        if labels is None:
            return self._get(name, lambda: Histogram(name, help, buckets))
        fam = self._family(
            name, help, "histogram",
            lambda lb: Histogram(name, help, buckets, labels=lb),
        )
        return fam.child(labels)

    def callback_gauge(
        self, name: str, help: str, fn, labels: dict | None = None
    ) -> "CallbackGauge":
        """A gauge whose value is read from `fn()` at scrape time — for
        state that already lives somewhere (spill depth, breaker state)
        and would otherwise need push updates on every change. Re-
        registering the same name rebinds the callback (components are
        rebuilt across service restarts in tests). With `labels`, the
        name is a family like the other metric kinds (one child per
        label set, e.g. per-subsystem HBM residency gauges)."""
        if labels is None:
            g = self._get(name, lambda: CallbackGauge(name, help, fn))
            g._fn = fn
            return g
        fam = self._family(
            name, help, "gauge",
            lambda lb: CallbackGauge(name, help, fn, labels=lb),
        )
        g = fam.child(labels)
        g._fn = fn
        return g

    def _get(self, name, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def _family(self, name, help, typ, child_factory) -> "Family":
        fam = self._get(name, lambda: Family(name, help, typ, child_factory))
        if not isinstance(fam, Family):
            raise ValueError(
                f"metric {name!r} is already registered WITHOUT labels; a "
                "name is either a flat metric or a labeled family, not both"
            )
        return fam

    def render(self) -> str:
        """Prometheus text-format-ish exposition of every metric."""
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.render() for m in metrics) + "\n"

    def snapshot(self) -> dict:
        with self._lock:
            return {
                name: m.value() for name, m in self._metrics.items()
            }


class Family:
    """All children of one labeled metric name: one HELP/TYPE header, one
    sample block per label set. child() is get-or-create keyed by the
    sorted label items, so re-registering the same labels returns the
    SAME child (modules grab their series at import time, tests rebuild
    components — both must land on one series)."""

    def __init__(self, name: str, help: str, typ: str, child_factory):
        self.name = name
        self.help = help
        self.typ = typ
        self._factory = child_factory
        self._children: dict[tuple, object] = {}  # guarded by self._lock
        self._lock = threading.Lock()

    def child(self, labels: dict):
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            c = self._children.get(key)
            if c is None:
                c = self._children[key] = self._factory(dict(key))
            return c

    def children(self) -> list:
        with self._lock:
            return list(self._children.values())

    def value(self) -> dict:
        return {
            _label_str(c.labels): c.value() for c in self.children()
        }

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.typ}",
        ]
        for c in self.children():
            lines.extend(c.render_samples())
        return "\n".join(lines)


class Counter:
    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = labels
        self._v = 0  # guarded by self._lock
        self._lock = threading.Lock()

    def inc(self, by: int = 1) -> None:
        with self._lock:
            self._v += by

    def value(self):
        with self._lock:
            return self._v

    def render_samples(self) -> list[str]:
        return [f"{self.name}{_label_str(self.labels)} {self.value()}"]

    def render(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n# TYPE {self.name} counter\n"
            + "\n".join(self.render_samples())
        )


class Gauge:
    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = labels
        self._v = 0.0  # guarded by self._lock
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def value(self):
        with self._lock:
            return self._v

    def render_samples(self) -> list[str]:
        return [f"{self.name}{_label_str(self.labels)} {self.value()}"]

    def render(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n# TYPE {self.name} gauge\n"
            + "\n".join(self.render_samples())
        )


class CallbackGauge:
    """Gauge evaluated at scrape time (see Registry.callback_gauge). A
    failing callback scrapes as 0 rather than breaking the whole /metrics
    exposition."""

    def __init__(self, name: str, help: str, fn, labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = labels
        self._fn = fn

    def value(self):
        try:
            return float(self._fn())
        except Exception:
            return 0.0

    def render_samples(self) -> list[str]:
        return [f"{self.name}{_label_str(self.labels)} {self.value()}"]

    def render(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n# TYPE {self.name} gauge\n"
            + "\n".join(self.render_samples())
        )


_DEFAULT_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5,
)


class Histogram:
    """Fixed-bucket histogram (seconds by convention) with quantile
    estimation by linear interpolation inside the winning bucket."""

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: tuple = None,
        labels: dict | None = None,
    ):
        self.name = name
        self.help = help
        self.labels = labels
        self.buckets = tuple(buckets or _DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)  # guarded by self._lock
        self._sum = 0.0  # guarded by self._lock
        self._n = 0  # guarded by self._lock
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    def time(self) -> "_Timer":
        return _Timer(self)

    def value(self) -> dict:
        with self._lock:
            return {
                "count": self._n,
                "sum": self._sum,
                "mean": self._sum / self._n if self._n else 0.0,
                "p50": self._quantile_locked(0.50),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
            }

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def percentiles(self, qs=(0.5, 0.9, 0.99)) -> dict:
        """{"p50": ..., "p90": ..., ...} for the requested quantiles,
        read under ONE lock acquisition (a concurrent observe between
        per-quantile reads would make e.g. p90 < p50 possible). The
        latency reports (scripts/soak.py, bench --latency) use this."""
        with self._lock:
            return {
                f"p{q * 100:g}": self._quantile_locked(q) for q in qs
            }

    def _quantile_locked(self, q: float) -> float:
        if self._n == 0:
            return 0.0
        target = q * self._n
        cum = 0
        for i, c in enumerate(self._counts):
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (
                    self.buckets[i]
                    if i < len(self.buckets)
                    else self.buckets[-1] * 2
                )
                frac = (target - cum) / c if c else 0.0
                return lo + (hi - lo) * frac
            cum += c
        return self.buckets[-1] * 2

    def render_samples(self) -> list[str]:
        # counts/sum/n must come from ONE lock acquisition: a concurrent
        # observe between reads would make the +Inf line smaller than a
        # finite bucket's cumulative count (invalid Prometheus data).
        with self._lock:
            counts = list(self._counts)
            total = self._n
            total_sum = self._sum
        lines = []
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            ls = _label_str(self.labels, {"le": b})
            lines.append(f"{self.name}_bucket{ls} {cum}")
        ls = _label_str(self.labels, {"le": "+Inf"})
        lines.append(f"{self.name}_bucket{ls} {total}")
        base = _label_str(self.labels)
        lines.append(f"{self.name}_sum{base} {total_sum}")
        lines.append(f"{self.name}_count{base} {total}")
        return lines

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        lines.extend(self.render_samples())
        return "\n".join(lines)


class _Timer:
    """Context manager recording one observation; exposes `elapsed` after
    exit so callers reuse the same clock reading."""

    elapsed: float = 0.0

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        self._hist.observe(self.elapsed)
        return False


# Process-global default registry (modules grab metrics from here).
REGISTRY = Registry()


# -- exposition parse + merge (fleet federation) -----------------------------
#
# The FleetAggregator (obs.fleet) scrapes N member processes'
# /metrics text and serves ONE merged exposition: counters sum, same-bucket
# histograms merge, gauges union under a new `proc` label. The parser below
# reads exactly the dialect Registry.render() writes (HELP line, TYPE line,
# sample lines with sorted labels and `le` last), so parse -> render is
# byte-identical — the lossless-merge contract tests pin.

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (.+)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


class Sample:
    """One exposition sample line, structured. `labels` preserves the
    source order (the registry writes sorted keys with `le` appended
    last, so re-rendering in insertion order reproduces the line);
    `value_str` keeps the exact source text so a parse -> render round
    trip never reformats numbers (`3` stays `3`, `0.0` stays `0.0`)."""

    __slots__ = ("name", "labels", "value_str")

    def __init__(self, name: str, labels: dict, value_str: str):
        self.name = name
        self.labels = labels
        self.value_str = value_str

    @property
    def value(self) -> float:
        return float(self.value_str)

    def line(self) -> str:
        if not self.labels:
            return f"{self.name} {self.value_str}"
        inner = ",".join(f'{k}="{v}"' for k, v in self.labels.items())
        return f"{self.name}{{{inner}}} {self.value_str}"


class ParsedFamily:
    """One metric family parsed back from exposition text: the HELP/TYPE
    header plus its sample lines (for histograms that includes the
    `_bucket`/`_sum`/`_count` suffixed samples)."""

    def __init__(self, name: str, help: str = "", typ: str = "untyped"):
        self.name = name
        self.help = help
        self.typ = typ
        self.samples: list[Sample] = []

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.typ}",
        ]
        lines.extend(s.line() for s in self.samples)
        return "\n".join(lines)


def parse_exposition(text: str) -> dict[str, ParsedFamily]:
    """Parse Prometheus text exposition into {family name: ParsedFamily},
    preserving family and sample order. Sample lines attach to the most
    recent HELP/TYPE header (which is how histogram `_bucket` suffixes
    stay with their base family); a sample before any header is a format
    error."""
    families: dict[str, ParsedFamily] = {}
    current: ParsedFamily | None = None
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            name = parts[2]
            fam = families.get(name)
            if fam is None:
                fam = families[name] = ParsedFamily(name)
            fam.help = parts[3] if len(parts) > 3 else ""
            current = fam
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            name = parts[2]
            fam = families.get(name)
            if fam is None:
                fam = families[name] = ParsedFamily(name)
            fam.typ = parts[3] if len(parts) > 3 else "untyped"
            current = fam
            continue
        if line.startswith("#"):
            continue  # comment — not part of the registry dialect
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line {lineno}: {line!r}")
        if current is None:
            raise ValueError(
                f"exposition line {lineno} has no preceding HELP/TYPE "
                f"header: {line!r}"
            )
        name, labelstr, value_str = m.groups()
        labels = (
            dict(_LABEL_RE.findall(labelstr)) if labelstr else {}
        )
        current.samples.append(Sample(name, labels, value_str))
    return families


def render_exposition(families: dict[str, ParsedFamily]) -> str:
    """Re-render parsed families in order — the inverse of
    parse_exposition and byte-identical to the Registry.render() dialect."""
    return "\n".join(f.render() for f in families.values()) + "\n"


def _fmt_merged(total: float, value_strs: list[str]) -> str:
    """Render a merged numeric total in the narrowest format the inputs
    used: all-int inputs stay int (`3`), any float input renders via
    repr (`0.0`) — so merged counters keep the counter dialect."""
    if all(re.fullmatch(r"-?\d+", v) for v in value_strs):
        return str(int(total))
    return repr(float(total))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _merge_counter(name: str, per_member: list[ParsedFamily]) -> ParsedFamily:
    out = ParsedFamily(name, per_member[0].help, "counter")
    order: list[tuple] = []
    acc: dict[tuple, tuple[str, dict, float, list]] = {}
    for fam in per_member:
        for s in fam.samples:
            key = (s.name, _label_key(s.labels))
            if key not in acc:
                order.append(key)
                acc[key] = (s.name, s.labels, s.value, [s.value_str])
            else:
                n, lb, tot, strs = acc[key]
                acc[key] = (n, lb, tot + s.value, strs + [s.value_str])
    for key in order:
        n, lb, tot, strs = acc[key]
        out.samples.append(Sample(n, lb, _fmt_merged(tot, strs)))
    return out


def _merge_gauge(
    name: str, members: list[tuple[str, ParsedFamily]]
) -> ParsedFamily:
    """Gauges don't sum meaningfully across processes (each is a local
    reading), so member samples union under a new `proc` label — labels
    re-sorted so `proc` lands in deterministic exposition position."""
    out = ParsedFamily(name, members[0][1].help, members[0][1].typ)
    for proc, fam in members:
        for s in fam.samples:
            labels = dict(sorted({**s.labels, "proc": proc}.items()))
            out.samples.append(Sample(s.name, labels, s.value_str))
    return out


def _merge_histogram(
    name: str, per_member: list[ParsedFamily]
) -> ParsedFamily:
    """Merge same-bucket histograms: per base label set (labels minus
    `le`), the cumulative bucket counts, `_sum`, and `_count` sum across
    members. Members whose `le` sequences differ can't merge losslessly —
    that's a hard ValueError, not a silent drop."""
    out = ParsedFamily(name, per_member[0].help, "histogram")
    # base label key -> {"les": [...], "buckets": {le: total},
    #                    "sum": (tot, strs), "count": (tot, strs)}
    order: list[tuple] = []
    acc: dict[tuple, dict] = {}
    for fam in per_member:
        per_base_les: dict[tuple, list[str]] = {}
        for s in fam.samples:
            if s.name == f"{name}_bucket":
                base = {k: v for k, v in s.labels.items() if k != "le"}
                key = _label_key(base)
                per_base_les.setdefault(key, []).append(s.labels["le"])
                ent = acc.get(key)
                if ent is None:
                    order.append(key)
                    ent = acc[key] = {
                        "base": base, "les": None, "buckets": {},
                        "sum": (0.0, []), "count": (0, []),
                    }
                le = s.labels["le"]
                ent["buckets"][le] = ent["buckets"].get(le, 0) + s.value
            elif s.name in (f"{name}_sum", f"{name}_count"):
                key = _label_key(s.labels)
                ent = acc.get(key)
                if ent is None:
                    order.append(key)
                    ent = acc[key] = {
                        "base": s.labels, "les": None, "buckets": {},
                        "sum": (0.0, []), "count": (0, []),
                    }
                which = "sum" if s.name.endswith("_sum") else "count"
                tot, strs = ent[which]
                ent[which] = (tot + s.value, strs + [s.value_str])
            else:
                raise ValueError(
                    f"histogram family {name!r} has unexpected sample "
                    f"{s.name!r}"
                )
        for key, les in per_base_les.items():
            ent = acc[key]
            if ent["les"] is None:
                ent["les"] = les
            elif ent["les"] != les:
                raise ValueError(
                    f"histogram {name!r} bucket mismatch across members: "
                    f"{ent['les']} vs {les} — same-bucket histograms only"
                )
    for key in order:
        ent = acc[key]
        base = ent["base"]
        for le in ent["les"] or []:
            labels = dict(base)
            labels["le"] = le  # after the sorted base labels, registry-style
            out.samples.append(
                Sample(f"{name}_bucket", labels, str(int(ent["buckets"][le])))
            )
        tot, strs = ent["sum"]
        out.samples.append(Sample(f"{name}_sum", dict(base), _fmt_merged(tot, strs)))
        tot, strs = ent["count"]
        out.samples.append(
            Sample(f"{name}_count", dict(base), _fmt_merged(tot, strs))
        )
    return out


def merge_expositions(
    members: dict[str, str | dict]
) -> dict[str, ParsedFamily]:
    """Merge N member expositions into one fleet view: counters SUM per
    label set, histograms merge per base label set (identical bucket
    sequences required), gauges (and untyped families) UNION under a new
    `proc="<member>"` label. `members` maps member name -> exposition
    text (or an already-parsed family dict). Conflicting TYPEs for one
    family name across members raise ValueError — a lossy merge is a
    bug, never a best-effort."""
    parsed: list[tuple[str, dict[str, ParsedFamily]]] = [
        (proc, parse_exposition(fams) if isinstance(fams, str) else fams)
        for proc, fams in members.items()
    ]
    name_order: list[str] = []
    seen: set[str] = set()
    for _, fams in parsed:
        for name in fams:
            if name not in seen:
                seen.add(name)
                name_order.append(name)
    out: dict[str, ParsedFamily] = {}
    for name in name_order:
        present = [(proc, fams[name]) for proc, fams in parsed if name in fams]
        typs = {fam.typ for _, fam in present}
        if len(typs) > 1:
            raise ValueError(
                f"family {name!r} has conflicting types across members: "
                f"{sorted(typs)}"
            )
        typ = typs.pop()
        if typ == "counter":
            out[name] = _merge_counter(name, [fam for _, fam in present])
        elif typ == "histogram":
            out[name] = _merge_histogram(name, [fam for _, fam in present])
        else:
            out[name] = _merge_gauge(name, present)
    return out


def family_total(fam: ParsedFamily) -> float:
    """One scalar per family for the lossless-merge audit: histograms
    total their `_count` samples, counters/gauges total every sample.
    sum(member totals) == merged total is the invariant tests assert."""
    if fam.typ == "histogram":
        return sum(
            s.value for s in fam.samples if s.name == f"{fam.name}_count"
        )
    return sum(s.value for s in fam.samples)
