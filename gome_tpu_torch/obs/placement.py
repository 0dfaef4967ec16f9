"""Placement observatory: who flows where, and what it costs.

The port of ``gome_tpu/obs/placement.py`` (stdlib and numpy there and
here). Naive placement shows from two ends: symbols hash unevenly onto
``fnv1a % P`` partitions, and under a mesh every shard pads to the
hottest shard's row block, so a skewed flow makes adding devices lose
throughput. This module measures symbol flow, lane occupancy and padding
waste, in three pieces:

  * :class:`SpaceSaving` — a deterministic Space-Saving top-K sketch
    (Metwally et al.) over per-symbol order arrivals. Bounded memory
    (at most ``k`` tracked counters per writer), a per-key error bound
    (``count - err <= true <= count``), an *exactly associative and
    commutative* :meth:`~SpaceSaving.merge` (a lossless sparse add — the
    fleet rollup over M members holds at most ``M*k`` counters), and a
    byte-stable :meth:`~SpaceSaving.to_bytes` wire form like
    ``obs.capacity.LogHistogram`` so per-process sketches fold into one
    fleet-wide flow table (the same bytes as the reference's).
  * :class:`OccupancyLedger` — the dispatch-side account: dispatched vs
    live rows per dense frame, padding rows/bytes, per-shard row blocks,
    plus per-lane EWMA dispatch rates. Fed by ``note_dispatch`` next to
    ``engine.batch._grid_geometry``; paired with the admit-side sketch it
    decomposes observed skew into *lane-placement skew* x *cap-class
    padding* (multiplicative, reconciling against the observed
    rows-per-live-lane within tolerance) plus the fleet-level
    *hash-partition imbalance* row.
  * ``PLACEMENT`` — the process-global singleton with the house
    disabled-contract (TIMELINE/CAPACITY/HOSTPROF): unarmed, every hook
    is one attribute check and zero allocations
    (``sys.getallocatedblocks``-pinned in tests); ``install()`` arms the
    ops ``/placement`` payload + the ``gome_placement_*`` gauges,
    optionally serving a what-if verdict (schema
    ``gome-placement-verdict-v1``).

The verdict and the attribution baselines come from the port's own
repo-root artifacts, written on the card by the drivers under
``gome_tpu_torch/scripts/``: ``PLACEMENT_CUDA_r01.json``
(placement_eval), ``MULTICHIP_CUDA_r01.json`` (mesh_overhead --curve)
and ``FLEET_CUDA_r01.json`` (fleet_drill). A missing or malformed file
gives None. The reference's files (``PLACEMENT_r01``, ``MULTICHIP_r06``,
``FLEET_r01``) were measured on a TPU or a CPU and are never opened.

The sketch and ledger are stdlib-only; numpy is imported lazily inside
armed hook bodies only (the gateway's columnar admit block hands numpy
index arrays straight through).
"""

from __future__ import annotations

import json
import struct
import threading
from pathlib import Path

__all__ = [
    "SpaceSaving",
    "OccupancyLedger",
    "PLACEMENT",
    "PlacementObservatory",
    "load_verdict",
    "SCHEMA",
    "DEFAULT_ROW_BYTES",
]

SCHEMA = "gome-placement-verdict-v1"

_MAGIC = b"GSS1"
_HEADER = struct.Struct("<4sIQI")  # magic, k, total, npairs
_KEYLEN = struct.Struct("<H")  # utf-8 key length
_PAIR = struct.Struct("<qq")  # count, err (int64)

#: Default padding cost per dispatched row: the int32 op-grid cell
#: (3 x int32 index fields + 4 x int32 value fields = 28 B,
#: obs.compile_journal.frame_combo_detail) at depth t=16. Service boot
#: overrides this with the engine's real dtype x max_t figure.
DEFAULT_ROW_BYTES = 28 * 16


class SpaceSaving:
    """Deterministic Space-Saving heavy-hitter sketch over string keys.

    At most ``k`` counters are tracked. ``note(key, n)`` charges an
    existing counter, claims a free slot, or evicts the deterministic
    minimum (smallest ``(count, key)`` — ties break on the key, so the
    same stream always produces the same state). The evicted counter's
    count seeds the newcomer's count *and* its error bound, giving the
    classic invariants for every tracked key::

        count >= true_count >= count - err        (per-key bound)
        err <= min_tracked_count <= total / k     (global bound)

    and every key whose true count exceeds ``total / k`` is tracked.
    The whole state is the integer counter map — which makes
    :meth:`merge` a *lossless sparse add* (sum count and err per key,
    sum totals): exactly associative and commutative, with identical
    :meth:`to_bytes` output whichever order a fleet folds its members.
    Eviction bounds only the stream-side writer; a rollup over M member
    sketches holds at most ``M * k`` counters — bounded by the fleet
    size, never by the stream. Sum of counts always equals ``total``
    (all stream mass is charged somewhere), which the wire decoder
    checks.

    Same lock discipline as ``obs.capacity.LogHistogram``: one internal
    lock, every public method safe to call from any thread.
    """

    __slots__ = ("k", "_lock", "_counts", "_total")

    def __init__(self, k: int = 64):
        if k <= 0:
            raise ValueError(f"sketch capacity must be positive: {k}")
        self.k = int(k)
        self._lock = threading.Lock()
        self._counts: dict[str, list[int]] = {}  # key -> [count, err]; guarded by self._lock
        self._total = 0  # guarded by self._lock

    def note(self, key: str, count: int = 1) -> None:
        """Charge ``count`` arrivals to ``key`` (Space-Saving update).

        The eviction scan is O(k) — k is small (64 by default) and the
        scan runs only on a full sketch meeting a *new* key; a heap
        would trade that for allocation on every update, which the
        armed admit path cares about more.
        """
        if count <= 0:
            return
        with self._lock:
            self._total += count
            c = self._counts.get(key)
            if c is not None:
                c[0] += count
                return
            if len(self._counts) < self.k:
                self._counts[key] = [count, 0]
                return
            counts = self._counts
            victim = min(counts, key=lambda s: (counts[s][0], s))
            floor = counts.pop(victim)[0]
            counts[key] = [floor + count, floor]

    @property
    def total(self) -> int:
        """Total stream mass noted (survives eviction and merge)."""
        with self._lock:
            return self._total

    @property
    def tracked(self) -> int:
        """Counters currently held (<= k per writer; <= M*k merged)."""
        with self._lock:
            return len(self._counts)

    def estimate(self, key: str) -> tuple[int, int] | None:
        """(count, err) for a tracked key, None if untracked."""
        with self._lock:
            c = self._counts.get(key)
            return (c[0], c[1]) if c is not None else None

    def top(self, n: int = 16) -> list[dict]:
        """The heavy-hitter table: up to ``n`` rows sorted by
        (count desc, key) — deterministic, like everything here."""
        with self._lock:
            items = sorted(
                self._counts.items(), key=lambda kv: (-kv[1][0], kv[0])
            )[:n]
            total = self._total
        return [
            {
                "symbol": key,
                "count": c,
                "err": e,
                "share": round(c / total, 6) if total else 0.0,
            }
            for key, (c, e) in items
        ]

    def merge(self, other: "SpaceSaving") -> None:
        """Fold ``other`` in: per-key (count, err) sums + total sum.

        Lossless by design (no truncation back to k), so the operation
        is exactly associative and commutative — the property the fleet
        rollup's byte-stability test pins. Capacity geometry must match,
        like LogHistogram's merge."""
        if self.k != other.k:
            raise ValueError(
                f"merge across sketch capacities: {self.k} vs {other.k}"
            )
        with other._lock:
            items = [(key, c[0], c[1]) for key, c in other._counts.items()]
            n = other._total
        with self._lock:
            for key, c, e in items:
                mine = self._counts.get(key)
                if mine is None:
                    self._counts[key] = [c, e]
                else:
                    mine[0] += c
                    mine[1] += e
            self._total += n

    def to_bytes(self) -> bytes:
        """Byte-stable wire form: same state -> same bytes (keys sorted
        by their utf-8 encoding)."""
        with self._lock:
            items = [
                (key.encode("utf-8"), c[0], c[1])
                for key, c in self._counts.items()
            ]
            total = self._total
        items.sort(key=lambda kv: kv[0])
        head = _HEADER.pack(_MAGIC, self.k, total, len(items))
        parts = [head]
        for kb, c, e in items:
            parts.append(_KEYLEN.pack(len(kb)))
            parts.append(kb)
            parts.append(_PAIR.pack(c, e))
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SpaceSaving":
        if len(data) < _HEADER.size:
            raise ValueError(f"short sketch blob: {len(data)} bytes")
        magic, k, total, npairs = _HEADER.unpack_from(data, 0)
        if magic != _MAGIC:
            raise ValueError(f"bad sketch magic: {magic!r}")
        sk = cls(k=k)
        off = _HEADER.size
        counts: dict[str, list[int]] = {}
        for _ in range(npairs):
            if off + _KEYLEN.size > len(data):
                raise ValueError("truncated sketch blob (key length)")
            (klen,) = _KEYLEN.unpack_from(data, off)
            off += _KEYLEN.size
            if off + klen + _PAIR.size > len(data):
                raise ValueError("truncated sketch blob (pair)")
            key = data[off:off + klen].decode("utf-8")
            off += klen
            c, e = _PAIR.unpack_from(data, off)
            off += _PAIR.size
            counts[key] = [c, e]
        if off != len(data):
            raise ValueError(
                f"sketch blob length {len(data)} != expected {off}"
            )
        if sum(c[0] for c in counts.values()) != total:
            raise ValueError("sketch blob total != sum of counter counts")
        # single-writer: sk is private to this frame until returned
        sk._counts = counts
        sk._total = total
        return sk


class OccupancyLedger:
    """Running account of what dense dispatch geometry costs.

    Cumulative dispatched/live/padding rows across every dense frame,
    plus the latest dispatch's full geometry (per-shard row blocks when
    the engine runs a mesh). Plain integers, single-writer under the
    owning observatory's lock — no lock of its own on purpose (the
    observatory's ``note_dispatch`` already holds one)."""

    __slots__ = ("frames", "dispatched_rows", "live_rows",
                 "padding_rows", "last")

    def __init__(self) -> None:
        self.frames = 0  # single-writer: PlacementObservatory.note_dispatch under PLACEMENT._lock
        self.dispatched_rows = 0  # single-writer: PlacementObservatory.note_dispatch under PLACEMENT._lock
        self.live_rows = 0  # single-writer: PlacementObservatory.note_dispatch under PLACEMENT._lock
        self.padding_rows = 0  # single-writer: PlacementObservatory.note_dispatch under PLACEMENT._lock
        self.last: dict | None = None  # single-writer: PlacementObservatory.note_dispatch under PLACEMENT._lock

    def note(self, n_rows: int, n_live: int,
             shard_counts=None, r_s: int | None = None) -> None:
        """One dense dispatch: ``n_rows`` rows carrying ``n_live`` live
        lanes; under a mesh, ``shard_counts`` are the per-shard live
        counts and ``r_s`` the uniform per-shard row block."""
        self.frames += 1
        self.dispatched_rows += n_rows
        self.live_rows += n_live
        self.padding_rows += n_rows - n_live
        last: dict = {
            "n_rows": n_rows,
            "live": n_live,
            "rows_per_live_lane": round(n_rows / n_live, 4),
        }
        if shard_counts is not None:
            counts = [int(c) for c in shard_counts]
            d = len(counts)
            mx = max(counts)
            last["devices"] = d
            last["r_s"] = int(r_s) if r_s is not None else None
            last["shard_skew"] = round(mx * d / n_live, 4)
            # Per-shard row blocks: under the uniform-R_s layout every
            # shard dispatches r_s rows; its padding is r_s - live.
            last["row_blocks"] = [
                {"shard": i, "rows": int(r_s or 0), "live": c,
                 "padding": int(r_s or 0) - c}
                for i, c in enumerate(counts)
            ]
        self.last = last

    def as_dict(self, row_bytes: int) -> dict:
        """The payload block; ``row_bytes`` converts padding rows to
        waste bytes at the configured grid depth."""
        disp, live = self.dispatched_rows, self.live_rows
        return {
            "frames": self.frames,
            "dispatched_rows": disp,
            "live_rows": live,
            "padding_rows": self.padding_rows,
            "padding_bytes": self.padding_rows * row_bytes,
            "row_bytes": row_bytes,
            "rows_per_live_lane": round(disp / live, 4) if live else 0.0,
            "last": self.last,
        }


def load_verdict(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {doc.get('schema')!r} != {SCHEMA!r}"
        )
    return doc


def default_verdict() -> dict | None:
    """The port's repo-root ``PLACEMENT_CUDA_r01.json``, or None when the
    artifact is absent or malformed (a service boot must not fail on a
    missing what-if verdict — live telemetry still arms)."""
    with _baseline_lock:
        root = _artifact_root
    try:
        return load_verdict(str(root / f"{VERDICT_ARTIFACT}.json"))
    except (OSError, ValueError):
        return None


# -- committed-baseline lookups ------------------------------------------

#: The port's artifacts, each written by a driver under
#: gome_tpu_torch/scripts/ (the reference reads PLACEMENT_r01,
#: MULTICHIP_r06 and FLEET_r01 in their places).
VERDICT_ARTIFACT = "PLACEMENT_CUDA_r01"
MESH_ARTIFACT = "MULTICHIP_CUDA_r01"
FLEET_ARTIFACT = "FLEET_CUDA_r01"

_REPO_ROOT = Path(__file__).resolve().parents[2]
_artifact_root = _REPO_ROOT  # guarded by _baseline_lock
_baseline_cache: dict[str, dict | None] = {}  # guarded by _baseline_lock
_baseline_lock = threading.Lock()


def set_artifact_root(root=None) -> None:
    """Read the artifacts from ``root`` (None: the repo root) and forget
    what was read before."""
    global _artifact_root
    with _baseline_lock:
        _artifact_root = _REPO_ROOT if root is None else Path(root)
        _baseline_cache.clear()


def _artifact(name: str) -> dict | None:
    """Best-effort read of a committed artifact under the artifact root
    (memoized). The attribution table cites the committed before-numbers
    from the artifacts themselves — never from prose — so a regenerated
    artifact updates the baseline rows automatically."""
    with _baseline_lock:
        if name in _baseline_cache:
            return _baseline_cache[name]
        root = _artifact_root
    doc: dict | None
    try:
        with open(root / name, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        doc = None
    if not isinstance(doc, dict):
        doc = None
    with _baseline_lock:
        _baseline_cache[name] = doc
    return doc


def shard_skew_baseline() -> dict | None:
    """MULTICHIP_CUDA_r01's widest-mesh point (the D=8 skew row)."""
    doc = _artifact(f"{MESH_ARTIFACT}.json")
    if not doc:
        return None
    points = doc.get("curve") or []
    if not points or not isinstance(points[-1], dict):
        return None
    p = points[-1]
    return {
        "artifact": MESH_ARTIFACT,
        "devices": p.get("devices"),
        "shard_skew": p.get("shard_skew"),
        "rows_per_live_lane": p.get("rows_per_live_lane"),
    }


def partition_imbalance_baseline() -> dict | None:
    """FLEET_CUDA_r01's measured partition order imbalance."""
    doc = _artifact(f"{FLEET_ARTIFACT}.json")
    if not doc:
        return None
    imb = (doc.get("table") or {}).get("imbalance") or {}
    return {
        "artifact": FLEET_ARTIFACT,
        "max_over_min_orders": imb.get("max_over_min_orders"),
        "orders_per_partition": imb.get("orders_per_partition"),
    }


# -- process-global singleton --------------------------------------------


class PlacementObservatory:
    """Heavy-hitter flow + occupancy accounting behind ``/placement``.

    House disabled-singleton contract (TIMELINE/FLEET/CAPACITY):
    module import costs nothing, every hot-path hook unarmed is one
    attribute check and zero allocations, ``payload()`` unarmed is
    ``{"enabled": False}``. ``install()`` arms the sketch + ledger and
    exports the ``gome_placement_*`` gauges; an optional committed
    what-if verdict (scripts/placement_eval.py) rides the payload."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sketch: SpaceSaving | None = None  # guarded by self._lock (armed ⇔ sketch)
        self._ledger = OccupancyLedger()  # guarded by self._lock
        self._lane_ewma = None  # guarded by self._lock (np.ndarray | None)
        self._alpha = 0.2  # guarded by self._lock
        self._row_bytes = DEFAULT_ROW_BYTES  # guarded by self._lock
        self._partitions = 8  # guarded by self._lock
        self._verdict: dict | None = None  # guarded by self._lock

    @property
    def enabled(self) -> bool:
        return self._sketch is not None  # gomelint: disable=GL402 — off-lock fast check; worst case one stale payload

    # -- lifecycle -------------------------------------------------------

    def install(self, topk: int = 64, ewma_alpha: float = 0.2,
                row_bytes: int = DEFAULT_ROW_BYTES, partitions: int = 8,
                verdict: dict | None = None, registry=None) -> None:
        """Arm the observatory: a fresh ``topk``-deep sketch + ledger,
        per-lane EWMA at ``ewma_alpha``, padding costed at ``row_bytes``
        per row, hash-attribution computed over ``partitions`` what-if
        partitions. ``verdict`` (optional) is a committed
        ``gome-placement-verdict-v1`` document to serve alongside the
        live telemetry."""
        if topk <= 0:
            raise ValueError(f"placement topk must be positive: {topk}")
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError(
                f"placement ewma_alpha must be in (0, 1]: {ewma_alpha}"
            )
        if row_bytes <= 0:
            raise ValueError(
                f"placement row_bytes must be positive: {row_bytes}"
            )
        if partitions <= 0:
            raise ValueError(
                f"placement partitions must be positive: {partitions}"
            )
        if verdict is not None and verdict.get("schema") != SCHEMA:
            raise ValueError(
                f"placement verdict schema {verdict.get('schema')!r} "
                f"!= {SCHEMA!r}"
            )
        with self._lock:
            self._ledger = OccupancyLedger()
            self._lane_ewma = None
            self._alpha = float(ewma_alpha)
            self._row_bytes = int(row_bytes)
            self._partitions = int(partitions)
            self._verdict = verdict
            # Arm LAST: a hook racing install() sees either disabled or
            # a fully-configured observatory, never a half-built one.
            self._sketch = SpaceSaving(topk)
        self._export(registry)

    def disable(self) -> None:
        with self._lock:
            self._sketch = None
            self._verdict = None
            self._ledger = OccupancyLedger()
            self._lane_ewma = None

    # -- hot-path hooks --------------------------------------------------

    def note_admit(self, symbol: str, count: int = 1) -> None:  # gomelint: hotpath
        """Gateway admit hook (scalar paths): one accepted order (or
        cancel) for ``symbol``. Disabled = one attribute check, zero
        allocations."""
        sk = self._sketch  # gomelint: disable=GL402 — lock-free fast check; the sketch's own lock re-validates nothing is torn
        if sk is None:
            return
        sk.note(symbol, count)

    def note_admit_frame(self, symbols, symbol_idx) -> None:  # gomelint: hotpath
        """Columnar admit hook: ``symbols`` is the batch's unique-symbol
        list and ``symbol_idx`` the per-row index column (gateway
        _intern output) — the per-symbol bincount happens HERE, armed
        only, so the disabled gateway pays one attribute check."""
        sk = self._sketch  # gomelint: disable=GL402 — lock-free fast check, same as note_admit
        if sk is None:
            return
        import numpy as np

        counts = np.bincount(
            np.asarray(symbol_idx, dtype=np.int64), minlength=len(symbols)
        )
        for sym, c in zip(symbols, counts.tolist()):
            if c:
                sk.note(sym, c)

    def note_dispatch(self, n_rows: int, live,  # gomelint: hotpath
                      shard_counts=None, r_s: int | None = None) -> None:
        """Dense-dispatch geometry hook (engine.batch._grid_geometry):
        ``live`` is the frame's live-lane id array, ``shard_counts`` /
        ``r_s`` the mesh layout when sharded. Disabled = one attribute
        check, zero allocations; armed it is one ledger update plus one
        vectorized EWMA decay over the lane axis."""
        if self._sketch is None:  # gomelint: disable=GL402 — fast check; the locked re-check below is authoritative
            return
        import numpy as np

        lanes = np.asarray(live)
        n_live = int(lanes.shape[0])
        if n_live == 0:
            return
        hi = int(lanes.max()) + 1
        with self._lock:
            if self._sketch is None:
                return
            self._ledger.note(int(n_rows), n_live,
                              shard_counts=shard_counts, r_s=r_s)
            ew = self._lane_ewma
            if ew is None or ew.shape[0] < hi:
                grown = np.zeros(max(hi, 64), np.float64)
                if ew is not None:
                    grown[: ew.shape[0]] = ew
                self._lane_ewma = ew = grown
            a = self._alpha
            ew *= 1.0 - a
            ew[lanes] += a

    # -- read side -------------------------------------------------------

    def occupancy_probe(self) -> dict:
        """Tiny cumulative-ledger snapshot for the timeline sampler —
        occupancy history rides ``/timeline`` next to RSS and queue
        depth. ``{}`` while disabled (probes must stay cheap)."""
        if self._sketch is None:  # gomelint: disable=GL402 — probe fast check
            return {}
        with self._lock:
            led = self._ledger
            return {
                "frames": led.frames,
                "dispatched_rows": led.dispatched_rows,
                "live_rows": led.live_rows,
                "padding_rows": led.padding_rows,
            }

    def _hash_partition_flows(self, sk: SpaceSaving,
                              partitions: int) -> list[int]:
        """Tracked flow per what-if ``fnv1a % P`` partition — the ONE
        placement policy tree-wide (fleet.router.partition_of);
        untracked tail mass is excluded (heavy hitters dominate the
        imbalance by construction)."""
        from ..fleet.router import partition_of

        flows = [0] * partitions
        for row in sk.top(sk.k):
            flows[partition_of(row["symbol"], partitions)] += row["count"]
        return flows

    def attribution(self) -> dict:
        """Decompose the latest observed dispatch skew.

        The dense packer's cost is multiplicative:
        ``rows/live = shard_skew * cap_class_padding`` exactly, where
        ``shard_skew = max_shard_live * D / live`` (lane placement) and
        ``cap_class_padding = r_s / max`` (pow2 bucketing + the grow-only
        floor; on an unsharded engine the
        skew term is 1 and padding carries everything). The components
        are computed *independently* from the recorded geometry and
        reconciled against the observed total within tolerance — a
        failing reconciliation means the ledger and the packer disagree
        about geometry, which is a bug, not a workload. The fleet-level
        ``hash_partition`` row is additive context (a different axis,
        not a factor of the dispatch product). Baselines cite the port's
        committed mesh and fleet artifacts (None without them)."""
        tol = 0.05
        with self._lock:
            sk = self._sketch
            last = self._ledger.last
            partitions = self._partitions
        if sk is None:
            return {"enabled": False}
        out: dict = {"enabled": True, "tol": tol}
        if last is None:
            out["components"] = []
            out["reconciliation"] = None
        else:
            observed = last["rows_per_live_lane"]
            if "shard_skew" in last:
                counts = [b["live"] for b in last["row_blocks"]]
                mx = max(counts)
                skew = mx * last["devices"] / last["live"]
                padding = (last["r_s"] or mx) / mx
            else:
                skew = 1.0
                padding = last["n_rows"] / last["live"]
            product = skew * padding
            frac = abs(product - observed) / observed if observed else 1.0
            out["observed_rows_per_live_lane"] = observed
            out["components"] = [
                {
                    "component": "lane_placement_skew",
                    "value": round(skew, 4),
                    "baseline": shard_skew_baseline(),
                },
                {
                    "component": "cap_class_padding",
                    "value": round(padding, 4),
                    "baseline": None,
                },
            ]
            out["reconciliation"] = {
                "product": round(product, 4),
                "frac_err": round(frac, 6),
                "within_tol": frac <= tol,
            }
        flows = self._hash_partition_flows(sk, partitions)
        total = sum(flows)
        mean = total / partitions if partitions else 0.0
        out["hash_partition"] = {
            "partitions": partitions,
            "tracked_flow_per_partition": flows,
            "imbalance_max_over_mean": (
                round(max(flows) / mean, 4) if mean else 0.0
            ),
            "baseline": partition_imbalance_baseline(),
        }
        return out

    def payload(self) -> dict:
        """The ``/placement`` wire form: heavy-hitter table + sketch
        wire bytes (the fleet aggregator merges members from these),
        occupancy ledger, hot-lane EWMA table, attribution rows, and
        the installed verdict (if any)."""
        with self._lock:
            sk = self._sketch
            if sk is None:
                return {"enabled": False}
            row_bytes = self._row_bytes
            alpha = self._alpha
            occupancy = self._ledger.as_dict(row_bytes)
            verdict = self._verdict
            ew = self._lane_ewma
            hot_lanes = []
            if ew is not None:
                import numpy as np

                n = min(16, int((ew > 0).sum()))
                if n:
                    order = np.argsort(-ew, kind="stable")[:n]
                    hot_lanes = [
                        {"lane": int(i), "ewma_rate": round(float(ew[i]), 6)}
                        for i in order
                        if ew[i] > 0
                    ]
        top = sk.top(16)
        total = sk.total
        return {
            "enabled": True,
            "admits": total,
            "top": top,
            "topk_share": (
                round(sum(r["count"] for r in top) / total, 6)
                if total else 0.0
            ),
            "sketch": {
                "k": sk.k,
                "tracked": sk.tracked,
                "total": total,
                "bytes_hex": sk.to_bytes().hex(),
            },
            "occupancy": occupancy,
            "lanes": {"ewma_alpha": alpha, "hot": hot_lanes},
            "attribution": self.attribution(),
            "verdict": verdict,
        }

    # -- metrics export --------------------------------------------------

    def _g_topk_share(self) -> float:
        sk = self._sketch  # gomelint: disable=GL402 — gauge read, snapshot semantics
        if sk is None:
            return 0.0
        total = sk.total
        if not total:
            return 0.0
        return sum(r["count"] for r in sk.top(16)) / total

    def _g_rows_per_live(self) -> float:
        with self._lock:
            last = self._ledger.last
        return float(last["rows_per_live_lane"]) if last else 0.0

    def _g_attr(self, component: str) -> float:
        a = self.attribution()
        for row in a.get("components", ()):
            if row["component"] == component:
                return float(row["value"])
        return 0.0

    def _export(self, registry=None) -> None:
        if registry is None:
            from ..utils.metrics import REGISTRY

            registry = REGISTRY
        registry.callback_gauge(
            "gome_placement_admits_total",
            "orders noted by the placement sketch since install",
            lambda: float(self._sketch.total if self._sketch else 0),  # gomelint: disable=GL402 — gauge read, snapshot semantics
        )
        registry.callback_gauge(
            "gome_placement_topk_share",
            "share of admitted flow carried by the top-16 symbols",
            self._g_topk_share,
        )
        registry.callback_gauge(
            "gome_placement_sketch_tracked",
            "symbol counters currently tracked by the placement sketch",
            lambda: float(self._sketch.tracked if self._sketch else 0),  # gomelint: disable=GL402 — gauge read, snapshot semantics
        )
        registry.callback_gauge(
            "gome_placement_rows_per_live_lane",
            "latest dense dispatch's rows per live lane (padding factor)",
            self._g_rows_per_live,
        )
        registry.callback_gauge(
            "gome_placement_attr_lane_skew",
            "attribution: lane-placement skew factor of the latest dispatch",
            lambda: self._g_attr("lane_placement_skew"),
        )
        registry.callback_gauge(
            "gome_placement_attr_padding",
            "attribution: cap-class padding factor of the latest dispatch",
            lambda: self._g_attr("cap_class_padding"),
        )


#: Process-global observatory (disabled until service boot or a test
#: arms it via install() — gated by the ops config's `placement` flag).
PLACEMENT = PlacementObservatory()
