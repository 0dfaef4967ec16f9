"""Batched execution: the host packs a micro-batch of orders into an [R, T]
op grid (R symbol rows, T time slots, NOP-padded) and the device applies all
of it in one kernel launch.

The port of ``gome_tpu/engine/batch.py`` (its object and columnar paths,
and the per-grid cap classes the frame path in ``engine/frames.py`` runs
on). Two invariants make one grid exactly equivalent to sequential processing:

  * same-symbol operations never split across rows and keep arrival order
    within the row (the reference's correctness-by-single-threadedness);
  * symbols share nothing, so cross-symbol interleaving is irrelevant to
    book state — the host re-sorts decoded events by arrival index.

Fixed device budgets (book capacity, K fill records) never cost exactness:
the engine keeps the pre-grid books and, when a budget trips, grows the
slot axis and re-runs the whole grid, or re-runs one row with a larger
record budget, before decoding.

Per-grid cap classes: a grid may run on the leading ``cap_g`` slots of the
storage (a class of ``_cap_ladder``: 64, 256, 1024, ... up to the storage
cap), so shallow lanes never pay one hot lane's escalated depth. A lane
deeper than its grid's class is flagged by ``_guard_capped`` and the grid
re-runs at a deeper class (``stats.grid_cap_escalations``) before the
storage itself grows.

Every device update builds new tensors; nothing is written in place. The
pre-grid books (escalation replay) and the checkpoint (rollback of a raised
batch) rely on that.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs.placement import PLACEMENT
from ..obs.profiler import PROFILER
from ..ops import match_step
from ..types import Action, MatchResult, Order, OrderType, check_kernel
from ..utils.cache import IdentityCache
from ..utils.metrics import REGISTRY
from ..utils.trace import TRACER
from .book import (
    BUY,
    BookConfig,
    BookState,
    DeviceOp,
    StepOutput,
    _host,
    grow_books,
    grow_lanes,
    init_books,
    numpy_dtype,
    resolve_device,
    to_device,
    torch_dtype,
)
from .host import Interner, OpContext, decode_events, encode_op
from .nativehost import make_interner
from .step import ACTION_ADD, LOT_MAX32

#: Element budget of one dense grid's [R, T, K] record tensors: deep dense
#: grids trade rows for depth under it.
_REC_ELEM_BUDGET = 1 << 24

#: Dense-dispatch skew telemetry: each dense grid observes dispatched-rows
#: / live-lanes — the row-padding tax the pow2 bucketing (and, under a
#: mesh, the per-shard MAX bucketing) makes the device pay. The p50 gauge
#: is the placement target (<= 2.0); the histogram carries the tail.
#: Ratio buckets, not seconds. The reference's names and buckets.
_ROWS_PER_LANE_BUCKETS = (
    1.0, 1.25, 1.5, 2.0, 2.5, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0,
)
_rows_per_live_lane = REGISTRY.histogram(
    "gome_dispatched_rows_per_live_lane",
    "dense-grid dispatched rows per live lane (row-padding/skew tax)",
    buckets=_ROWS_PER_LANE_BUCKETS,
)
REGISTRY.callback_gauge(
    "gome_dispatched_rows_per_live_lane_p50",
    "median dispatched-rows/live-lane across dense dispatches "
    "(ROADMAP open item 2 targets <= 2.0)",
    lambda: _rows_per_live_lane.quantile(0.5),
)
#: Per-shard skew companion: each dense MESH dispatch observes
#: max-shard-live / mean-shard-live — 1.0 is perfectly balanced; the
#: per-shard MAX bucketing makes dispatched rows (and so device time)
#: scale with this ratio, not with total live work.
_dense_shard_skew = REGISTRY.histogram(
    "gome_dense_shard_skew",
    "dense mesh dispatch max/mean live lanes per shard (1.0 = balanced)",
    buckets=_ROWS_PER_LANE_BUCKETS,
)
REGISTRY.callback_gauge(
    "gome_dense_shard_skew_p50",
    "median per-shard live-lane skew across dense mesh dispatches",
    lambda: _dense_shard_skew.quantile(0.5),
)


def _nop_grid(config: BookConfig, n_rows: int, t: int) -> dict[str, np.ndarray]:
    i32 = lambda: np.zeros((n_rows, t), np.int32)
    val = lambda: np.zeros((n_rows, t), numpy_dtype(config.dtype))
    return dict(
        action=i32(), side=i32(), is_market=i32(),
        price=val(), volume=val(), oid=val(), uid=val(),
    )


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _next_pow4(n: int) -> int:
    """Coarser bucket for a frame's train grids: pow4 classes (8, 32, 128,
    ...) visit 4x fewer shapes for at most 4x padding on small grids."""
    p = 1
    while p < n:
        p *= 4
    return p


#: Smallest per-grid cap class. Also keeps every class >= the default
#: max_fills record budget.
CAP_CLASS_MIN = 64


def _cap_ladder(cap: int) -> list[int]:
    """The per-grid cap classes available under a storage cap: pow4 steps
    from CAP_CLASS_MIN (64, 256, 1024, ...) strictly below `cap`, plus `cap`
    itself. A storage cap at or below CAP_CLASS_MIN yields a single class
    (every grid runs at the storage cap)."""
    if cap <= CAP_CLASS_MIN:
        return [cap]
    out = []
    c = CAP_CLASS_MIN
    while c < cap:
        out.append(c)
        c *= 4
    out.append(cap)
    return out


def _slice_books_cap(books: BookState, cap: int) -> BookState:
    """The leading `cap` slots of every lane (the books themselves at the
    storage width), as contiguous tensors — the kernel takes no strided
    views. Exact for every lane whose resting count <= cap (active slots
    are a prefix); _guard_capped flags the deeper ones."""
    if books.price.shape[-1] == cap:
        return books
    cut = lambda a: a[..., :cap].contiguous()
    return books._replace(
        price=cut(books.price), lots=cut(books.lots), seq=cut(books.seq),
        oid=cut(books.oid), uid=cut(books.uid),
    )


def _writeback_full_cap(books: BookState, sub: BookState, cap: int):
    """A cap-sliced full-grid result written into a copy of the
    storage-width stack (row == lane; slots beyond `cap` were untouched by
    the grid). The input stack is left as it was: the checkpoint and the
    escalation replay hold it."""
    if books.price.shape[-1] == cap:
        return sub

    def put(a, s):
        out = a.clone()
        out[..., :cap] = s
        return out

    return books._replace(
        price=put(books.price, sub.price), lots=put(books.lots, sub.lots),
        seq=put(books.seq, sub.seq), oid=put(books.oid, sub.oid),
        uid=put(books.uid, sub.uid), count=sub.count, next_seq=sub.next_seq,
    )


def _guard_capped(outs: StepOutput, pre_counts, cap: int,
                  ops: DeviceOp) -> StepOutput:
    """Flag rows whose PRE-grid resting count exceeds the grid's cap: their
    books cannot be represented at this width, so the grid's result for
    them is not trustworthy. Folding the flag into book_overflow reuses the
    cap escalation. Rows with no real op are exempt (NOPs never touch
    slots)."""
    touched = (ops.action != 0).any(dim=-1)
    bad = touched & (pre_counts.max(dim=-1).values > cap)
    return outs._replace(
        book_overflow=torch.maximum(
            outs.book_overflow, bad.to(outs.book_overflow.dtype)[:, None]
        )
    )


def _gather_rows(books: BookState, lane_ids: torch.Tensor, n_live: int,
                 cap: int) -> BookState:
    """Dense gather at cap class `cap`: row r < n_live takes the leading
    `cap` slots of lane lane_ids[r]; the sentinel rows past n_live (the
    live rows are a prefix) get zero books. No host sync."""
    ids = lane_ids.clamp(max=books.count.shape[0] - 1)

    def take(a):
        out = (a[..., :cap] if a.dim() == 3 else a)[ids]
        out[n_live:] = 0
        return out

    return BookState(*(take(a) for a in books))


def _scatter_books_cap(books: BookState, lane_ids: torch.Tensor, n_live: int,
                       sub: BookState, cap: int) -> BookState:
    """Scatter a dense grid's sub-stack into a copy of ``books``, writing
    only the leading `cap` slots of each live lane (sentinel rows drop).
    Lanes in a cap-class grid hold nothing beyond `cap` (guarded), so the
    untouched tail slots stay zero. The input stack is left as it was. No
    host sync."""
    ids = lane_ids[:n_live]

    def put(a, s):
        out = a.clone()
        if a.dim() == 3:
            out[ids, :, :cap] = s[:n_live]
        else:
            out[ids] = s[:n_live]
        return out

    return BookState(*(put(a, s) for a, s in zip(books, sub)))


def full_grid_step(cfg: BookConfig, books: BookState, ops: DeviceOp):
    """One full grid (row == lane) at cap class cfg.cap: K1 on the leading
    cfg.cap slots of every lane, the capped-lane guard, and the write-back
    into a copy of the stack. Queues device work only."""
    cap = cfg.cap
    sub, outs = match_step.batch_step(cfg, _slice_books_cap(books, cap), ops)
    outs = _guard_capped(outs, books.count, cap, ops)
    return _writeback_full_cap(books, sub, cap), outs


def dense_grid_step(cfg: BookConfig, books: BookState, ids: torch.Tensor,
                    n_live: int, ops: DeviceOp):
    """One dense grid at cap class cfg.cap: gather the rows' lanes (ids on
    the books' device; the first n_live rows are live, the rest sentinel
    padding), K1, the guard, and the scatter into a copy of the stack.
    Queues device work only."""
    cap = cfg.cap
    sub = _gather_rows(books, ids, n_live, cap)
    new_sub, outs = match_step.batch_step(cfg, sub, ops)
    outs = _guard_capped(outs, sub.count, cap, ops)
    return _scatter_books_cap(books, ids, n_live, new_sub, cap), outs


def _merge_buf_floor(dst: dict, src) -> None:
    """Raise per-class buffer floors: src is {pow2 class: slots} or an
    int (a floor for its own pow2 class)."""
    items = (
        src.items() if isinstance(src, dict)
        else [(_next_pow2(max(int(src), 64)), int(src))]
    )
    for b, v in items:
        v = _next_pow2(max(int(v), 64))
        dst[b] = max(dst.get(b, 0), v)


def splice_outs(outs: StepOutput, overrides: dict):
    """The ``outs_at(field, rows, ts)`` accessor decode_grid_columnar needs:
    reads StepOutput columns at packed (row, t) coordinates (gathered on the
    device, so only the packed ops cross to the host) and splices in
    per-row escalation re-runs (each with its own record budget K', padded
    to align)."""

    def outs_at(field, rows, ts):
        a = getattr(outs, field)
        base = _host(a[torch.as_tensor(rows, device=a.device),
                       torch.as_tensor(ts, device=a.device)])
        for row, src in overrides.items():
            m = rows == row
            if not m.any():
                continue
            ov = np.asarray(getattr(src, field))[ts[m]]
            if base.ndim > 1:
                k_base, k_ov = base.shape[1], ov.shape[1]
                if k_ov > k_base:
                    base = np.pad(base, [(0, 0), (0, k_ov - k_base)])
                elif k_ov < k_base:
                    ov = np.pad(ov, [(0, 0), (0, k_base - k_ov)])
            base[m] = ov
        return base

    return outs_at


class CapacityError(RuntimeError):
    """A configured growth ceiling (max_slots / max_cap) was hit. The book
    state is unchanged for the batch that tripped it."""


class BookInvariantError(RuntimeError):
    """verify_books found book state violating a structural invariant."""


@dataclasses.dataclass
class EngineStats:
    """Host-side engine counters. Escalations are exact-but-slow events:
    frequent cap growth means the configured geometry is undersized."""

    orders: int = 0
    fills: int = 0
    cancels: int = 0
    cancels_missed: int = 0
    dropped_no_prepool: int = 0  # incremented by the orchestrator facade
    device_calls: int = 0  # match-step kernel launches
    cap_escalations: int = 0
    # Confined escalations: one GRID's cap class deepened (re-sliced from
    # the same storage) without growing the [S]-wide stack
    # (cap_escalations = storage grew).
    grid_cap_escalations: int = 0
    fill_record_escalations: int = 0
    frame_fallbacks: int = 0  # fast-path frames re-run on the exact path
    lane_growths: int = 0


class BatchEngine:
    """The host side of the batched device engine.

    Owns the device-resident [S] book stack, the symbol->lane mapping and
    the id interners; packs order lists into op grids and decodes
    StepOutputs back into the global MatchResult event stream. Orders
    given here already passed admission (MatchEngine); every ADD hits the
    book.
    """

    def __init__(
        self,
        config: BookConfig,
        n_slots: int,
        max_t: int = 32,
        auto_grow: bool = True,
        max_slots: int = 1 << 16,
        max_cap: int = 1 << 14,
        kernel: str = "scan",
        pallas_interpret: bool = False,
        mesh=None,
        dense: bool = True,
        dense_t_max: int = 1024,
        device=None,
    ):
        """The reference's parameters in the reference's order, then the
        port's own `device`.

        max_slots / max_cap bound auto-grow (symbol lanes / per-side book
        capacity); growth past a ceiling raises CapacityError.

        kernel: the reference's "scan" or "pallas" (checked against
        types.KERNELS); pallas_interpret: its Pallas interpreter switch.
        Both kept so the reference's calls bind, and checked here once;
        every value runs the one step: K1 on the card, its plain version
        on the CPU. self.kernel is kept only to be read back (the
        reference's attribute); no step reads it.

        dense: let the columnar path pack batches touching few symbols into
        compact gather/scatter grids over just the live lanes instead of
        the full [n_slots, max_t] grid; a hot symbol's stream can then run
        dense_t_max deep per launch. Semantics identical.

        device: where the books live (default: the CUDA card; "cpu" runs
        the plain PyTorch version).

        mesh: an optional 1-D mesh (gome_tpu_torch.parallel.make_mesh)
        splitting the symbol-lane axis into per-shard blocks, each on its
        own device; every grid runs K1 once per shard on that shard's
        rows. Lane counts stay multiples of the mesh size (growth rounds
        up). The engine's device is then the mesh's home device, where
        the frame path compacts events and whole-stack reads gather."""
        check_kernel(kernel)
        if config.cap > max_cap:
            raise ValueError(f"cap {config.cap} exceeds max_cap {max_cap}")
        if n_slots > max_slots:
            raise ValueError(f"n_slots {n_slots} exceeds max_slots {max_slots}")
        if mesh is not None:
            # Every place n_slots can be set (init, growth, restore) must
            # produce a mesh multiple; enforcing the two static bounds here
            # and rounding growth up lets the blocks assume divisibility.
            for name, v in (("n_slots", n_slots), ("max_slots", max_slots)):
                if v % mesh.size != 0:
                    raise ValueError(
                        f"{name} {v} must be a multiple of the mesh size "
                        f"{mesh.size}"
                    )
            dev = None if device is None else resolve_device(device)
            if dev is not None and (dev.type != mesh.home.type or (
                    dev.index is not None and dev.index != mesh.home.index)):
                raise ValueError(
                    f"device {device} is not the mesh's home device "
                    f"{mesh.home}"
                )
            device = mesh.home
        self.mesh = mesh
        self.device = resolve_device(device)
        self.config = config
        self.n_slots = n_slots
        self.max_t = max_t
        self.auto_grow = auto_grow
        self.kernel = kernel
        self.max_slots = max_slots
        self.max_cap = max_cap
        self.dense = dense
        self.dense_t_max = dense_t_max
        # Grow-only geometry ratchets keyed by cap class: compiled-shape
        # stability on the reference side; here they keep grid shapes
        # identical to it.
        self._dense_rows_floor: dict[int, int] = {}
        self._dense_t_floor: dict[int, int] = {}
        # Per-lane resting-count upper bound, the host-side input to
        # cap-class selection (frames._class_partitions): ub = _ub_base
        # (true per-lane max-side counts at the last device fetch) +
        # _ub_extra (limit-ADDs packed since; each can rest at most once).
        # A performance hint only: an underestimate is caught on the device
        # by _guard_capped and re-run deeper.
        self._ub_base = np.zeros(n_slots, np.int64)
        self._ub_extra = np.zeros(n_slots, np.int64)
        # Compaction-buffer ratchets (frames._compact_sizes): grow-only
        # fetch-buffer sizes keyed by the frame's pow2 op-count class.
        self._fills_buf_floor: dict[int, int] = {}
        self._cancels_buf_floor: dict[int, int] = {}
        # Every dispatched frame-path shape combo (record_combo is the one
        # writer): the shape manifest and the timeline's geometry hash.
        self._seen_combos: set[tuple] = set()
        if mesh is None:
            self.books = init_books(config, n_slots, self.device)
        else:
            from ..parallel.mesh import sharded_books

            self.books = sharded_books(config, n_slots, mesh)
        self.symbols = Interner()  # lane = interner id - 1
        # symbol-dictionary object -> (lane-id array, max lane); hits are
        # revalidated against n_slots (frames._lane_map).
        self._lane_map_cache = IdentityCache()
        # oids are the one per-order-unique string column: interned in C++
        # wherever the native branches run (nativehost).
        self.oids = make_interner()
        self.uids = Interner()
        self.stats = EngineStats()
        # Price rebasing (32-bit books only): device prices are stored
        # relative to a per-lane int64 base, so absolute tick magnitudes are
        # unbounded while each symbol's ACTIVE window is +-2^31 ticks.
        # int64 books keep base 0.
        self._rebase = numpy_dtype(config.dtype).itemsize <= 4
        self.price_base = np.zeros(n_slots, np.int64)
        self._base_set = np.zeros(n_slots, bool)
        # Conservative absolute-price envelope per lane (grows only): the
        # recenter check proves every price the lane has EVER admitted still
        # fits the int32 window under a new base, without a device scan.
        self._env_lo = np.zeros(n_slots, np.int64)
        self._env_hi = np.zeros(n_slots, np.int64)

    # Admission window around the current base; recenter when exceeded.
    REBASE_LIMIT = 1 << 30
    _INT32_SAFE = (1 << 31) - 2

    def _grow_base_arrays(self, new_slots: int) -> None:
        pad = new_slots - len(self.price_base)
        self.price_base = np.pad(self.price_base, (0, pad))
        self._base_set = np.pad(self._base_set, (0, pad))
        self._env_lo = np.pad(self._env_lo, (0, pad))
        self._env_hi = np.pad(self._env_hi, (0, pad))
        self._ub_base = np.pad(self._ub_base, (0, pad))
        self._ub_extra = np.pad(self._ub_extra, (0, pad))

    # -- resting-count upper bound (cap-class selection) -------------------
    def count_ub(self) -> np.ndarray:
        """Current per-lane upper bound on max-side resting count."""
        return self._ub_base + self._ub_extra

    def note_packed_adds(self, add_counts: np.ndarray) -> None:
        """Record a packed batch's per-lane limit-ADD counts (each may rest
        at most once, keeping count_ub an upper bound). add_counts is
        [n_slots] at pack time; callers keep it for _note_exact_counts."""
        self._ub_extra[: len(add_counts)] += add_counts

    def _note_exact_counts(self, counts_max, resolved_adds=None) -> None:
        """Reset the estimate from a device fetch of true per-lane max-side
        counts (taken AFTER some batch B executed). resolved_adds = B's own
        note_packed_adds increments when later batches are already packed
        on top (extra minus B's share is the still-in-flight sum); None
        asserts nothing is in flight and zeroes extra."""
        n = self.n_slots
        base = np.zeros(n, np.int64)
        m = min(len(counts_max), n)
        base[:m] = np.asarray(counts_max[:m], np.int64)
        self._ub_base = base
        if resolved_adds is None:
            self._ub_extra = np.zeros(n, np.int64)
        else:
            extra = self._ub_extra.copy()
            m = min(len(resolved_adds), n)
            extra[:m] -= np.asarray(resolved_adds[:m], np.int64)
            np.maximum(extra, 0, out=extra)
            self._ub_extra = extra

    @staticmethod
    def _buf_class(n: int) -> int:
        """Compaction-buffer floors are keyed by the pow2 op-count class."""
        return _next_pow2(max(n, 64))

    def _prepare_bases(self, pending, lanes) -> np.ndarray:
        """Set / recenter per-lane price bases so every ADMITTED price in
        `pending` is representable on device. Runs before packing.

        Returns a boolean drop mask aligned with `pending`: True marks a DEL
        whose price is unrepresentable under the lane's base. Only ADD limit
        prices feed the grow-only envelope — a DEL price is a lookup key,
        and since every RESTING price fits the window, an unrepresentable
        DEL provably matches nothing and is dropped host-side as a missed
        cancel."""
        n = len(pending)
        drop = np.zeros(n, bool)
        if not self._rebase:
            return drop
        lo: dict[int, int] = {}
        hi: dict[int, int] = {}
        for (_, o), lane in zip(pending, lanes):
            if o.action is not Action.ADD or o.order_type is OrderType.MARKET:
                # MARKET prices are ignored (encoded 0); DEL/NOP prices
                # never admit a resting order.
                continue
            p = o.price
            l = lo.get(lane)
            if l is None:
                lo[lane] = hi[lane] = p
            else:
                if p < l:
                    lo[lane] = p
                elif p > hi[lane]:
                    hi[lane] = p
        for lane, l in lo.items():
            self._admit_lane_range(lane, l, hi[lane])
        for i, ((_, o), lane) in enumerate(zip(pending, lanes)):
            if o.action is Action.DEL and (
                abs(o.price - int(self.price_base[lane])) > self._INT32_SAFE
            ):
                drop[i] = True
        return drop

    def prewarm_geometry(
        self,
        rows_floor: int | dict | None = None,
        t_floor: int | dict | None = None,
        fills_buf: int | dict | None = None,
        cancels_buf: int | dict | None = None,
    ) -> None:
        """Pre-set the grow-only shape ratchets to known steady-state
        values (each rounds up to a power of two; existing floors never
        shrink). rows_floor/t_floor take an int (a floor for the storage
        cap class) or a {cap class: floor} dict, fills_buf/cancels_buf an
        int (a floor for its own pow2 op-class) or a {pow2 op-class:
        slots} dict, as geometry_floors() returns them. A deployment that
        knows its flow's geometry (a saved manifest) starts with the grid
        and buffer shapes the flow settles on, so the first frames run at
        them. Performance only: untouched ratchets grow on demand."""

        def merge(dst: dict, src, cap: int) -> None:
            """Merge grow-only, clamped to `cap`: a floor beyond the usable
            range (rows past n_slots, depth past the dense ceiling) only
            forces every grid to the full-grid fallback, and persisting it
            would let a compounding margin poison the geometry."""
            items = (
                src.items() if isinstance(src, dict)
                else [(self.config.cap, src)]
            )
            for c, v in items:
                v = min(_next_pow2(max(int(v), 8)), cap)
                dst[c] = max(dst.get(c, 8), v)

        if rows_floor is not None:
            merge(
                self._dense_rows_floor, rows_floor, _next_pow2(self.n_slots)
            )
        if t_floor is not None:
            merge(
                self._dense_t_floor, t_floor,
                _next_pow2(max(self.dense_t_max, self.max_t)),
            )
        if fills_buf is not None:
            _merge_buf_floor(self._fills_buf_floor, fills_buf)
        if cancels_buf is not None:
            _merge_buf_floor(self._cancels_buf_floor, cancels_buf)

    def reset_geometry_floors(self, combos: bool = False) -> None:
        """Forget every grow-only geometry ratchet (rows/depth floors,
        compaction-buffer floors). Correctness-neutral; a warmup loop
        calls it once the flow reaches steady state, so floors latched
        during the transient (books filling from empty) do not pin a
        wide-and-deep grid for the life of the process. combos=True also
        forgets the recorded shape combos, so the transient's shapes stay
        out of a saved manifest."""
        self._dense_rows_floor.clear()
        self._dense_t_floor.clear()
        self._fills_buf_floor.clear()
        self._cancels_buf_floor.clear()
        if combos:
            self._seen_combos.clear()

    def ensure_cap(self, cap: int) -> None:
        """Pre-size book storage to `cap` slots a side (pow2-snapped,
        grow-only, bounded by max_cap): a deployment that knows its flow's
        stationary depth (a saved manifest) grows once at boot instead of
        paying a mid-traffic grow and replay, and its deep-cap combos
        become replayable by frames.precompile_combos."""
        cap = _next_pow2(max(int(cap), self.config.cap))
        if cap == self.config.cap:
            return
        if cap > self.max_cap:
            raise CapacityError(
                f"ensure_cap({cap}) exceeds max_cap={self.max_cap}"
            )
        self.books = self._per_block(lambda b: grow_books(b, cap), self.books)
        self.config = dataclasses.replace(self.config, cap=cap)

    def geometry_floors(self) -> dict:
        """The current grow-only shape ratchets: rows_floor/t_floor are
        {cap class: floor} dicts, the buffer floors {pow2 op-class: slots}
        dicts; everything is copied (safe to hold across further
        frames)."""
        return dict(
            rows_floor=dict(self._dense_rows_floor),
            t_floor=dict(self._dense_t_floor),
            fills_buf=dict(self._fills_buf_floor),
            cancels_buf=dict(self._cancels_buf_floor),
            cap=self.config.cap,
        )

    def shape_manifest(self) -> dict:
        """The flow's shape geometry: the grow-only floors (so the same
        shapes are CHOSEN) plus every dispatched shape combo. The
        timeline hashes it (obs.timeline.geometry_manifest_hash): at
        steady state it stops changing."""
        return dict(
            floors=self.geometry_floors(),
            combos=self.combos(),
        )

    # Dispatch-combo chokepoint: the ONLY writer of the recorded shape
    # set. Everything outside this class — the frame dispatch, the
    # observability probes — goes through these four accessors.
    def record_combo(self, combo) -> bool:
        """Record one dispatched shape combo (tuple-ified). Returns True
        when the combo is first-seen — i.e. the dispatch that produced it
        just paid the first launch at its shapes."""
        combo = tuple(combo)
        if combo in self._seen_combos:
            return False
        self._seen_combos.add(combo)
        return True

    def combo_seen(self, combo) -> bool:
        """Whether this shape combo has been dispatched before."""
        return tuple(combo) in self._seen_combos

    def combo_count(self) -> int:
        """How many distinct dispatch shape combos this engine ran."""
        return len(self._seen_combos)

    def combos(self) -> list:
        """The recorded dispatch combos, sorted (stable across runs for
        manifests and tests)."""
        return sorted(self._seen_combos)

    def _grid_geometry(self, live: np.ndarray, first: bool = True,
                       cls: int | None = None):
        """When the batch touches few of the provisioned lanes, pack a
        compact grid over just the live lanes (row -> lane indirection);
        rows bucket to powers of two (min 8) with sentinel padding rows.

        `first` marks the first dense grid of a frame's train: only it
        consults and advances the grow-only row floor. The train's deeper
        grids (lanes outliving earlier grids' time axes) use raw pow4
        buckets, so a tail grid never runs at the head grid's width.
        `cls` keys the floors by the grid's cap class (None = the storage
        cap).

        Under a mesh the row axis is laid out PER SHARD: shard d's live
        lanes occupy a prefix of the row block [d*R_s, (d+1)*R_s), so each
        shard's block of the [D*R_s, T] grid names only its own lanes and
        the dense gather stays shard-local. R_s buckets to the max
        per-shard live count (every shard pays the hottest shard's rows).

        Returns (use_dense, n_rows, lane_ids, row_of): lane_ids [n_rows]
        global lane ids with sentinel n_slots on padding rows (the live
        rows are a prefix, of each shard's block under a mesh); row_of
        [n_slots] maps live lane -> row. Both None for full grids."""
        if not (self.dense and len(live) > 0):
            return False, self.n_slots, None, None
        cls = self.config.cap if cls is None else cls
        floor = self._dense_rows_floor.get(cls, 8) if first else 8
        bucket = _next_pow2 if first else _next_pow4
        if self.mesh is None:
            n_rows = max(8, bucket(len(live)), floor)
            if n_rows >= self.n_slots:
                return False, self.n_slots, None, None
            if first:
                self._dense_rows_floor[cls] = n_rows
            lane_ids = np.full(n_rows, self.n_slots, np.int64)
            lane_ids[: len(live)] = live
            rows_for_live = np.arange(len(live), dtype=np.int64)
            # Occupancy ledger (obs.placement): dispatched-vs-live rows
            # for the unsharded dense grid, values already in hand.
            PLACEMENT.note_dispatch(n_rows, live)
        else:
            d = self.mesh.size
            local = self.n_slots // d
            shard = live // local  # live is sorted (np.unique upstream)
            counts = np.bincount(shard, minlength=d)
            r_s = max(8, bucket(int(counts.max())), floor)
            if r_s * d >= self.n_slots:
                return False, self.n_slots, None, None
            if first:
                self._dense_rows_floor[cls] = r_s
            n_rows = r_s * d
            lane_ids = np.full(n_rows, self.n_slots, np.int64)
            starts = np.zeros(d, np.int64)
            np.cumsum(counts[:-1], out=starts[1:])
            rank = np.arange(len(live), dtype=np.int64) - starts[shard]
            rows_for_live = shard * r_s + rank
            lane_ids[rows_for_live] = live
            # Per-shard telemetry (always-on histogram + the armed
            # profiler's dispatch ring) from values already in hand.
            _dense_shard_skew.observe(int(counts.max()) * d / len(live))
            PROFILER.note_shard_dispatch(d, r_s, counts)
            PLACEMENT.note_dispatch(n_rows, live, counts, r_s)
        row_of = np.empty(self.n_slots, np.int64)
        row_of[live] = rows_for_live
        # Skew telemetry: what row padding (pow2 bucket, grow-only floor,
        # and per-shard MAX bucketing under a mesh) costs THIS dispatch.
        _rows_per_live_lane.observe(n_rows / len(live))
        return True, n_rows, lane_ids, row_of

    def _admit_lane_range(self, lane: int, l: int, h: int) -> None:
        """Admit the ADD-limit price range [l, h] into `lane`'s grow-only
        envelope, seeding or recentering the base as needed. Raises
        CapacityError — committing NOTHING — when the envelope cannot fit an
        int32 window."""
        if not self._base_set[lane]:
            nb = (l + h) // 2
            if max(h - nb, nb - l) > self._INT32_SAFE:
                raise CapacityError(
                    f"lane {lane}: batch price range [{l}, {h}] spans "
                    "more than 2^31 ticks — int32 books cannot window "
                    "it; use coarser ticks or an int64 BookConfig"
                )
            self.price_base[lane] = nb
            self._base_set[lane] = True
            self._env_lo[lane] = l
            self._env_hi[lane] = h
            return
        el = min(int(self._env_lo[lane]), l)
        eh = max(int(self._env_hi[lane]), h)
        b = int(self.price_base[lane])
        if max(abs(l - b), abs(h - b)) > self.REBASE_LIMIT:
            nb = (el + eh) // 2
            if max(eh - nb, nb - el) > self._INT32_SAFE:
                raise CapacityError(
                    f"lane {lane}: admitted price range [{el}, {eh}] "
                    "spans more than 2^31 ticks — int32 books cannot "
                    "window it; use coarser ticks or an int64 BookConfig"
                )
            self._shift_lane_prices(lane, b - nb)
            self.price_base[lane] = nb
        # Commit the envelope only after every check passed.
        self._env_lo[lane] = el
        self._env_hi[lane] = eh

    def _shift_lane_prices(self, lane: int, delta: int) -> None:
        """Recenter: stored rebased price -> stored + (old_base - new_base).
        Inactive slots shift too, harmlessly. Builds a new price tensor: the
        checkpoint may still hold the old one. Under a mesh only the lane's
        own block changes."""

        def shift(books: BookState, row: int) -> BookState:
            price = books.price.clone()
            price[row] += delta
            return books._replace(price=price)

        self.books = self._with_row(self.books, lane, shift)

    def _lane(self, symbol: str) -> int:
        lane = self.symbols.intern(symbol) - 1  # Interner ids start at 1
        if lane >= self.n_slots:
            if not self.auto_grow:
                raise CapacityError(
                    f"symbol {symbol!r} needs lane {lane} but engine has "
                    f"n_slots={self.n_slots} (auto_grow disabled)"
                )
            new_slots = min(max(self.n_slots * 2, lane + 1), self.max_slots)
            if self.mesh is not None:
                m = self.mesh.size
                new_slots = min(((new_slots + m - 1) // m) * m, self.max_slots)
            if lane >= new_slots:
                raise CapacityError(
                    f"symbol {symbol!r} needs lane {lane} but max_slots="
                    f"{self.max_slots}; raise max_slots or shard symbols "
                    "across more engines"
                )
            if self.mesh is None:
                self.books = grow_lanes(self.books, new_slots)
            else:
                from ..parallel.mesh import grow_sharded_lanes

                self.books = grow_sharded_lanes(self.books, new_slots)
            self._grow_base_arrays(new_slots)
            self.n_slots = new_slots
            self.stats.lane_growths += 1
        return lane

    def _checkpoint(self):
        """Everything a failed batch must roll back: the book stack (never
        written in place, so keeping the reference is enough) plus the
        host-side rebasing state and the resting-count bound that packing
        mutates. Interner growth is not rolled back (grow-only and
        idempotent)."""
        return (
            self.books, self.config, self.n_slots,
            self.price_base.copy(), self._base_set.copy(),
            self._env_lo.copy(), self._env_hi.copy(),
            self._ub_base.copy(), self._ub_extra.copy(),
        )

    def _restore(self, cp) -> None:
        """Copies the host arrays: a checkpoint may be restored twice
        (restore, exact re-run mutates the rebasing state in place, re-run
        fails, restore the same checkpoint again)."""
        (
            self.books, self.config, self.n_slots,
            price_base, base_set, env_lo, env_hi, ub_base, ub_extra,
        ) = cp
        self.price_base = price_base.copy()
        self._base_set = base_set.copy()
        self._env_lo = env_lo.copy()
        self._env_hi = env_hi.copy()
        self._ub_base = ub_base.copy()
        self._ub_extra = ub_extra.copy()

    def process(self, orders: list[Order]) -> list[MatchResult]:
        """Apply a micro-batch. Symbols with more than max_t ops are drained
        over several grids (order preserved); returns all events in arrival
        order. Transactional: a raised batch rolls the engine back to its
        pre-batch state."""
        return [
            ev
            for _, evs in self.process_indexed(list(enumerate(orders)))
            for ev in evs
        ]

    def process_indexed(
        self, indexed: list[tuple[int, Order]]
    ) -> list[tuple[int, list[MatchResult]]]:
        """process() keyed by caller-assigned arrival tags: each input item
        is (tag, order) and the result is (tag, events) groups sorted by
        tag. Same transactional rollback as process()."""
        cp = self._checkpoint()
        try:
            return self._process_indexed(indexed)
        except Exception:
            self._restore(cp)
            raise

    def _process_indexed(self, indexed):
        pending = list(indexed)
        decoded: list[tuple[int, list[MatchResult]]] = []
        while pending:
            pending = self._one_grid(pending, decoded)
        decoded.sort(key=lambda kv: kv[0])
        self.stats.orders += len(indexed)
        for _, evs in decoded:
            for ev in evs:
                if ev.is_cancel:
                    self.stats.cancels += 1
                else:
                    self.stats.fills += 1
        return decoded

    def _pack_grid(self, pending):
        """Pack a pending (arrival, order) list into one [S, max_t] op grid.
        Returns (ops, contexts, leftover): contexts maps (lane, t) -> the
        packed (arrival, order); leftover holds deferred ops from lanes
        whose time axis filled (FIFO within a symbol is never split)."""
        lanes = [self._lane(order.symbol) for _, order in pending]
        drop = self._prepare_bases(pending, lanes)
        grid = _nop_grid(self.config, self.n_slots, self.max_t)
        contexts: dict[tuple[int, int], tuple[int, Order]] = {}
        fill_level: dict[int, int] = {}
        leftover: list[tuple[int, Order]] = []
        blocked: set[int] = set()  # lanes whose FIFO order must not be broken

        for (arrival, order), lane, dropped in zip(pending, lanes, drop):
            if dropped:
                # Unrepresentable DEL price (see _prepare_bases): provably a
                # miss; never reaches the device.
                self.stats.cancels_missed += 1
                continue
            t = fill_level.get(lane, 0)
            if lane in blocked or t >= self.max_t:
                blocked.add(lane)
                leftover.append((arrival, order))
                continue
            op = encode_op(
                order,
                self.oids,
                self.uids,
                self.config.dtype,
                price_base=int(self.price_base[lane]),
            )
            for name, arr in grid.items():
                arr[lane, t] = getattr(op, name)
            contexts[(lane, t)] = (arrival, order)
            fill_level[lane] = t + 1
            if order.action is Action.ADD and not op.is_market:
                self._ub_extra[lane] += 1  # count_ub upper-bound upkeep
        return DeviceOp(**grid), contexts, leftover

    def process_columnar(self, orders: list[Order]):
        """Apply a micro-batch and return events as a columnar EventBatch
        (engine.events) instead of MatchResult objects. Identical event
        content and global order to process(); transactional like it."""
        cp = self._checkpoint()
        try:
            return self._process_columnar(orders)
        except Exception:
            self._restore(cp)
            raise

    def _process_columnar(self, orders: list[Order]):
        from .events import EventBatch, empty_batch

        pending = [(i, o) for i, o in enumerate(orders)]
        dels = sum(1 for o in orders if o.action is Action.DEL)
        batches: list[dict] = []  # per-grid column dicts
        while pending:
            pending = self._one_grid_columnar(pending, batches)
        self.stats.orders += len(orders)

        tables = dict(
            symbols=self.symbols.to_list(),
            oid_table=self.oids.table,
            uid_table=self.uids.table,
        )
        if not batches:
            # Nothing reached the device (every op was a dropped
            # unrepresentable DEL): they are all missed cancels.
            self.stats.cancels_missed += dels
            return empty_batch(**tables)
        cols = {
            n: np.concatenate([b[n] for b in batches]) for n in batches[0]
        }
        # Leftover grids hold deferred ops whose arrivals interleave with
        # the first grid's: restore the global emission order.
        order_ix = np.argsort(cols["arrival"], kind="stable")
        cols = {n: v[order_ix] for n, v in cols.items()}
        batch = EventBatch(columns=cols, **tables)
        cancels = int(batch.columns["is_cancel"].sum())
        self.stats.cancels += cancels
        self.stats.fills += len(batch) - cancels
        self.stats.cancels_missed += dels - cancels
        return batch

    def _pack_grid_vectorized(self, pending):
        """Columnar-path packing: one Python pass extracts per-op fields into
        an [N, 7] int table; lane/slot assignment and the grid writes are
        numpy scatters."""
        n = len(pending)
        lanes = np.fromiter(
            (self._lane(o.symbol) for _, o in pending), np.int64, n
        )
        drop = self._prepare_bases(pending, lanes)
        bases = self.price_base[lanes]  # [N] int64
        # Slot within the lane = occurrence index (FIFO by construction).
        # Dropped DELs consume no slot and are neither packed nor deferred.
        t = np.full(n, -1, np.int64)
        level: dict[int, int] = {}
        for i, lane in enumerate(lanes):
            if drop[i]:
                continue
            c = level.get(lane, 0)
            t[i] = c
            level[lane] = c + 1

        live = (
            np.unique(lanes[~drop]) if bool((~drop).any())
            else np.zeros(0, np.int64)
        )
        use_dense, n_rows, lane_ids, row_of = self._grid_geometry(live)
        if use_dense:
            row = row_of[lanes]
            # Depth budgeted against rows (record tensors are [R, T, K]).
            t_mem = max(
                self.max_t,
                _next_pow2(
                    _REC_ELEM_BUDGET
                    // max(n_rows * self.config.max_fills, 1)
                    + 1
                )
                // 2,
            )
            t_floor = self._dense_t_floor.get(self.config.cap, 8)
            t_grid = min(
                max(_next_pow2(max(level.values())), t_floor),
                max(self.dense_t_max, self.max_t),
                t_mem,
            )
            self._dense_t_floor[self.config.cap] = max(t_floor, t_grid)
        else:
            row = lanes
            t_grid = self.max_t
        packed = (t >= 0) & (t < t_grid)

        oids, uids = self.oids, self.uids
        table = np.empty((n, 7), np.int64)
        for i, (_, o) in enumerate(pending):
            rec = table[i]
            rec[0] = int(o.action)
            rec[1] = int(o.side)
            rec[2] = o.order_type is OrderType.MARKET
            rec[3] = o.price
            rec[4] = o.volume
            rec[5] = oids.intern(o.oid)
            rec[6] = uids.intern(o.uuid)
        adds = packed & (table[:, 0] == int(Action.ADD))
        # Keep count_ub an upper bound across paths: every packed limit ADD
        # may rest once (the frame path's increments live in
        # frames._frame_arrays).
        rest_candidates = adds & (table[:, 2] == 0)
        if rest_candidates.any():
            self._ub_extra += np.bincount(
                lanes[rest_candidates], minlength=self.n_slots
            )
        bad = adds & (table[:, 4] <= 0)
        if bad.any():
            i = int(np.nonzero(bad)[0][0])
            raise ValueError(
                f"volume must be positive, got {table[i, 4]} "
                f"(oid={pending[i][1].oid}); volume<=0 is out of contract"
            )
        if numpy_dtype(self.config.dtype).itemsize <= 4:
            over = adds & (table[:, 4] > LOT_MAX32)
            if over.any():
                i = int(np.nonzero(over)[0][0])
                raise ValueError(
                    f"volume {table[i, 4]} exceeds the int32-mode per-order "
                    f"lot ceiling {LOT_MAX32} (oid={pending[i][1].oid}); "
                    "use coarser lot units or an int64 BookConfig"
                )

        grid = _nop_grid(self.config, n_rows, t_grid)
        pl, pt = row[packed], t[packed]
        for col, name in enumerate(DeviceOp._fields):
            vals = table[packed, col]
            if name == "price":
                # Device sees rebased ticks; MARKET prices are ignored and
                # encode as 0.
                vals = np.where(
                    table[packed, 2] != 0, 0, vals - bases[packed]
                )
            grid[name][pl, pt] = vals
        meta = {
            "lane": lanes[packed],
            "row": pl,
            "t": pt,
            "arrival": np.fromiter(
                (a for (a, _), p in zip(pending, packed) if p),
                np.int64,
            ),
            "action": table[packed, 0],
            "side": table[packed, 1],
            "is_market": table[packed, 2],
            "price": table[packed, 3],  # absolute (events carry these)
            "price_base": bases[packed],
            "oid_id": table[packed, 5],
            "uid_id": table[packed, 6],
        }
        leftover = [pending[i] for i in np.nonzero(~packed & ~drop)[0]]
        return DeviceOp(**grid), meta, leftover, lane_ids

    def _one_grid_columnar(self, pending, batches):
        from .events import decode_grid_columnar

        with TRACER.stage("pad_pack"):
            ops, meta, leftover, lane_ids = self._pack_grid_vectorized(
                pending
            )
        if len(meta["arrival"]) == 0:
            # Everything dropped (unrepresentable DELs): nothing to run.
            return leftover
        contexts = {
            (int(r), int(tt)): None for r, tt in zip(meta["row"], meta["t"])
        }
        outs, lane_overrides = self._run_exact(
            self._upload_tree(ops), contexts, lane_ids
        )
        with TRACER.stage("decode"):
            batches.append(
                decode_grid_columnar(meta, splice_outs(outs, lane_overrides))
            )
        return leftover

    def _one_grid(self, pending, decoded):
        ops, contexts, leftover = self._pack_grid(pending)
        if not contexts:
            # Everything dropped (unrepresentable DELs): nothing to run.
            return leftover
        outs, lane_overrides = self._run_exact(self._upload_tree(ops), contexts)
        keys = list(contexts)
        rows = np.array([lane for lane, _ in keys], np.int64)
        ts = np.array([t for _, t in keys], np.int64)
        outs_at = splice_outs(outs, lane_overrides)
        cols = StepOutput(*(outs_at(f, rows, ts) for f in StepOutput._fields))
        for i, ((lane, _), (arrival, order)) in enumerate(contexts.items()):
            events = decode_events(
                OpContext(order),
                StepOutput(*(c[i] for c in cols)),
                self.oids,
                self.uids,
                price_base=int(self.price_base[lane]),
            )
            if order.action is Action.DEL and not events:
                self.stats.cancels_missed += 1
            decoded.append((arrival, events))
        return leftover

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, queued with no host sync
        (book.to_device)."""
        return to_device(a, self.device)

    def _upload_tree(self, tree):
        """A host tree (a packer's numpy grid, a snapshot's books) on the
        engine's device (_upload); under a mesh, each shard's row block up
        to that shard's device."""
        if self.mesh is not None:
            from ..parallel.mesh import shard_batch

            return shard_batch(self.mesh, tree)
        return type(tree)(*(self._upload(a) for a in tree))

    def _host_leaf(self, tree, name: str | None = None) -> np.ndarray:
        """Host copy of one leaf of the whole stack or grid, or of a bare
        tensor with name None (under a mesh, the blocks copied one by one
        and joined on the host)."""
        if self.mesh is None:
            return _host(tree if name is None else getattr(tree, name))
        return tree.host_leaf(name)

    def _host_tree(self, tree):
        """Host copy of a whole stack or grid, leaf by leaf (under a mesh,
        each leaf's blocks joined on the host)."""
        if self.mesh is None:
            return type(tree)(*(_host(a) for a in tree))
        return tree.host()

    def _per_block(self, fn, books):
        """fn over the book stack, or over each shard's block."""
        return fn(books) if self.mesh is None else books.map(fn)

    def _row(self, tree, i: int):
        """Rows [i, i + 1) of a stack or grid, on the device that holds
        row i (no copy)."""
        if self.mesh is None:
            return type(tree)(*(a[i : i + 1] for a in tree))
        return tree.row(i)

    def _with_row(self, books, i: int, fn):
        """The stack with fn(block, j) in place of the block that holds
        lane i (the whole stack, j = i, without a mesh)."""
        if self.mesh is None:
            return fn(books, i)
        return books.with_row(i, fn)

    def _run_exact(self, ops: DeviceOp, contexts, lane_ids=None,
                   cap_g: int | None = None):
        """Run one grid, escalating device budgets until nothing overflowed.
        Syncs with the card by design: it reads book_overflow on the host.

        Returns (outs, lane_overrides): the committed [R, T] outputs (on the
        device) plus, for rows whose fill records were truncated at K, a
        host [T] StepOutput re-run with a large-enough record budget.

        ops: on the engine's device. lane_ids: for a dense grid, the [R] row ->
        lane mapping (sentinel >= n_slots on padding rows); None for full
        grids (row == lane).

        cap_g: the grid's cap class (None = the storage cap). Overflow
        first deepens the CLASS — a re-slice of the same storage, confined
        to this grid — and grows the [S]-wide storage only once the grid
        already runs at the storage cap."""
        books_before = self.books  # never written in place
        if cap_g is None:
            cap_g = self.config.cap

        def lane_of(row: int) -> int:
            return row if lane_ids is None else int(lane_ids[row])

        # Phase 1: book capacity. A tripped `book_overflow` means a resting
        # insert was dropped, or the grid's cap class sliced away a lane's
        # resting tail (_guard_capped) — deepen and replay the whole grid
        # from the pre-grid books (exact: active slots are a prefix). The
        # new cap targets the host-side bound (resting count plus the ADDs
        # packed into the row) but grows at most 4x per replay.
        while True:
            # One stage span per attempt: the step's launches plus the
            # overflow read, which waits for them, so this is the device
            # wait (the path's own barrier; the span adds none).
            with TRACER.stage("device_execute"):
                new_books, outs = self._step(
                    books_before, ops, lane_ids, cap_g
                )
                self.stats.device_calls += 1
                overflow = bool(outs.book_overflow.any())
            if not overflow:
                break
            counts = self._host_leaf(books_before, "count")  # [S, 2]
            # Fetched only now an overflow tripped: frame grids are built
            # on the device.
            adds = self._per_block(
                lambda o: (o.action == ACTION_ADD).sum(dim=1), ops
            )
            adds_per_row = self._host_leaf(adds)
            if lane_ids is None:
                row_counts = counts.max(axis=1)
            else:
                lid = np.asarray(lane_ids)
                valid = lid < counts.shape[0]
                row_counts = np.where(
                    valid,
                    counts.max(axis=1)[np.clip(lid, 0, counts.shape[0] - 1)],
                    0,
                )
            bound = int((row_counts + adds_per_row).max())
            if cap_g < self.config.cap:
                # Confined escalation: this grid re-runs on a deeper slice
                # of the SAME storage; the other grids and the stack are
                # untouched. Snap to the class ladder.
                self.stats.grid_cap_escalations += 1
                target = max(min(bound, 4 * cap_g), cap_g + 1)
                cap_g = next(
                    (c for c in _cap_ladder(self.config.cap) if c >= target),
                    self.config.cap,
                )
                continue
            self.stats.cap_escalations += 1
            new_cap = _next_pow2(
                max(min(bound, 4 * self.config.cap), self.config.cap + 1)
            )
            if new_cap > self.max_cap:
                raise CapacityError(
                    f"book cap escalation to {new_cap} exceeds max_cap="
                    f"{self.max_cap} (a side is holding >{self.config.cap} "
                    "resting orders); raise max_cap or shed load"
                )
            books_before = self._per_block(
                lambda b: grow_books(b, new_cap), books_before
            )
            self.config = dataclasses.replace(self.config, cap=new_cap)
            cap_g = new_cap
        self.books = new_books

        # Phase 2: fill records. n_fills > K truncated this op's *records*
        # only — the book transition is exact either way — so re-run just
        # the affected rows from the pre-grid books with K' >= the fills
        # observed, through the same kernel on a one-row grid.
        lane_overrides: dict[int, StepOutput] = {}
        n_fills = _host(outs.n_fills)
        overflowed = sorted(
            {
                row
                for (row, t) in contexts
                if n_fills[row, t] > self.config.max_fills
            }
        )
        for row in overflowed:
            self.stats.fill_record_escalations += 1
            k = min(_next_pow2(int(n_fills[row].max())), self.config.cap)
            big = dataclasses.replace(self.config, max_fills=k)
            # Under a mesh the row's shard owns its lane: both slices are
            # on the shard's device.
            lane_book = self._row(books_before, lane_of(row))
            lane_ops = self._row(ops, row)
            _, lane_out = match_step.batch_step(big, lane_book, lane_ops)
            self.stats.device_calls += 1
            lane_overrides[row] = StepOutput(*(_host(a[0]) for a in lane_out))
        return outs, lane_overrides

    def _step(self, books: BookState, ops: DeviceOp, lane_ids=None,
              cap_g: int | None = None):
        """Run one [R, T] grid through the match step at cap class `cap_g`
        (None = the storage cap): a full grid (row == lane) on the leading
        cap_g slots of every lane, written back into a copy of the stack;
        a dense grid gathers its rows' lanes, steps them and scatters them
        back into a copy. Queues device work only (no host sync).

        Every launch runs with K = min(max_fills, cap_g): a cap below
        max_fills clamps the record axis to the cap, as the reference
        step's record slice does (K <= cap is the kernel's contract).

        Under a mesh, books and ops are Sharded and K1 runs once per shard
        on its own block and device (parallel.mesh.sharded_batch_step /
        sharded_dense_step, dense ids localized as lane % local with the
        sentinel mapped to local); the per-shard outputs come together in
        row order on the home device (Sharded.gather), so the returned
        outs are the whole [R, T] StepOutput either way."""
        cap = self.config.cap if cap_g is None else cap_g
        cfg = dataclasses.replace(
            self.config, cap=cap, max_fills=min(self.config.max_fills, cap)
        )
        if self.mesh is not None:
            from ..parallel import mesh as pm

            ops = pm.shard_batch(self.mesh, ops)
            if lane_ids is None:
                books, outs = pm.sharded_batch_step(cfg, self.mesh)(
                    books, ops
                )
            else:
                ids_local = pm.localize_ids(
                    _host(lane_ids), self.n_slots, self.mesh
                )
                books, outs = pm.sharded_dense_step(cfg, self.mesh)(
                    books, ids_local, ops
                )
            return books, outs.gather()
        if lane_ids is None:
            return full_grid_step(cfg, books, ops)
        lane_ids = _host(lane_ids)
        # The live rows are a prefix, so their count comes from the host
        # copy and the gather and scatter index without a device read.
        n_live = int(np.count_nonzero(lane_ids < books.count.shape[0]))
        return dense_grid_step(cfg, books, self._upload(lane_ids), n_live, ops)

    # -- snapshot support ----------------------------------------------------
    def export_state(self) -> dict:
        """Host-side copy of all mutable engine state (books + interners +
        rebasing) — the same keys, dtypes and shapes as
        gome_tpu's BatchEngine.export_state(); under a mesh the blocks come
        to the host one by one and join there."""
        return {
            "books": self._host_tree(self.books)._asdict(),
            "symbols": self.symbols.to_list(),
            "oids": self.oids.to_list(),
            "uids": self.uids.to_list(),
            "cap": self.config.cap,
            "max_fills": self.config.max_fills,
            "dtype": numpy_dtype(self.config.dtype).name,
            "n_slots": self.n_slots,
            "max_t": self.max_t,
            "price_base": self.price_base.tolist(),
            "base_set": self._base_set.astype(int).tolist(),
            "env_lo": self._env_lo.tolist(),
            "env_hi": self._env_hi.tolist(),
        }

    def import_state(self, state: dict) -> None:
        """Restore a state exported by export_state (this engine's or
        gome_tpu's, including one written before price rebasing, without
        price_base / base_set / env_lo / env_hi). Replaces books,
        interners and rebasing state; stats are not restored. Under a mesh
        each shard's block goes from the host arrays straight to its own
        device; a snapshot whose n_slots the mesh does not divide is
        refused before anything changes."""
        n_slots = int(state["n_slots"])
        if self.mesh is not None and n_slots % self.mesh.size != 0:
            raise ValueError(
                f"snapshot n_slots {n_slots} is not a multiple of the "
                f"mesh size {self.mesh.size}; restore into a non-mesh "
                "engine or re-snapshot from a mesh-aligned one"
            )
        self.config = dataclasses.replace(
            self.config,
            cap=int(state["cap"]),
            max_fills=int(state["max_fills"]),
            dtype=torch_dtype(state["dtype"]),
        )
        self.n_slots = n_slots
        self.max_t = int(state["max_t"])
        b = state["books"]
        self.books = self._upload_tree(
            BookState(*(np.asarray(b[f]) for f in BookState._fields))
        )
        self.symbols = Interner.from_list(list(state["symbols"]))
        self._lane_map_cache.clear()  # lane ids come from the new interner
        self.oids = make_interner(from_list=list(state["oids"]))
        self.uids = Interner.from_list(list(state["uids"]))
        self._rebase = numpy_dtype(self.config.dtype).itemsize <= 4
        n = self.n_slots
        # count_ub restarts exact from the restored books (nothing in
        # flight after a restore).
        self._ub_base = np.asarray(b["count"], np.int64).max(axis=1)
        self._ub_extra = np.zeros(n, np.int64)
        if "price_base" in state:
            self.price_base = np.asarray(state["price_base"], np.int64).copy()
            self._base_set = np.asarray(state["base_set"], bool).copy()
            self._env_lo = np.asarray(state["env_lo"], np.int64).copy()
            self._env_hi = np.asarray(state["env_hi"], np.int64).copy()
        else:
            # Pre-rebasing snapshot: stored prices are absolute, i.e. base
            # 0. Lanes holding resting orders MUST be marked base-set at 0
            # — otherwise the next batch seeds a fresh base and encodes
            # takers relative to it while the restored book stays absolute
            # (silent non-matching). Envelope from the restored books.
            self.price_base = np.zeros(n, np.int64)
            counts = np.asarray(b["count"])  # [S, 2]
            occupied = counts.sum(axis=1) > 0
            self._base_set = occupied.copy()
            prices = np.asarray(b["price"]).astype(np.int64)  # [S, 2, cap]
            cap = prices.shape[-1]
            slot = np.arange(cap)
            active = slot[None, None, :] < counts[:, :, None]
            self._env_lo = np.where(
                occupied,
                np.where(active, prices, np.iinfo(np.int64).max).min((1, 2)),
                0,
            )
            self._env_hi = np.where(
                occupied, np.where(active, prices, 0).max((1, 2)), 0
            )

    def verify_books(self) -> None:
        """Check every lane against the book invariants (priority-sorted
        slots, positive resting lots, zeroed tails, FIFO seq within price
        levels). Raises BookInvariantError with the offending lane/side."""

        def check(cond, lane, side, what):
            if not cond:
                raise BookInvariantError(f"lane {lane} side {side}: {what}")

        price, lots, seq, counts = (
            self._host_leaf(self.books, f)
            for f in ("price", "lots", "seq", "count")
        )
        cap = price.shape[-1]
        for lane in range(counts.shape[0]):
            for side in (0, 1):
                n = int(counts[lane, side])
                check(0 <= n <= cap, lane, side, f"count {n} out of range")
                p, l, s = (a[lane, side] for a in (price, lots, seq))
                check(bool((l[:n] > 0).all()), lane, side, "empty slot in prefix")
                check(bool((l[n:] == 0).all()), lane, side, "lots beyond count")
                if n > 1:
                    dp = np.diff(p[:n].astype(np.int64))
                    ordered = (dp <= 0) if side == BUY else (dp >= 0)
                    check(bool(ordered.all()), lane, side, "priority order broken")
                    same = dp == 0
                    check(
                        bool((np.diff(s[:n])[same] > 0).all()),
                        lane, side, "FIFO seq order broken",
                    )

    # -- views -------------------------------------------------------------
    def lane_books(self) -> BookState:
        """Host (numpy) copy of the books with ABSOLUTE prices (per-lane
        rebasing offsets added back; the price leaf widens to int64 when
        bases are in play)."""
        books = self._host_tree(self.books)
        if self._rebase and self._base_set.any():
            price = books.price.astype(np.int64) + self.price_base[:, None, None]
            books = books._replace(price=price)
        return books

    def symbol_lane(self, symbol: str) -> int:
        """Read-only lookup: the lane owning `symbol` (KeyError if unseen)."""
        i = self.symbols.get(symbol)
        if i is None:
            raise KeyError(f"unknown symbol {symbol!r}")
        return i - 1
