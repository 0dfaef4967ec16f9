"""Frame path: apply a columnar order batch with no per-order Python.

The port of ``gome_tpu/engine/frames.py``. A decoded
ORDER frame (numpy columns: uint8 action/side/kind, int64 price/volume,
uint32 symbol_idx/uuid_idx into per-frame ``symbols``/``uuids`` lists, and
an ``S`` array of oids) is applied straight from its columns:

  * interning is vectorized: the interner is touched once per UNIQUE
    symbol and uuid (lane maps are cached by dictionary identity), and a
    take() broadcasts ids back to all N orders; oids intern in one native
    call where the C++ interner backs eng.oids;
  * the rebasing envelope, the unrepresentable-DEL drop mask and the
    per-lane time-slot assignment are numpy;
  * the frame's kept ops split into per-cap-class partitions by lane
    (count_ub), each packed into a train of grids; every grid's ops go to
    the card as packed columns and are scattered into the padded [R, T]
    grid there (_scatter_grid_fn).

The occurrence pass, each grid's pack and the compact decode run in C++
(engine.nativehost) wherever the native branches run; their numpy forms
here give the same arrays and run where no g++ is found.

Two execution strategies:

  * `apply_frame` — exact, synchronous: each grid runs through
    BatchEngine._run_exact (device budgets escalate in line).
  * `apply_frame_fast` — the hot path: every grid of the frame is queued
    back to back with a device-side event compaction (compact_accum) into
    frame buffers, then one two-phase fetch resolves the whole frame. If
    any device budget tripped (book overflow, record truncation, the
    compaction buffer), the frame rolls back and re-runs on the exact path.

Event content and ordering are pinned to gome_tpu's frame path and to the
oracle by differential tests (tests/test_torch_frames.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..obs.compile_journal import JOURNAL, frame_combo_detail
from ..obs.timeline import TIMELINE
from ..types import Action, Order, OrderType, Side
from ..utils.trace import TRACER
from . import nativehost
from .batch import BatchEngine, _cap_ladder, _next_pow2, _next_pow4, splice_outs
from .book import GRID_I32_FIELDS, DeviceOp, _host, numpy_dtype, to_device
from .events import EventBatch, _COLUMNS, decode_grid_columnar, empty_batch
from .step import ACTION_ADD, LOT_MAX32

#: Cumulative wall-clock seconds resolve_frame spent BLOCKED on the
#: device->host fetch of compacted events, both phases (the first phase
#: waits for the frame's device work to finish).
FETCH_SECONDS = 0.0
#: The part of FETCH_SECONDS spent in the first phase (the totals).
FETCH_TOTALS_SECONDS = 0.0

ACTION_DEL = int(Action.DEL)
MARKET = int(OrderType.MARKET)

#: Per-grid record-tensor element budget (R*T*K per record array). Bounds
#: the rows-x-depth product of dense grids so deep time axes are reserved
#: for few-row (hot-lane) grids.
_REC_ELEM_BUDGET = 1 << 24

#: Hard per-frame op ceiling (wire contract, enforced in _frame_arrays).
MAX_FRAME_OPS = 1 << 20


def _lane_map(eng: BatchEngine, symbols) -> np.ndarray:
    """symbol-dictionary -> lane-id array, cached by dictionary identity.

    Lane ids are permanent (the interner is grow-only), but a cached map is
    only usable while every lane fits the CURRENT book stack: _lane()'s
    side effect is auto-growing n_slots, and a rollback (_restore after a
    failed or overflowed frame) shrinks n_slots back — a blind cache hit
    on the retry would skip the re-growth and index past the restored
    books. Hence the max-lane revalidation; a stale hit recomputes,
    re-growing exactly as the first attempt did."""
    ent = eng._lane_map_cache.get(symbols)
    if ent is not None and ent[1] < eng.n_slots:
        return ent[0]
    lane_of_sym = np.empty(len(symbols), np.int64)
    for i, s in enumerate(symbols):
        lane_of_sym[i] = eng._lane(s)  # may auto-grow the book stack
    max_lane = int(lane_of_sym.max()) if len(lane_of_sym) else -1
    eng._lane_map_cache.put(symbols, (lane_of_sym, max_lane))
    return lane_of_sym


def intern_column(interner, uniques) -> np.ndarray:
    """Intern a column's per-batch unique strings; returns int64 ids
    aligned with `uniques`. The only Python loop is over uniques."""
    ids = np.empty(len(uniques), np.int64)
    intern = interner.intern
    for i, s in enumerate(uniques):
        ids[i] = intern(s if isinstance(s, str) else s.decode())
    return ids


def _frame_arrays(eng: BatchEngine, cols: dict) -> dict:
    """Stage 1: vectorized interning, contract checks, envelope/drop mask,
    and per-lane slot assignment. Returns the arrays grid packing needs."""
    n = int(cols["n"])
    if n > MAX_FRAME_OPS:
        raise ValueError(
            f"frame has {n} ops, above the MAX_FRAME_OPS contract ceiling "
            f"({MAX_FRAME_OPS}); split the frame"
        )
    action = np.ascontiguousarray(cols["action"], np.int64)
    side = np.ascontiguousarray(cols["side"], np.int64)
    kind = np.ascontiguousarray(cols["kind"], np.int64)
    price = np.ascontiguousarray(cols["price"], np.int64)
    volume = np.ascontiguousarray(cols["volume"], np.int64)

    lane_of_sym = _lane_map(eng, cols["symbols"])
    lanes = lane_of_sym[np.asarray(cols["symbol_idx"], np.int64)]

    uid_of = intern_column(eng.uids, cols["uuids"])
    uid_ids = uid_of[np.asarray(cols["uuid_idx"], np.int64)]
    # oids are raw per-order strings, almost all new in exchange flow: a
    # dedup sort would cost more than it saves, so intern directly — one
    # native call when the C++ interner backs eng.oids.
    intern_batch = getattr(eng.oids, "intern_batch", None)
    if intern_batch is not None:
        oid_ids = intern_batch(cols["oids"])
    else:
        intern = eng.oids.intern
        oid_ids = np.fromiter(
            (intern(o.decode()) for o in cols["oids"].tolist()), np.int64, n
        )

    is_add = action == ACTION_ADD
    bad = is_add & (volume <= 0)
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise ValueError(
            f"volume must be positive, got {volume[i]}; volume<=0 is out "
            "of contract"
        )
    if numpy_dtype(eng.config.dtype).itemsize <= 4:
        over = is_add & (volume > LOT_MAX32)
        if over.any():
            i = int(np.nonzero(over)[0][0])
            raise ValueError(
                f"volume {volume[i]} exceeds the int32-mode per-order lot "
                f"ceiling {LOT_MAX32}; use coarser lot units or an int64 "
                "BookConfig"
            )

    drop = _prepare_bases_vec(eng, lanes, action, kind, price)
    bases = eng.price_base[lanes]

    # Occurrence index of each op within its lane, in arrival order: one
    # native linear pass where available.
    keep = ~drop
    if nativehost.available():
        t = nativehost.occurrences(
            lanes, None if keep.all() else keep, eng.n_slots
        )
    else:
        t = _occurrences_numpy(lanes, keep)

    # count_ub upkeep (cap-class selection): every kept limit ADD may rest
    # at most once. The increment happens at PACK time, so the classes
    # chosen below cover this frame's own worst case.
    rest_mask = keep & is_add & (kind != MARKET)
    add_counts = np.bincount(
        lanes[rest_mask], minlength=eng.n_slots
    ).astype(np.int64)
    eng.note_packed_adds(add_counts)

    return dict(
        n=n, action=action, side=side, kind=kind, price=price,
        volume=volume, lanes=lanes, uid_ids=uid_ids, oid_ids=oid_ids,
        keep=keep, t=t, bases=bases,
        dels_total=int((action == ACTION_DEL).sum()),
        add_counts=add_counts,
    )


def _occurrences_numpy(lanes: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """The numpy form of nativehost.occurrences: a stable sort by lane
    groups each lane's kept ops contiguously with arrival order preserved;
    index-in-group = arange minus the group's start (-1 where not kept)."""
    t = np.full(len(lanes), -1, np.int64)
    if keep.any():
        ki = np.nonzero(keep)[0]
        order = np.argsort(lanes[ki], kind="stable")
        sorted_lanes = lanes[ki][order]
        starts = np.concatenate(
            ([0], np.nonzero(np.diff(sorted_lanes))[0] + 1)
        )
        group_start = np.zeros(len(sorted_lanes), np.int64)
        group_start[starts] = starts
        group_start = np.maximum.accumulate(group_start)
        t[ki[order]] = np.arange(len(sorted_lanes)) - group_start
    return t


def _scatter_grid_fn(cols: torch.Tensor, flat: torch.Tensor, n_rows: int,
                     t_grid: int) -> DeviceOp:
    """Device-side grid construction (the reference's name; there it
    returns a jitted function per shape, here it does the work): packed op
    columns [7, m_pad] + flat positions [m_pad] -> a NOP-padded [R, T]
    DeviceOp. The host uploads
    O(ops) bytes whatever the grid's occupancy. Padding columns carry
    flat == R*T and land in one extra sentinel column that the grid's
    leaves (contiguous prefixes) leave out. No host sync."""
    rt = n_rows * t_grid
    buf = cols.new_zeros((len(DeviceOp._fields), rt + 1))
    buf[:, flat] = cols
    return DeviceOp(
        *(
            buf[i, :rt].to(torch.int32 if name in GRID_I32_FIELDS
                           else cols.dtype).view(n_rows, t_grid)
            for i, name in enumerate(DeviceOp._fields)
        )
    )


def _class_partitions(eng: BatchEngine, a: dict, active_idx):
    """Split a frame's kept ops into per-cap-class partitions by LANE, so
    shallow lanes never pay one hot lane's escalated cap. A lane's class is
    the smallest ladder cap covering its resting-count upper bound
    (count_ub, which already includes this frame's packed ADDs). Same-lane
    ops stay in one partition: per-symbol FIFO is preserved.

    Returns [(cap_class, active_idx_subset), ...], ascending by class; a
    single-class ladder or disabled dense packing is one partition at the
    storage cap."""
    ladder = _cap_ladder(eng.config.cap)
    if len(ladder) == 1 or not eng.dense:
        return [(eng.config.cap, active_idx)]
    lad = np.asarray(ladder, np.int64)
    need = eng.count_ub()[a["lanes"][active_idx]]
    cls_i = np.minimum(np.searchsorted(lad, need), len(ladder) - 1)
    out = []
    for ci in np.unique(cls_i):
        out.append((ladder[int(ci)], active_idx[cls_i == ci]))
    return out


def pack_frame_grids(eng: BatchEngine, a: dict) -> list[tuple]:
    """Stage 2: split the frame into per-cap-class grid trains (lanes
    deeper than a grid's time axis roll into the next grid, FIFO by
    construction), pack each grid's ops as columns, and queue the
    device-side scatter that builds the padded grid on the card. Returns
    [(ops, meta, lane_ids, cap_g), ...] with ops on the engine's device."""
    keep, t = a["keep"], a["t"]
    grids: list[tuple] = []
    kept_idx = np.nonzero(keep)[0]
    if not len(kept_idx):
        return grids
    for cap_g, part_idx in _class_partitions(eng, a, kept_idx):
        _pack_class_train(eng, a, part_idx, t[part_idx], cap_g, grids)
    return grids


def _pack_class_train(eng: BatchEngine, a: dict, active_idx, t_sub,
                      cap_g: int, grids: list) -> None:
    """Pack one cap class's grid train. Each grid touches only the ops
    still alive at its time offset, so a G-grid train costs O(survivors),
    not O(G * frame)."""
    lanes = a["lanes"]
    dt = numpy_dtype(eng.config.dtype)
    t_off = 0
    while len(active_idx):
        live = np.unique(lanes[active_idx])
        first = t_off == 0
        use_dense, n_rows, lane_ids, row_of = eng._grid_geometry(
            live, first=first, cls=cap_g
        )
        if use_dense:
            # Depth budgeted against the grid's ROW count (the record
            # tensors are [R, T, K]); only the train's first dense grid
            # consults or advances the depth floor.
            t_mem = max(
                eng.max_t,
                _next_pow2(
                    _REC_ELEM_BUDGET
                    // max(n_rows * eng.config.max_fills, 1)
                    + 1
                )
                // 2,
            )
            cap_t = max(8, min(max(eng.dense_t_max, eng.max_t), t_mem))
            need = int(t_sub.max()) - t_off + 1
            if first:
                t_floor = eng._dense_t_floor.get(cap_g, 8)
                t_grid = min(max(_next_pow2(need), t_floor), cap_t)
                eng._dense_t_floor[cap_g] = max(t_floor, t_grid)
            else:
                # Train tails snap to four fixed depth classes (shallow /
                # 8x-shallow / quarter-ceiling / ceiling), as the
                # reference packs them.
                cands = sorted({
                    min(max(8, eng.max_t), cap_t),
                    min(max(8, 8 * eng.max_t), cap_t),
                    min(max(8, cap_t // 4), cap_t),
                    cap_t,
                })
                t_grid = next(
                    (c for c in cands if c >= min(need, cap_t)), cap_t
                )
        else:
            # Full grid: row == lane (identity map).
            row_of = np.arange(eng.n_slots, dtype=np.int64)
            t_grid = eng.max_t

        in_window = t_sub < t_off + t_grid
        m_pad = _packed_axis(int(np.count_nonzero(in_window)))
        if nativehost.available():
            # Column pack + the 11 meta extractions in ONE native pass.
            cols, flat, meta = nativehost.pack_grid(
                a, active_idx, row_of, t_off, t_grid, n_rows, m_pad, dt,
                MARKET, ACTION_ADD,
            )
        else:
            cols, flat, meta = _pack_grid_numpy(
                a, active_idx[in_window], row_of, t_off, t_grid, n_rows,
                m_pad, dt,
            )
        ops = _grid_ops(eng, cols, flat, n_rows, t_grid)
        grids.append((ops, meta, lane_ids, cap_g))

        t_off += t_grid
        alive = t_sub >= t_off
        active_idx = active_idx[alive]
        t_sub = t_sub[alive]


def _packed_axis(m: int) -> int:
    """A grid's packed-op axis for m ops: pow4 buckets from 64."""
    return _next_pow4(max(m, 64))


def _grid_ops(eng: BatchEngine, cols: np.ndarray, flat: np.ndarray,
              n_rows: int, t_grid: int):
    """A grid's packed columns up to the card and scattered into the
    padded [R, T] grid there (_scatter_grid_fn). Under a mesh the host
    splits the ops by shard (flat // (R/D * T): each shard's rows are a
    contiguous block; padding columns fall past the last shard), and each
    shard's ops go up to its own device and build its [R/D, T] block there
    (a Sharded DeviceOp)."""
    if eng.mesh is None:
        return _scatter_grid_fn(
            eng._upload(cols), eng._upload(flat), n_rows, t_grid
        )
    from ..parallel.mesh import Sharded

    r_s = n_rows // eng.mesh.size
    block = r_s * t_grid
    shard = flat // block
    blocks = []
    for d, dev in enumerate(eng.mesh.devices):
        sel = shard == d
        blocks.append(_scatter_grid_fn(
            to_device(cols[:, sel], dev), to_device(flat[sel] - d * block, dev),
            r_s, t_grid,
        ))
    return Sharded(eng.mesh, blocks)


def _pack_grid_numpy(a: dict, sel, row_of, t_off: int, t_grid: int,
                     n_rows: int, m_pad: int, dt) -> tuple:
    """The numpy form of nativehost.pack_grid, over the ops `sel` of this
    grid's window: (cols [7, m_pad], flat [m_pad] int64, meta)."""
    m = len(sel)
    cols = np.zeros((7, m_pad), dt)
    flat = np.full(m_pad, n_rows * t_grid, np.int64)
    pr, pt = row_of[a["lanes"][sel]], a["t"][sel] - t_off
    flat[:m] = pr * t_grid + pt
    is_mkt = (a["kind"][sel] == MARKET) & (a["action"][sel] == ACTION_ADD)
    for i, val in enumerate(
        (
            a["action"][sel],
            a["side"][sel],
            is_mkt,
            np.where(is_mkt, 0, a["price"][sel] - a["bases"][sel]),
            a["volume"][sel],
            a["oid_ids"][sel],
            a["uid_ids"][sel],
        )
    ):
        cols[i, :m] = val
    meta = {
        "lane": a["lanes"][sel],
        "row": pr,
        "t": pt,
        "arrival": sel.astype(np.int64),
        "action": a["action"][sel],
        "side": a["side"][sel],
        "is_market": is_mkt.astype(np.int64),
        "price": a["price"][sel],
        "price_base": a["bases"][sel],
        "oid_id": a["oid_ids"][sel],
        "uid_id": a["uid_ids"][sel],
    }
    return cols, flat, meta


def _tables(eng):
    return dict(
        symbols=eng.symbols.to_list(),
        oid_table=eng.oids.table,
        uid_table=eng.uids.table,
    )


def _assemble(eng, a, batches):
    """Join a frame's per-grid event columns in arrival order and count
    them (once per applied frame, on either path)."""
    # Timeline flow counters (obs.timeline): _assemble runs exactly once
    # per applied frame on BOTH execution paths, so a frame count cannot
    # double on an exact-path fallback. Disabled sampler = one attribute
    # check, zero allocations.
    TIMELINE.note_frame(a["n"])
    eng.stats.orders += a["n"]
    if not batches:
        eng.stats.cancels_missed += a["dels_total"]
        return empty_batch(**_tables(eng))
    out_cols = {
        name: np.concatenate([b[name] for b in batches])
        for name in batches[0]
    }
    order = np.argsort(out_cols["arrival"], kind="stable")
    out_cols = {name: v[order] for name, v in out_cols.items()}
    batch = EventBatch(columns=out_cols, **_tables(eng))
    cancels = int(batch.columns["is_cancel"].sum())
    eng.stats.cancels += cancels
    eng.stats.fills += len(batch) - cancels
    eng.stats.cancels_missed += a["dels_total"] - cancels
    return batch


def apply_frame(eng: BatchEngine, cols: dict):
    """Exact synchronous frame application (one _run_exact per grid);
    returns an EventBatch identical to process_columnar on the same
    orders. Caller guarantees admission was already applied."""
    with TRACER.stage("pad_pack"):
        a = _frame_arrays(eng, cols)
        grids = pack_frame_grids(eng, a)
    batches = []
    for ops, meta, lane_ids, cap_g in grids:
        contexts = {
            (int(r), int(tt)): None for r, tt in zip(meta["row"], meta["t"])
        }
        outs, overrides = eng._run_exact(ops, contexts, lane_ids, cap_g)
        batches.append(
            decode_grid_columnar(meta, splice_outs(outs, overrides))
        )
    # Nothing in flight: re-anchor count_ub exactly so the grow-only ADD
    # increments cannot drift classes upward forever. Only when cap
    # classes are live.
    if len(_cap_ladder(eng.config.cap)) > 1 and eng._ub_extra.any():
        eng._note_exact_counts(
            eng._host_leaf(eng.books, "count").max(axis=1)
        )
    return _assemble(eng, a, batches)


def process_frame(eng: BatchEngine, cols: dict):
    """Transactional wrapper (same rollback contract as process_columnar)."""
    cp = eng._checkpoint()
    try:
        return apply_frame(eng, cols)
    except Exception:
        eng._restore(cp)
        raise


# --- device-side event compaction (the fast path) -----------------------


#: Row order of the packed compaction matrices (fetch layout).
_FILL_FIELDS = (
    "src", "fill_price", "fill_qty", "maker_oid", "maker_uid",
    "maker_volume", "taker_after",
)
_CANCEL_FIELDS = ("src", "volume")


def _decode_compact(eng, meta, shape, fetched) -> dict:
    """Host-side decode of one grid's compacted events into raw event
    columns (decode_grid_columnar's output shape, same ordering rule)."""
    t_len, k = shape
    totals, fills, cancels = fetched
    nf, nc = int(totals[0]), int(totals[1])
    if nativehost.available():
        return nativehost.decode_compact(
            meta, t_len, k, nf, nc, fills, cancels
        )

    # (row, t) -> packed-op index join table.
    n_rows = int(meta["_n_rows"])
    op_index = np.full((n_rows, t_len), -1, np.int64)
    op_index[meta["row"], meta["t"]] = np.arange(len(meta["row"]))

    src = fills["src"][:nf].astype(np.int64)
    rr = src // (t_len * k)
    tt = (src // k) % t_len
    pos = op_index[rr, tt]  # every fill belongs to a packed ADD
    base = meta["price_base"][pos]
    fill_cols = {
        "arrival": meta["arrival"][pos],
        "is_cancel": np.zeros(nf, np.bool_),
        "symbol_id": meta["lane"][pos],
        "taker_uid": meta["uid_id"][pos],
        "taker_oid": meta["oid_id"][pos],
        "taker_side": meta["side"][pos].astype(np.int8),
        "taker_price": meta["price"][pos],
        "taker_volume": fills["taker_after"][:nf].astype(np.int64),
        "maker_uid": fills["maker_uid"][:nf].astype(np.int64),
        "maker_oid": fills["maker_oid"][:nf].astype(np.int64),
        "fill_price": fills["fill_price"][:nf].astype(np.int64) + base,
        "maker_volume": fills["maker_volume"][:nf].astype(np.int64),
        "match_volume": fills["fill_qty"][:nf].astype(np.int64),
        "is_market": meta["is_market"][pos].astype(np.bool_),
    }

    csrc = cancels["src"][:nc].astype(np.int64)
    cpos = op_index[csrc // t_len, csrc % t_len]
    cvol = cancels["volume"][:nc].astype(np.int64)
    cancel_cols = {
        "arrival": meta["arrival"][cpos],
        "is_cancel": np.ones(nc, np.bool_),
        "symbol_id": meta["lane"][cpos],
        "taker_uid": meta["uid_id"][cpos],
        "taker_oid": meta["oid_id"][cpos],
        "taker_side": meta["side"][cpos].astype(np.int8),
        "taker_price": meta["price"][cpos],
        "taker_volume": cvol,
        "maker_uid": meta["uid_id"][cpos],
        "maker_oid": meta["oid_id"][cpos],
        "fill_price": meta["price"][cpos],
        "maker_volume": cvol,
        "match_volume": np.zeros(nc, np.int64),
        "is_market": np.zeros(nc, np.bool_),
    }
    columns = {
        name: np.concatenate(
            [np.asarray(fill_cols[name], dt), np.asarray(cancel_cols[name], dt)]
        )
        for name, dt in _COLUMNS
    }
    # Global emission order: arrival, then record order within the op (the
    # fill src values are (r, t, k)-ascending; a stable sort keeps that).
    order = np.argsort(columns["arrival"], kind="stable")
    return {name: v[order] for name, v in columns.items()}


def compact_accum(outs, fills_acc, cancels_acc, totals_acc, g: int):
    """Append one grid's compacted events into the FRAME-level buffers, in
    place, with no host sync.

    Events land at the frame's running offsets (the sums of earlier
    grids' counts in totals_acc), so the whole frame resolves with one
    fetch of three tensors. The event buffers are [F, e + 1]: column e is
    the sentinel where every dropped write lands (record slots without a
    fill, and appends past the buffer), so the events are the [:, :e]
    prefix. totals_acc[g] records this grid's TRUE fill and cancel counts
    (the whole mask sums, even when appends dropped), the sum of its
    book_overflow flags and its largest n_fills."""
    e_fills = fills_acc.shape[1] - 1
    e_cancels = cancels_acc.shape[1] - 1
    wide = fills_acc.dtype
    off_f = totals_acc[:, 0].sum()
    off_c = totals_acc[:, 1].sum()
    fq = outs.fill_qty  # [R, T, K]
    r, t_len, k = fq.shape
    mask = (fq > 0).reshape(-1)
    idx = torch.cumsum(mask, 0) - 1
    tgt = torch.where(mask, (off_f + idx).clamp(max=e_fills), e_fills)
    maker_volume = torch.where(
        outs.maker_remaining == 0, outs.maker_prefill, outs.maker_remaining
    )
    fill_src = dict(
        src=torch.arange(r * t_len * k, dtype=torch.int32, device=fq.device),
        fill_price=outs.fill_price,
        fill_qty=fq,
        maker_oid=outs.maker_oid,
        maker_uid=outs.maker_uid,
        maker_volume=maker_volume,
        taker_after=outs.taker_after,
    )
    vals = torch.stack(
        [fill_src[f].reshape(-1).to(wide) for f in _FILL_FIELDS]
    )
    fills_acc[:, tgt] = vals

    cmask = (outs.cancel_found != 0).reshape(-1)  # [R*T]
    cidx = torch.cumsum(cmask, 0) - 1
    ctgt = torch.where(cmask, (off_c + cidx).clamp(max=e_cancels), e_cancels)
    cancel_src = dict(
        src=torch.arange(r * t_len, dtype=torch.int32, device=fq.device),
        volume=outs.cancel_volume,
    )
    cvals = torch.stack(
        [cancel_src[f].reshape(-1).to(wide) for f in _CANCEL_FIELDS]
    )
    cancels_acc[:, ctgt] = cvals
    totals_acc[g] = torch.stack(
        [
            mask.sum(),
            cmask.sum(),
            outs.book_overflow.sum(),
            outs.n_fills.max().to(torch.int64),
        ]
    ).to(torch.int32)
    return fills_acc, cancels_acc, totals_acc


class PendingFrame:
    """A frame whose grids are queued on the card but not yet resolved:
    everything resolve_frame needs, plus the checkpoint that makes a
    tripped budget or failure recoverable."""

    __slots__ = ("cols", "arrays", "checkpoint", "items", "compact",
                 "n_kept", "fetched")

    def __init__(self, cols, arrays, checkpoint, items, compact, n_kept,
                 fetched):
        # The admitted columns: FramePipeline re-runs them exactly, or
        # resubmits them, when an earlier frame's recovery rewinds.
        self.cols = cols
        self.arrays = arrays  # incl. add_counts for the count_ub handoff
        self.checkpoint = checkpoint
        self.items = items  # [(meta, (t_grid, K))]
        # (totals_acc, fills_acc, cancels_acc) on the device, or None.
        self.compact = compact
        self.n_kept = n_kept
        # (event, host totals, host counts_max | None): the phase-1 copies,
        # started at submit; `event` (None off the card) marks their end.
        # counts_max is the post-frame per-lane max-side resting count,
        # riding the frame's first fetch to re-anchor count_ub.
        self.fetched = fetched


def _fetch_async(t: torch.Tensor) -> torch.Tensor:
    """Start a device->host copy into a pinned host tensor (a plain copy
    off the card)."""
    host = torch.empty(
        t.shape, dtype=t.dtype, pin_memory=t.device.type == "cuda"
    )
    host.copy_(t, non_blocking=True)
    return host


def submit_frame(eng: BatchEngine, cols: dict) -> PendingFrame:
    """Queue every grid of the frame and its device-side compaction back
    to back (no host sync) and start the asynchronous device->host copy of
    the frame totals. Advances eng.books. Raises (with rollback) only on
    host-side errors; device budget trips surface at resolve_frame."""
    cp = eng._checkpoint()
    try:
        # Packing and the grid scatters' queueing: host work (the scatters
        # themselves run on the card, asynchronously).
        with TRACER.stage("pad_pack"):
            a = _frame_arrays(eng, cols)
            grids = pack_frame_grids(eng, a)
        books = eng.books
        items = []
        compact = fetched = None
        n_kept = int(np.count_nonzero(a["keep"]))
        if grids:
            e_fills, e_cancels = _compact_sizes(
                eng, n_kept, a["dels_total"]
            )
            # result_type(int32, book dtype); one sentinel column each.
            wide = torch.promote_types(torch.int32, eng.config.dtype)
            dev = eng.device
            fills_acc = torch.zeros(
                (len(_FILL_FIELDS), e_fills + 1), dtype=wide, device=dev
            )
            cancels_acc = torch.zeros(
                (len(_CANCEL_FIELDS), e_cancels + 1), dtype=wide, device=dev
            )
            totals_acc = torch.zeros(
                (max(_next_pow2(len(grids)), 8), 4), dtype=torch.int32,
                device=dev,
            )
        for g_i, (ops, meta, lane_ids, cap_g) in enumerate(grids):
            t_disp = TRACER.clock() if TRACER.enabled else 0.0
            t_disp_j = JOURNAL.clock() if JOURNAL.enabled else 0.0
            with TRACER.annotation("grid_dispatch"):
                books, outs = eng._step(books, ops, lane_ids, cap_g)
                eng.stats.device_calls += 1
                n_rows, t_grid = outs.n_fills.shape
                compact_accum(outs, fills_acc, cancels_acc, totals_acc, g_i)
            meta["_n_rows"] = n_rows
            # The record axis K comes from the ARRAY, never from
            # config.max_fills: with cap < max_fills the step's record axis
            # clamps to the cap, and the decode's flat src arithmetic and
            # the truncation check must use the K the records were emitted
            # with.
            k_rec = int(outs.fill_qty.shape[-1])
            items.append((meta, (t_grid, k_rec)))
            # The full dispatch combo (grid geometry x frame buffers; the
            # buffers' event capacity, their sentinel column aside), as the
            # reference records it.
            combo = (
                n_rows, t_grid, int(cap_g), lane_ids is not None,
                _packed_axis(len(meta["arrival"])), k_rec,
                e_fills, e_cancels, int(totals_acc.shape[0]),
            )
            if TRACER.enabled:
                # Dispatch cost split by whether this shape combo ran
                # before. The launches are asynchronous, so both spans
                # time the host's queueing; a first-seen combo's also
                # holds the first launch at its shapes and the caching
                # allocator's growth for its buffers.
                TRACER.observe_span(
                    "compile_hit" if eng.combo_seen(combo)
                    else "compile_miss",
                    t_disp, TRACER.clock(),
                )
            if JOURNAL.enabled and not eng.combo_seen(combo):
                # Compile journal: the SAME miss path, recording the combo
                # itself plus its analytic cost block.
                JOURNAL.record(
                    "frame_dispatch", combo,
                    JOURNAL.clock() - t_disp_j,
                    detail=frame_combo_detail(
                        numpy_dtype(eng.config.dtype).name, combo
                    ),
                )
            eng.record_combo(combo)
        eng.books = books
        if grids:
            compact = (totals_acc, fills_acc, cancels_acc)
            # Phase-1 fetch starts now: totals (+ counts_max) are tiny and
            # resolve needs them first. Only multi-class engines read
            # counts_max.
            counts_max = (
                _fetch_async(_counts_max(eng, books))
                if len(_cap_ladder(eng.config.cap)) > 1 else None
            )
            totals = _fetch_async(totals_acc)
            event = None
            if eng.device.type == "cuda":
                # On the engine's own stream: the copies above were queued
                # there, whichever card is current.
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(eng.device))
            fetched = (event, totals, counts_max)
        return PendingFrame(cols, a, cp, items, compact, n_kept, fetched)
    except Exception:
        eng._restore(cp)
        raise


def _counts_max(eng: BatchEngine, books) -> torch.Tensor:
    """Per-lane max-side resting count [S] on the engine's device (under a
    mesh each shard's [S/D] reduced on its device, joined on the home
    device)."""
    if eng.mesh is None:
        return books.count.max(dim=-1).values
    return books.map(lambda b: b.count.max(dim=-1).values).gather()


def _prefix_slice_fn(mat: torch.Tensor, length: int) -> np.ndarray:
    """Phase 2 of the frame fetch: the used prefix [F, :length] of an
    event buffer, copied to the host (a plain slice; length is
    pow2-bucketed by the caller)."""
    return _host(mat[:, :length])


def resolve_frame(eng: BatchEngine, pend: PendingFrame):
    """Fetch and decode a submitted frame — a TWO-phase device->host fetch:

      1. the [G, 4] totals (+ the [S] count_ub re-anchor), already in
         flight since submit;
      2. the USED PREFIX of the fill/cancel event buffers, pow2-bucketed
         from the totals, so the transfer scales with the frame's events,
         not with the buffers' capacity.

    Raises _NeedExact when a device budget tripped; the caller owns the
    recovery (rewind to pend.checkpoint, run exactly)."""
    if pend.compact is None:
        return _assemble(eng, pend.arrays, [])
    global FETCH_SECONDS, FETCH_TOTALS_SECONDS
    t0 = time.perf_counter()
    ts0 = TRACER.clock() if TRACER.enabled else 0.0
    event, totals_host, counts_host = pend.fetched
    if event is not None:
        event.synchronize()
    totals = totals_host.numpy()
    counts_max = None if counts_host is None else counts_host.numpy()
    spent = time.perf_counter() - t0
    FETCH_SECONDS += spent
    FETCH_TOTALS_SECONDS += spent
    if TRACER.enabled:
        # The totals fetch is the frame's completion barrier: waiting on
        # it drains every queued grid, so this IS the device-execute wait.
        # (Span clock = the tracer's, which tests may script.)
        TRACER.observe_span("device_execute", ts0, TRACER.clock())
    _, fills_dev, cancels_dev = pend.compact
    e_fills = fills_dev.shape[1] - 1
    e_cancels = cancels_dev.shape[1] - 1
    g = len(pend.items)
    nf_g = totals[:g, 0].astype(np.int64)
    nc_g = totals[:g, 1].astype(np.int64)
    total_f = int(nf_g.sum())
    total_c = int(nc_g.sum())
    # A fills-buffer overflow ratchets the grow-only floor (keyed by the
    # FRAME's kept-op class) BEFORE the exact fallback, so the next frame
    # fits. The totals are TRUE counts, so one step reaches the right size.
    tripped = False
    if total_f > e_fills:
        cls = eng._buf_class(pend.n_kept)
        eng._fills_buf_floor[cls] = max(
            eng._fills_buf_floor.get(cls, 0), _next_pow2(total_f)
        )
        tripped = True
    if (
        tripped
        or int(totals[:g, 2].sum()) > 0  # book overflow: state is wrong
        # Records truncated: an op produced more fills than the K its
        # grid's record arrays were emitted with.
        or any(
            int(totals[i, 3]) > shape[1]
            for i, (_, shape) in enumerate(pend.items)
        )
        # Unreachable by construction (cancels <= the frame's DEL count,
        # which sizes the buffer) — defensive only.
        or total_c > e_cancels
    ):
        raise _NeedExact()
    # Phase 2: the used prefixes, now the true counts are known.
    t0 = time.perf_counter()
    ts0 = TRACER.clock() if TRACER.enabled else 0.0
    f_len = min(_next_pow2(max(total_f, 64)), e_fills)
    c_len = min(_next_pow2(max(total_c, 64)), e_cancels)
    fills_mat = _prefix_slice_fn(fills_dev, f_len)
    cancels_mat = _prefix_slice_fn(cancels_dev, c_len)
    FETCH_SECONDS += time.perf_counter() - t0
    if TRACER.enabled:
        TRACER.observe_span("device_execute", ts0, TRACER.clock())
    # Re-anchor count_ub from this frame's true post-frame counts (extra
    # minus THIS frame's increments is the still-in-flight sum).
    if counts_max is not None:
        eng._note_exact_counts(counts_max, pend.arrays["add_counts"])
    off_f = np.concatenate(([0], np.cumsum(nf_g)))
    off_c = np.concatenate(([0], np.cumsum(nc_g)))
    batches = []
    with TRACER.stage("decode"):
        for i, (meta, shape) in enumerate(pend.items):
            fills = {
                f: fills_mat[j, off_f[i] : off_f[i + 1]]
                for j, f in enumerate(_FILL_FIELDS)
            }
            cancels = {
                f: cancels_mat[j, off_c[i] : off_c[i + 1]]
                for j, f in enumerate(_CANCEL_FIELDS)
            }
            batches.append(
                _decode_compact(
                    eng, meta, shape, (totals[i], fills, cancels)
                )
            )
    return _assemble(eng, pend.arrays, batches)


def apply_frame_fast(eng: BatchEngine, cols: dict):
    """The hot path, single-frame form: submit + resolve with one
    two-phase fetch; falls back — transactionally — to the exact path when
    any device budget tripped. Semantics identical to apply_frame."""
    pend = submit_frame(eng, cols)
    try:
        return resolve_frame(eng, pend)
    except _NeedExact:
        eng.stats.frame_fallbacks += 1
        eng._restore(pend.checkpoint)
        try:
            return apply_frame(eng, cols)
        except Exception:
            eng._restore(pend.checkpoint)
            raise
    except Exception:
        eng._restore(pend.checkpoint)
        raise


def _compact_sizes(eng, n_ops: int, n_dels: int) -> tuple[int, int]:
    """Compaction buffer sizes for a frame of n_ops kept ops (n_dels of
    them DELs), pow2-bucketed and grow-only per op-count class
    (BatchEngine._fills_buf_floor):

      fills   — next_pow2(n_ops) (<= 1 fill per op on average) or the
                class's floor, whichever is larger; a frame whose fills
                overflow it re-runs exactly and raises the floor;
      cancels — next_pow2 of the DEL count (the exact upper bound for its
                cancel events) or the class's floor."""
    cls = eng._buf_class(n_ops)
    fills = max(cls, eng._fills_buf_floor.get(cls, 0))
    cancels = max(
        _next_pow2(max(n_dels, 64)), eng._cancels_buf_floor.get(cls, 0)
    )
    eng._fills_buf_floor[cls] = fills
    eng._cancels_buf_floor[cls] = cancels
    return fills, cancels


def precompile_combos(eng: BatchEngine, combos) -> int:
    """Replay recorded fast-path shape combos (BatchEngine.shape_manifest
    "combos") with ALL-PADDING inputs through the frame path's own device
    work — the grid scatter, the step (dense or full, at the combo's cap
    class: one K1 launch), and the frame-level compaction — before real
    traffic arrives.

    All-padding: scatter positions at the drop sentinel (R*T), so the
    DeviceOp grid is all NOPs; dense lane ids at the n_slots sentinel
    (gathered as zero books, scattered nowhere). The step's new books are
    discarded: replay never mutates the engine. PyTorch has no trace
    cache, so a replay warms the caching allocator's pools at the frame's
    shapes and the pinned host blocks of the fetch; prewarm_geometry
    first makes the live flow CHOOSE these shapes.

    Returns the number of combos replayed. A stale combo (another tuple
    layout, a full grid whose n_rows no longer equals n_slots, a cap class
    above the storage cap) is skipped on its own."""
    dt = numpy_dtype(eng.config.dtype)
    wide = torch.promote_types(torch.int32, eng.config.dtype)
    combos = sorted(set(map(tuple, combos)))
    replayed = 0
    failed = 0
    for combo in combos:
        try:
            (
                n_rows, t_grid, cap_g, dense, m_pad, k_rec,
                e_fills, e_cancels, totals_len,
            ) = combo
            if cap_g > eng.config.cap:
                # Recorded after a storage-cap escalation this engine has
                # not done (load_geometry runs ensure_cap first).
                continue
            cols = np.zeros((len(DeviceOp._fields), m_pad), dt)
            flat = np.full(m_pad, n_rows * t_grid, np.int64)
            ops = _grid_ops(eng, cols, flat, n_rows, t_grid)
            lane_ids = (
                np.full(n_rows, eng.n_slots, np.int64) if dense else None
            )
            if lane_ids is None and n_rows != eng.n_slots:
                raise ValueError(f"full-grid combo {combo} at "
                                 f"{eng.n_slots} lanes")
            _books, outs = eng._step(eng.books, ops, lane_ids, cap_g)
            dev = eng.device
            compact_accum(
                outs,
                torch.zeros((len(_FILL_FIELDS), e_fills + 1), dtype=wide,
                            device=dev),
                torch.zeros((len(_CANCEL_FIELDS), e_cancels + 1),
                            dtype=wide, device=dev),
                torch.zeros((totals_len, 4), dtype=torch.int32, device=dev),
                0,
            )
            # Serialise: each replay holds a transient books-sized
            # output; waiting frees it before the next combo allocates.
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except Exception:
            failed += 1
            continue
        eng.record_combo(combo)
        replayed += 1
    if failed:
        from ..utils.logging import get_logger

        get_logger("frames").warning(
            "precompile_combos: %d stale combo(s) skipped, %d replayed",
            failed, replayed,
        )
    # The pinned host blocks of the phase-1 fetch: the count_ub
    # re-anchor (multi-class engines) and the totals at each recorded
    # length. (Phase 2 copies into pageable memory: nothing to warm.)
    if len(_cap_ladder(eng.config.cap)) > 1:
        _fetch_async(_counts_max(eng, eng.books))
    for totals_len in {c[8] for c in combos if len(c) == 9}:
        _fetch_async(torch.zeros((totals_len, 4), dtype=torch.int32,
                                 device=eng.device))
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return replayed


class _NeedExact(Exception):
    """Internal: a device budget tripped on the fast path — roll back and
    re-run the frame on the exact escalating path."""


def orders_from_frame(cols: dict):
    """Decode an ORDER frame into Order objects (the compatibility path
    for callers without a frame pipeline)."""
    syms, uuids = cols["symbols"], cols["uuids"]
    sidx, uidx = cols["symbol_idx"].tolist(), cols["uuid_idx"].tolist()
    traces = cols.get("trace")  # traced frames carry per-order contexts
    traces = traces.tolist() if traces is not None else None
    out = []
    for i, (a, s, k, p, v, o) in enumerate(
        zip(
            cols["action"].tolist(), cols["side"].tolist(),
            cols["kind"].tolist(), cols["price"].tolist(),
            cols["volume"].tolist(), cols["oids"].tolist(),
        )
    ):
        trace = None
        if traces is not None and traces[i]:
            trace = traces[i].decode()
        out.append(
            Order(
                uuid=uuids[uidx[i]], oid=o.decode(), symbol=syms[sidx[i]],
                side=Side(int(s)), price=int(p), volume=int(v),
                action=Action(int(a)), order_type=OrderType(int(k)),
                trace=trace,
            )
        )
    return out


def _prepare_bases_vec(eng, lanes, action, kind, price) -> np.ndarray:
    """Vectorized _prepare_bases: same semantics as the object path
    (ADD-limit-only grow-only envelope; commit after checks;
    unrepresentable DELs dropped as misses), with numpy segment min/max
    and a Python loop only over the UNIQUE lanes admitting prices."""
    n = len(lanes)
    drop = np.zeros(n, bool)
    if not eng._rebase:
        return drop
    adm = (action == ACTION_ADD) & (kind != MARKET)
    if adm.any():
        al = lanes[adm]
        ap = price[adm]
        # Steady state: prices inside their lane's admitted envelope AND
        # within REBASE_LIMIT of its base need no work at all.
        inside = (
            eng._base_set[al]
            & (ap >= eng._env_lo[al])
            & (ap <= eng._env_hi[al])
            & (np.abs(ap - eng.price_base[al]) <= eng.REBASE_LIMIT)
        )
        if not inside.all():
            viol = ~inside
            al, ap = al[viol], ap[viol]
            uniq = np.unique(al)
            lo = np.full(eng.n_slots, np.iinfo(np.int64).max)
            hi = np.full(eng.n_slots, np.iinfo(np.int64).min)
            np.minimum.at(lo, al, ap)
            np.maximum.at(hi, al, ap)
            # Vectorized widen for lanes that only need their envelope
            # stretched (base set, no recenter); seeding and recentering
            # stay on the exact scalar path.
            b = eng.price_base[uniq]
            easy = eng._base_set[uniq] & (
                np.maximum(np.abs(lo[uniq] - b), np.abs(hi[uniq] - b))
                <= eng.REBASE_LIMIT
            )
            ez = uniq[easy]
            eng._env_lo[ez] = np.minimum(eng._env_lo[ez], lo[ez])
            eng._env_hi[ez] = np.maximum(eng._env_hi[ez], hi[ez])
            for lane in uniq[~easy].tolist():
                eng._admit_lane_range(int(lane), int(lo[lane]), int(hi[lane]))
    dels = action == ACTION_DEL
    if dels.any():
        dl = lanes[dels]
        drop[dels] = (
            np.abs(price[dels] - eng.price_base[dl]) > eng._INT32_SAFE
        )
    return drop
