"""The single-op book transition — ADD (match + rest), DEL (cancel), NOP —
applied to a batch of rows at once.

The port of ``gome_tpu/engine/step.py``. ``step_rows`` applies one op to each
of R independent books (one op per row), vectorised over the leading row
axis instead of vmapped. It is the plain PyTorch version of the match-step
kernel's per-op math (``gome_tpu_torch/ops/csrc/match_step.cu``):

  match   = crossing prefix + one saturating exclusive prefix sum + clip
  removal = left shift of the fully filled prefix
  rest    = right-shift insert at the priority slot
  cancel  = masked locate + left shift

Both the ADD and the DEL path are computed for every row and selected by
mask, so the function has no data-dependent control flow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import Action
from .book import BUY, BookConfig, BookState, DeviceOp, StepOutput

ACTION_NOP = int(Action.NOP)
ACTION_ADD = int(Action.ADD)
ACTION_DEL = int(Action.DEL)

# Saturation ceiling for 32-bit depth prefix sums. Every addend is clamped
# here and every partial sum is clamped again, so no 32-bit add overflows.
# Exactness (int32 operating contract, per-order lots <= LOT_MAX32): a fill
# only reads cum_excl through clip(volume - cum_excl, 0, lots), so any
# clamped value >= volume yields the same (zero) fill as the true sum, and
# partials below the clamp are exact. For nonnegative addends the clamped
# prefix equals min(true prefix, SAT32_MAX) whatever the summation order.
SAT32_MAX = (1 << 30) - 1
LOT_MAX32 = SAT32_MAX  # documented int32-mode per-order lot ceiling


class _Side(NamedTuple):
    """One side's slot arrays for every row: each leaf is [R, cap]."""

    price: torch.Tensor
    lots: torch.Tensor
    seq: torch.Tensor
    oid: torch.Tensor
    uid: torch.Tensor


def _sel(c, a, b):
    """Row-wise select: ``a`` where the [R] mask ``c`` is set, else ``b``;
    a and b are [R] or [R, cap]."""
    if a.dim() > c.dim():
        c = c[:, None]
    return torch.where(c, a, b)


def _sel_side(c, a: _Side, b: _Side) -> _Side:
    return _Side(*(_sel(c, x, y) for x, y in zip(a, b)))


def _exclusive_prefix(clots: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the slot axis. 32-bit books saturate at
    SAT32_MAX (see above); 64-bit books wrap like the hardware does."""
    shifted = torch.nn.functional.pad(clots[:, :-1], (1, 0))
    if clots.element_size() <= 4:
        cum = torch.cumsum(shifted.to(torch.int64), dim=1)
        return torch.clamp(cum, max=SAT32_MAX).to(clots.dtype)
    return torch.cumsum(shifted, dim=1)


def _shift_left(a: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """new[:, i] = a[:, i + by] (zero past the end), per-row shift ``by``."""
    cap = a.shape[1]
    src = torch.arange(cap, device=a.device)[None, :] + by[:, None]
    vals = torch.gather(a, 1, src.clamp(max=cap - 1))
    return torch.where(src < cap, vals, torch.zeros_like(vals))


def _shl1(a):
    return torch.nn.functional.pad(a[:, 1:], (0, 1))


def _shr1(a):
    return torch.nn.functional.pad(a[:, :-1], (1, 0))


def _match(config: BookConfig, opp: _Side, opp_count, side, price, volume,
           is_market):
    """Fill the crossing prefix of the opposing side. BUY takers hit asks
    with price <= limit, SALE takers bids with price >= limit, MARKET takers
    every active order; the side is priority-sorted, so crossing slots form
    a prefix."""
    cap, k = config.cap, config.max_fills
    idx = torch.arange(cap, device=opp.price.device)[None, :]
    active = idx < opp_count[:, None]
    crosses = torch.where(
        (side == BUY)[:, None],
        opp.price <= price[:, None],
        opp.price >= price[:, None],
    ) | (is_market != 0)[:, None]
    crossing = active & crosses

    clots = torch.where(crossing, opp.lots, torch.zeros_like(opp.lots))
    cum_excl = _exclusive_prefix(clots)
    fill = torch.minimum(
        torch.clamp(volume[:, None] - cum_excl, min=0), clots
    )
    total = fill.sum(dim=1)  # int64 accumulation
    remaining = (volume.to(torch.int64) - total).to(volume.dtype)

    new_lots = opp.lots - fill
    filled = fill > 0
    n_removed = (filled & (new_lots == 0)).sum(dim=1).to(torch.int32)
    n_fills = filled.sum(dim=1).to(torch.int32)

    # Fill records: fills occupy slots [0, n_fills) before compaction.
    taker_after = volume[:, None] - (cum_excl[:, :k] + fill[:, :k])
    out = dict(
        fill_price=opp.price[:, :k],
        fill_qty=fill[:, :k],
        maker_oid=opp.oid[:, :k],
        maker_uid=opp.uid[:, :k],
        maker_prefill=opp.lots[:, :k],
        maker_remaining=new_lots[:, :k],
        taker_after=torch.where(
            filled[:, :k], taker_after, torch.zeros_like(taker_after)
        ),
        n_fills=n_fills,
        fill_overflow=torch.clamp(n_fills - k, min=0),
    )
    compacted = _Side(
        *(_shift_left(a, n_removed) for a in opp._replace(lots=new_lots))
    )
    return compacted, opp_count - n_removed, remaining, out


def _insert(config: BookConfig, own: _Side, own_count, entry: _Side, side):
    """Rest the remainder at its own limit price: insert after the last
    slot whose priority beats or equals the new order, so existing
    same-price orders keep time priority. A full side is left unchanged and
    reports overflow."""
    idx = torch.arange(config.cap, device=own.price.device)[None, :]
    active = idx < own_count[:, None]
    beats = torch.where(
        (side == BUY)[:, None],
        own.price >= entry.price[:, None],
        own.price <= entry.price[:, None],
    )
    pos = (active & beats).sum(dim=1)[:, None]
    overflow = own_count >= config.cap

    def ins(a, v):
        shifted = torch.where(idx > pos, _shr1(a), a)
        return torch.where(idx == pos, v.to(a.dtype)[:, None], shifted)

    new = _Side(*(ins(a, v) for a, v in zip(own, entry)))
    new = _sel_side(overflow, own, new)
    return new, torch.where(overflow, own_count, own_count + 1), overflow


def _remove(config: BookConfig, own: _Side, own_count, oid, price):
    """Cancel: hit slots are active with the exact oid AND price (uid is not
    compared). pos and volume are masked sums over the hits (oids are unique
    by contract; with duplicates the sums are what the reference computes)."""
    idx = torch.arange(config.cap, device=own.price.device)[None, :]
    active = idx < own_count[:, None]
    hit = active & (own.oid == oid[:, None]) & (own.price == price[:, None])
    found = hit.any(dim=1)
    pos = torch.where(hit, idx, 0).sum(dim=1)[:, None]
    volume = torch.where(hit, own.lots, torch.zeros_like(own.lots)).sum(dim=1)

    removed = _Side(*(torch.where(idx >= pos, _shl1(a), a) for a in own))
    new = _sel_side(found, removed, own)
    count = torch.where(found, own_count - 1, own_count)
    return new, count, found, volume.to(own.lots.dtype)


def step_rows(
    config: BookConfig,
    buy: _Side,
    sale: _Side,
    buy_count: torch.Tensor,
    sale_count: torch.Tensor,
    next_seq: torch.Tensor,
    op: DeviceOp,
):
    """Apply one op per row to R books given as per-side [R, cap] rows.
    ``op`` leaves are [R]. Returns (buy', sale', buy_count', sale_count',
    next_seq', StepOutput with [R, K] records and [R] scalars). Inputs are
    never modified."""
    dt = config.dtype
    is_add = op.action == ACTION_ADD
    is_del = op.action == ACTION_DEL
    is_buy = op.side == BUY

    own0 = _sel_side(is_buy, buy, sale)
    opp0 = _sel_side(is_buy, sale, buy)
    own_count0 = torch.where(is_buy, buy_count, sale_count)
    opp_count0 = torch.where(is_buy, sale_count, buy_count)

    # ADD: match against the opposing side, then rest a limit remainder
    # (a MARKET remainder is dropped).
    opp1, opp_count1, remaining, fills = _match(
        config, opp0, opp_count0, op.side, op.price, op.volume, op.is_market
    )
    do_rest = is_add & (remaining > 0) & (op.is_market == 0)
    entry = _Side(
        price=op.price, lots=remaining, seq=next_seq + 1, oid=op.oid,
        uid=op.uid,
    )
    own1, own_count1, overflow = _insert(config, own0, own_count0, entry,
                                         op.side)
    # DEL: cancel.
    own2, own_count2, found, cancel_volume = _remove(
        config, own0, own_count0, op.oid, op.price
    )

    own_final = _sel_side(
        is_add, _sel_side(do_rest, own1, own0), _sel_side(is_del, own2, own0)
    )
    own_count_final = torch.where(
        is_add,
        torch.where(do_rest, own_count1, own_count0),
        torch.where(is_del, own_count2, own_count0),
    )
    opp_final = _sel_side(is_add, opp1, opp0)
    opp_count_final = torch.where(is_add, opp_count1, opp_count0)

    new_buy = _sel_side(is_buy, own_final, opp_final)
    new_sale = _sel_side(is_buy, opp_final, own_final)
    new_buy_count = torch.where(is_buy, own_count_final, opp_count_final)
    new_sale_count = torch.where(is_buy, opp_count_final, own_count_final)
    new_next_seq = torch.where(do_rest, next_seq + 1, next_seq)

    zero = lambda a: torch.zeros_like(a)
    rec = lambda f: _sel(is_add, fills[f], zero(fills[f]))
    i32 = lambda m: m.to(torch.int32)
    out = StepOutput(
        fill_price=rec("fill_price"),
        fill_qty=rec("fill_qty"),
        maker_oid=rec("maker_oid"),
        maker_uid=rec("maker_uid"),
        maker_prefill=rec("maker_prefill"),
        maker_remaining=rec("maker_remaining"),
        taker_after=rec("taker_after"),
        n_fills=rec("n_fills"),
        fill_overflow=rec("fill_overflow"),
        taker_remaining=torch.where(is_add, remaining, zero(remaining)).to(dt),
        rested=i32(do_rest & ~overflow),
        book_overflow=i32(do_rest & overflow),
        cancel_found=i32(is_del & found),
        cancel_volume=torch.where(
            is_del, cancel_volume, zero(cancel_volume)
        ).to(dt),
    )
    return new_buy, new_sale, new_buy_count, new_sale_count, new_next_seq, out


def book_to_rows(books: BookState):
    """[R, 2, cap] books -> (buy, sale, buy_count, sale_count, next_seq)."""
    buy = _Side(*(getattr(books, n)[:, 0] for n in _Side._fields))
    sale = _Side(*(getattr(books, n)[:, 1] for n in _Side._fields))
    return buy, sale, books.count[:, 0], books.count[:, 1], books.next_seq


def rows_to_book(buy: _Side, sale: _Side, nb, ns, nseq) -> BookState:
    pair = lambda b, a: torch.stack([b, a], dim=1)
    return BookState(
        price=pair(buy.price, sale.price),
        lots=pair(buy.lots, sale.lots),
        seq=pair(buy.seq, sale.seq),
        oid=pair(buy.oid, sale.oid),
        uid=pair(buy.uid, sale.uid),
        count=torch.stack([nb, ns], dim=1),
        next_seq=nseq,
    )


def step(config: BookConfig, books: BookState, op: DeviceOp):
    """Apply one op per row to [R, 2, cap] books (``op`` leaves [R])."""
    *rows, out = step_rows(config, *book_to_rows(books), op)
    return rows_to_book(*rows), out
