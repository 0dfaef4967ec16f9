"""Fixed-shape order-book state for a stack of symbol lanes, as torch tensors.

The port of ``gome_tpu/engine/book.py``. One symbol's book is five [2, cap]
integer arrays kept sorted in *priority order* per side:

  * side 0 (BUY bids):  descending price, FIFO (ascending seq) within price
  * side 1 (SALE asks): ascending price,  FIFO (ascending seq) within price

Active orders occupy a contiguous prefix of length ``count[side]``; slot 0 is
always the best-priority resting order. Keeping the invariant "sorted,
prefix-packed" turns matching into vector work: a crossing mask is a prefix,
fill quantities are one exclusive prefix sum, removals are a left shift and
inserts a right shift.

The engine stacks S lanes on a leading axis ([S, 2, cap] and so on). Prices
and volumes are scaled integer ticks/lots; oid/uid are integer handles
interned by the host (string ids never reach the device).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

BUY = 0
SALE = 1

_DTYPES = {"int32": torch.int32, "int64": torch.int64}


def torch_dtype(dtype) -> torch.dtype:
    """A torch integer dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype).name]


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype that matches a torch integer dtype."""
    return np.dtype(str(torch_dtype(dtype)).removeprefix("torch."))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another device. There is no silent fallback: with no card and no
    explicit ``device="cpu"`` this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gome_tpu_torch runs on a CUDA card and torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch version "
                "on the CPU"
            )
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class BookConfig:
    """Static book geometry.

    cap       — max resting orders per side per symbol. Overflow is reported
                (``book_overflow``) and the engine grows the books and re-runs
                the grid; nothing is silently dropped.
    max_fills — fill records emitted per op (K). An op crossing more than K
                resting orders still mutates the book exactly; the engine
                re-runs that lane with a larger record budget.
    dtype     — lot/price dtype, torch.int64 (default) or torch.int32. The
                int32 books store prices relative to a per-lane base.
    """

    cap: int = 256
    max_fills: int = 16
    dtype: torch.dtype = torch.int64

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    @property
    def seq_dtype(self) -> torch.dtype:
        return torch.int32


class BookState(NamedTuple):
    """Stacked books. price/lots/seq/oid/uid are [S, 2, cap]; count is
    [S, 2] int32 and next_seq [S] int32 (the time-priority stamp)."""

    price: torch.Tensor
    lots: torch.Tensor  # remaining lots; 0 <=> slot empty (beyond count)
    seq: torch.Tensor
    oid: torch.Tensor
    uid: torch.Tensor
    count: torch.Tensor
    next_seq: torch.Tensor


class DeviceOp(NamedTuple):
    """An op grid: every leaf is [S, T]. action/side/is_market are int32,
    the rest carry the book dtype."""

    action: torch.Tensor  # 0=NOP, 1=ADD, 2=DEL
    side: torch.Tensor  # 0=BUY, 1=SALE
    is_market: torch.Tensor  # bool as int32
    price: torch.Tensor  # ticks (rebased on int32 books)
    volume: torch.Tensor  # lots
    oid: torch.Tensor  # interned order id
    uid: torch.Tensor  # interned user id


#: DeviceOp fields carried as int32 regardless of the book value dtype.
GRID_I32_FIELDS = ("action", "side", "is_market")


class StepOutput(NamedTuple):
    """Fixed-shape per-op result. Record leaves are [S, T, K] in the book
    dtype; scalar leaves are [S, T].

    Fill j (j < min(n_fills, K)) reconstructs to one fill event:
      maker volume field = maker_prefill[j] if maker_remaining[j]==0 (full
      fill) else maker_remaining[j] (partial); taker volume field =
      taker_after[j].
    """

    fill_price: torch.Tensor  # [K] maker level price (the fill price)
    fill_qty: torch.Tensor  # [K] traded lots
    maker_oid: torch.Tensor  # [K]
    maker_uid: torch.Tensor  # [K]
    maker_prefill: torch.Tensor  # [K] maker lots before this fill
    maker_remaining: torch.Tensor  # [K] maker lots after this fill
    taker_after: torch.Tensor  # [K] taker remaining after fill j
    n_fills: torch.Tensor  # int32 total fills (may exceed K)
    fill_overflow: torch.Tensor  # int32 fills not captured in records
    taker_remaining: torch.Tensor  # dtype: taker lots left after matching
    rested: torch.Tensor  # int32 bool: remainder rested in the book
    book_overflow: torch.Tensor  # int32 bool: rest dropped, side full
    cancel_found: torch.Tensor  # int32 bool: DEL matched a resting order
    cancel_volume: torch.Tensor  # dtype: lots remaining at cancel


#: StepOutput leaves with a trailing record axis K.
RECORD_FIELDS = StepOutput._fields[:7]
#: StepOutput leaves carried as int32 (the others use the book dtype).
OUT_I32_FIELDS = (
    "n_fills", "fill_overflow", "rested", "book_overflow", "cancel_found",
)


def init_books(config: BookConfig, n_symbols: int, device=None) -> BookState:
    """An empty [n_symbols, ...] book stack on ``device`` (default: the
    CUDA card). Every leaf is its own zeroed tensor."""
    device = resolve_device(device)
    shape = (n_symbols, 2, config.cap)
    z = lambda dt: torch.zeros(shape, dtype=dt, device=device)
    return BookState(
        price=z(config.dtype),
        lots=z(config.dtype),
        seq=z(config.seq_dtype),
        oid=z(config.dtype),
        uid=z(config.dtype),
        count=torch.zeros((n_symbols, 2), dtype=torch.int32, device=device),
        next_seq=torch.zeros(n_symbols, dtype=config.seq_dtype, device=device),
    )


def grow_books(books: BookState, new_cap: int) -> BookState:
    """Widen the slot axis to ``new_cap``, zero-padding the tail. Active
    slots are a prefix, so padding on the right preserves every book. The
    input is left as it was (new tensors are returned)."""
    cap = books.price.shape[-1]
    if new_cap < cap:
        raise ValueError(f"cannot shrink cap {cap} -> {new_cap}")
    if new_cap == cap:
        return books
    widen = lambda a: torch.nn.functional.pad(a, (0, new_cap - cap))
    return books._replace(
        price=widen(books.price),
        lots=widen(books.lots),
        seq=widen(books.seq),
        oid=widen(books.oid),
        uid=widen(books.uid),
    )


def grow_lanes(books: BookState, n_lanes: int) -> BookState:
    """Append empty symbol lanes to a stacked [S, ...] book."""
    s = books.count.shape[0]
    if n_lanes < s:
        raise ValueError(f"cannot shrink lanes {s} -> {n_lanes}")
    if n_lanes == s:
        return books

    def pad(a):
        tail = torch.zeros(
            (n_lanes - s,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device
        )
        return torch.cat([a, tail])

    return BookState(*(pad(a) for a in books))


def book_depth(book: BookState, side: int, max_levels: int):
    """Aggregate [price, volume] depth view of ONE book ([2, cap] leaves),
    best-first. Returns (prices[max_levels], volumes[max_levels], n_levels)
    as int64 numpy arrays; unused slots are zero. Pass a
    BatchEngine.lane_books() lane to get absolute prices."""
    n_active = int(book.count[side])
    price = np.asarray(_host(book.price[side])[:n_active], dtype=np.int64)
    lots = np.asarray(_host(book.lots[side])[:n_active], dtype=np.int64)
    prices = np.zeros(max_levels, np.int64)
    volumes = np.zeros(max_levels, np.int64)
    # slots are priority-sorted, so equal prices are contiguous runs
    n = 0
    i = 0
    while i < n_active and n < max_levels:
        j = i
        while j < n_active and price[j] == price[i]:
            j += 1
        prices[n] = price[i]
        volumes[n] = lots[i:j].sum()
        n += 1
        i = j
    return prices, volumes, np.int32(n)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, queued with no host sync: on the card it
    goes up from a pinned copy by a non-blocking copy. The pinned block
    comes from CUDA's caching host allocator, which records the copy's
    event on it and reuses it only once the copy is done, so nothing here
    keeps it alive. Never a view of the array's memory. A read-only array
    (a snapshot's, loaded from disk) is copied first: torch takes no
    read-only memory."""
    t = torch.from_numpy(np.require(a, requirements=("C", "W")))
    if torch.device(device).type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)


def _host(a) -> np.ndarray:
    """A host numpy copy of a tensor (never a view of a CPU tensor's
    memory), or the array itself."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True).numpy()
    return np.asarray(a)
