"""Embedding the matching engine as a library — no gRPC, no queues.

The port of the reference's ``examples/embed.py``. Runs a mixed
limit/market/cancel stream through the batched engine (K1, the CUDA match
kernel, on the card) and prints fills, book depth and engine counters.
The book is a value you own.

    python -m gome_tpu_torch.examples.embed [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..engine import BatchEngine, BookConfig
from ..engine.book import BookState, book_depth
from ..fixed import scale
from ..scripts.common import require_device
from ..types import Action, Order, OrderType, Side


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch version)")
    args = ap.parse_args(argv)
    engine = BatchEngine(
        # int32 ticks; exact for any price magnitude via per-lane rebasing
        # (ARCHITECTURE.md "Numeric model"). Every kernel value runs K1 on
        # the card.
        BookConfig(cap=64, max_fills=8, dtype=torch.int32),
        n_slots=2,
        kernel="pallas",
        device=require_device(args.device),
    )

    mk = lambda oid, side, price, vol, **kw: Order(
        uuid="alice", oid=oid, symbol="btc2usdt", side=side,
        price=scale(price), volume=scale(vol), **kw
    )
    orders = [
        mk("a1", Side.SALE, 100_000.0, 0.5),   # ask rests
        mk("a2", Side.SALE, 100_010.0, 0.7),   # deeper ask
        mk("b1", Side.BUY, 100_005.0, 0.6),    # fills 0.5 @ 100000; the
        #   remainder 0.1 rests as a bid @ 100005
        mk("m1", Side.BUY, 0.0, 0.3, order_type=OrderType.MARKET),
        #   market: sweeps the best ask (a2) for 0.3
        mk("a1x", Side.SALE, 99_990.0, 0.2),   # crosses the resting bid b1
        Order(uuid="alice", oid="a2", symbol="btc2usdt", side=Side.SALE,
              price=scale(100_010.0), volume=0, action=Action.DEL),
    ]

    batch = engine.process_columnar(orders)
    for ev in batch.to_results():
        kind = "CANCEL" if ev.is_cancel else "FILL  "
        print(
            f"{kind} taker={ev.node.oid:<4} maker={ev.match_node.oid:<4} "
            f"qty={ev.match_volume} @ {ev.match_node.price}"
        )

    books = engine.lane_books()
    lane = engine.symbol_lane("btc2usdt")
    one = BookState(*(a[lane] for a in books))
    for side, name in ((0, "bids"), (1, "asks")):
        prices, vols, n = book_depth(one, side, max_levels=4)
        levels = [
            f"{int(prices[i])}x{int(vols[i])}" for i in range(int(n))
        ]
        print(f"{name}: {levels}")
    print(f"stats: {engine.stats}")
    engine.verify_books()
    print("book invariants OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
