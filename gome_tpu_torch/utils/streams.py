"""Synthetic order-stream generators for tests and benchmarks.

Models the reference's only load generator (gomengine/doorder.go:37-59: 1,999
pseudo-random limit orders, random side, 2-decimal price/volume in (0,1],
fixed uuid, one symbol) plus the BASELINE.json configs the reference lacks:
100-symbol Poisson flow (config 3), 10K-symbol Zipf-skewed flow (config 4),
and mixed streams with cancels (config 2) / market orders (config 5).
"""

from __future__ import annotations

import random

from ..fixed import scale
from ..types import Action, Order, OrderType, Side


def doorder_stream(
    n: int = 1999,
    symbol: str = "eth2usdt",
    seed: int = 0,
    accuracy: int = 8,
    uuid: str = "2",
) -> list[Order]:
    """doorder.go-style stream: random BUY/SALE, price/volume uniform in
    (0,1] rounded to 2 decimals (doorder.go:38-47), oid = loop index."""
    rng = random.Random(seed)
    orders = []
    for i in range(1, n + 1):
        price = round(rng.uniform(0.01, 1.0), 2)
        volume = round(rng.uniform(0.01, 1.0), 2)
        orders.append(
            Order(
                uuid=uuid,
                oid=str(i),
                symbol=symbol,
                side=Side(rng.randrange(2)),
                price=scale(price, accuracy),
                volume=scale(volume, accuracy),
            )
        )
    return orders


def mixed_stream(
    n: int = 2000,
    symbol: str = "eth2usdt",
    seed: int = 0,
    accuracy: int = 8,
    cancel_prob: float = 0.2,
    market_prob: float = 0.0,
    n_users: int = 8,
    price_range: tuple[float, float] = (0.90, 1.10),
) -> list[Order]:
    """Mixed add/cancel (and optionally market) stream — BASELINE configs 2/5.

    Cancels target a random still-open prior order with its exact resting
    price and side (the reference's cancel contract, SURVEY §2.3.2).
    """
    rng = random.Random(seed)
    orders: list[Order] = []
    open_orders: list[Order] = []
    oid = 0
    for _ in range(n):
        if open_orders and rng.random() < cancel_prob:
            target = open_orders.pop(rng.randrange(len(open_orders)))
            orders.append(
                Order(
                    uuid=target.uuid,
                    oid=target.oid,
                    symbol=symbol,
                    side=target.side,
                    price=target.price,
                    volume=target.volume,
                    action=Action.DEL,
                )
            )
            continue
        oid += 1
        is_market = rng.random() < market_prob
        price = round(rng.uniform(*price_range), 2)
        volume = round(rng.uniform(0.01, 2.0), 2)
        order = Order(
            uuid=str(rng.randrange(n_users)),
            oid=f"o{oid}",
            symbol=symbol,
            side=Side(rng.randrange(2)),
            price=scale(price, accuracy),
            volume=scale(volume, accuracy),
            order_type=OrderType.MARKET if is_market else OrderType.LIMIT,
        )
        orders.append(order)
        if not is_market:
            open_orders.append(order)
            if len(open_orders) > 256:
                open_orders.pop(0)
    return orders


def multi_symbol_stream(
    n: int,
    n_symbols: int,
    seed: int = 0,
    accuracy: int = 8,
    zipf_a: float | None = None,
    cancel_prob: float = 0.0,
    price_range: tuple[float, float] = (0.90, 1.10),
) -> list[Order]:
    """Multi-symbol flow — BASELINE configs 3 (uniform ≈ Poisson merge) and 4
    (zipf_a set ⇒ Zipf-skewed per-symbol arrival rates)."""
    rng = random.Random(seed)
    if zipf_a is not None:
        weights = [1.0 / (k + 1) ** zipf_a for k in range(n_symbols)]
    else:
        weights = [1.0] * n_symbols
    symbols = [f"sym{k}" for k in range(n_symbols)]
    open_by_symbol: dict[str, list[Order]] = {s: [] for s in symbols}
    orders: list[Order] = []
    oid = 0
    choices = rng.choices(range(n_symbols), weights=weights, k=n)
    for k in choices:
        sym = symbols[k]
        opens = open_by_symbol[sym]
        if opens and rng.random() < cancel_prob:
            target = opens.pop(rng.randrange(len(opens)))
            orders.append(
                Order(
                    uuid=target.uuid,
                    oid=target.oid,
                    symbol=sym,
                    side=target.side,
                    price=target.price,
                    volume=target.volume,
                    action=Action.DEL,
                )
            )
            continue
        oid += 1
        order = Order(
            uuid=str(rng.randrange(8)),
            oid=f"o{oid}",
            symbol=sym,
            side=Side(rng.randrange(2)),
            price=scale(round(rng.uniform(*price_range), 2), accuracy),
            volume=scale(round(rng.uniform(0.01, 2.0), 2), accuracy),
        )
        orders.append(order)
        opens.append(order)
        if len(opens) > 64:
            opens.pop(0)
    return orders
