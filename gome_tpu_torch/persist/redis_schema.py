"""Export the engine's book state to the reference's exact Redis schema.

This makes the engine's state inspectable by any tooling written against
the reference's keys (SURVEY §2.1): for a symbol S, scaled price P, user U,
order O —

  S:BUY / S:SALE   zset   one member per occupied level, score = member =
                          scaled price (nodepool.go:71-73)
  S:depth          hash   field "S:depth:P" -> aggregate resting volume
                          (nodepool.go:61-63, ordernode.go:104-108)
  S:link:P         hash   "f"/"l" head/tail node names + one field
                          "S:node:O" per resting order holding the
                          JSON-encoded node with FIFO prev/next pointers
                          (nodelink.go; ordernode.go:110-117)
  S:comparison     hash   field "S:U:O" -> "1" per pre-pool mark
                          (nodepool.go:14-16, ordernode.go:89-92)

Command generation needs no Redis client (returns (cmd, *args) tuples,
testable offline); `export_to_redis` applies them and is gated on redis-py,
which is not a dependency of this package.

The port of ``gome_tpu/persist/redis_schema.py``: the same command list
for the same state (it reads the host copy BatchEngine.lane_books makes).
"""

from __future__ import annotations

import json

import numpy as np

from ..types import Action

_SIDE_KEY = {0: "BUY", 1: "SALE"}  # ordernode.go:94-102 zset key suffixes


def _fmt_price(ticks: int) -> str:
    """The reference renders scaled prices through shopspring decimal's
    String() on a float-held integer (ordernode.go:106,115) — for in-range
    integers that is the plain integer string."""
    return str(int(ticks))


def _node_json(
    symbol: str, uuid: str, oid: str, side: int, price: int, volume: int,
    prev_oid: str | None, next_oid: str | None, accuracy: int,
) -> str:
    """The resting-node JSON the reference stores in S:link:P (the
    serialized OrderNode, ordernode.go:9-36: domain fields + linked-list
    pointers + derived key names)."""
    node_name = f"{symbol}:node:{oid}"
    price_s = _fmt_price(price)
    return json.dumps(
        {
            "Action": int(Action.ADD),
            "Uuid": uuid,
            "Oid": oid,
            "Symbol": symbol,
            "Transaction": side,
            "Price": price,
            "Volume": volume,
            "Accuracy": accuracy,
            "NodeName": node_name,
            "IsFirst": prev_oid is None,
            "IsLast": next_oid is None,
            "PrevNode": f"{symbol}:node:{prev_oid}" if prev_oid else "",
            "NextNode": f"{symbol}:node:{next_oid}" if next_oid else "",
            "NodeLink": f"{symbol}:link:{price_s}",
            "OrderHashKey": f"{symbol}:comparison",
            "OrderHashField": f"{symbol}:{uuid}:{oid}",
            "OrderListZsetKey": f"{symbol}:{_SIDE_KEY[side]}",
            "OrderListZsetRKey": f"{symbol}:{_SIDE_KEY[1 - side]}",
            "OrderDepthHashKey": f"{symbol}:depth",
            "OrderDepthHashField": f"{symbol}:depth:{price_s}",
        },
        separators=(",", ":"),
    )


def book_redis_commands(
    engine, accuracy: int = 8, include_pre_pool: bool = True
) -> list[tuple]:
    """Generate the full command list re-creating the engine's current book
    state under the reference schema. `engine` is a MatchEngine (or anything
    with .batch and .pre_pool)."""
    batch = engine.batch
    books = batch.lane_books()
    cmds: list[tuple] = []
    n_lanes = int(books.count.shape[0])
    for lane in range(n_lanes):
        sym_id = lane + 1
        if sym_id >= len(batch.symbols):
            continue
        symbol = batch.symbols.lookup(sym_id)
        for side in (0, 1):
            count = int(books.count[lane, side])
            if count == 0:
                continue
            zset_key = f"{symbol}:{_SIDE_KEY[side]}"
            prices = np.asarray(books.price[lane, side][:count])
            lots = np.asarray(books.lots[lane, side][:count])
            oids = np.asarray(books.oid[lane, side][:count])
            uids = np.asarray(books.uid[lane, side][:count])
            # slots are priority-sorted; group contiguous equal prices into
            # levels (book.py invariant) — FIFO order within level is slot
            # order, which becomes the linked-list order.
            level_start = 0
            for i in range(count + 1):
                if i < count and prices[i] == prices[level_start]:
                    continue
                level = slice(level_start, i)
                p = int(prices[level_start])
                p_s = _fmt_price(p)
                cmds.append(("ZADD", zset_key, float(p), p_s))
                cmds.append(
                    (
                        "HSET",
                        f"{symbol}:depth",
                        f"{symbol}:depth:{p_s}",
                        str(int(lots[level].sum())),
                    )
                )
                link_key = f"{symbol}:link:{p_s}"
                level_oids = [
                    batch.oids.lookup(int(o)) for o in oids[level]
                ]
                level_uids = [
                    batch.uids.lookup(int(u)) for u in uids[level]
                ]
                cmds.append(
                    ("HSET", link_key, "f", f"{symbol}:node:{level_oids[0]}")
                )
                cmds.append(
                    ("HSET", link_key, "l", f"{symbol}:node:{level_oids[-1]}")
                )
                for j, oid in enumerate(level_oids):
                    cmds.append(
                        (
                            "HSET",
                            link_key,
                            f"{symbol}:node:{oid}",
                            _node_json(
                                symbol,
                                level_uids[j],
                                oid,
                                side,
                                p,
                                int(lots[level][j]),
                                level_oids[j - 1] if j > 0 else None,
                                level_oids[j + 1]
                                if j + 1 < len(level_oids)
                                else None,
                                accuracy,
                            ),
                        )
                    )
                level_start = i
    if include_pre_pool:
        for symbol, uuid, oid in sorted(engine.pre_pool):
            cmds.append(
                ("HSET", f"{symbol}:comparison", f"{symbol}:{uuid}:{oid}", "1")
            )
    return cmds


def export_to_redis(engine, accuracy: int = 8, client=None, flush: bool = False):
    """Apply book_redis_commands to a live Redis. Gated: redis-py is not a
    dependency, so a client (or an object with execute_command) must be
    injectable: persist.resp.RespClient or DictRedis."""
    if client is None:
        try:
            import redis  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "redis-py is not installed; pass an explicit client with an "
                "execute_command(*args) method"
            ) from e
        client = redis.Redis()
    if flush:
        client.execute_command("FLUSHDB")
    cmds = book_redis_commands(engine, accuracy=accuracy)
    for cmd in cmds:
        client.execute_command(*cmd)
    return len(cmds)
