"""Live migration from a running gome deployment — over a real socket.

The port of the reference's ``examples/migrate_from_gome.py``. The Go
reference's order book IS its Redis keyspace: sorted sets for price
levels, hashes for depth and FIFO linked lists, a comparison hash for the
pre-pool. This example plays both sides of a migration:

  1. stands up a Redis-compatible server (persist.respserver — substitute
     your real Redis host/port) and populates it with a book in the
     reference's EXACT key schema, as a live gome would have left it —
     including a pre-pool mark for an in-flight order;
  2. imports the whole keyspace into a MatchEngine on the card over the
     RESP socket (persist.restore_from_redis via the dependency-free RESP2
     client);
  3. keeps matching: new orders cross the imported resting book, the
     imported pre-pool mark admits the in-flight ADD, and the event stream
     carries the reference's MatchResult semantics;
  4. exports the evolved book back out in the same schema
     (persist.redis_schema) so reference-side tooling keeps working.

    python -m gome_tpu_torch.examples.migrate_from_gome [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..engine import BookConfig, MatchEngine
from ..persist.redis_restore import restore_from_redis
from ..persist.redis_schema import export_to_redis
from ..persist.resp import RespClient
from ..persist.respserver import FakeRedisServer
from ..scripts.common import require_device
from ..types import Action, Order, Side


def populate_reference_book(client: RespClient) -> None:
    """What a live gome leaves in Redis for eth2usdt: two resting asks
    (FIFO at one level via the linked-list hash), one bid, aggregate
    depth, and a pre-pool mark for an ADD still queued in RabbitMQ."""
    sym = "eth2usdt"

    def node(oid, uuid, side, price, volume, prev=None, nxt=None):
        return json.dumps({
            "Action": 1, "Uuid": uuid, "Oid": oid, "Symbol": sym,
            "Transaction": side, "Price": price, "Volume": volume,
            "Accuracy": 8, "NodeName": f"{sym}:node:{oid}",
            "IsFirst": prev is None, "IsLast": nxt is None,
            "PrevNode": f"{sym}:node:{prev}" if prev else "",
            "NextNode": f"{sym}:node:{nxt}" if nxt else "",
            "NodeLink": f"{sym}:link:{price}",
            "OrderHashKey": f"{sym}:comparison",
            "OrderHashField": f"{sym}:{uuid}:{oid}",
            "OrderListZsetKey": f"{sym}:{'BUY' if side == 0 else 'SALE'}",
            "OrderListZsetRKey": f"{sym}:{'SALE' if side == 0 else 'BUY'}",
            "OrderDepthHashKey": f"{sym}:depth",
            "OrderDepthHashField": f"{sym}:depth:{price}",
        }, separators=(",", ":"))

    ask = 60_000_000  # 0.60 at accuracy 8
    bid = 55_000_000
    client.execute_command("ZADD", f"{sym}:SALE", ask, str(ask))
    client.execute_command("ZADD", f"{sym}:BUY", bid, str(bid))
    client.execute_command(
        "HSET", f"{sym}:depth",
        f"{sym}:depth:{ask}", "700000000",
        f"{sym}:depth:{bid}", "200000000",
    )
    # FIFO at the ask level: a1 (older) then a2.
    client.execute_command(
        "HSET", f"{sym}:link:{ask}",
        "f", f"{sym}:node:a1", "l", f"{sym}:node:a2",
        f"{sym}:node:a1", node("a1", "alice", 1, ask, 300_000_000, nxt="a2"),
        f"{sym}:node:a2", node("a2", "bob", 1, ask, 400_000_000, prev="a1"),
    )
    client.execute_command(
        "HSET", f"{sym}:link:{bid}",
        "f", f"{sym}:node:b1", "l", f"{sym}:node:b1",
        f"{sym}:node:b1", node("b1", "carol", 0, bid, 200_000_000),
    )
    # An ADD accepted by the gateway but not yet consumed (nodepool.go:14-16).
    client.execute_command(
        "HSET", f"{sym}:comparison", f"{sym}:dave:inflight9", "1"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch version)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    with FakeRedisServer() as server:  # substitute your real Redis here
        with RespClient(port=server.port) as client:
            populate_reference_book(client)

            engine = MatchEngine(
                config=BookConfig(cap=64, max_fills=8), n_slots=4, max_t=8,
                device=device,
            )
            imported = restore_from_redis(engine, client)
            print(f"imported {imported} resting orders over RESP "
                  f"(port {server.port}); pre-pool marks: "
                  f"{sorted(engine.pre_pool)}")

            # The in-flight ADD drains from the queue: its imported mark
            # admits it and it crosses the imported asks.
            inflight = Order(uuid="dave", oid="inflight9", symbol="eth2usdt",
                             side=Side.BUY, price=60_000_000,
                             volume=500_000_000)
            for ev in engine.process([inflight]):
                t, m = ev.node, ev.match_node
                print(f"  FILL taker={t.oid} maker={m.oid} "
                      f"qty={ev.match_volume} @ {m.price}")

            # A fresh cancel with reference semantics (exact price needed).
            cancel = Order(uuid="carol", oid="b1", symbol="eth2usdt",
                           side=Side.BUY, price=55_000_000, volume=0,
                           action=Action.DEL)
            for ev in engine.process([cancel]):
                print(f"  CANCEL {ev.node.oid} remaining={ev.node.volume}")

            engine.batch.verify_books()

            # Export the evolved book back in the reference schema.
            client.flushdb()
            n_cmds = export_to_redis(engine, client=client)
            print(f"re-exported evolved book as {n_cmds} reference-schema "
                  f"commands; keys now: {sorted(client.keys('*'))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
