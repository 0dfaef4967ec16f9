"""Bus wire codec — JSON bodies shaped like the reference's.

The reference publishes JSON-marshalled Go structs: OrderNode to "doOrder"
(engine.go:36) and MatchResult{Node, MatchNode, MatchVolume} to "matchOrder"
(engine.go:153-158). Go's encoder uses the exact exported field names
(no json tags anywhere in gomengine), so the parity field set is
  order:  Action, Uuid, Oid, Symbol, Transaction, Price, Volume
          (ordernode.go:10-16; the Redis key-plumbing fields NodeName..
          OrderDepthHashField are internal — meaningless off-device — and a
          decoder must ignore them)
  result: Node, MatchNode, MatchVolume (engine.go:24-28)

Price/Volume on the wire are the *scaled* values (the reference marshals
post-scaling nodes — float64 on 10^accuracy-scaled integers, SURVEY §2.2);
we encode our exact int ticks, which serialize identically for every value
in the float64-exact range. Extension field: Kind (market orders) — absent
⇒ LIMIT, so reference-shaped messages decode unchanged.
"""

from __future__ import annotations

import json

from ..types import Action, MatchResult, Order, OrderSnapshot, OrderType, Side


def encode_order(order: Order) -> bytes:
    body = {
        "Action": int(order.action),
        "Uuid": order.uuid,
        "Oid": order.oid,
        "Symbol": order.symbol,
        "Transaction": int(order.side),
        "Price": order.price,
        "Volume": order.volume,
    }
    if order.order_type is not OrderType.LIMIT:
        body["Kind"] = int(order.order_type)
    if order.trace is not None:
        # Order-lifecycle trace context (utils.trace). Extension field
        # like Kind: absent on reference-shaped messages, ignored by a
        # reference decoder.
        body["Trace"] = order.trace
    return json.dumps(body, separators=(",", ":")).encode()


def decode_order(body: bytes) -> Order:
    d = json.loads(body)
    return Order(
        uuid=d["Uuid"],
        oid=d["Oid"],
        symbol=d["Symbol"],
        side=Side(d["Transaction"]),
        price=int(d["Price"]),
        volume=int(d["Volume"]),
        action=Action(d.get("Action", int(Action.ADD))),
        order_type=OrderType(d.get("Kind", 0)),
        trace=d.get("Trace"),
    )


def _encode_snapshot(s: OrderSnapshot) -> dict:
    return {
        "Uuid": s.uuid,
        "Oid": s.oid,
        "Symbol": s.symbol,
        "Transaction": int(s.side),
        "Price": s.price,
        "Volume": s.volume,
    }


def _decode_snapshot(d: dict) -> OrderSnapshot:
    return OrderSnapshot(
        uuid=d["Uuid"],
        oid=d["Oid"],
        symbol=d["Symbol"],
        side=Side(d["Transaction"]),
        price=int(d["Price"]),
        volume=int(d["Volume"]),
    )


def encode_match_result(mr: MatchResult) -> bytes:
    body = {
        "Node": _encode_snapshot(mr.node),
        "MatchNode": _encode_snapshot(mr.match_node),
        "MatchVolume": mr.match_volume,
    }
    if mr.seq is not None:
        # Matchfeed sequence number (ISSUE 11 exactly-once). Extension
        # field like Kind/Trace: absent on reference-shaped messages,
        # ignored by a reference decoder.
        body["Seq"] = mr.seq
    return json.dumps(body, separators=(",", ":")).encode()


def decode_match_result(body: bytes) -> MatchResult:
    d = json.loads(body)
    seq = d.get("Seq")
    return MatchResult(
        node=_decode_snapshot(d["Node"]),
        match_node=_decode_snapshot(d["MatchNode"]),
        match_volume=int(d["MatchVolume"]),
        seq=None if seq is None else int(seq),
    )
