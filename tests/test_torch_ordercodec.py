"""The port's batch order codec (gome_tpu_torch/bus/ordercodec.py) with its
native parser on the CPU: the parity cases of tests/test_ordercodec.py —
the JSON path, messages the native parser declines, malformed JSON, an
out-of-range enum, non-ASCII — equal to the port's per-message json path
and to gome_tpu's batch decode on the same bodies."""

import json

import pytest

from gome_tpu.bus import decode_orders_batch as j_decode_orders_batch
from gome_tpu_torch.bus import decode_orders_batch, encode_order
from gome_tpu_torch.bus.codec import decode_order
from gome_tpu_torch.bus.ordercodec import _load
from gome_tpu_torch.types import Action, Order, OrderType, Side
from gome_tpu_torch.utils.streams import mixed_stream
from test_torch_bridge import to_torch_orders


def decode_all_ways(bodies):
    """(port batch, port json per message, gome_tpu batch) — each a list
    of orders or the name of the exception it raised."""
    out = []
    for fn in (decode_orders_batch, lambda bs: [decode_order(b) for b in bs],
               lambda bs: to_torch_orders(j_decode_orders_batch(bs))):
        try:
            out.append(fn(bodies))
        except Exception as e:  # the exception's type is the result
            out.append(type(e).__name__)
    return out


def test_the_native_parser_is_in_use():
    assert _load() is not None


def test_batch_decode_matches_json_path():
    orders = mixed_stream(n=300, seed=8, cancel_prob=0.2, market_prob=0.15)
    bodies = [encode_order(o) for o in orders]
    got, want, ref = decode_all_ways(bodies)
    assert got == want == ref == orders


def test_batch_decode_fallback_cases():
    """Escaped strings, unknown keys, missing optional keys, whitespace —
    every message must decode exactly, native or fallback."""
    bodies = [
        encode_order(Order(uuid="u", oid="1", symbol="s", side=Side.BUY,
                           price=5, volume=7)),
        # escaped quote in oid -> native declines, json handles
        json.dumps({"Uuid": "u", "Oid": 'o"x', "Symbol": "s",
                    "Transaction": 1, "Price": 3, "Volume": 2}).encode(),
        # unknown extra key -> native declines
        b'{"Uuid":"a","Oid":"b","Symbol":"c","Transaction":0,"Price":1,'
        b'"Volume":1,"Extra":9}',
        # defaults: no Action, no Kind
        b'{"Uuid":"x","Oid":"y","Symbol":"z","Transaction":1,"Price":10,'
        b'"Volume":20}',
        # whitespace + reordered keys + Kind
        b'{ "Kind": 1 , "Volume": 4, "Price": 8, "Transaction": 0, '
        b'"Symbol": "w", "Oid": "q", "Uuid": "e", "Action": 1 }',
    ]
    got, want, ref = decode_all_ways(bodies)
    assert got == want == ref
    assert want[1].oid == 'o"x'
    assert want[3].action is Action.ADD
    assert want[3].order_type is OrderType.LIMIT
    assert want[4].order_type is OrderType.MARKET


@pytest.mark.parametrize("body", [
    # leading-zero int
    b'{"Uuid":"u","Oid":"o","Symbol":"s","Transaction":0,"Price":007,'
    b'"Volume":1}',
    # control char in a string
    b'{"Uuid":"u\nx","Oid":"o","Symbol":"s","Transaction":0,"Price":1,'
    b'"Volume":1}',
    # int64 overflow
    b'{"Uuid":"u","Oid":"o","Symbol":"s","Transaction":0,'
    b'"Price":99999999999999999999,"Volume":1}',
], ids=["leading_zero", "control_char", "int64_overflow"])
def test_malformed_json_declines_to_fallback(body):
    """The native parser declines, so the result (orders or the exception
    raised) equals json.loads's exactly."""
    got, want, ref = decode_all_ways([body])
    assert got == want == ref


def test_out_of_range_enum_raises_like_json_path():
    bad = (
        b'{"Uuid":"u","Oid":"o","Symbol":"s","Transaction":7,"Price":1,'
        b'"Volume":1}'
    )
    with pytest.raises(ValueError):
        decode_orders_batch([bad])
    with pytest.raises(ValueError):
        decode_order(bad)
    good = encode_order(Order(uuid="u", oid="1", symbol="s", side=Side.BUY,
                              price=5, volume=7))
    assert decode_all_ways([good, bad]) == ["ValueError"] * 3


def test_non_ascii_falls_back_exactly():
    body = json.dumps({"Uuid": "u", "Oid": "o", "Symbol": "сим",
                       "Transaction": 0, "Price": 1, "Volume": 1}).encode()
    plain = encode_order(Order(uuid="u", oid="2", symbol="s", side=Side.SALE,
                               price=9, volume=3))
    got, want, ref = decode_all_ways([plain, body])
    assert got == want == ref
    assert got[1].symbol == "сим"
