"""Batch order decoding (the port of ``gome_tpu/bus/ordercodec.py``).

The reference's module parses a whole micro-batch in one native call and
falls back to json.loads per message where the native parser declines or
is missing. The port carries the fallback only: `decode_orders_batch`
returns exactly what ``[codec.decode_order(b) for b in bodies]`` returns,
the ValueError for an out-of-range enum included. The native parser is a
later slice of the port (the native host layer).
"""

from __future__ import annotations

from ..types import Order
from .codec import decode_order


def decode_orders_batch(bodies: list[bytes]) -> list[Order]:
    """Decode a batch of doOrder message bodies. Semantics identical to
    [decode_order(b) for b in bodies]."""
    return [decode_order(b) for b in bodies]
