"""Cancel client — behavioral port of gomengine/delorder.go:14-38: one
DeleteOrder for a hardcoded order (uuid="2", oid="11", price=0.5,
delorder.go:30-36). The cancel contract requires the exact resting price
(SURVEY §2.3.2). Retryable (code 14) responses — overloaded or degraded
gateway — are retried under decorrelated-jitter backoff like the load
client, honoring the server's retry-after hint.

The port of ``gome_tpu/clients/delorder.py``, over the port's OrderStub.
"""

from __future__ import annotations

import random
import time

import grpc

from ..api import order_pb2 as pb
from ..api.service import OrderStub
from ..utils.resilience import BackoffPolicy, backoff_delays
from .doorder import CODE_RETRYABLE, RETRY_AFTER_RE


def cancel_client(
    target: str,
    uuid: str = "2",
    oid: str = "11",
    symbol: str = "eth2usdt",
    transaction: int = 0,
    price: float = 0.5,
    volume: float = 1.0,
    policy: BackoffPolicy | None = None,
    sleep=time.sleep,
) -> pb.OrderResponse:
    delays = backoff_delays(policy or BackoffPolicy(), random.Random())
    with grpc.insecure_channel(target) as channel:
        stub = OrderStub(channel)
        while True:
            resp = stub.DeleteOrder(
                pb.OrderRequest(
                    uuid=uuid,
                    oid=oid,
                    symbol=symbol,
                    transaction=transaction,
                    price=price,
                    volume=volume,
                )
            )
            if resp.code != CODE_RETRYABLE:
                return resp
            m = RETRY_AFTER_RE.search(resp.message or "")
            hint = float(m.group(1)) if m else 0.0
            try:
                delay = next(delays)
            except StopIteration:  # budget exhausted: surface the 14
                return resp
            sleep(max(delay, hint))


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    target = argv[0] if argv else "127.0.0.1:8088"
    resp = cancel_client(target)
    print(f"code={resp.code} message={resp.message}")


if __name__ == "__main__":
    main()
