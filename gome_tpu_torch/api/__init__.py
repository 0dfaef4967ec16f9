"""Wire contract package: order.proto (parity with the reference's
api/order.proto:1-29 + extensions), generated message classes, and the
hand-wired gRPC service plumbing (service registration and stubs live in
service.py; no grpc_python_plugin output is needed).

The port of ``gome_tpu/api``: the same serialized order.proto, so the wire
paths and messages are the reference's (order_pb2's docstring)."""

from . import order_pb2
from .service import OrderStub, add_order_servicer

OrderRequest = order_pb2.OrderRequest
OrderResponse = order_pb2.OrderResponse
MatchEvent = order_pb2.MatchEvent
OrderSnapshotMsg = order_pb2.OrderSnapshot
SubscribeRequest = order_pb2.SubscribeRequest

__all__ = [
    "order_pb2",
    "OrderRequest",
    "OrderResponse",
    "MatchEvent",
    "OrderSnapshotMsg",
    "SubscribeRequest",
    "OrderStub",
    "add_order_servicer",
]
