"""Service layer (the port of ``gome_tpu/service``): the gRPC gateway, the
order consumer, and the match-event feed — the reference's three processes
(gomengine/main.go, consume_new_order.go, consume_match_order.go) as
composable components that run in one binary (EngineService) or
separately against a shared `file` bus.

The gateway and EngineService need grpc and protobuf; they are imported
on first use (PEP 562), so the consumer, the feed, admission, health and
the ops endpoint import on a machine without those packages."""

from .consumer import OrderConsumer
from .matchfeed import MatchFeed

__all__ = [
    "OrderGateway",
    "serve_gateway",
    "OrderConsumer",
    "MatchFeed",
    "EngineService",
]

_LAZY = {
    "OrderGateway": "gateway",
    "serve_gateway": "gateway",
    "EngineService": "app",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
