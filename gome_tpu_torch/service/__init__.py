"""Service layer (the port of ``gome_tpu/service``): the order consumer and
the match-event feed — the reference's consume_new_order and
consume_match_order processes. The gRPC gateway and the single-binary
EngineService come with the gateway slice."""

from .consumer import OrderConsumer
from .matchfeed import MatchFeed

__all__ = ["OrderConsumer", "MatchFeed"]
