"""Message bus — the reference's RabbitMQ layer (gomengine/engine/rabbitmq.go)
re-expressed as a pluggable queue abstraction. The port of
``gome_tpu/bus/__init__.py``: the memory, file and native file backends,
both wire codecs, and `make_bus`, which builds the two-queue bus from the
config's BusConfig. The amqp backend is not ported yet: make_bus refuses it
(ROADMAP Queue 1 item 2c) rather than fall back to the memory bus.

Topology parity: two named queues, inbound ``doOrder`` (orders + cancels)
and outbound ``matchOrder`` (fill/cancel events) — rabbitmq.go:60-84 and the
two consume loops rabbitmq.go:86-177. Backends:

  memory — in-process deques; the single-binary deployment (and tests).
  file   — durable append-only log segments with consumer offsets; unlike
           the reference's non-durable auto-ack queues (rabbitmq.go:64,102 —
           in-flight messages die with the process, SURVEY §2.3.6), a file
           queue doubles as the replay log for crash recovery (§5.4).
  cfile  — the same on-disk format through the port's C++ log
           (NativeFileQueue; one write+fsync per published batch).
  amqp   — (not ported yet, ROADMAP Queue 1 item 2c) the reference's AMQP
           0-9-1 client and its fake broker.

Deliberately NOT reproduced: the reference opens a brand-new AMQP connection
per published message (NewSimpleRabbitMQ inline at engine.go:37,112,157,174,
193; dial at rabbitmq.go:35-38) — the documented anti-pattern. Publishers
here hold their queue handle.
"""

from .base import Message, Queue, QueueBus
from .codec import (
    decode_match_result,
    decode_order,
    encode_match_result,
    encode_order,
)
from .filelog import FileQueue
from .memory import MemoryQueue
from .native import NativeFileQueue, native_available
from .ordercodec import decode_orders_batch

__all__ = [
    "decode_message_orders",
    "decode_orders_batch",
    "Message",
    "Queue",
    "QueueBus",
    "MemoryQueue",
    "FileQueue",
    "NativeFileQueue",
    "native_available",
    "make_bus",
    "encode_order",
    "decode_order",
    "encode_match_result",
    "decode_match_result",
]


def decode_message_orders(body: bytes) -> list:
    """Orders carried by one bus message, whichever wire kind it is: a
    binary ORDER frame (colwire) holds a batch, a reference-shape JSON
    document holds one. The single dispatch point shared by the consumer's
    quarantine replay and the persistence layer's recovery scan — live
    decoding and recovery must never diverge."""
    from .colwire import decode_order_frame, is_frame

    if is_frame(body):
        from ..engine.frames import orders_from_frame

        return orders_from_frame(decode_order_frame(body))
    return decode_orders_batch([body])


def make_bus(config) -> QueueBus:
    """Build the two-queue bus from a BusConfig (gome_tpu_torch.config).

    Unlike the reference, nothing falls back: `cfile` without g++ raises
    (a failed build raises from the build itself) instead of taking the
    Python `file` queue, and `amqp` raises instead of booting on the memory
    bus, since the port has no AMQP client yet."""
    import os

    if config.backend == "memory":
        factory = lambda name: MemoryQueue(name)
    elif config.backend == "file":
        factory = lambda name: FileQueue(name, os.path.join(config.dir, name))
    elif config.backend == "cfile":
        if not native_available():
            raise RuntimeError(
                "bus.backend cfile needs the port's native queue library, "
                "and no g++ is on PATH to build it"
            )
        factory = lambda name: NativeFileQueue(
            name, os.path.join(config.dir, name)
        )
    elif config.backend == "amqp":
        raise NotImplementedError(
            "bus.backend amqp (a rabbitmq: section): the port has no AMQP "
            "client yet (ROADMAP Queue 1 item 2c); use memory, file or cfile"
        )
    else:  # pragma: no cover - BusConfig validates
        raise ValueError(config.backend)
    return QueueBus(
        order_queue=factory(config.order_queue),
        match_queue=factory(config.match_queue),
    )
