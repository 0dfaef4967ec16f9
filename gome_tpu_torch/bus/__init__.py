"""Message bus — the reference's RabbitMQ layer (gomengine/engine/rabbitmq.go)
re-expressed as a pluggable queue abstraction. The port of
``gome_tpu/bus/__init__.py``: the memory, file and native file backends,
both wire codecs, the AMQP 0-9-1 client and its fake broker, and
`make_bus`, which builds the two-queue bus from the config's BusConfig.

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
  amqp   — a dependency-free AMQP 0-9-1 protocol client (bus/amqp.py)
           speaking to RabbitMQ or the in-process fake broker
           (bus/fakebroker.py); when no broker is listening, make_bus
           falls back loudly to `memory` so a reference config.yaml
           still boots.

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

    `amqp` gives two SupervisedAmqpQueues, or, when no broker answers, the
    memory bus with the reference's RuntimeWarning (a transport fallback:
    the engine still runs on the card or raises). Unlike the reference,
    `cfile` without g++ raises (a failed build raises from the build
    itself) instead of taking the Python `file` queue."""
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
        # Supervised client: reconnect with backoff + circuit breaker +
        # topology re-declare on every ConnectionError (utils.resilience).
        # The raw AmqpQueue fails loudly and stays down; the supervised
        # wrapper is what makes a broker bounce a non-event.
        from .amqp import SupervisedAmqpQueue

        def factory(name, _cfg=config):
            return SupervisedAmqpQueue(
                name,
                host=_cfg.host,
                port=_cfg.port,
                username=_cfg.username or "guest",
                password=_cfg.password or "guest",
            )

        # A reference config.yaml selects this backend (its rabbitmq:
        # section); the service must still BOOT when no broker is
        # listening — fall back loudly to the in-process backend instead
        # of crashing at startup.
        order_q = None
        try:
            order_q = factory(config.order_queue)
            return QueueBus(
                order_queue=order_q, match_queue=factory(config.match_queue)
            )
        except OSError as e:
            if order_q is not None:  # match-queue connect failed: clean up
                order_q.close()
            import warnings

            warnings.warn(
                f"amqp broker unreachable at {config.host}:{config.port} "
                f"({e}); falling back to the in-process memory bus — "
                "matching runs, but cross-process AMQP interop is off "
                "until a broker is available",
                RuntimeWarning,
                stacklevel=2,
            )
            factory = lambda name: MemoryQueue(name)
    else:  # pragma: no cover - BusConfig validates
        raise ValueError(config.backend)
    return QueueBus(
        order_queue=factory(config.order_queue),
        match_queue=factory(config.match_queue),
    )
