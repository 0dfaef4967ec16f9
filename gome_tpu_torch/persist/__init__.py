"""Durability — snapshot/restore + replay recovery (SURVEY §5.4).

The reference gets durability for free: Redis IS the book, so every mutation
is instantly persistent and restart = reconnect (redis.go:17-28; the queues
are deliberately lossy, rabbitmq.go:64,102). This engine inverts the
tiers: the books live in the card's memory, so durability must be
explicit —

  snapshot — periodic atomic dump of all mutable engine state (books,
             interners, pre-pool) plus the bus cursors that make it a
             *consistent cut*: the order-queue committed offset (everything
             below it is IN the books) and the match-queue end offset
             (everything below it was emitted FOR those orders).
  replay   — on restore, rewind the order-queue consumer to the snapshot's
             offset and truncate the match queue to its end offset; the
             normal consumer loop then re-processes the tail
             deterministically, regenerating the exact same events
             (exactly-once on the match queue, vs the reference's
             at-most-once).

Requires the `file` bus backend for crash durability (the memory bus dies
with the process — then snapshots still restore books, and the replay tail
is empty, which is precisely the reference's crash model: in-flight
messages lost, book state kept, SURVEY §2.3.6).

Redis interop is bidirectional: redis_schema *exports* the book in the
reference's exact key schema (commands are generated without a client;
applying them is gated on redis-py being installed), and redis_restore
*imports* that schema back — a live gome deployment's Redis book migrates
into the engine, which continues matching the same symbols. DictRedis
(redis_restore) is an offline in-memory store serving both directions in
tests and as a snapshot target without a server.

The port of ``gome_tpu/persist/``. The on-disk snapshot format, the Redis
key schema and the RESP wire are byte-compatible with the reference's: a
snapshot written by either package restores in the other, and either
package's client talks to either package's server.
"""

from .redis_restore import DictRedis, discover_symbols, restore_from_redis
from .snapshot import Persister, SnapshotStore
from .redis_schema import book_redis_commands

__all__ = [
    "DictRedis",
    "Persister",
    "SnapshotStore",
    "book_redis_commands",
    "discover_symbols",
    "restore_from_redis",
]
