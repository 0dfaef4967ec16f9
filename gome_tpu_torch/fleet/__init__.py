"""Fleet fault-tolerance tier: partition routing, member health gating,
and exactly-once failover.

The port of ``gome_tpu/fleet`` (no JAX there either: a copy, with
`partition_of` on the port's own ``parallel/router.fnv1a``).

`parallel/` answers "which in-process shard owns this symbol"; this
package answers the *deployment* question — which fleet **member**
(engine service process) owns which bus partition right now, given that
members die. The split is deliberate: routing math (`PartitionMap`)
is pure and testable, health classification (`HealthGate`) folds in the
existing `/healthz`/`/durability` polls, and `FailoverController` is the
only piece that mutates ownership — and only after a standby has
recovered the dead member's durable state (`Persister.restore_latest()`
+ `match_seq`), so a handoff can never double-consume.
"""

from .router import (
    FailoverController,
    HealthGate,
    PartitionMap,
    PartitionRouter,
    RouteUnavailable,
    partition_of,
)

__all__ = [
    "FailoverController",
    "HealthGate",
    "PartitionMap",
    "PartitionRouter",
    "RouteUnavailable",
    "partition_of",
]
