"""Partition routing, health gating, and exactly-once failover.

The port of ``gome_tpu/fleet/router.py``, whole.

Three layers, strictly ordered by what they are allowed to know:

  partition_of / PartitionMap   pure math + explicit ownership table.
                                Consistent hashing (fnv1a, the same
                                stable hash parallel/router.py uses for
                                in-process shards) maps a symbol to a
                                *partition*; the map — not the hash —
                                maps a partition to a *member*, so
                                reassignment is a table edit with an
                                epoch bump, never a rehash that moves
                                unrelated symbols (CoinTossX keeps its
                                failover unit the replicated partition
                                for the same reason).

  HealthGate                    classifies members UP/SUSPECT/DOWN from
                                consecutive poll failures — fed by the
                                obs/fleet aggregator's `/healthz` poll
                                results, or directly by a drill parent
                                that watched the process die.

  PartitionRouter               the read path: symbol -> live member.
                                Routing to a DOWN member whose
                                partitions have not been failed over
                                raises RouteUnavailable — callers shed
                                (retryable) rather than enqueue into a
                                stalled partition.

  FailoverController            the only writer of the map. A standby
                                must (1) *claim* the dead member under
                                the lock — exactly one claimant wins per
                                (member, epoch) — then (2) recover the
                                dead member's durable state off-lock
                                (`Persister.restore_latest()` + WAL
                                replay seeds `match_seq`, the
                                exactly-once cursor), and only then
                                (3) commit the reassignment. A crash
                                between claim and commit leaves the map
                                untouched; `release()` re-opens the
                                claim. No double-consume is possible
                                because ownership changes only after
                                recovery proves where the committed
                                offset stands.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from ..parallel.router import fnv1a

__all__ = [
    "FailoverController",
    "HealthGate",
    "PartitionMap",
    "PartitionRouter",
    "RouteUnavailable",
    "partition_of",
]

# Member health states (HealthGate) ------------------------------------
UP = "up"
SUSPECT = "suspect"
DOWN = "down"

# Failover claim states (FailoverController) ---------------------------
CLAIMED = "claimed"
RECOVERED = "recovered"


def partition_of(symbol: str, n_partitions: int) -> int:
    """Stable symbol -> partition id. fnv1a, not crc32: one hash family
    for every routing tier in the tree (parallel/router.py chose it
    because Python's hash() is salted per process)."""
    if n_partitions <= 0:
        raise ValueError("n_partitions must be positive")
    return fnv1a(symbol) % n_partitions


class RouteUnavailable(ConnectionError):
    """Owner of the target partition is DOWN and not yet failed over.

    Subclasses ConnectionError so every existing degraded-path handler
    (gateway code 14, batcher spill, client retry) treats it as
    retryable without new plumbing."""

    def __init__(self, symbol: str, partition: int, member: str):
        super().__init__(
            f"partition {partition} ({symbol!r}) owner {member!r} is down"
        )
        self.symbol = symbol
        self.partition = partition
        self.member = member


class PartitionMap:
    """Explicit partition -> member ownership table with an epoch.

    The epoch is bumped on every reassignment; a failover claim is keyed
    to the epoch it observed, so a claim raced against a concurrent
    reassignment is void rather than silently applied to a newer map.
    """

    def __init__(self, n_partitions: int, assignments: dict[int, str]):
        if n_partitions <= 0:
            raise ValueError("n_partitions must be positive")
        missing = set(range(n_partitions)) - set(assignments)
        if missing:
            raise ValueError(f"unassigned partitions: {sorted(missing)}")
        extra = set(assignments) - set(range(n_partitions))
        if extra:
            raise ValueError(f"assignments out of range: {sorted(extra)}")
        for p, m in assignments.items():
            if not m:
                raise ValueError(f"partition {p}: empty member name")
        self.n_partitions = n_partitions
        self._lock = threading.Lock()
        self._assignments = dict(assignments)  # guarded by self._lock
        self._epoch = 0  # guarded by self._lock

    @classmethod
    def even(cls, n_partitions: int, members: Iterable[str]) -> "PartitionMap":
        """Round-robin bootstrap map: partition i -> members[i % len]."""
        ms = list(members)
        if not ms:
            raise ValueError("need at least one member")
        return cls(
            n_partitions,
            {p: ms[p % len(ms)] for p in range(n_partitions)},
        )

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def owner(self, partition: int) -> str:
        with self._lock:
            return self._assignments[partition]

    def owner_of_symbol(self, symbol: str) -> tuple[int, str]:
        p = partition_of(symbol, self.n_partitions)
        with self._lock:
            return p, self._assignments[p]

    def partitions_of(self, member: str) -> list[int]:
        with self._lock:
            return sorted(
                p for p, m in self._assignments.items() if m == member
            )

    def members(self) -> list[str]:
        with self._lock:
            return sorted(set(self._assignments.values()))

    def reassign(self, partitions: Iterable[int], member: str) -> int:
        """Move `partitions` to `member`; returns the new epoch.

        Only FailoverController should call this on a live fleet — it is
        public for bootstrap/rebalance tooling, and atomic: all moves
        land under one epoch bump."""
        ps = list(partitions)
        if not member:
            raise ValueError("empty member name")
        with self._lock:
            for p in ps:
                if p not in self._assignments:
                    raise KeyError(f"unknown partition {p}")
            for p in ps:
                self._assignments[p] = member
            self._epoch += 1
            return self._epoch

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "epoch": self._epoch,
                "n_partitions": self.n_partitions,
                "assignments": {
                    str(p): m for p, m in sorted(self._assignments.items())
                },
            }


@dataclass
class _MemberHealth:
    state: str = UP
    consecutive_failures: int = 0
    polls: int = 0


class HealthGate:
    """Consecutive-failure debounce over member health polls.

    One failed `/healthz` scrape is noise (GC pause, port hiccup);
    `suspect_after` consecutive failures marks SUSPECT, `down_after`
    marks DOWN. Any success snaps back to UP. A parent that *watched*
    the process exit skips the debounce via `mark_down()` — it has
    ground truth, not a sample."""

    def __init__(self, suspect_after: int = 2, down_after: int = 4):
        if not (0 < suspect_after <= down_after):
            raise ValueError("need 0 < suspect_after <= down_after")
        self.suspect_after = suspect_after
        self.down_after = down_after
        self._lock = threading.Lock()
        self._members: dict[str, _MemberHealth] = {}  # guarded by self._lock

    def record(self, member: str, healthy: bool) -> str:
        """Fold one poll result; returns the member's new state."""
        with self._lock:
            h = self._members.setdefault(member, _MemberHealth())
            h.polls += 1
            if healthy:
                h.consecutive_failures = 0
                h.state = UP
            else:
                h.consecutive_failures += 1
                if h.consecutive_failures >= self.down_after:
                    h.state = DOWN
                elif h.consecutive_failures >= self.suspect_after:
                    h.state = SUSPECT
            return h.state

    def mark_down(self, member: str) -> None:
        """Ground-truth death (observed process exit): skip the debounce."""
        with self._lock:
            h = self._members.setdefault(member, _MemberHealth())
            h.consecutive_failures = max(
                h.consecutive_failures, self.down_after
            )
            h.state = DOWN

    def state(self, member: str) -> str:
        with self._lock:
            h = self._members.get(member)
            return h.state if h is not None else UP

    def is_down(self, member: str) -> bool:
        return self.state(member) == DOWN

    def snapshot(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {
                m: {
                    "state": h.state,
                    "consecutive_failures": h.consecutive_failures,
                    "polls": h.polls,
                }
                for m, h in sorted(self._members.items())
            }


class PartitionRouter:
    """Health-gated read path: symbol -> live owning member.

    Pure reader — holds no state of its own beyond the map + gate it was
    built over, so a drill parent, a gateway, and a test can share one
    map and see reassignments the instant the controller commits them.
    """

    def __init__(self, pmap: PartitionMap, gate: HealthGate | None = None):
        self.pmap = pmap
        self.gate = gate or HealthGate()

    def partition(self, symbol: str) -> int:
        return partition_of(symbol, self.pmap.n_partitions)

    # gomelint: hotpath — every order resolves its target member here
    def route(self, symbol: str) -> str:
        """Owner of `symbol`'s partition; RouteUnavailable if DOWN."""
        p, member = self.pmap.owner_of_symbol(symbol)
        if self.gate.is_down(member):
            raise RouteUnavailable(symbol, p, member)
        return member

    # gomelint: hotpath — batch dispatch routes whole partitions here
    def route_partition(self, partition: int) -> str:
        member = self.pmap.owner(partition)
        if self.gate.is_down(member):
            raise RouteUnavailable("", partition, member)
        return member


@dataclass
class _Claim:
    standby: str
    epoch: int  # map epoch the claim observed
    state: str = CLAIMED  # CLAIMED -> RECOVERED (then removed on commit)
    partitions: tuple[int, ...] = field(default_factory=tuple)


class FailoverController:
    """Exactly-once partition handoff: claim -> recover -> commit.

    `failover(dead, standby, recover_fn)` is the whole protocol:

      claim    under `lock`, reject if `dead` is not DOWN, if it is
               already claimed, or if the map epoch moved since the
               caller looked — exactly one standby wins.
      recover  off-lock, run `recover_fn(dead, partitions)`: the standby
               restores the dead member's durable state
               (`Persister.restore_latest()` + WAL replay) and seeds its
               consumer's `match_seq` cursor from it, so replay after
               the handoff emits identical seqs and the committed bus
               offset is honored — no double-consume.
      commit   back under the map, `reassign()` bumps the epoch; the
               claim is retired. If `recover_fn` raises, the claim is
               released and another standby may try.

    The lock is injectable (`lock=`) so a deterministic
    interleaver can drive the claim race with a SteppingLock across
    seeded schedules.
    """

    def __init__(
        self,
        pmap: PartitionMap,
        gate: HealthGate,
        lock: Any | None = None,
    ):
        self.pmap = pmap
        self.gate = gate
        self._lock = lock if lock is not None else threading.Lock()
        self._claims: dict[str, _Claim] = {}  # guarded by self._lock
        self._history: list[dict[str, Any]] = []  # guarded by self._lock

    def claim(self, dead: str, standby: str) -> _Claim | None:
        """Phase 1: atomically claim `dead` for `standby`. None = lost."""
        if not self.gate.is_down(dead):
            return None
        with self._lock:
            if dead in self._claims:
                return None  # another standby already holds the claim
            parts = tuple(self.pmap.partitions_of(dead))
            if not parts:
                return None  # nothing to take over
            c = _Claim(standby=standby, epoch=self.pmap.epoch,
                       partitions=parts)
            self._claims[dead] = c
            return c

    def release(self, dead: str, standby: str) -> None:
        """Abort a claim (recovery failed / claimant died mid-handoff)."""
        with self._lock:
            c = self._claims.get(dead)
            if c is not None and c.standby == standby:
                del self._claims[dead]

    def commit(self, dead: str, standby: str) -> int | None:
        """Phase 3: reassign the claimed partitions; returns new epoch.

        Voids the claim (returns None) if the map epoch moved since the
        claim was taken — someone rebalanced underneath us, so applying
        the stale reassignment could clobber newer ownership."""
        with self._lock:
            c = self._claims.get(dead)
            if c is None or c.standby != standby:
                return None
            if self.pmap.epoch != c.epoch:
                del self._claims[dead]
                return None
            epoch = self.pmap.reassign(c.partitions, standby)
            del self._claims[dead]
            self._history.append({
                "dead": dead,
                "standby": standby,
                "partitions": list(c.partitions),
                "epoch": epoch,
            })
            return epoch

    def failover(
        self,
        dead: str,
        standby: str,
        recover_fn: Callable[[str, tuple[int, ...]], Any],
    ) -> int | None:
        """Full claim -> recover -> commit protocol; returns the new map
        epoch, or None if this standby lost the claim race (or the
        member was not DOWN / had no partitions)."""
        c = self.claim(dead, standby)
        if c is None:
            return None
        try:
            recover_fn(dead, c.partitions)
        except BaseException:
            self.release(dead, standby)
            raise
        c.state = RECOVERED
        epoch = self.commit(dead, standby)
        if epoch is None:
            # Epoch moved under the claim; treat like a lost race.
            return None
        return epoch

    def history(self) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(h) for h in self._history]
