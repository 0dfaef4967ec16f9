"""Symbol-hash routing across engine shards — the multi-host dispatch layer.

The port of ``gome_tpu/parallel/router.py``. The reference's parallelism
axis is per-symbol independence (every Redis key is symbol-prefixed), so
scaling past one card or host needs no collective: partition symbols
across engine shards and route each order to its owner. Cross-shard
traffic exists only here, at dispatch; matching never communicates.

  ShardRouter      — stable symbol -> shard mapping (fnv1a; adding shards
                     is a controlled resharding, never implicit).
  ShardedEngine    — N MatchEngine shards behind the single-engine facade:
                     mark/process split per shard, events merged back into
                     arrival order. By default shard i runs on CUDA card
                     i % device_count (all on one card when there is one).
  multihost_mesh   — the mesh over every visible local card. A mesh across
                     processes or hosts is not ported yet.
"""

from __future__ import annotations

import torch

from ..engine.book import BookConfig, resolve_device
from ..engine.orchestrator import MatchEngine
from ..types import MatchResult, Order, check_kernel


def fnv1a(s: str) -> int:
    """Stable 64-bit FNV-1a (Python's hash() is salted per process — useless
    for cross-host agreement)."""
    h = 0xCBF29CE484222325
    for b in s.encode():
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class ShardRouter:
    def __init__(self, n_shards: int):
        if n_shards <= 0:
            raise ValueError("n_shards must be positive")
        self.n_shards = n_shards

    def route(self, symbol: str) -> int:
        return fnv1a(symbol) % self.n_shards


def shard_device(i: int, device=None) -> torch.device:
    """Shard i's device: `device` when given (e.g. "cpu"), else CUDA card
    i % device_count (raises without a card)."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    return torch.device("cuda", i % torch.cuda.device_count())


class ShardedEngine:
    """N engine shards behind the MatchEngine facade. Correctness argument:
    a symbol maps to exactly one shard, so per-symbol op order is preserved
    by construction; shards share nothing, so processing order across
    shards is free (the serialized-per-symbol invariant)."""

    def __init__(
        self,
        n_shards: int,
        config: BookConfig | None = None,
        n_slots: int = 128,
        max_t: int = 32,
        kernel: str = "scan",
        engine_factory=None,
        device=None,
    ):
        """kernel: the reference's "scan" or "pallas", checked here and
        passed to every default shard's MatchEngine. device: every shard's
        device (e.g. "cpu"); by default shard i runs on CUDA card
        i % device_count. engine_factory(i) -> MatchEngine replaces the
        default shards."""
        check_kernel(kernel)
        self.router = ShardRouter(n_shards)
        factory = engine_factory or (
            lambda i: MatchEngine(
                config=config, n_slots=n_slots, max_t=max_t, kernel=kernel,
                device=shard_device(i, device),
            )
        )
        self.shards = [factory(i) for i in range(n_shards)]

    def mark(self, order: Order) -> None:
        self.shards[self.router.route(order.symbol)].mark(order)

    def unmark(self, order: Order) -> None:
        self.shards[self.router.route(order.symbol)].unmark(order)

    def process(self, orders: list[Order]) -> list[MatchResult]:
        """Apply one micro-batch across shards; returns the event stream in
        the EXACT single-FIFO global emission order of the reference
        consumer: each shard processes its sub-batch tagged with global
        arrival indices (one device call per shard, full batching
        preserved) and the per-order event groups merge back by arrival."""
        by_shard: dict[int, list[tuple[int, Order]]] = {}
        for i, order in enumerate(orders):
            by_shard.setdefault(self.router.route(order.symbol), []).append(
                (i, order)
            )
        merged: list[tuple[int, list[MatchResult]]] = []
        for shard_id, items in by_shard.items():
            merged.extend(self.shards[shard_id].process_indexed(items))
        merged.sort(key=lambda kv: kv[0])
        return [ev for _, evs in merged for ev in evs]

    def process_columnar(self, orders: list[Order]):
        """Columnar facade parity with MatchEngine (the consumer publishes
        through the EventBatch surface; the wrapper provides it)."""
        return _ResultsBatch(self.process(orders))

    def process_frame(self, cols: dict):
        """ORDER-frame ingestion on the in-process sharded facade: decodes
        to Orders and runs the exact object path, admission included
        (sharded deployments route frames to per-shard doOrder queues
        upstream, so each shard's consumer gets whole frames)."""
        from ..engine.frames import orders_from_frame

        return _ResultsBatch(self.process(orders_from_frame(cols)))

    def process_with_arrival_order(
        self, orders: list[Order]
    ) -> list[MatchResult]:
        """Kept for API compatibility: process() itself emits exact
        global-FIFO order (per-order arrival tags), so this is an alias."""
        return self.process(orders)

    @property
    def stats(self):
        return [s.stats for s in self.shards]


class _ResultsBatch:
    """list[MatchResult] with the minimal EventBatch surface the consumer's
    publish path uses (len, to_results, to_json_lines, seq0)."""

    seq0 = None  # unstamped; the consumer passes seq0 explicitly

    def __init__(self, results):
        self._results = results

    def __len__(self):
        return len(self._results)

    def to_results(self):
        return list(self._results)

    def to_json_lines(self, seq0=None):
        import dataclasses

        from ..bus import encode_match_result

        if seq0 is None:
            return [encode_match_result(r) for r in self._results]
        return [
            encode_match_result(dataclasses.replace(r, seq=seq0 + i))
            for i, r in enumerate(self._results)
        ]


def multihost_mesh(n_local: int | None = None, devices=None):
    """Global 1-D symbol mesh across all participating processes' devices.

    Without an initialized ``torch.distributed`` group: the local mesh
    (``make_mesh(n_local, devices)``: this host's cards, all of them by
    default), the reference's single-host behaviour. With one (the
    counterpart of ``jax.distributed.initialize()``): every rank calls
    this with its own ``n_local`` shards (on ``devices``, default its
    first ``n_local`` visible cards), and the mesh spreads shard blocks
    over the ranks (``mesh.process_mesh``). Every rank then runs the same
    engine on the same frames, steps only its own blocks, and joins
    whole-stack reads with collectives; the group's backend must serve
    the layout (``mesh.mesh_backend``) or this raises."""
    import torch.distributed as dist

    from .mesh import make_mesh, process_mesh

    local = make_mesh(n_local, devices=devices)
    if not (dist.is_available() and dist.is_initialized()):
        return local
    return process_mesh(local.devices)
