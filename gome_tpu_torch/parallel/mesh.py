"""Multi-card scaling: symbol-sharded books over a device mesh.

The port of ``gome_tpu/parallel/mesh.py``. Symbols share nothing, so the
[S] symbol-lane axis of the book stack and of every op grid splits across
a 1-D "sym" mesh of devices, and matching needs no collective: each shard
runs the single-card step (K1, ``ops/match_step.batch_step``) on its own
lane block, on its own device. Cross-shard traffic exists only at the
dispatch layer (the host routes each grid's rows to the shard owning their
lanes) and where the engine reads the whole stack.

JAX keeps the books as one global array whose lane axis XLA shards, so
whole-array code runs unchanged under a mesh. PyTorch has no such tensor:
here a sharded tree is a ``Sharded`` — D row blocks, block d on
``mesh.devices[d]`` — and every read of the whole stack goes through
``Sharded.gather`` (onto the home device, ``mesh.devices[0]``) or
``Sharded.host`` (block by block onto the host). Shard d owns lanes
``[d * S/D, (d+1) * S/D)`` (``symbol_sharding``).

Several shards may live on one device: ``make_mesh(D, devices=[cpu] * D)``
(the tests) or ``[cuda:0] * D`` (one card) runs D shards there, the
counterpart of conftest's virtual CPU devices. It is never a fallback:
without ``devices=`` the mesh takes distinct CUDA cards and raises when
there are fewer than asked.

A mesh may also span processes (``process_mesh``, which
``router.multihost_mesh`` calls once ``torch.distributed`` is
initialized): the reference's multi-controller model after
``jax.distributed.initialize()``. Every rank runs the same program on the
same host inputs; shard d belongs to rank ``mesh.ranks[d]`` (ranks hold
contiguous runs of shards, the same count each), and a rank holds, uploads
and steps only its own blocks (the others are ``None`` in
``Sharded.blocks``). Whole-tree reads join across ranks with
``torch.distributed`` collectives, so every rank reads the same stack:
``gather``/``gather_leaf``/``host``/``host_leaf`` all-gather the blocks
(one collective a call, the leaves packed as bytes), ``row`` broadcasts
a row from its owner, and lane growth re-lays the gathered stack. The
collectives run on the backend the group was made with, which must serve
the mesh's layout (``mesh_backend``): gloo stages through host memory (CPU
shards, or ranks that share a card, which NCCL refuses); NCCL runs on the
home card when each rank owns its cards. Any other layout raises.
"""

from __future__ import annotations

import socket
import time
from typing import NamedTuple

import numpy as np
import torch

from ..engine.book import (
    BookConfig,
    BookState,
    grow_lanes,
    init_books,
    to_device,
)
from ..types import check_kernel

SYM_AXIS = "sym"


class Mesh:
    """A 1-D "sym" axis over a tuple of torch devices (repeats allowed:
    several shards on one device). Across processes, ``ranks[d]`` is the
    rank holding shard d (its device is a device of that rank's), ``rank``
    this process's and ``backend`` the process group's; in one process
    every shard is this process's and ``backend`` is None."""

    axis_names = (SYM_AXIS,)

    def __init__(self, devices, ranks=None, rank: int = 0,
                 backend: str | None = None):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.ranks = ((rank,) * len(self.devices) if ranks is None
                      else tuple(ranks))
        if len(self.ranks) != len(self.devices) or \
                list(self.ranks) != sorted(self.ranks):
            raise ValueError(f"ranks {self.ranks} must name each of the "
                             f"{len(self.devices)} shards' rank, in order")
        self.rank = rank
        self.backend = backend
        #: the shards this process holds, in mesh order
        self.local = tuple(
            d for d, r in enumerate(self.ranks) if r == rank)
        if not self.local:
            raise ValueError(f"rank {rank} holds no shard of {self.ranks}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        return self.backend is not None

    def is_local(self, d: int) -> bool:
        return self.ranks[d] == self.rank

    @property
    def home(self) -> torch.device:
        """Where whole-stack reads and the frame path's compaction run:
        this process's first shard's device."""
        return self.devices[self.local[0]]

    def __repr__(self) -> str:
        if not self.multiprocess:
            return f"Mesh({', '.join(map(str, self.devices))})"
        return "Mesh(" + ", ".join(
            f"{d}@rank{r}" for d, r in zip(self.devices, self.ranks)
        ) + f"; rank {self.rank}, {self.backend})"


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index ("cuda" -> "cuda:<current>"), so it
    compares equal to the device a tensor reports."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_backend(devices, shared_card: bool = False) -> str:
    """The process-group backend that serves a mesh across processes,
    given this rank's devices: gloo for CPU shards and for ranks that
    share a card (NCCL refuses two ranks on one device; gloo stages the
    collectives through host memory), NCCL when each rank owns its
    cards. Pass it to ``torch.distributed.init_process_group``."""
    kinds = {torch.device(d).type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds == {"cuda"}:
        return "gloo" if shared_card else "nccl"
    raise ValueError(f"no backend serves a rank whose shards sit on "
                     f"{sorted(kinds)}")


def _check_layout(backend: str, layouts) -> None:
    """Raise unless ``backend`` serves the ranks' (host, devices)
    layouts."""
    kinds = {torch.device(d).type for _, devs in layouts for d in devs}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh across processes needs every shard on "
                         f"the CPU or every shard on a card, not "
                         f"{sorted(kinds)}")
    if backend == "gloo":
        return  # host staging serves any layout
    if backend != "nccl" or kinds != {"cuda"}:
        fit = mesh_backend(list(kinds))
        raise ValueError(f"backend {backend!r} cannot serve shards on "
                         f"{sorted(kinds)}: use {fit!r}")
    owner: dict = {}
    for r, (host, devs) in enumerate(layouts):
        for d in {str(_indexed(torch.device(x))) for x in devs}:
            prev = owner.setdefault((host, d), r)
            if prev != r:
                raise ValueError(
                    f"ranks {prev} and {r} share {d} on {host}: NCCL refuses "
                    "two ranks on one device; init the group with gloo "
                    "(mesh_backend(devices, shared_card=True))")


def process_mesh(local_devices) -> Mesh:
    """A mesh across the processes of the initialized default group: this
    rank's shards on ``local_devices`` (repeats allowed), every rank the
    same count, rank r's shards after rank r-1's. A collective: every
    rank calls it. Raises when the group's backend cannot serve the
    layout (``mesh_backend``)."""
    import torch.distributed as dist

    local = [_indexed(torch.device(d)) for d in local_devices]
    if not local:
        raise ValueError("a rank needs at least one shard")
    backend = str(dist.get_backend())
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    rank, world = dist.get_rank(), dist.get_world_size()
    layouts = [None] * world
    dist.all_gather_object(
        layouts, (socket.gethostname(), [str(d) for d in local]))
    counts = {len(devs) for _, devs in layouts}
    if len(counts) != 1:
        raise ValueError(f"every rank must hold the same number of shards, "
                         f"not {[len(devs) for _, devs in layouts]}")
    _check_layout(backend, layouts)
    devices = [d for _, devs in layouts for d in devs]
    ranks = [r for r, (_, devs) in enumerate(layouts) for _ in devs]
    devices[rank * len(local):(rank + 1) * len(local)] = local
    return Mesh(devices, ranks=ranks, rank=rank, backend=backend)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the symbol axis. By default it takes the visible CUDA
    cards (the first n_devices of them) and raises when fewer than
    n_devices exist — a silently smaller mesh would pass every downstream
    divisibility check against the WRONG size. ``devices`` names them
    instead (repeats allowed: D shards on one device)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices is None:
            if n == 0:
                raise ValueError(
                    "make_mesh found no CUDA devices (torch.cuda."
                    "is_available() is False); pass devices= to place "
                    "the shards"
                )
            n_devices = n
        if n < n_devices:
            raise ValueError(
                f"mesh wants {n_devices} devices but only {n} are available"
            )
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    elif n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"mesh wants {n_devices} devices but {len(devices)} were "
                "given"
            )
        devices = list(devices)[:n_devices]
    return Mesh(devices)


class SymbolSharding(NamedTuple):
    """The lane-block rule: shard d owns rows [d * n/D, (d+1) * n/D) of any
    tree whose leading axis is the symbol-lane (or grid-row) axis."""

    mesh: Mesh

    def local(self, n: int) -> int:
        """Rows per shard; n must be a multiple of the mesh size."""
        if n % self.mesh.size:
            raise ValueError(
                f"{n} rows do not split evenly over the mesh size "
                f"{self.mesh.size}"
            )
        return n // self.mesh.size

    def bounds(self, n: int, d: int) -> tuple[int, int]:
        local = self.local(n)
        return d * local, (d + 1) * local


def symbol_sharding(mesh: Mesh) -> SymbolSharding:
    return SymbolSharding(mesh)


def _tmap(fn, *trees):
    """fn over the leaves of NamedTuple trees (or over bare leaves)."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(fn(*leaves) for leaves in zip(*trees)))
    return fn(*trees)


def _as_bytes(t: torch.Tensor, stage: torch.device) -> torch.Tensor:
    """A tensor's bytes, flat, on ``stage``."""
    return t.to(stage).contiguous().view(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, like: torch.Tensor,
                rows: int | None = None) -> torch.Tensor:
    """A tensor of ``like``'s dtype and trailing shape (``rows`` rows, or
    ``like``'s) from the flat bytes ``buf``."""
    shape = (like.shape[0] if rows is None else rows,) + tuple(like.shape[1:])
    return buf.clone().view(like.dtype).view(shape)


def _stage(mesh: Mesh) -> torch.device:
    """Where this process's collectives run: the home card under NCCL,
    host memory under gloo."""
    return mesh.home if mesh.backend == "nccl" else torch.device("cpu")


def gather_ranks(mesh: Mesh, tensors) -> list[list[torch.Tensor]]:
    """Every rank's ``tensors`` (the same shapes and dtypes on every rank)
    by one all-gather of their bytes, on the mesh's stage device (host
    memory under gloo, which a tensor on a card reaches by a blocking
    copy; the home card under NCCL). Returns [rank][k]. A collective:
    every rank calls it with the same shapes."""
    import torch.distributed as dist

    stage = _stage(mesh)
    sizes = [a.numel() * a.element_size() for a in tensors]
    buf = torch.cat([_as_bytes(a, stage) for a in tensors])
    bufs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, buf)
    return [[_from_bytes(part, a) for part, a in
             zip(torch.split(rbuf, sizes), tensors)] for rbuf in bufs]


class Sharded:
    """A tree (BookState, DeviceOp, StepOutput or one tensor) held as
    ``mesh.size`` row blocks of equal height: ``blocks[d]`` is a tree of
    the same type on ``mesh.devices[d]`` (``None`` for a shard another
    process holds). Never written in place (a new Sharded replaces a
    block), so a reference is a checkpoint."""

    __slots__ = ("mesh", "blocks")

    def __init__(self, mesh: Mesh, blocks):
        self.mesh = mesh
        self.blocks = tuple(blocks)

    def _leaf(self, tree, name):
        return tree if name is None else getattr(tree, name)

    @property
    def _first(self):
        """This process's first block."""
        return self.blocks[self.mesh.local[0]]

    @property
    def block_rows(self) -> int:
        first = self._first
        return int((first[0] if isinstance(first, tuple) else first).shape[0])

    @property
    def rows(self) -> int:
        return self.block_rows * len(self.blocks)

    def map(self, fn) -> "Sharded":
        """fn applied to every block this process holds (on its own
        device)."""
        return Sharded(self.mesh, [None if b is None else fn(b)
                                   for b in self.blocks])

    def replace_block(self, d: int, block) -> "Sharded":
        blocks = list(self.blocks)
        blocks[d] = block
        return Sharded(self.mesh, blocks)

    def with_row(self, i: int, fn) -> "Sharded":
        """A new Sharded whose block holding row i is fn(block, j), j the
        row's index inside its block (unchanged when another process holds
        that block: its owner applies fn)."""
        d, j = divmod(i, self.block_rows)
        if not self.mesh.is_local(d):
            return self
        return self.replace_block(d, fn(self.blocks[d], j))

    def row(self, i: int):
        """Rows [i, i + 1) of the whole tree, as a tree on its shard's
        device (no copy). Across processes the owner broadcasts the row,
        which the other ranks receive on their home device (a
        collective)."""
        d, j = divmod(i, self.block_rows)
        mine = self.mesh.is_local(d)
        here = (_tmap(lambda a: a[j:j + 1], self.blocks[d]) if mine
                else None)
        if not self.mesh.multiprocess:
            return here
        import torch.distributed as dist

        stage = _stage(self.mesh)
        first = self._first
        leaves = list(first) if isinstance(first, tuple) else [first]
        sizes = [a[:1].numel() * a.element_size() for a in leaves]
        if mine:
            got = list(here) if isinstance(here, tuple) else [here]
            buf = torch.cat([_as_bytes(a, stage) for a in got])
        else:
            buf = torch.empty(sum(sizes), dtype=torch.uint8, device=stage)
        dist.broadcast(buf, src=self.mesh.ranks[d])
        if mine:
            return here
        parts = torch.split(buf, sizes)
        out = [_from_bytes(p, a, 1).to(self.mesh.home)
               for p, a in zip(parts, leaves)]
        return type(first)(*out) if isinstance(first, tuple) else out[0]

    def _gather_ranks(self, names, device) -> list[torch.Tensor]:
        """The named leaves of the whole tree on ``device``, joined across
        processes by one all-gather of this process's blocks' bytes."""
        mine = [self._leaf(self.blocks[d], n)
                for d in self.mesh.local for n in names]
        per = {n: [] for n in names}
        # ranks hold contiguous runs of shards, in order
        for parts in gather_ranks(self.mesh, mine):
            for k, part in enumerate(parts):
                per[names[k % len(names)]].append(part)
        return [torch.cat(per[n]).to(device) for n in names]

    def gather_local(self):
        """This process's blocks as one tree on the home device, in row
        order, and the whole tree's row where they start: the whole tree
        in one process (row 0). Ranks hold contiguous runs of shards, so
        this is a contiguous run of the whole tree's rows. No
        collective."""
        mesh = self.mesh
        first = self._first
        fields = first._fields if isinstance(first, tuple) else (None,)
        on_card = mesh.home.type == "cuda"
        leaves = []
        for f in fields:
            parts = [self._leaf(self.blocks[d], f) for d in mesh.local]
            if len(parts) == 1 and parts[0].device == mesh.home:
                leaves.append(parts[0])
                continue
            # A peer copy of this rank's device blocks onto its home card.
            moved = [p.to(mesh.home, non_blocking=on_card) for p in parts]  # gomelint: disable=GL505 — a peer copy of device blocks, not a host upload
            leaves.append(torch.cat(moved))
        tree = type(first)(*leaves) if isinstance(first, tuple) else leaves[0]
        return tree, mesh.local[0] * self.block_rows

    def gather_leaf(self, name: str | None = None, device=None):
        """One leaf of the whole tree on ``device`` (default: the home
        device): the blocks concatenated in row order. A block on another
        card comes over by a peer copy, which PyTorch orders after the
        work queued on that card's current stream; no host sync. One block
        already on the device is returned as it is. Across processes the
        blocks come over by an all-gather (a collective)."""
        device = self.mesh.home if device is None else _indexed(
            torch.device(device))
        if self.mesh.multiprocess:
            return self._gather_ranks([name], device)[0]
        parts = [self._leaf(b, name) for b in self.blocks]
        if len(parts) == 1 and parts[0].device == device:
            return parts[0]
        return torch.cat([
            p.to(device, non_blocking=device.type == "cuda") for p in parts
        ])

    def gather(self, device=None):
        """The whole tree on ``device`` (default: the home device); across
        processes one all-gather for every leaf."""
        first = self._first
        if not isinstance(first, tuple):
            return self.gather_leaf(None, device)
        if self.mesh.multiprocess:
            device = self.mesh.home if device is None else _indexed(
                torch.device(device))
            return type(first)(*self._gather_ranks(first._fields, device))
        return type(first)(
            *(self.gather_leaf(f, device) for f in first._fields)
        )

    def host_leaf(self, name: str | None = None) -> np.ndarray:
        """One leaf of the whole tree as a host numpy array, copied block
        by block (no whole-stack tensor on any device)."""
        if self.mesh.multiprocess:
            return self.gather_leaf(name, "cpu").numpy()
        return np.concatenate([
            self._leaf(b, name).detach().to("cpu").numpy()
            for b in self.blocks
        ])

    def host(self):
        """The whole tree as host numpy leaves."""
        first = self._first
        if not isinstance(first, tuple):
            return self.host_leaf()
        if self.mesh.multiprocess:
            return type(first)(*(a.numpy() for a in self.gather("cpu")))
        return type(first)(*(self.host_leaf(f) for f in first._fields))


def shard_batch(mesh: Mesh, tree) -> Sharded:
    """Split every [S, ...] leaf of a tree (torch tensors or host numpy
    arrays) into the mesh's row blocks, block d on mesh.devices[d]: host
    arrays go up to each shard's device from pinned memory (no host sync),
    device tensors by a slice (no copy on the same device) or a peer copy.
    Across processes only this process's blocks go up (the others are
    None). A tree already sharded on this mesh is returned as it is."""
    if isinstance(tree, Sharded):
        if tree.mesh is not mesh:
            raise ValueError("tree is sharded over another mesh")
        return tree
    first = tree[0] if isinstance(tree, tuple) else tree
    rule = symbol_sharding(mesh)
    n = int(first.shape[0])

    def block(d, dev):
        lo, hi = rule.bounds(n, d)

        def put(a):
            if isinstance(a, np.ndarray):
                return to_device(a[lo:hi], dev)
            return a[lo:hi].to(dev, non_blocking=dev.type == "cuda")

        return _tmap(put, tree)

    return Sharded(mesh, [block(d, dev) if mesh.is_local(d) else None
                          for d, dev in enumerate(mesh.devices)])


def sharded_books(config: BookConfig, n_slots: int, mesh: Mesh) -> Sharded:
    """An empty [n_slots] book stack as the mesh's blocks, each made on its
    own device (this process's blocks only)."""
    local = symbol_sharding(mesh).local(n_slots)
    return Sharded(mesh, [
        init_books(config, local, dev) if mesh.is_local(d) else None
        for d, dev in enumerate(mesh.devices)
    ])


def grow_sharded_lanes(books: Sharded, n_lanes: int) -> Sharded:
    """Append empty lanes to a sharded stack, re-laying its lanes over the
    blocks: a block is S/D lanes wide, so growing S moves every lane past
    the first block's new width to a lower shard. Each new block takes the
    old blocks' overlapping rows (a peer copy across cards) and zeros; the
    whole stack is never put on one device. Across processes the rows
    move between ranks: every rank gathers the stack, grows it and keeps
    its own new blocks."""
    mesh = books.mesh
    old, new = books.block_rows, symbol_sharding(mesh).local(n_lanes)
    if new < old:
        raise ValueError(f"cannot shrink lanes {books.rows} -> {n_lanes}")
    if new == old:
        return books
    if mesh.multiprocess:
        return shard_batch(mesh, grow_lanes(books.gather(), n_lanes))
    out = []
    for d, dev in enumerate(mesh.devices):
        lo, hi = d * new, (d + 1) * new

        def leaf(*blocks_leaf, lo=lo, hi=hi, dev=dev):
            parts = []
            for e, a in enumerate(blocks_leaf):
                s, t = max(lo, e * old), min(hi, (e + 1) * old)
                if s < t:
                    # A peer copy of the old device blocks (parameters, so
                    # unknown to the pass); only when the lanes grow.
                    parts.append(a[s - e * old:t - e * old].to(dev, non_blocking=True))  # gomelint: disable=GL505 — a peer copy of device blocks, not a host upload
            got = sum(int(p.shape[0]) for p in parts)
            if got < new:
                parts.append(torch.zeros(
                    (new - got,) + tuple(blocks_leaf[0].shape[1:]),
                    dtype=blocks_leaf[0].dtype, device=dev,
                ))
            return torch.cat(parts) if len(parts) > 1 else parts[0]

        out.append(BookState(*(
            leaf(*(getattr(b, f) for b in books.blocks))
            for f in BookState._fields
        )))
    return Sharded(mesh, out)


def _check_blocks(mesh: Mesh, *trees) -> None:
    for t in trees:
        if not isinstance(t, Sharded) or t.mesh is not mesh:
            raise ValueError("expected a tree sharded over this mesh "
                             "(shard_batch)")


def sharded_batch_step(config: BookConfig, mesh: Mesh, kernel: str = "scan",
                       pallas_interpret: bool = False):
    """The full-grid step per shard: on each block, the cap-class slice,
    K1, the capped-lane guard and the write-back that BatchEngine._step
    runs for a full grid (engine.batch.full_grid_step), launched on that
    shard's device. Returns fn(books, ops) -> (books, outs), all three
    Sharded; no cross-shard traffic. kernel and pallas_interpret are the
    reference's arguments, kept so its calls bind; every value runs K1."""
    from ..engine import batch

    check_kernel(kernel)

    def stepper(books: Sharded, ops: Sharded):
        _check_blocks(mesh, books, ops)
        pairs = [
            (None, None) if b is None else batch.full_grid_step(config, b, o)
            for b, o in zip(books.blocks, ops.blocks)
        ]
        return (Sharded(mesh, [p[0] for p in pairs]),
                Sharded(mesh, [p[1] for p in pairs]))

    return stepper


def _dense_block_ids(ids_local: np.ndarray, d: int, r_s: int,
                     local: int) -> tuple[np.ndarray, int]:
    """Shard d's [R_s] local ids and its live-row count, read on the host.
    The packer lays each shard's live rows out as a prefix of its block
    (sentinel >= local after them), which is what lets the gather and the
    scatter index without a device read."""
    ids = np.asarray(ids_local[d * r_s:(d + 1) * r_s], np.int64)
    live = ids < local
    n_live = int(np.count_nonzero(live))
    if not live[:n_live].all():
        raise ValueError(
            f"shard {d}: live rows must be a prefix of its row block"
        )
    return ids, n_live


def sharded_dense_step(config: BookConfig, mesh: Mesh, kernel: str = "scan",
                       pallas_interpret: bool = False):
    """The dense live-lane step per shard, the multi-card form of
    BatchEngine's dense grid: shard d's rows [d * R_s, (d+1) * R_s) name
    only lanes it owns, so on each block it gathers its local lanes, runs
    K1, guards and scatters back (engine.batch.dense_grid_step), with no
    cross-shard traffic.

    Returns fn(books, ids_local, ops) -> (books, outs): books and ops
    Sharded, ids_local the [D * R_s] shard-local lane ids on the HOST
    (sentinel >= S/D on padding rows: gathered as zero books, dropped by
    the scatter); each block's ids go up to its device. kernel and
    pallas_interpret as in sharded_batch_step."""
    from ..engine import batch

    check_kernel(kernel)

    def stepper(books: Sharded, ids_local, ops: Sharded):
        _check_blocks(mesh, books, ops)
        ids_local = np.asarray(ids_local)
        r_s = len(ids_local) // mesh.size
        if r_s * mesh.size != len(ids_local) or r_s != ops.block_rows:
            raise ValueError(
                f"{len(ids_local)} ids do not match the grid's "
                f"{ops.rows} rows over {mesh.size} shards"
            )
        local = books.block_rows
        pairs = []
        for d, (b, o) in enumerate(zip(books.blocks, ops.blocks)):
            if b is None:  # another process's shard
                pairs.append((None, None))
                continue
            ids, n_live = _dense_block_ids(ids_local, d, r_s, local)
            dev = mesh.devices[d]
            pairs.append(batch.dense_grid_step(
                config, b, to_device(ids, dev), n_live, o
            ))
        return (Sharded(mesh, [p[0] for p in pairs]),
                Sharded(mesh, [p[1] for p in pairs]))

    return stepper


def localize_ids(lane_ids, n_slots: int, mesh: Mesh) -> np.ndarray:
    """Global dense-grid lane ids (sentinel n_slots) -> shard-local ids:
    each shard's row block names only its own lanes, so lane % local IS
    the local index; the sentinel maps to `local` (out of range on every
    shard)."""
    local = symbol_sharding(mesh).local(n_slots)
    ids = np.asarray(lane_ids, np.int64)
    return np.where(ids >= n_slots, local, ids % local)


def _elapsed_ms(fn, dev: torch.device) -> float:
    """One call's time: CUDA events on the shard's own device, or the
    host clock off the card."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    with torch.cuda.device(dev):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)


def shard_execution_report(config: BookConfig, mesh: Mesh, books, lane_ids,
                           ops, repeats: int = 3) -> dict:
    """Measured per-shard execution time of one dense mesh dispatch: the
    skew tax as device time, not a host histogram.

    Each shard's row block is replayed alone — the same gather, K1 and
    scatter (engine.batch.dense_grid_step) on its own lane block, on its
    own device — and timed best-of-``repeats`` (CUDA events on that
    device; the host clock on the CPU). Every shard runs R_s rows, the
    bucketed MAX of the live counts, so every shard pays the hottest
    shard's row count; ``exec_ms`` against ``live_lanes`` is that tax.

    ``books``: the [S] stack (a BookState, or Sharded over this mesh);
    ``lane_ids``: the [D * R_s] GLOBAL ids with sentinel S on padding rows
    (what BatchEngine._grid_geometry returns); ``ops``: the [D * R_s, T]
    grid (a DeviceOp or Sharded). A probe, never the dispatch path; the
    books are not changed. Across processes each rank times its own shards
    and the report joins every rank's (a collective)."""
    from ..engine import batch

    books = shard_batch(mesh, books)
    ops = shard_batch(mesh, ops)
    d_n = mesh.size
    s = books.rows
    local = books.block_rows
    r_s = len(lane_ids) // d_n
    ids_local = localize_ids(lane_ids, s, mesh)
    shards = []
    for d, dev in enumerate(mesh.devices):
        if not mesh.is_local(d):
            continue
        ids, n_live = _dense_block_ids(ids_local, d, r_s, local)
        ids_t = to_device(ids, dev)
        run = lambda d=d, ids_t=ids_t, n_live=n_live: batch.dense_grid_step(
            config, books.blocks[d], ids_t, n_live, ops.blocks[d])
        run()  # warm-up
        best = min(_elapsed_ms(run, dev) for _ in range(max(1, repeats)))
        shards.append({
            "shard": d,
            "device": str(dev),
            "rows": r_s,
            "live_lanes": n_live,
            "rows_per_live_lane": r_s / n_live if n_live else None,
            "exec_ms": best,
        })
    if mesh.multiprocess:
        import torch.distributed as dist

        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, shards)
        shards = [sh for part in every for sh in part]
    times = [sh["exec_ms"] for sh in shards]
    lives = [sh["live_lanes"] for sh in shards]
    total_live = sum(lives) or 1
    return {
        "n_shards": d_n,
        "rows_per_shard": r_s,
        "dispatched_rows": d_n * r_s,
        "live_lanes": sum(lives),
        "shards": shards,
        "exec_ms_max": max(times),
        "exec_ms_mean": sum(times) / len(times),
        "live_skew": max(lives) * d_n / total_live,
        "rows_per_live_lane": d_n * r_s / total_live,
    }


def global_fill_rate(outs) -> torch.Tensor:
    """Total fills in a batch: a sum over the lane axis (on the home device
    when the outputs are Sharded — the one cross-shard reduction; across
    processes an all-reduce)."""
    if isinstance(outs, Sharded):
        mesh = outs.mesh
        total = sum(b.n_fills.sum().to(mesh.home) for b in outs.blocks
                    if b is not None)
        if mesh.multiprocess:
            import torch.distributed as dist

            part = total.to(_stage(mesh))
            dist.all_reduce(part)
            total = part.to(mesh.home)
        return total
    return outs.n_fills.sum()
