"""The engine facade: pre-pool admission + batched device matching.

The port of ``gome_tpu/engine/orchestrator.py`` (its object, single-order,
columnar and frame entry points). It is the layer the gateway and the order
consumer talk to:

  gateway side   mark(order) / mark_frame(cols)
                   — HSET S:comparison S:U:O 1 in the reference
  consumer side  process(orders) / process_frame(cols)
                 — the consumer loop body:
                   ADD: consumed only if still marked, else dropped (the
                        cancel-before-consume race)
                   DEL: clears the mark first so a still-queued ADD dies,
                        then cancels on the book
"""

from __future__ import annotations

import numpy as np

from ..types import Action, MatchResult, Order
from .batch import BatchEngine, EngineStats
from .book import BookConfig
from .prepool import consume_batch_of, make_prepool


class MatchEngine:
    """Admission + matching for one engine shard (a set of symbol lanes).

    Orders enter twice, like the reference's two process hops: `mark()` when
    the gateway accepts an ADD (before it is queued), `process()` when the
    consumer drains a micro-batch from the queue. Cancels are never marked.
    """

    def __init__(
        self,
        config: BookConfig | None = None,
        n_slots: int = 1024,
        max_t: int = 32,
        auto_grow: bool = True,
        kernel: str = "scan",
        device=None,
        **batch_kw,
    ):
        """kernel: the reference's "scan" or "pallas"; both run the one
        step (BatchEngine). device: the CUDA card by default (raises if
        there is none); "cpu" runs the plain PyTorch version. batch_kw
        passes through to BatchEngine (mesh, dense, dense_t_max,
        max_slots, max_cap, pallas_interpret); with
        mesh= (gome_tpu_torch.parallel.make_mesh) the books split into
        per-shard blocks and the engine's device is the mesh's home."""
        self.batch = BatchEngine(
            config or BookConfig(),
            n_slots,
            max_t=max_t,
            auto_grow=auto_grow,
            kernel=kernel,
            device=device,
            **batch_kw,
        )
        self.pre_pool = make_prepool()

    # -- gateway side ------------------------------------------------------
    def mark(self, order: Order) -> None:
        """Record "submitted, not yet consumed/cancelled" for an ADD. No-op
        for other actions."""
        if order.action is Action.ADD:
            self.pre_pool.add(self._prekey(order))

    def unmark(self, order: Order) -> None:
        """Discard an order's pre-pool entry without processing it."""
        self.pre_pool.discard(self._prekey(order))

    def mark_frame(self, cols: dict) -> None:
        """Bulk mark for the columnar admit path: the ADD rows of a decoded
        ORDER frame (same contract as mark())."""
        self.pre_pool.mark_frame(cols)

    def unmark_frame(self, cols: dict) -> None:
        """Bulk undo of mark_frame."""
        self.pre_pool.unmark_frame(cols)

    # -- consumer side -----------------------------------------------------
    def process(self, orders: list[Order]) -> list[MatchResult]:
        """Apply one micro-batch in arrival order; returns the MatchResult
        event stream in the reference's global emission order. Admission
        drops ADDs cancelled before consumption without touching the book."""
        return [
            ev
            for _, evs in self.process_indexed(list(enumerate(orders)))
            for ev in evs
        ]

    def process_indexed(
        self, indexed: list[tuple[int, Order]]
    ) -> list[tuple[int, list[MatchResult]]]:
        """process() keyed by caller-assigned arrival tags — admission
        applies identically; tags of dropped ADDs emit no group."""
        admitted, consumed = self._admit(indexed)
        try:
            return self.batch.process_indexed(admitted)
        except Exception:
            self.pre_pool |= consumed
            raise

    def process_one(self, order: Order) -> list[MatchResult]:
        return self.process([order])

    def process_columnar(self, orders: list[Order]):
        """process() with the vectorized decode path: same admission, same
        event content/order, but returns a columnar EventBatch."""
        admitted, consumed = self._admit(list(enumerate(orders)))
        try:
            return self.batch.process_columnar([o for _, o in admitted])
        except Exception:
            self.pre_pool |= consumed
            raise

    def process_frame(self, cols: dict, fast: bool = True):
        """Columnar-frame ingestion (a decoded ORDER frame): admission
        semantics identical to process() — unmarked ADDs drop, DELs clear
        their marks — applied by filtering the columns, then the frame path
        (engine.frames) runs the batch. Returns an EventBatch. fast=True
        queues every grid with device-side event compaction and one
        two-phase fetch (falling back to the exact path when a device
        budget trips); fast=False runs the exact synchronous path."""
        from . import frames

        cols, consumed = self.admit_frame(cols)
        run = frames.apply_frame_fast if fast else frames.process_frame
        try:
            return run(self.batch, cols)
        except Exception:
            self.pre_pool |= consumed
            raise

    def admit_frame(self, cols: dict) -> tuple[dict, set]:
        """Frame admission: returns (filtered columns, the consumed marks);
        the caller restores `consumed` (pre_pool |= consumed) if the batch
        later fails."""
        consume_frame = getattr(self.pre_pool, "consume_frame", None)
        if consume_frame is not None:
            # Fused native pass: compose keys + pop markers + masks in C++.
            keep, consumed = consume_frame(cols)
            dropped = int(
                ((cols["action"] == int(Action.ADD)) & ~keep).sum()
            )
            self.stats.dropped_no_prepool += dropped
            return self._keep_rows(cols, keep), consumed

        n = int(cols["n"])
        action = cols["action"].tolist()
        syms, uuids = cols["symbols"], cols["uuids"]
        sidx, uidx = cols["symbol_idx"].tolist(), cols["uuid_idx"].tolist()
        oid_list = [o.decode() for o in cols["oids"].tolist()]
        consumed: set[tuple[str, str, str]] = set()
        ADD, DEL = int(Action.ADD), int(Action.DEL)
        # Key construction at C speed: list-comp indexing + zip tuples;
        # marks consume through ONE batched call.
        keys = list(
            zip((syms[k] for k in sidx), (uuids[k] for k in uidx), oid_list)
        )
        sel = [i for i, a in enumerate(action) if a == ADD or a == DEL]
        existed = consume_batch_of(
            self.pre_pool,
            keys if len(sel) == n else [keys[i] for i in sel],
        )
        keep = np.zeros(n, bool)  # NOP padding never reaches the device
        dropped = 0
        for i, ex in zip(sel, existed):
            if action[i] == ADD:
                if ex:
                    keep[i] = True
                    consumed.add(keys[i])
                else:
                    dropped += 1
            else:  # DEL: always admitted; a consumed mark kills a queued ADD
                keep[i] = True
                if ex:
                    consumed.add(keys[i])
        self.stats.dropped_no_prepool += dropped
        return self._keep_rows(cols, keep), consumed

    @staticmethod
    def _keep_rows(cols: dict, keep: np.ndarray) -> dict:
        """The frame's admitted rows: `cols` itself when every row is kept,
        else a new dict of fresh column arrays (the input is never
        written: a NativeConsumed holds it for the rollback)."""
        if keep.all():
            return cols
        return dict(
            cols,
            n=int(keep.sum()),
            **{
                k: np.ascontiguousarray(cols[k][keep])
                for k in (
                    "action", "side", "kind", "price", "volume",
                    "symbol_idx", "uuid_idx", "oids",
                )
            },
        )

    def _admit(
        self, indexed: list[tuple[int, Order]]
    ) -> tuple[list[tuple[int, Order]], set]:
        """Apply admission over (tag, order) items; also returns the
        pre-pool keys this batch consumed so a FAILED batch can restore them
        (a replayed ADD must not die as unmarked because the failed attempt
        already popped its key)."""
        sel: list[tuple[int, Order]] = []
        keys: list[tuple[str, str, str]] = []
        for item in indexed:
            action = item[1].action
            if action is Action.ADD or action is Action.DEL:
                sel.append(item)
                keys.append(self._prekey(item[1]))
            # NOP padding never reaches the device.
        existed = consume_batch_of(self.pre_pool, keys)
        admitted: list[tuple[int, Order]] = []
        consumed: set[tuple[str, str, str]] = set()
        for item, key, ex in zip(sel, keys, existed):
            if item[1].action is Action.ADD:
                if not ex:
                    self.stats.dropped_no_prepool += 1
                    continue
                consumed.add(key)
            elif ex:
                consumed.add(key)
            admitted.append(item)
        return admitted, consumed

    # -- geometry persistence ----------------------------------------------
    def save_geometry(self, path: str) -> None:
        """Persist the flow's shape manifest (grow-only geometry floors +
        every dispatched fast-path shape combo) as JSON, the reference's
        layout: either package loads the other's. A later process
        load_geometry()s it so its first frames run at the shapes this
        flow settled on."""
        import json
        import os

        m = self.batch.shape_manifest()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(m, f)
        os.replace(tmp, path)  # atomic: readers never see a torn file

    def load_geometry(self, path: str, presize_cap: bool = True) -> int:
        """Load a persisted shape manifest: presize storage to its cap
        (clamped to max_cap; presize_cap=False keeps the boot storage, and
        combos above it are skipped), prewarm the grow-only floors (so
        this process CHOOSES the recorded shapes) and replay the recorded
        combos with all-padding inputs (frames.precompile_combos: the
        caching allocator and the fetch's pinned blocks warm at those
        shapes). Returns the number of combos replayed (0 for an absent or
        invalid file: geometry is a performance hint, never state, and a
        bad manifest only logs)."""
        import json

        from . import frames

        try:
            try:
                f = open(path)
            except FileNotFoundError:
                return 0  # no manifest yet: the first boot
            with f:
                m = json.load(f)
            floors = m["floors"]
            combos = m["combos"]
            as_int = lambda d: {int(k): int(v) for k, v in d.items()}
            if presize_cap and floors.get("cap"):
                self.batch.ensure_cap(
                    min(int(floors["cap"]), self.batch.max_cap)
                )
            self.batch.prewarm_geometry(
                rows_floor=as_int(floors.get("rows_floor", {})),
                t_floor=as_int(floors.get("t_floor", {})),
                fills_buf=as_int(floors.get("fills_buf", {})),
                cancels_buf=as_int(floors.get("cancels_buf", {})),
            )
            return frames.precompile_combos(self.batch, combos)
        except Exception as e:
            from ..utils.logging import get_logger

            get_logger("engine").warning(
                "geometry manifest %s not applied: %s", path, e
            )
            return 0

    # -- views -------------------------------------------------------------
    @property
    def stats(self) -> EngineStats:
        return self.batch.stats

    @property
    def config(self) -> BookConfig:
        return self.batch.config

    @property
    def books(self):
        """The device book stack: a BookState, or under a mesh a Sharded
        of per-shard BookState blocks (.gather() puts the whole stack on
        the home device, .host() on the host)."""
        return self.batch.books

    @staticmethod
    def _prekey(order: Order) -> tuple[str, str, str]:
        """S:comparison field = S:U:O."""
        return (order.symbol, order.uuid, order.oid)
