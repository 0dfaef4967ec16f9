"""Pre-pool marker store — the shared state between gateway and consumer.

The port of ``gome_tpu/engine/prepool.py`` (its in-process pool). The
gateway marks an ADD at accept (HSET S:comparison S:U:O 1 in the
reference), the consumer consumes the mark when the ADD reaches the book,
and a cancel clears it first — that is what makes the cancel-before-consume
race drop the queued ADD.

The contract the engine uses (beyond set-ish add/discard/contains/iter):

  consume_batch(keys) -> list[bool]   pop each (symbol, uuid, oid) key in
      order; True where the key existed.
"""

from __future__ import annotations

import numpy as np

from ..types import Action

Key = tuple[str, str, str]  # (symbol, uuid, oid)


class LocalPrePool(set):
    """In-process marker store: a plain set of (symbol, uuid, oid)."""

    def consume_batch(self, keys: list[Key]) -> list[bool]:
        out = []
        discard = self.discard
        for k in keys:
            if k in self:
                discard(k)
                out.append(True)
            else:
                out.append(False)
        return out

    def _frame_keys(self, cols: dict):
        """Key tuples of an ORDER frame's ADD rows: one vectorized row
        select, then C-speed zip/update (no per-order Python calls)."""
        act = np.ascontiguousarray(cols["action"])
        sel = np.nonzero(act == int(Action.ADD))[0]
        if not len(sel):
            return None
        syms, uuids = cols["symbols"], cols["uuids"]
        sidx = np.asarray(cols["symbol_idx"])[sel].tolist()
        uidx = np.asarray(cols["uuid_idx"])[sel].tolist()
        oids = np.asarray(cols["oids"])[sel].tolist()
        return zip(
            map(syms.__getitem__, sidx),
            map(uuids.__getitem__, uidx),
            (o.decode() for o in oids),
        )

    def mark_frame(self, cols: dict) -> None:
        """Gateway-side bulk marking of an ORDER frame's ADDs."""
        keys = self._frame_keys(cols)
        if keys is not None:
            self.update(keys)

    def unmark_frame(self, cols: dict) -> None:
        """Undo mark_frame (the frame never entered the engine, so no
        marker may dangle)."""
        keys = self._frame_keys(cols)
        if keys is not None:
            self.difference_update(keys)


def consume_batch_of(pool, keys: list[Key]) -> list[bool]:
    """consume_batch for any pool object — uses the pool's own batched
    implementation when present, else the generic set-protocol fallback
    (covers plain sets assigned by older persistence snapshots)."""
    consume = getattr(pool, "consume_batch", None)
    if consume is not None:
        return consume(keys)
    return LocalPrePool.consume_batch(pool, keys)  # set-protocol fallback


def make_prepool() -> LocalPrePool:
    """The engine's marker store: the in-process pool."""
    return LocalPrePool()
