"""Snapshot store + the Persister that wires it into the service loop.

The port of ``gome_tpu/persist/snapshot.py``. A snapshot is a host copy of
the books (BatchEngine.export_state moves every leaf off the card at the
storage width) written as ``snap-<n>/books.npz`` + ``manifest.json`` with
the reference's keys and dtypes, so either package restores the other's;
restore moves the arrays back to the engine's device (import_state).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

from ..utils.faults import FAULTS
from ..utils.logging import get_logger

log = get_logger("persist")

_MANIFEST = "manifest.json"
_BOOKS = "books.npz"


class SnapshotStore:
    """Atomic, versioned snapshot directory.

    Layout: <dir>/snap-<n>/ containing manifest.json (everything JSON-able:
    cursors, interners, pre-pool, geometry) + books.npz (the array state).
    Written to a temp dir then os.rename'd — a crash mid-write leaves no
    torn snapshot, and restore picks the newest directory with a valid
    manifest ("DONE" marker is the manifest itself, written last).
    """

    def __init__(self, directory: str, keep: int = 4):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _ids(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("snap-"):
                try:
                    out.append(int(name.split("-", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, manifest: dict, books: dict[str, np.ndarray]) -> str:
        ids = self._ids()
        snap_id = (ids[-1] + 1) if ids else 0
        final = os.path.join(self.dir, f"snap-{snap_id}")
        tmp = tempfile.mkdtemp(prefix=".tmp-snap-", dir=self.dir)
        try:
            books_path = os.path.join(tmp, _BOOKS)
            np.savez(books_path, **books)
            with open(books_path, "rb+") as f:
                os.fsync(f.fileno())
            # manifest last: its presence marks the snapshot complete
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            cut = FAULTS.fire("snapshot.rename")
            if cut:
                # Torn publish: truncate the manifest inside tmp, complete
                # the rename anyway, and die — load_latest must skip the
                # unreadable snapshot and fall back to the previous one.
                mpath = os.path.join(tmp, _MANIFEST)
                with open(mpath, "rb+") as f:
                    f.truncate(cut % os.path.getsize(mpath))
                os.rename(tmp, final)
                FAULTS.hard_exit()
            os.rename(tmp, final)
            # fsync the parent dir so the rename itself survives power loss
            dirfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return final

    def _prune(self) -> None:
        ids = self._ids()
        for old in ids[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.dir, f"snap-{old}"), ignore_errors=True
            )

    def load_latest(self) -> tuple[dict, dict[str, np.ndarray]] | None:
        """Newest snapshot with a valid manifest, or None."""
        for snap_id in reversed(self._ids()):
            path = os.path.join(self.dir, f"snap-{snap_id}")
            try:
                with open(os.path.join(path, _MANIFEST)) as f:
                    manifest = json.load(f)
                with np.load(os.path.join(path, _BOOKS)) as z:
                    books = {k: z[k] for k in z.files}
                return manifest, books
            except Exception as e:  # torn npz raises BadZipFile etc.; any
                # unreadable snapshot must fall back to the previous one
                log.warning("skipping unreadable snapshot %s: %s", path, e)
        return None


class Persister:
    """Service-loop integration: cadence counting, consistent-cut capture,
    restore + replay rewind. Attach via EngineService(persist=...)."""

    def __init__(self, config):
        """config: config.PersistConfig."""
        self.store = SnapshotStore(config.dir, keep=config.keep)
        self.every_n = config.every_n_batches
        self._batches = 0  # single-writer: the consuming thread (on_batch)
        self.engine = None  # MatchEngine  # single-writer: attach() caller
        self.bus = None  # single-writer: attach() caller
        self.consumer = None  # single-writer: attach() caller (matchfeed seq recovery)
        self.snapshots_taken = 0  # single-writer: the consuming thread
        self.restored = False  # single-writer: restore_latest() caller
        # Durability telemetry (/durability payload, gome_* gauges, the
        # timeline probe). Written from the consuming thread / the
        # restore_latest() caller only; the ops HTTP thread reads it
        # off-lock (floats and small ints are single-bytecode loads —
        # stale at worst, never torn).
        self.last_snapshot_unix = 0.0  # single-writer: the consuming thread
        self.last_snapshot_bytes = 0  # single-writer: the consuming thread
        self.last_restore = "never"  # single-writer: restore_latest() caller
        self.last_recovery_seconds = 0.0  # single-writer: restore_latest() caller
        self.wal_replay_frames = 0  # single-writer: restore_latest() caller

    def attach(self, engine, bus, consumer=None) -> None:
        self.engine = engine
        self.bus = bus
        if consumer is not None:
            self.consumer = consumer

    # -- called by OrderConsumer after each committed batch ------------------
    def on_batch(self, n_orders: int, n_events: int) -> None:
        self._batches += 1
        if self._batches >= self.every_n:
            self._batches = 0
            self.snapshot()

    def snapshot(self) -> str:
        """Capture a consistent cut. Must run from the consumer thread (or
        with the consumer idle): the cut is 'books == orders below the
        committed offset', which only holds between batches."""
        state = self.engine.batch.export_state()
        # The gateway thread mutates pre_pool concurrently; retry the copy on
        # the (tiny) window where iteration observes a mutation. Extra marks
        # captured here belong to orders published after the cut and are
        # reconciled from the order log on restore.
        for _ in range(100):
            try:
                pre_pool = sorted(self.engine.pre_pool)
                break
            except RuntimeError:
                continue
        else:
            raise RuntimeError(
                "could not copy pre_pool after 100 attempts (pathological "
                "concurrent marking); snapshot aborted"
            )
        manifest = {
            "version": 1,
            "order_committed": self.bus.order_queue.committed(),
            "match_end": self.bus.match_queue.end_offset(),
            # Matchfeed seq at the cut: every event below match_end carries
            # a seq below this (exactly-once suppression after restore).
            "match_seq": (
                self.consumer.match_seq if self.consumer is not None else 0
            ),
            "pre_pool": pre_pool,
            **{k: v for k, v in state.items() if k != "books"},
        }
        path = self.store.save(manifest, state["books"])
        self.snapshots_taken += 1
        self.last_snapshot_unix = time.time()
        try:
            self.last_snapshot_bytes = sum(
                os.path.getsize(os.path.join(path, n)) for n in os.listdir(path)
            )
        except OSError:
            pass
        log.info(
            "snapshot %s (orders<%d, matches<%d)",
            os.path.basename(path),
            manifest["order_committed"],
            manifest["match_end"],
        )
        return path

    def restore_latest(self) -> bool:
        """Restore books + pre-pool and rewind the bus to the snapshot cut.
        After this, the NORMAL consumer loop replays the order-log tail
        deterministically, regenerating the truncated match-queue tail
        exactly (see package docstring). Returns True if a snapshot was
        applied."""
        t0 = time.monotonic()
        loaded = self.store.load_latest()
        oq = self.bus.order_queue
        mq = self.bus.match_queue
        # The pre-crash consumer position: tail messages below it were
        # consumed by the crashed process (their effects may have been
        # observable), messages at/above it never were.
        consumed_to = oq.committed()
        if loaded is not None:
            manifest, books = loaded
            self.engine.batch.import_state({**manifest, "books": books})
            # In place, not reassignment: the pool object may be a shared
            # remote marker store (prepool.RespPrePool) the gateway also
            # holds.
            self.engine.pre_pool.clear()
            self.engine.pre_pool.update(tuple(k) for k in manifest["pre_pool"])
            # The snapshot is the authority on the cut. Normally the cut is
            # at/below the committed offset (rollback); after a TORN
            # .offset sidecar the recovered committed offset can sit BELOW
            # the cut (FileQueue falls back to a conservative digit
            # prefix) — the snapshot proves orders below the cut are fully
            # applied, so seek forward instead of replaying them onto
            # restored books (found by scripts/chaos.py's torn-sidecar
            # schedule).
            cut = manifest["order_committed"]
            if cut <= oq.committed():
                oq.rollback(cut)
            else:
                oq.commit(cut)
            # The feed may have committed past the cut before the crash;
            # replay regenerates byte-identical events, so rewind its cursor
            # and drop the stale tail.
            mq.rollback(min(mq.committed(), manifest["match_end"]))
            mq.truncate_to(manifest["match_end"])
            if self.consumer is not None:
                # Replay regenerates the truncated match tail with the
                # SAME seqs it had pre-crash (exactly-once across restarts).
                self.consumer.reset_seq(int(manifest.get("match_seq", 0)))
            self.restored = True
        elif oq.committed() > 0 or mq.end_offset() > 0:
            # Durable order log but no snapshot yet (crash before the first
            # cadence tick): the engine is fresh/empty, so the only
            # consistent cut is offset 0 — rewind and replay the ENTIRE log;
            # the truncated match queue is regenerated deterministically.
            # The mq conditions cover a crash BEFORE the first order-queue
            # commit but AFTER a match publish (the at-least-once window at
            # offset 0): without truncation the replay would re-publish
            # those events as queue-level duplicates (found by
            # scripts/chaos.py's first-frame kill).
            oq.rollback(0)
            mq.rollback(0)
            mq.truncate_to(0)
            if self.consumer is not None:
                self.consumer.reset_seq(0)
        replayed = self._reconstruct_marks(
            cut=oq.committed(), consumed_to=consumed_to
        )
        self.wal_replay_frames = replayed
        self.last_recovery_seconds = time.monotonic() - t0
        self.last_restore = (
            "restored"
            if loaded is not None
            else ("replayed" if replayed else "none")
        )
        if loaded is not None or replayed:
            log.info(
                "recovery: snapshot=%s, %d queued ops to replay",
                "yes" if loaded is not None else "no",
                replayed,
            )
        return loaded is not None

    def _reconstruct_marks(self, cut: int, consumed_to: int) -> int:
        """Rebuild pre-pool marks for ADDs queued at/after `cut` (they were
        marked in the crashed process's memory: the gateway marks BEFORE
        publishing, main.go:44-45 ordering — so every queued ADD carried a
        mark).

        One refinement separates two cases by `consumed_to` (the pre-crash
        consumer position):

        * ADD consumed pre-crash (offset < consumed_to): its admission
          decision may already be observable (fills delivered to live
          subscribers), so replay must re-admit — always re-mark. The
          realizable serialization: the mark was placed at publish time,
          after every DEL consumed before it.
        * ADD never consumed (offset >= consumed_to): no decision was made,
          so any realizable interleaving is valid; we choose NOT to re-mark
          when the key's latest committed message below the cut is a DEL —
          that DEL's cancel semantics were observable (event below
          match_end), and resurrecting a cancelled order would surprise
          (SURVEY §2.3.3's race, resolved deterministically at recovery).

        Residual ambiguity (documented, not resolvable from the log alone):
        a DEL *inside* the consumed tail followed by a same-key ADD replays
        as drop, while the crashed process may have raced to admit. Both
        outcomes are realizable serializations of the reference's racy
        pre-pool; eliminating the race entirely would need a durable mark
        log (fsync per gateway mark — rejected as the wrong latency trade).
        """
        from ..bus import decode_message_orders
        from ..types import Action

        def orders_in(m):
            # A frame's whole batch shares the message offset (it consumes
            # atomically), so the offset-based logic below is unchanged.
            return decode_message_orders(m.body)

        oq = self.bus.order_queue
        tail = oq.read_from(cut, oq.end_offset() - cut)
        suppressible = set()  # keys of never-consumed ADDs
        tail_adds: list[tuple[int, tuple]] = []
        for m in tail:
            for order in orders_in(m):
                if order.action is Action.ADD:
                    key = (order.symbol, order.uuid, order.oid)
                    tail_adds.append((m.offset, key))
                    if m.offset >= consumed_to:
                        suppressible.add(key)
        if not tail_adds:
            return len(tail)
        # Last committed action per suppressible key (recovery-only scan).
        last_committed: dict[tuple, Action] = {}
        pos = 0
        while pos < cut and suppressible:
            for m in oq.read_from(pos, min(4096, cut - pos)):
                for order in orders_in(m):
                    key = (order.symbol, order.uuid, order.oid)
                    if key in suppressible:
                        last_committed[key] = order.action
                pos = m.offset + 1
        remark = [
            key
            for offset, key in tail_adds
            if not (
                offset >= consumed_to
                and last_committed.get(key) is Action.DEL
            )
        ]
        # One batched update: with a remote marker store this is a single
        # pipelined round trip instead of one HSET per queued ADD (a tail
        # of 256K-order frames would otherwise take minutes to re-mark).
        self.engine.pre_pool.update(remark)
        return len(tail)

    # -- observability -------------------------------------------------------
    def snapshot_age_seconds(self) -> float:
        """Seconds since the last snapshot; -1 before the first one."""
        if not self.last_snapshot_unix:
            return -1.0
        return max(0.0, time.time() - self.last_snapshot_unix)

    def export_metrics(self, registry=None) -> None:
        """Register the durability gauges (callback gauges: values are read
        from this Persister at scrape time; re-registering rebinds)."""
        if registry is None:
            from ..utils.metrics import REGISTRY as registry  # noqa: N811
        registry.callback_gauge(
            "gome_snapshot_age_seconds",
            "Seconds since the last snapshot (-1 before the first)",
            self.snapshot_age_seconds,
        )
        registry.callback_gauge(
            "gome_snapshot_bytes",
            "On-disk size of the last snapshot",
            lambda: float(self.last_snapshot_bytes),
        )
        registry.callback_gauge(
            "gome_snapshots_taken_total",
            "Snapshots taken by this process",
            lambda: float(self.snapshots_taken),
        )
        registry.callback_gauge(
            "gome_recovery_seconds",
            "Duration of the last restore_latest (restore + mark rebuild)",
            lambda: self.last_recovery_seconds,
        )
        registry.callback_gauge(
            "gome_wal_replay_frames",
            "Order-log messages rewound for replay by the last restore",
            lambda: float(self.wal_replay_frames),
        )

    def probe(self) -> dict:
        """TimelineSampler probe: snapshot cadence + recovery state."""
        return {
            "snapshots_taken": self.snapshots_taken,
            "snapshot_age_s": round(self.snapshot_age_seconds(), 3),
            "snapshot_bytes": self.last_snapshot_bytes,
            "last_restore": self.last_restore,
            "recovery_s": round(self.last_recovery_seconds, 6),
            "wal_replay_frames": self.wal_replay_frames,
        }
