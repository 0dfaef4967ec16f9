"""Live-buffer accounting — the caching allocator's residency per card,
tagged subsystem trees, and a steady-state leak detector.

The port of ``gome_tpu/obs/live.py``, rewritten for PyTorch. The
reference enumerates ``jax.live_arrays()``; PyTorch keeps no such list,
but every CUDA tensor lives in its card's caching allocator, whose
counters (``torch.cuda.memory_stats``) are exact and cost no walk:

  * :func:`live_array_stats` — process-wide count/bytes. On the card:
    the allocator's current allocated and active bytes and block counts,
    per initialized card (never a ``gc`` walk of tensors). Off the card
    (the CPU engine): the tensor totals of the trees registered with a
    live :class:`LiveBufferMonitor`, under the same keys;
  * :func:`pytree_stats` — count/bytes of one subsystem's tree (the
    engine's book stack, ...): ``nbytes`` summed over its tensors, which
    equals the reference's byte count for the same ``BookConfig`` (same
    shapes, same dtypes);
  * :class:`LiveBufferMonitor` — named subsystems exported as
    ``gome_hbm_resident_bytes{subsystem=...}`` callback gauges plus the
    process totals (``gome_live_arrays`` / ``gome_live_array_bytes``) —
    scrape-time reads, nothing on the hot path;
  * :func:`leak_report` / :func:`assert_steady_state` — the leak
    detector: at steady state an engine step must not grow the live
    buffer count (escalations and first-seen shapes allocate, so the
    caller settles those first).
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import torch

#: Monitors whose trees count as the CPU's residency (the allocator's
#: counters cover the cards). Weak: a monitor lives as long as its owner
#: (an OpsServer), never longer because of this set.
_MONITORS: "weakref.WeakSet[LiveBufferMonitor]" = weakref.WeakSet()


def _leaves(tree):
    """Array leaves of a tree: tensors and numpy arrays inside tuples
    (NamedTuples included), lists, dicts, and mesh ``Sharded`` blocks."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "blocks"):  # parallel.mesh.Sharded
        yield from _leaves(tree.blocks)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def _card_stats() -> dict:
    """The caching allocator's counters of every card this process has
    initialized (a process that never touched CUDA initializes none)."""
    out = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "allocated_bytes": int(s.get("allocated_bytes.all.current", 0)),
            "active_bytes": int(s.get("active_bytes.all.current", 0)),
            "allocated_count": int(s.get("allocation.all.current", 0)),
            "active_count": int(s.get("active.all.current", 0)),
        }
    return out


def _cpu_stats() -> dict | None:
    """Tensor totals of the registered trees that live off the card."""
    n = total = 0
    for mon in list(_MONITORS):
        for fn in list(mon._sections.values()):
            try:
                tree = fn()
            except Exception:  # a dead subsystem must not break a scrape
                continue
            for leaf in _leaves(tree):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    continue  # counted by its card's allocator
                n += 1
                total += _nbytes(leaf)
    if not n:
        return None
    return {"allocated_bytes": total, "active_bytes": total,
            "allocated_count": n, "active_count": n}


def live_array_stats(collect: bool = True) -> dict:
    """Process-wide live buffer count and bytes: {"count", "bytes",
    "devices": {"cuda:0": {...}, "cpu": {...}}}. ``count``/``bytes`` are
    the allocated blocks and bytes summed over the devices; each device's
    entry carries allocated and active bytes and counts. ``collect`` runs
    the gc first so reference cycles holding dead tensors do not read as
    residency."""
    if collect:
        gc.collect()
    devices = _card_stats()
    cpu = _cpu_stats()
    if cpu is not None:
        devices["cpu"] = cpu
    return {
        "count": sum(d["allocated_count"] for d in devices.values()),
        "bytes": sum(d["allocated_bytes"] for d in devices.values()),
        "devices": devices,
    }


def pytree_stats(tree) -> dict:
    """Count/bytes over one tree's array leaves (host numpy leaves count
    too — a restored-but-not-yet-placed subsystem is still residency
    somewhere)."""
    n = 0
    total = 0
    for leaf in _leaves(tree):
        n += 1
        total += _nbytes(leaf)
    return {"count": n, "bytes": total}


class LiveBufferMonitor:
    """Named subsystems -> live-buffer gauges.

    ``register(name, fn)`` stores a zero-arg callable returning the
    subsystem's current tree (called at snapshot/scrape time — the
    engine swaps its book stack on every step, so the monitor must not
    hold a reference). ``export(registry)`` wires scrape-time callback
    gauges; ``snapshot()`` is the JSON form."""

    def __init__(self):
        self._sections: dict[str, object] = {}
        _MONITORS.add(self)

    def register(self, name: str, fn) -> "LiveBufferMonitor":
        self._sections[name] = fn
        return self

    def snapshot(self) -> dict:
        out = {"total": live_array_stats()}
        subsystems = {}
        for name, fn in self._sections.items():
            try:
                subsystems[name] = pytree_stats(fn())
            except Exception as exc:  # a dead subsystem must not 500
                subsystems[name] = {"error": str(exc)}
        out["subsystems"] = subsystems
        return out

    def export(self, registry=None) -> None:
        """Register scrape-time gauges: per-subsystem
        ``gome_hbm_resident_bytes{subsystem=...}`` plus process totals."""
        from ..utils.metrics import REGISTRY

        registry = registry or REGISTRY
        registry.callback_gauge(
            "gome_live_arrays",
            "process-wide live device-buffer count (caching allocator)",
            lambda: live_array_stats(collect=False)["count"],
        )
        registry.callback_gauge(
            "gome_live_array_bytes",
            "process-wide live device-buffer bytes (caching allocator)",
            lambda: live_array_stats(collect=False)["bytes"],
        )
        for name, fn in self._sections.items():
            registry.callback_gauge(
                "gome_hbm_resident_bytes",
                "per-subsystem device-resident bytes",
                (lambda f: lambda: pytree_stats(f())["bytes"])(fn),
                labels={"subsystem": name},
            )


def service_monitor(service) -> LiveBufferMonitor:
    """The standard subsystem tagging for one EngineService/MatchEngine:
    the device book stack (the dominant steady-state residency) — reads
    go through the closure so engine growth/restore is always reflected."""
    mon = LiveBufferMonitor()
    engine = getattr(service, "engine", service)
    batch = getattr(engine, "batch", engine)
    mon.register("engine_books", lambda: batch.books)
    return mon


# -- leak detection --------------------------------------------------------


def leak_report(step_fn, steps: int = 8, settle: int = 2) -> dict:
    """Run ``step_fn`` ``settle`` times (escalations, first-seen shapes,
    and allocator warm-up allocate legitimately), snapshot the live-buffer
    count, then run ``steps`` more and record the count after each. A
    steady-state engine loop must come back to the baseline every step —
    monotonic growth is a leaked buffer (a retained checkpoint, an
    accumulator that outlived its frame, a cache without a bound).

    Returns {"baseline", "counts", "leaked"}: ``leaked`` = final count
    minus baseline (<= 0 means flat)."""
    for _ in range(settle):
        step_fn()
    baseline = live_array_stats()["count"]
    counts = []
    for _ in range(steps):
        step_fn()
        counts.append(live_array_stats()["count"])
    return {
        "baseline": baseline,
        "counts": counts,
        "leaked": (counts[-1] - baseline) if counts else 0,
    }


def assert_steady_state(
    step_fn, steps: int = 8, settle: int = 2, tolerance: int = 0
) -> dict:
    """leak_report + assertion: raises AssertionError when the loop leaks
    more than ``tolerance`` buffers end to end. Returns the report."""
    report = leak_report(step_fn, steps=steps, settle=settle)
    if report["leaked"] > tolerance:
        raise AssertionError(
            f"live device buffers grew by {report['leaked']} over "
            f"{steps} steady-state steps (baseline {report['baseline']}, "
            f"trajectory {report['counts']}) — leaked buffer(s)"
        )
    return report
