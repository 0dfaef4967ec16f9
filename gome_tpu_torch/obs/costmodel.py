"""Analytic device cost model — bytes and integer operations per entry.

The port of ``gome_tpu/obs/costmodel.py``. The reference reads XLA's
``cost_analysis()`` and ``memory_analysis()`` off each compiled engine
entry. PyTorch compiles nothing ahead of a call, so here every number is
analytic or read off one real call of the entry:

  * ``argument_bytes`` / ``output_bytes`` — the leaf sums
    (``numel * element_size``) of the tensors the call takes and returns;
    ``bytes_accessed`` their sum (each input read once, each output
    written once).
  * ``flops`` — the integer-operation count, static in the shapes
    (:func:`k1_work`'s ``"static"`` mode: every op slot counted as K1's
    ADD path, as XLA's cost analysis charges every slot whatever its
    action). The canonical argument grids are all NOPs, so a count that
    followed the data would be 0 there.
  * ``temp_bytes`` — 0: no compiler plans the call's temporaries ahead of
    it. ``peak_hbm_bytes`` is ``argument + output - alias``, the
    reference's live-set bound, on every device: deterministic, as a
    ratchet needs. The caching allocator's peak is not read: its counters
    are process-wide, so in a live service they would report the
    consumer's memory, not the entry's.
  * ``alias_bytes`` — the output bytes that ARE an argument's storage.
    PyTorch has no buffer donation: the step entries build new tensors
    (0), only ``compact_accum`` appends into its buffers in place.
  * ``jaxpr_eqns`` — no jaxpr exists; it is the number of kernel and
    PyTorch op launches one call makes (K1 launches plus every non-view,
    non-allocating aten op dispatched). On the CPU that is the plain
    version's ops, on the card K1 and the PyTorch ops around it.
  * ``generated_code_bytes`` — None (nothing is generated per entry).

The entries are the reference's, at the reference's canonical geometry
(``analysis/envelope.py``: cap 8, K 4, S 2, T 4), on the port's
counterparts:

  ``batch_step``       ``engine/batch.py::full_grid_step`` (K1)
  ``dense_batch_step`` ``engine/batch.py::dense_grid_step`` (gather, K1,
                       scatter; lane ids int32 as the reference's — the
                       engine itself uploads int64 ids)
  ``lane_scan``        ``ops/match_step.py::batch_step`` on one row (the
                       engine's per-row re-run at K')
  ``compact_accum``    ``engine/frames.py::compact_accum`` (K2)
  ``scatter_grid``     ``engine/frames.py::_scatter_grid_fn`` (K3)

Reports are memoized per (dtype, device type): ``/cost``, the profiler
and ``bench_analytics`` share one set of calls per process.
"""

from __future__ import annotations

import math
import threading

#: Memoized per (dtype, device type) report.
_REPORT_CACHE: dict[tuple, list[dict]] = {}

#: The reference's canonical envelope geometry (cap, max_fills, S, T).
CANONICAL = (8, 4, 2, 4)

#: The entries the perf ratchet gates (the engine's hot-path graphs).
RATCHET_ENTRIES = (
    "batch_step", "dense_batch_step", "lane_scan", "compact_accum",
    "scatter_grid",
)

#: K1 launches made by entry calls (run_entry) on the card: a service
#: that checks its own launch count sets these apart.
ENTRY_K1_LAUNCHES = 0
_K1_LOCK = threading.Lock()

#: Aten ops that launch nothing: allocations and metadata.
_NO_LAUNCH = frozenset((
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::detach",
    "aten::alias", "aten::lift_fresh",
))


def _leaves(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)


def leaf_bytes(tree) -> int:
    """Summed ``numel * element_size`` of every tensor in a (nested)
    tuple; anything else (ints, configs) counts 0."""
    return sum(a.numel() * a.element_size() for a in _leaves(tree))


def k1_slot_operations(cap: int) -> float:
    """Integer operations of one ADD over a cap-slot side: a log-depth
    scan plus ~20 elementwise passes."""
    return cap * (math.log2(cap) + 20)


def k1_work(config, books, ops, mode: str = "data") -> tuple[int, float]:
    """(bytes, integer operations) of one K1 grid: ``ops`` [S, T] on
    ``books`` [S, 2, cap] with K = ``config.max_fills``.

    Bytes: each input read once, each output written once — the books in
    and out, the op grid, and the StepOutput leaves (7 record leaves
    [S, T, K] and 2 scalars [S, T] in the book dtype, 5 int32 scalars).

    Operations: ``"data"`` follows this grid's ops — an ADD a log-depth
    scan plus ~20 elementwise passes over cap slots, a DEL ~10, a NOP
    none (reads the action column: a host sync on the card);
    ``"static"`` counts every slot as an ADD, whatever the data."""
    if mode not in ("data", "static"):
        raise ValueError(f"k1_work mode must be 'data' or 'static', got {mode!r}")
    s, t = ops.action.shape
    cap, k = config.cap, config.max_fills
    item = books.price.element_size()
    out_bytes = s * t * (7 * k * item + 5 * 4 + 2 * item)
    nbytes = 2 * leaf_bytes(books) + leaf_bytes(ops) + out_bytes
    if mode == "static":
        return nbytes, s * t * k1_slot_operations(cap)
    n_add = int((ops.action == 1).sum())
    n_del = int((ops.action == 2).sum())
    return nbytes, n_add * k1_slot_operations(cap) + n_del * cap * 10


def compact_operations(r: int, t: int, k: int) -> float:
    """Integer operations of one compact_accum: per record slot a compare,
    a prefix-sum step (log-depth), a target index (3) and 7 field writes;
    per op slot the same for the 2 cancel fields."""
    n, m = r * t * k, r * t
    return n * (math.log2(n) + 11) + m * (math.log2(m) + 6)


def scatter_operations(n_rows: int, t_grid: int, m_pad: int) -> float:
    """Integer operations of one grid scatter: 7 field writes per packed
    op, 7 dtype conversions per grid cell."""
    return 7 * m_pad + 7 * n_rows * t_grid


def canonical_entries(dtype: str = "int32", device=None,
                      geometry: tuple = CANONICAL) -> list[dict]:
    """The entries at ``geometry`` (cap, max_fills, S, T) on ``device``
    (default: the CUDA card): records ``{"entry", "context", "fn",
    "args", "n_ops", "flops", "k1"}`` (``k1``: K1 launches per call on
    the card).
    ``args()`` builds a fresh argument tuple (compact_accum appends in
    place, so every call wants its own); the op grids are all NOPs."""
    import torch

    from ..engine import frames
    from ..engine.batch import dense_grid_step, full_grid_step
    from ..engine.book import (
        GRID_I32_FIELDS,
        OUT_I32_FIELDS,
        RECORD_FIELDS,
        BookConfig,
        DeviceOp,
        StepOutput,
        init_books,
        resolve_device,
        torch_dtype,
    )
    from ..ops import match_step

    device = resolve_device(device)
    cap, k, s, t = geometry
    dt = torch_dtype(dtype)
    cfg = BookConfig(cap=cap, max_fills=k, dtype=dt)
    wide = torch.promote_types(torch.int32, dt)

    def grid(rows):
        return DeviceOp(*(
            torch.zeros((rows, t), device=device,
                        dtype=torch.int32 if f in GRID_I32_FIELDS else dt)
            for f in DeviceOp._fields))

    def outs():
        return StepOutput(*(
            torch.zeros((s, t, k) if f in RECORD_FIELDS else (s, t),
                        device=device,
                        dtype=torch.int32 if f in OUT_I32_FIELDS else dt)
            for f in StepOutput._fields))

    m_pad = 64
    k1 = k1_slot_operations(cap)
    return [
        dict(entry="batch_step", context="engine/batch.py:full_grid_step",
             fn=lambda b, o: full_grid_step(cfg, b, o),
             args=lambda: (init_books(cfg, s, device), grid(s)),
             n_ops=s * t, flops=s * t * k1, k1=1),
        dict(entry="dense_batch_step",
             context="engine/batch.py:dense_grid_step",
             fn=lambda b, ids, o: dense_grid_step(cfg, b, ids, s, o),
             args=lambda: (init_books(cfg, s, device),
                           torch.arange(s, dtype=torch.int32, device=device),
                           grid(s)),
             n_ops=s * t, flops=s * t * k1, k1=1),
        dict(entry="lane_scan", context="ops/match_step.py:batch_step (one row)",
             fn=lambda b, o: match_step.batch_step(cfg, b, o),
             args=lambda: (init_books(cfg, 1, device), grid(1)),
             n_ops=t, flops=t * k1, k1=1),
        dict(entry="compact_accum", context="engine/frames.py:compact_accum",
             fn=lambda o, f, c, tt: frames.compact_accum(o, f, c, tt, 0),
             args=lambda: (
                 outs(),
                 torch.zeros((len(frames._FILL_FIELDS), m_pad + 1),
                             dtype=wide, device=device),
                 torch.zeros((len(frames._CANCEL_FIELDS), m_pad + 1),
                             dtype=wide, device=device),
                 torch.zeros((8, 4), dtype=torch.int32, device=device)),
             n_ops=s * t, flops=compact_operations(s, t, k), k1=0),
        dict(entry="scatter_grid", context="engine/frames.py:_scatter_grid_fn",
             fn=lambda c, f: frames._scatter_grid_fn(c, f, s, t),
             args=lambda: (
                 torch.zeros((len(DeviceOp._fields), m_pad), dtype=dt,
                             device=device),
                 torch.full((m_pad,), s * t, dtype=torch.int64,
                            device=device)),
             n_ops=m_pad, flops=scatter_operations(s, t, m_pad), k1=0),
    ]


def _launch_counter():
    """A dispatch mode counting the aten ops that launch work (views,
    allocations and metadata ops left out)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func.name().split(".")[0] not in _NO_LAUNCH:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    return Count()


def warm() -> None:
    """Pay the launch counter's one-time cost now. PyTorch imports
    ``torch._dynamo`` (some 840 modules) at a TorchDispatchMode's first
    dispatch; made by the first ``/cost`` on the ops handler's thread of
    a serving process, that import stalls the read and the service
    around it (``chip_smoke.py`` phase 14 (a)). ``EngineService`` calls
    this when it arms ``cost``, before it serves."""
    import torch

    with _launch_counter():
        torch.zeros(1)


def run_entry(rec: dict, args):
    """One call of an entry record on ``args``, its K1 launches counted
    into ENTRY_K1_LAUNCHES on the card."""
    global ENTRY_K1_LAUNCHES
    out = rec["fn"](*args)
    if rec["k1"] and next(_leaves(args)).device.type == "cuda":
        with _K1_LOCK:
            ENTRY_K1_LAUNCHES += rec["k1"]
    return out


def call_stats(rec: dict, args) -> dict:
    """``compiled_stats``'s row keys (and ``jaxpr_eqns``) for one call of
    an entry record on ``args`` (see the module docstring for what each
    means here)."""
    arg_b = leaf_bytes(args)
    cuda = next(_leaves(args)).device.type == "cuda"
    counter = _launch_counter()
    with counter:
        out = run_entry(rec, args)
    launches = counter.n + (rec["k1"] if cuda else 0)
    out_b = leaf_bytes(out)
    arg_ptrs = {a.untyped_storage().data_ptr() for a in _leaves(args)}
    alias = sum(a.numel() * a.element_size() for a in _leaves(out)
                if a.untyped_storage().data_ptr() in arg_ptrs)
    nbytes = arg_b + out_b
    flops = rec["flops"]
    return {
        "flops": float(flops),
        "bytes_accessed": float(nbytes),
        "arithmetic_intensity": float(flops) / nbytes if flops and nbytes
        else None,
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": 0,
        "alias_bytes": alias,
        "generated_code_bytes": None,
        "peak_hbm_bytes": arg_b + out_b - alias,
        "jaxpr_eqns": launches,
    }


def _device_key(device) -> str:
    from ..engine.book import resolve_device

    return str(resolve_device(device))


def entry_report(dtype: str = "int32", device=None) -> list[dict]:
    """One attribution row per entry at the canonical geometry, on
    ``device`` (default: the CUDA card). Memoized per (dtype, device)."""
    key = (dtype, _device_key(device))
    if key in _REPORT_CACHE:
        return _REPORT_CACHE[key]
    rows = []
    for rec in canonical_entries(dtype, key[1]):
        try:
            stats = call_stats(rec, rec["args"]())
        except Exception as exc:  # a device that cannot run the entry
            rows.append({"entry": rec["entry"], "context": rec["context"],
                         "error": f"{type(exc).__name__}: {exc}"})
            continue
        n_ops = rec["n_ops"]
        stats.update(
            entry=rec["entry"],
            context=rec["context"],
            n_ops=n_ops,
            flops_per_order=stats["flops"] / n_ops,
            bytes_per_order=stats["bytes_accessed"] / n_ops,
        )
        rows.append(stats)
    _REPORT_CACHE[key] = rows
    return rows


#: Donation-report geometry: the reference's (cap = the engine's smallest
#: cap class, S 8, T 32).
_DONATION_GEOMETRY = (64, 8, 32)  # (cap, S, T)

_DONATION_CACHE: dict[tuple, list[dict]] = {}


def donation_report(dtype: str = "int32", device=None) -> list[dict]:
    """The reference's donation rows for batch_step, dense_batch_step and
    lane_scan at ``_DONATION_GEOMETRY``. PyTorch has no buffer donation
    and the port no ``_donating`` twins: the "donating" columns describe
    the same entry, nothing is saved (``peak_hbm_saved_bytes`` 0) and
    ``donation_effective`` is False. The peaks are each entry's own
    (call_stats)."""
    key = (dtype, _device_key(device))
    if key in _DONATION_CACHE:
        return _DONATION_CACHE[key]
    cap, s, t = _DONATION_GEOMETRY
    recs = canonical_entries(dtype, key[1], geometry=(cap, 4, s, t))
    out = []
    for rec in recs:
        if rec["entry"] not in ("batch_step", "dense_batch_step", "lane_scan"):
            continue
        try:
            st = call_stats(rec, rec["args"]())
        except Exception as exc:
            out.append({"entry": rec["entry"],
                        "error": f"{type(exc).__name__}: {exc}"})
            continue
        out.append({
            "entry": rec["entry"],
            "geometry": {"cap": cap, "s": s, "t": t},
            "public_peak_hbm_bytes": st["peak_hbm_bytes"],
            "donating_peak_hbm_bytes": st["peak_hbm_bytes"],
            "peak_hbm_saved_bytes": 0,
            "donating_alias_bytes": st["alias_bytes"],
            "donation_effective": False,
        })
    _DONATION_CACHE[key] = out
    return out


def ratchet_metrics(dtype: str = "int32", device=None) -> dict:
    """Flat {metric: value} of the ratchet entries — lower is better for
    every metric."""
    out: dict[str, float] = {}
    for r in entry_report(dtype, device):
        if "error" in r or r["entry"] not in RATCHET_ENTRIES:
            continue
        name = r["entry"]
        out[f"{name}.flops_per_order"] = round(r["flops_per_order"], 3)
        out[f"{name}.bytes_per_order"] = round(r["bytes_per_order"], 3)
        out[f"{name}.peak_hbm_bytes"] = int(r["peak_hbm_bytes"])
    return out


def bench_analytics(dtype: str = "int32", device=None) -> dict:
    """The compact analytic block a benchmark folds into its JSON payload:
    per-entry flops/order, bytes/order, intensity, peak bytes, and the
    donation savings (0: no donation in PyTorch)."""
    entries = {}
    for r in entry_report(dtype, device):
        if "error" in r or r["entry"] not in RATCHET_ENTRIES:
            continue
        entries[r["entry"]] = {
            "flops_per_order": r.get("flops_per_order"),
            "bytes_per_order": r.get("bytes_per_order"),
            "arithmetic_intensity": r.get("arithmetic_intensity"),
            "peak_hbm_bytes": r.get("peak_hbm_bytes"),
        }
    return {
        "dtype": dtype,
        "entries": entries,
        "donation": {
            d["entry"]: d.get("peak_hbm_saved_bytes")
            for d in donation_report(dtype, device)
        },
    }


def clear_cache() -> None:
    """Drop the memoized reports."""
    _REPORT_CACHE.clear()
    _DONATION_CACHE.clear()
