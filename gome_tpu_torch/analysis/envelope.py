"""GL2xx int32-envelope: a dtype audit of the port's device entries.

The port of ``gome_tpu/analysis/envelope.py``. The matching core's
exactness argument is an *integer* argument: every device value is a
scaled tick/lot integer, depth prefix sums saturate below 2^31
(``engine/step.py`` SAT32_MAX), and nothing passes through floating
point. PyTorch promotes more readily than JAX with x64 off: ``sum`` and
``cumsum`` of int32 return int64, a Python float operand turns an integer
tensor into float32, and a ``.to(torch.int64)`` slips in anywhere. An
int32 book widened to int64 doubles its bytes on the card (the dtype knob
exists to halve them); a lot that goes through float32 is silently
inexact. The reference audits every equation of its jaxprs; the port has
no jaxpr, so :func:`record_call` runs each entry once under a
``TorchDispatchMode`` that records every aten op the entry dispatches
(:class:`OpRecord`: the op, its outputs' dtypes and shapes, the
``gome_tpu_torch`` source line that issued it, and whether each output is
a tainted value), and :func:`check_values` audits the records:

  GL201  float64 anywhere in an entry, float-tolerant or not
  GL202  any float dtype in an entry of the integer matching envelope
  GL203  a tainted integer (a value, below) wider than the declared book
         dtype, e.g. an int64 price in an int32-book engine

A Python float passed as an operand is not a tensor and is no finding;
the float tensor it produces is.

**Values and indexes (GL203's taint).** In PyTorch every index is int64:
``arange``, gather and scatter indices, ``max(dim)`` indices,
``searchsorted``, ``nonzero``, the sum of a bool mask. The reference's
rule (any integer wider than the book dtype) would flag each. GL203
therefore reads a taint that follows the book's values instead:

  * seeds: the value leaves of ``BookState`` (price, lots, seq, oid,
    uid), the value fields of ``DeviceOp`` (price, volume, oid, uid), the
    ``StepOutput`` fields that carry prices, lots or ids (the seven
    record leaves, taker_remaining, cancel_volume), and the packed op
    columns the grid scatter takes;
  * an op's non-bool outputs are tainted when any tensor input is; the
    index outputs (``max``/``sort``/``topk`` indices, ``argmax``,
    ``argsort``, ``searchsorted``, ``nonzero``) never are;
  * an in-place write (``index_put_``, ``copy_``, ``scatter_``, ``out=``)
    taints its destination; a view shares its base's taint (the taint
    lives on the storage).

So ``price.to(torch.int64)`` and ``lots.sum()`` of int32 lots are GL203,
while ``(lots > 0).sum()`` (a count: a bool sum) and
``price[torch.arange(n)]``'s index are not.

**The hand kernels are audited at their boundary.** On the card K1
(``ops/match_step.py::batch_step``) and K5
(``ops/hawkes_scan.py::hawkes_scan``) are opaque ``ctypes`` launches: no
aten op runs inside them, and the tensors they read and write in device
memory are their arguments and results. The recorder therefore records
each wrapper call's tensor arguments and results (``kernel input`` /
``kernel output``: book leaves and fill records at the declared dtype,
the int32 fields int32, K5's float32) and does not descend into the
wrapper. On the CPU the wrapper runs the plain version, whose body is the
tests' oracle, never the card's path; its int64 prefix sums are exact by
the argument at ``engine/step.py`` SAT32_MAX, and the kernel's own
``long long`` sums live in registers, not in device memory
(``ops/csrc/match_step.cu``). Recording the same boundary on both devices
makes the CPU audit and the card audit see one op set. (The reference
recurses into the Pallas kernel's jaxpr because on the TPU that jaxpr is
the kernel.)

Driven by the CLI (``python -m gome_tpu_torch.analysis gome_tpu_torch
--traced``) and tests through :func:`check_engine_envelope`, which runs
the cost model's entries (``obs/costmodel.canonical_entries``: the full
and dense grid steps, one row through K1, the frame-compaction
accumulator, the grid scatter) at its canonical geometry on op
grids with live orders in every row, and the simulator's ``gen_ops``
(float-tolerant: the Hawkes intensities are float32 by design). Imports
torch lazily: the AST families do not pay for it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import sysconfig
import weakref
from typing import NamedTuple

from .core import Finding, register_rules

register_rules({
    "GL201": "float64 value in an engine jaxpr (x64 creep)",
    "GL202": "float value inside the integer matching envelope",
    "GL203": "integer wider than the declared book dtype in the jaxpr",
})

#: dtype names always allowed regardless of declared width: predicates
#: and sub-word index/code types.
_ALWAYS_OK = {"bool", "int8", "uint8", "int16", "uint16"}

_INT_WIDTH = {"int8": 8, "uint8": 8, "int16": 16, "uint16": 16,
              "int32": 32, "uint32": 32, "int64": 64, "uint64": 64}

#: Ops whose every output is an index (never a value).
_INDEX_OPS = frozenset((
    "argmax", "argmin", "argsort", "searchsorted", "bucketize", "nonzero",
    "nonzero_static", "argwhere",
))

#: Value leaves of the engine's trees (the taint's seeds).
BOOK_VALUES = ("price", "lots", "seq", "oid", "uid")
OP_VALUES = ("price", "volume", "oid", "uid")
OUT_VALUES = ("fill_price", "fill_qty", "maker_oid", "maker_uid",
              "maker_prefill", "maker_remaining", "taker_after",
              "taker_remaining", "cancel_volume")

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PACKAGE)
_SELF = os.path.abspath(__file__)


class OpRecord(NamedTuple):
    """One recorded op (or one kernel boundary, or one entry argument):
    per tensor output its dtype name, shape and taint."""

    op: str  # aten op name ("aten::sum"), "kernel:<name>" or "input"
    path: str  # repo-relative source file, or "<entry:context>"
    line: int
    where: str  # "value", "constant", "input", "kernel input/output"
    dtypes: tuple
    shapes: tuple
    tainted: tuple


def _rel(fname: str) -> str:
    return (os.path.relpath(fname, _ROOT)
            if fname.startswith(_ROOT + os.sep) else fname)


def _src_line() -> tuple[str, int]:
    """``(path, line)`` of the op being dispatched: the innermost frame
    inside ``gome_tpu_torch`` (this module excluded), else the innermost
    frame outside torch, the standard library and site-packages (a test's
    fixture)."""
    fallback = None
    frame = sys._getframe(1)
    while frame is not None:
        fname = frame.f_code.co_filename
        if fname != _SELF:
            if fname.startswith(_PACKAGE + os.sep):
                return _rel(fname), frame.f_lineno
            if fallback is None and not fname.startswith("<") \
                    and not fname.startswith(_library()):
                fallback = (_rel(fname), frame.f_lineno)
        frame = frame.f_back
    return fallback or ("<unknown>", 0)


@functools.cache
def _library() -> tuple:
    """Path prefixes of library code: the standard library,
    site-packages and torch's own directory, wherever it is installed."""
    import torch

    paths = {sysconfig.get_paths()[k] for k in ("stdlib", "purelib",
                                                 "platlib")}
    return tuple(p + os.sep for p in paths | {os.path.dirname(torch.__file__)})


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _at(t) -> tuple:
    """A tensor's storage: its device and address (views share it)."""
    return str(t.device), t.untyped_storage().data_ptr()


class _Taint:
    """Each storage's taint (views share their base's storage). A storage
    is keyed by its device and address and held by a weak reference to
    its Python object, so an address the allocator hands out again after
    a free reads as unseen, not as the freed storage's taint."""

    def __init__(self):
        self._by: dict[tuple, tuple] = {}

    @staticmethod
    def _ref(t):
        try:
            return _at(t), weakref.ref(t.untyped_storage())
        except TypeError:  # a storage object without weak references
            return _at(t), None

    def get(self, t) -> bool | None:
        """The storage's taint, or None when the recorder has not seen it."""
        key, ref = self._ref(t)
        hit = self._by.get(key)
        if hit is None or (hit[0] is not None and hit[0]() is not ref()):
            return None
        return hit[1]

    def set(self, t, tainted: bool) -> None:
        key, ref = self._ref(t)
        self._by[key] = (ref, tainted)

    def mark(self, t, tainted: bool) -> None:
        """Taint the storage (a write into it), never clear it."""
        self.set(t, bool(self.get(t)) or tainted)


class _Recorder:
    """The recording state of one entry call: the records, the storages'
    taint and the pause depth (a kernel wrapper's body is not recorded).
    ``mode()`` builds the TorchDispatchMode that feeds it."""

    def __init__(self):
        self.records: list[OpRecord] = []
        self.taint = _Taint()
        self.paused = 0

    def add(self, op, path, line, where, tensors, flags) -> None:
        self.records.append(OpRecord(
            op, path, line, where, tuple(_dtype_name(t) for t in tensors),
            tuple(tuple(t.shape) for t in tensors), tuple(flags)))

    def note(self, func, args, kwargs, out) -> None:
        import torch
        from torch.utils._pytree import tree_leaves

        path, line = _src_line()
        name = func.name()
        dirty = False
        for a in tree_leaves((args, kwargs)):
            if not isinstance(a, torch.Tensor):
                continue
            seen = self.taint.get(a)
            if seen is None:  # made outside the entry: a constant
                self.taint.set(a, False)
                self.add(name, path, line, "constant", [a], [False])
            dirty = dirty or bool(seen)
        schema = func._schema
        written = []
        for i, x in enumerate(schema.arguments):
            if x.alias_info is not None and x.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(x.name)
                written.extend(a for a in tree_leaves(v)
                               if isinstance(a, torch.Tensor))
        index_op = name.split("::")[-1].split(".")[0] in _INDEX_OPS
        returns = [r.name for r in schema.returns]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        flags = []
        for i, o in enumerate(outs):
            if func.is_view:
                t = bool(self.taint.get(o))
            else:
                t = (dirty and o.dtype != torch.bool and not index_op
                     and (returns[i] if i < len(returns) else "")
                     != "indices")
                if any(_at(o) == _at(w) for w in written):
                    t = t or bool(self.taint.get(o))
                self.taint.set(o, t)
            flags.append(t)
        for w in written:  # a write taints its destination
            self.taint.mark(w, dirty)
        if outs:
            self.add(name, path, line, "value", outs, flags)

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class Record(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if not rec.paused:
                    rec.note(func, args, kwargs, out)
                return out

        return Record()

    def kernel(self, name, fn, seeds_in, seeds_out):
        """``fn`` (a kernel wrapper) recorded at its boundary:
        ``seeds_in(args)`` / ``seeds_out(args, out)`` give each tensor
        argument / result with its taint (None: the storage's taint, or
        any argument's)."""

        def call(*args):
            path, line = _src_line()
            ins = seeds_in(args)
            flags = [bool(self.taint.get(t)) if f is None else f
                     for t, f in ins]
            for (t, _), f in zip(ins, flags):
                self.taint.mark(t, f)
            self.add(f"kernel:{name}", path, line, "kernel input",
                     [t for t, _ in ins], flags)
            self.paused += 1
            try:
                out = fn(*args)
            finally:
                self.paused -= 1
            outs = seeds_out(args, out)
            oflags = [any(flags) and _dtype_name(t) != "bool"
                      if f is None else f for t, f in outs]
            for (t, _), f in zip(outs, oflags):
                self.taint.set(t, f)
            self.add(f"kernel:{name}", path, line, "kernel output",
                     [t for t, _ in outs], oflags)
            return out

        return call


def _k1_in(args):
    _, books, ops = args
    return ([(getattr(books, f), f in BOOK_VALUES) for f in books._fields]
            + [(getattr(ops, f), f in OP_VALUES) for f in ops._fields])


def _k1_out(args, out):
    books, outs = out
    return ([(getattr(books, f), f in BOOK_VALUES) for f in books._fields]
            + [(getattr(outs, f), f in OUT_VALUES) for f in outs._fields])


def _k5_in(args):
    return [(t, None) for t in args[1:]]


def _k5_out(args, out):
    return [(t, None) for t in out]


@contextlib.contextmanager
def _kernel_boundaries(rec: _Recorder):
    """K1's and K5's wrappers replaced, for the block, by calls recorded
    at their boundary (``_Recorder.kernel``); the module attributes the
    engine and the simulator call through are restored after."""
    from ..ops import hawkes_scan, match_step

    places = ((match_step, "batch_step", "match_step", _k1_in, _k1_out),
              (hawkes_scan, "hawkes_scan", "hawkes_scan", _k5_in, _k5_out))
    saved = [getattr(mod, attr) for mod, attr, *_ in places]
    for (mod, attr, name, sin, sout), fn in zip(places, saved):
        setattr(mod, attr, rec.kernel(name, fn, sin, sout))
    try:
        yield
    finally:
        for (mod, attr, *_), fn in zip(places, saved):
            setattr(mod, attr, fn)


def value_leaves(tree) -> list:
    """The taint's seeds in one argument: the value leaves of a
    BookState, DeviceOp or StepOutput, none of anything else."""
    fields = set(getattr(tree, "_fields", ()))
    for values in (BOOK_VALUES, OP_VALUES, OUT_VALUES):
        if fields and set(values) <= fields:
            return [getattr(tree, f) for f in values]
    return []


def record_call(fn, args, seeds=(), context: str = "fixture"):
    """Call ``fn(*args)`` once under the recorder; returns
    ``(result, records)``. Every tensor of ``args`` is an entry input,
    tainted when it is (a view of) one of ``seeds``; K1 and K5 are
    recorded at their boundary."""
    import torch
    from torch.utils._pytree import tree_leaves

    rec = _Recorder()
    seeded = {_at(t) for t in seeds}
    inputs = [a for a in tree_leaves(args) if isinstance(a, torch.Tensor)]
    for a in inputs:
        tainted = _at(a) in seeded
        rec.taint.mark(a, tainted)
        rec.add("input", f"<entry:{context}>", 0, "input", [a], [tainted])
    with _kernel_boundaries(rec), rec.mode():
        out = fn(*args)
    return out, rec.records


def check_values(records, declared_dtype: str, context: str,
                 allow_floats: bool = False) -> list[Finding]:
    """Audit one entry's op records against the declared integer
    envelope. ``declared_dtype`` is the book dtype name ("int32" /
    "int64"). One finding per (dtype, path, line, where)."""
    findings: list[Finding] = []
    width = _INT_WIDTH[declared_dtype]
    seen: set[tuple] = set()
    for r in records:
        prim = f" [{r.op}]"
        for name, tainted in zip(r.dtypes, r.tainted):
            key = (name, r.path, r.line, r.where)
            if key in seen:
                continue
            if name == "float64":
                seen.add(key)
                findings.append(Finding(
                    "GL201", r.path, r.line, 0,
                    f"float64 {r.where} in {context}{prim}: x64 creep — "
                    "every engine value is an exact scaled integer",
                ))
            elif name.startswith(("float", "complex", "bfloat")):
                if not allow_floats:
                    seen.add(key)
                    findings.append(Finding(
                        "GL202", r.path, r.line, 0,
                        f"{name} {r.where} in {context}{prim}: the matching "
                        "envelope is integer-only (inexact lots otherwise)",
                    ))
            elif (tainted and _INT_WIDTH.get(name, 0) > width
                  and name not in _ALWAYS_OK):
                seen.add(key)
                findings.append(Finding(
                    "GL203", r.path, r.line, 0,
                    f"{name} {r.where} in {context}{prim}: wider than the "
                    f"declared {declared_dtype} book dtype (silent promotion "
                    "— 2x HBM traffic and a broken saturation argument)",
                ))
    return findings


#: Per (dtype, device) memo of the recorded entries: the CLI, the tests
#: and chip_smoke.py's phase 19 pay for one run of each entry.
_TRACE_CACHE: dict[tuple[str, str], list[dict]] = {}


def traced_entries(dtype: str = "int32", device=None) -> list[dict]:
    """Run the engine's device entries once per (dtype, device) under the
    recorder (``device``: the CUDA card by default); records ``{"entry",
    "context", "records", "n_ops", "allow_floats"}`` (``n_ops``: the
    orders one call applies)."""
    from ..engine.book import resolve_device

    key = (dtype, str(resolve_device(device)))
    if key not in _TRACE_CACHE:
        _TRACE_CACHE[key] = list(_entry_records(dtype, key[1]))
    return _TRACE_CACHE[key]


#: The live grids' ops, per row r: (action, side, is_market, price,
#: volume, oid, uid). The setup grid rests two asks and two bids; the
#: audited grid then rests a bid, crosses it partially (the remainder
#: rests), sweeps the asks with a market order and cancels: a hit in row
#: 0, a miss in row 1.
_SETUP = lambda r: [(1, 1, 0, 100, 5, 1 + 10 * r, 1),
                    (1, 1, 0, 101, 5, 2 + 10 * r, 2),
                    (1, 0, 0, 98, 5, 3 + 10 * r, 3),
                    (1, 0, 0, 97, 5, 4 + 10 * r, 4)]
_LIVE = lambda r: [(1, 0, 0, 99, 3, 5 + 10 * r, 5),
                   (1, 1, 0, 99, 4, 6 + 10 * r, 6),
                   (1, 0, 1, 0, 8, 7 + 10 * r, 7),
                   (2, 0, 0, 97, 0, 4, 4) if r == 0
                   else (2, 1, 0, 100, 0, 999, 9)]


def live_grids(config, s: int, t: int, device):
    """Books holding resting orders on both sides of every row, and an
    [s, t] grid of live orders on them (``_SETUP`` / ``_LIVE``, the first
    t columns; rows past the second repeat the second's orders). The
    books are made by the plain version, so no kernel launches."""
    import torch

    from ..engine.book import GRID_I32_FIELDS, DeviceOp, init_books
    from ..ops.match_step import batch_step_reference

    def grid(rows):
        cells = [rows(min(r, 1))[:t] for r in range(s)]
        return DeviceOp(*(
            torch.tensor([[c[i] for c in row] for row in cells],
                         dtype=torch.int32 if f in GRID_I32_FIELDS
                         else config.dtype, device=device)
            for i, f in enumerate(DeviceOp._fields)))

    books, _ = batch_step_reference(
        config, init_books(config, s, device), grid(_SETUP))
    return books, grid(_LIVE)


def _entry_records(dtype: str, device: str):
    import torch

    from ..engine import frames
    from ..engine.book import BookConfig, BookState, DeviceOp, torch_dtype
    from ..obs import costmodel
    from ..ops.match_step import batch_step_reference
    from ..sim.flow import FlowConfig, flow_init, gen_ops

    cap, k, s, t = costmodel.CANONICAL
    dt = torch_dtype(dtype)
    config = BookConfig(cap=cap, max_fills=k, dtype=dt)
    books, grid = live_grids(config, s, t, device)
    _, outs = batch_step_reference(config, books, grid)
    wide = torch.promote_types(torch.int32, dt)
    m_pad = 64
    # The grid scatter's packed columns: the live grid's ops at flat
    # positions 0..s*t-1, the padding at the sentinel s*t.
    cols = torch.zeros((len(DeviceOp._fields), m_pad), dtype=dt,
                       device=device)
    cols[:, :s * t] = torch.stack([f.reshape(-1).to(dt) for f in grid])
    flat = torch.full((m_pad,), s * t, dtype=torch.int64, device=device)
    flat[:s * t] = torch.arange(s * t, device=device)
    seeds = [*value_leaves(books), *value_leaves(grid)]
    # Each entry's arguments and the taint's seeds among them.
    calls = dict(
        batch_step=lambda: ((books, grid), seeds),
        dense_batch_step=lambda: (
            (books, torch.arange(s, dtype=torch.int32, device=device),
             grid), seeds),
        lane_scan=lambda: ((BookState(*(a[:1] for a in books)),
                            DeviceOp(*(f[:1] for f in grid))), seeds),
        compact_accum=lambda: ((
            outs,
            torch.zeros((len(frames._FILL_FIELDS), m_pad + 1), dtype=wide,
                        device=device),
            torch.zeros((len(frames._CANCEL_FIELDS), m_pad + 1), dtype=wide,
                        device=device),
            torch.zeros((8, 4), dtype=torch.int32, device=device)),
            value_leaves(outs)),
        scatter_grid=lambda: ((cols, flat), [cols]),
    )
    for rec in costmodel.canonical_entries(dtype, device):
        args, tainted = calls[rec["entry"]]()
        _, records = record_call(rec["fn"], args, tainted, rec["context"])
        yield dict(entry=rec["entry"], context=rec["context"],
                   records=records, n_ops=rec["n_ops"], allow_floats=False)

    # The simulator's flow generator: the grid it emits must honour the
    # engine's envelope. Hawkes intensities are float32 by design (the
    # stochastic model, never book state), so GL202 is waived here; GL201
    # and GL203 still audit it.
    fcfg = FlowConfig(n_lanes=s, t_bins=t)
    fstate = flow_init(fcfg, 0, device)
    _, records = record_call(lambda st, b: gen_ops(fcfg, st, b),
                             (fstate, books), value_leaves(books),
                             "sim/flow.py:gen_ops")
    yield dict(entry="gen_ops", context="sim/flow.py:gen_ops",
               records=records, n_ops=t, allow_floats=True)


def check_engine_envelope(dtype: str = "int32", device=None) -> list[Finding]:
    """The whole-engine envelope audit the CLI and CI run."""
    findings: list[Finding] = []
    for rec in traced_entries(dtype, device):
        findings.extend(check_values(
            rec["records"], dtype, rec["context"],
            allow_floats=rec["allow_floats"],
        ))
    return findings
