"""GL5xx transfer-hygiene: host↔device syncs on annotated hot paths.

The port of ``gome_tpu/analysis/transfers.py``, rewritten on PyTorch's
syncs. The engine's throughput story is the reference's: book state
lives on the card; the host ships one batched grid down and one batched
fetch up per frame. A single ``.item()`` on a per-order value, an
implicit ``bool()`` on a CUDA tensor in a conditional, or a
``torch.as_tensor(..., device=)`` inside the packing loop silently
reintroduces the per-order round trip the whole design deletes.

These rules run on the host functions reachable from a
``# gomelint: hotpath`` seed (analysis.callgraph; in the port every
function is host code, see there). The rule ids and meanings are the
reference's:

  GL501  blocking scalar fetch: ``.item()``/``.tolist()``/``float()``/
         ``int()``/``complex()`` of a device tensor (one device→host sync
         each — per order, that is the Redis round trip again)
  GL502  host materialization: ``np.asarray``/``np.array`` (any ``np.*``
         call) of a device tensor, ``.numpy()``, or a blocking ``.cpu()``
         / ``.to("cpu")`` (one without ``non_blocking=True``)
  GL503  implicit bool sync: ``if``/``while``/``assert``/ternary/
         ``bool()``/and-or/iteration on a device tensor
  GL504  ``torch.cuda.synchronize()``, ``Event.synchronize()`` or
         ``Stream.synchronize()`` inside a loop (the counterpart of
         ``block_until_ready``: it serializes the device pipeline per
         iteration; wait once per batch instead)
  GL505  host→device transfer inside a loop: ``torch.as_tensor`` /
         ``torch.tensor`` (any ``torch.*`` call) given a ``device=``,
         ``.to(device)`` or ``.cuda()`` of a host value (per-iteration
         upload; hoist or batch the transfer)

Device-taint model (documented limits — a linter, not an interpreter):

  * DEVICE sources: a ``torch.*`` call given a ``device=`` that is not
    the CPU; ``.to(device)`` (a device argument that is not the CPU, or a
    device receiver moved anywhere but the CPU) and ``.cuda()``; the
    kernel wrappers ``batch_step`` (``ops/match_step``, K1) and
    ``hawkes_scan`` (``ops/hawkes_scan``, K5). The bit propagates
    interprocedurally (a helper whose ``return`` is device makes its
    callers' results device), through arithmetic, subscripts, attribute
    access, tuple unpacking, other ``torch.*`` calls of device
    arguments, and methods of a device receiver;
  * HOST values: ``.numpy()``, ``.tolist()``, ``.item()``, ``.cpu()`` and
    ``.to("cpu")`` results, numpy calls, and a call given the CPU as an
    argument (``gather_leaf(name, "cpu")``, ``to_device(x,
    device="cpu")``: a device argument names where the result lands). The sanctioned fetch, the
    counterpart of ``jax.device_get``, is the frame path's pinned copy
    (``engine/frames.py::resolve_frame``): ``pinned.copy_(t,
    non_blocking=True)`` (or ``t.to("cpu", non_blocking=True)``) queued
    behind the frame's work, then one ``Event.synchronize()`` for the
    whole fetch. It flags nothing; that the host reads the copy only
    after the event wait is the caller's contract, which an AST pass
    cannot see;
  * ``.shape``/``.dtype``/``.device``/``len()``/``.size()``/
    ``.numel()`` and friends are metadata — they de-taint (reading them
    never syncs);
  * a Python container of device values (a list, tuple, set or dict
    display or comprehension, or a helper that returns one) is a SEQUENCE:
    iterating it, testing its truthiness or taking ``len()`` reads no
    device value (no GL503); its elements, and a ``torch.*`` or numpy
    call given it, are device values as before;
  * parameters, ``self`` attributes, and unresolved calls are UNKNOWN
    (untainted): the pass under-reports rather than spamming — the grep
    surface for what it can miss is the ``# gomelint: hotpath`` seeds.
    So a blocking copy of a parameter (``t.to(stage)`` in a helper) is
    not seen, and ``.to(device)`` of a parameter in a loop reads as an
    upload even when the parameter is a device block (a peer copy).

GL504/GL505 are *lexically* loop-scoped within one function; a transfer
in a helper called from a loop is only caught if the helper itself loops.
"""

from __future__ import annotations

import ast

from . import callgraph
from .core import Finding, _dotted, register_project_checker, register_rules

register_rules({
    "GL501": "blocking scalar fetch (.item()/float()/int()) of a device "
             "value on a hot path",
    "GL502": "numpy materialization of a device value on a hot path",
    "GL503": "implicit bool() sync on a device value on a hot path",
    "GL504": "synchronize() inside a loop on a hot path (the counterpart "
             "of block_until_ready())",
    "GL505": "host->device transfer inside a loop on a hot path",
})

#: Tensor metadata: reading it never syncs (the reference's list, with
#: torch's own names).
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "size", "itemsize", "name", "_fields",
    "weak_type", "sharding", "aval", "device", "is_cuda", "layout",
}
#: Tensor methods that return host metadata.
_META_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                 "stride", "is_contiguous", "data_ptr", "get_device",
                 "is_pinned"}
_SCALAR_CASTS = {"float", "int", "complex"}
_DETAINT_CALLS = {"len", "isinstance", "type", "id", "repr", "str", "hash",
                  "bool"}
#: The hand kernels' wrappers: their outputs live on the card.
_KERNEL_WRAPPERS = {"batch_step", "hawkes_scan"}
#: torch's dtype names: `.to(torch.int64)` converts, it does not move.
#: Taint kinds. DEVICE (== True) is a device tensor or a tree of them;
#: SEQ a Python container of device values, whose own truthiness,
#: iteration and length never sync.
DEVICE, SEQ = 1, 2


def _merge(*kinds) -> int | bool:
    """The kind of a value that may be any of ``kinds``: DEVICE dominates
    (it may sync where a SEQ would not)."""
    if DEVICE in kinds:
        return DEVICE
    return SEQ if SEQ in kinds else False


_DTYPES = {
    "bool", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "half", "float", "double", "long",
    "int", "short",
}


def _is_cpu(node: ast.AST) -> bool:
    """Does this expression name the CPU ("cpu", torch.device("cpu"))?"""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and (_dotted(node.func) or "").endswith(
            "device") and node.args:
        return _is_cpu(node.args[0])
    return False


def _is_dtype(node: ast.AST) -> bool:
    d = _dotted(node) or ""
    return d.startswith("torch.") and d.split(".", 1)[1] in _DTYPES


def _kw(node: ast.Call, name: str) -> ast.AST | None:
    for k in node.keywords:
        if k.arg == name:
            return k.value
    return None


def _non_blocking(node: ast.Call) -> bool:
    v = _kw(node, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


class _FnFacts:
    __slots__ = ("returns_device",)

    def __init__(self):
        self.returns_device = False  # or the kind: DEVICE / SEQ


class _Scan(ast.NodeVisitor):
    """One function body's device-taint scan. emit=False runs are the
    returns-device fixpoint; emit=True runs report findings (hot
    functions only)."""

    def __init__(self, checker: "_Checker", fn: callgraph.FuncNode,
                 emit: bool):
        self.c = checker
        self.fn = fn
        self.emit = emit
        self.taint: dict[str, bool] = {}
        self.loop_depth = 0
        self.returns_device = False
        self.findings: list[Finding] = []

    # -- expression taint --------------------------------------------------
    def t(self, node: ast.AST | None) -> bool:
        if node is None:
            return False
        method = getattr(self, f"_t_{type(node).__name__}", None)
        if method is not None:
            return method(node)
        out = False
        for child in ast.iter_child_nodes(node):
            out = self.t(child) or out
        return out

    def _t_Name(self, node):
        return self.taint.get(node.id, False)

    def _t_Constant(self, node):
        return False

    def _t_Lambda(self, node):
        return False

    def _t_Attribute(self, node):
        if node.attr in _STATIC_ATTRS:
            self.t(node.value)
            return False
        return self.t(node.value)

    def _t_Subscript(self, node):
        value, index = self.t(node.value), self.t(node.slice)
        if value == SEQ:  # an element, or a slice of the container
            return SEQ if isinstance(node.slice, ast.Slice) else DEVICE
        return DEVICE if value or index else False

    def _display(self, elts) -> int | bool:
        """A container display: SEQ when an element holds device values."""
        out = False
        for el in elts:
            out = self.t(el) or out
        return SEQ if out else False

    def _t_List(self, node):
        return self._display(node.elts)

    _t_Tuple = _t_Set = _t_List

    def _t_Dict(self, node):
        return self._display([*(k for k in node.keys if k), *node.values])

    def _t_IfExp(self, node):
        if self.t(node.test) == DEVICE:
            self._report("GL503", node,
                         "ternary condition on a device value (blocking "
                         "truthiness fetch)")
        return _merge(self.t(node.body), self.t(node.orelse))

    def _t_Compare(self, node):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False  # identity tests never materialize
        out = self.t(node.left)
        for cmp_ in node.comparators:
            out = self.t(cmp_) or out
        return DEVICE if out else False  # containers compare elementwise

    def _t_BoolOp(self, node):
        # `x and y` forces bool(x): same sync as an `if`.
        for v in node.values[:-1]:
            if self.t(v) == DEVICE:
                self._report("GL503", v,
                             "and/or on a device value (forces bool())")
        return _merge(*(self.t(v) for v in node.values))

    def _upload_in_loop(self, node, what: str) -> None:
        if self.loop_depth and self.fn.hot:
            self._report(
                "GL505", node,
                f"{what} inside a loop uploads host data to the device per "
                "iteration — hoist or batch the transfer",
            )

    def _method(self, node: ast.Call, arg_dev: bool):
        """Tensor-method syncs and moves; None when not one of them."""
        attr = node.func.attr
        recv = self.t(node.func.value)
        if attr in ("item", "tolist"):
            if recv:
                self._report(
                    "GL501", node,
                    f".{attr}() is a blocking device->host scalar fetch — "
                    "batch it through one pinned copy and event wait",
                )
            return False
        if attr == "numpy":
            if recv:
                self._report(
                    "GL502", node,
                    ".numpy() of a device value is a blocking device->host "
                    "copy — fetch via the frame's pinned copy at the batch "
                    "boundary",
                )
            return False
        if attr == "cpu":
            if recv:
                self._report(
                    "GL502", node,
                    ".cpu() of a device value is a blocking device->host "
                    "copy — fetch via the frame's pinned copy at the batch "
                    "boundary",
                )
            return False
        if attr == "synchronize":
            if self.loop_depth and self.fn.hot:
                self._report(
                    "GL504", node,
                    "synchronize() inside a loop serializes the device "
                    "pipeline per iteration — wait once per batch/frame",
                )
            return False
        if attr in _META_METHODS:
            return False
        if attr == "cuda":
            if not recv:
                self._upload_in_loop(node, ".cuda()")
            return True
        if attr == "to":
            target = node.args[0] if node.args else _kw(node, "device")
            if target is None or _is_dtype(target):
                return recv  # a dtype conversion stays where it is
            if _is_cpu(target):
                if recv and not _non_blocking(node):
                    self._report(
                        "GL502", node,
                        ".to(\"cpu\") of a device value is a blocking "
                        "device->host copy — fetch via the frame's pinned "
                        "copy at the batch boundary",
                    )
                return False
            if not recv:
                self._upload_in_loop(node, ".to(device)")
            return True
        return None

    def _t_Call(self, node):
        fname = _dotted(node.func) or ""
        leaf = fname.rsplit(".", 1)[-1]
        root = fname.split(".", 1)[0]
        arg_dev = any(self.t(a) for a in node.args) | any(
            self.t(k.value) for k in node.keywords
        )

        if isinstance(node.func, ast.Attribute) and root != "torch":
            out = self._method(node, arg_dev)
            if out is not None:
                return out

        if fname in _SCALAR_CASTS:
            if arg_dev:
                self._report(
                    "GL501", node,
                    f"{fname}() on a device value is a blocking scalar "
                    "fetch — fetch the batch once instead",
                )
            return False
        if fname == "bool":
            if any(self.t(a) == DEVICE for a in node.args):
                self._report("GL503", node,
                             "bool() on a device value is a blocking sync")
            return False
        if fname in _DETAINT_CALLS:
            return False

        if root in ("np", "numpy"):
            if arg_dev:
                self._report(
                    "GL502", node,
                    f"{fname}() materializes a device value on the host "
                    "(implicit __array__ sync) — fetch via the frame's "
                    "pinned copy at the batch boundary",
                )
            return False

        if root == "torch":
            if leaf == "synchronize":
                if self.loop_depth and self.fn.hot:
                    self._report(
                        "GL504", node,
                        f"{fname}() inside a loop serializes the device "
                        "pipeline per iteration — wait once per "
                        "batch/frame",
                    )
                return False
            if fname.startswith("torch.cuda."):
                return False  # events, streams, device queries
            dev = _kw(node, "device")
            if dev is not None and not _is_cpu(dev):
                if not arg_dev:
                    self._upload_in_loop(node, f"{fname}(..., device=)")
                return True
            return arg_dev  # torch.cat, torch.where, ...: follow the args

        if leaf in _KERNEL_WRAPPERS:
            return True

        # a call told to put its result on the CPU returns host values
        if any(_is_cpu(a) for a in node.args) or any(
                _is_cpu(k.value) for k in node.keywords):
            return False

        # calls into project functions: device iff the target returns device
        out = _merge(*(self.c.facts[target].returns_device
                       for target in self._resolve(node)))
        # a method call on a device receiver stays device (`outs.sum()`,
        # `books._replace(...)`, `t.clone()`, `blocks.pop()`)
        if isinstance(node.func, ast.Attribute) and not out:
            out = DEVICE if self.t(node.func.value) else False
        return out

    def _resolve(self, node: ast.Call) -> list[callgraph.FuncNode]:
        func = node.func
        if isinstance(func, ast.Name):
            return self.c.graph.resolve_name(func.id, self.fn)
        if isinstance(func, ast.Attribute):
            return self.c.graph.resolve_method(func.attr, self.fn)
        return []

    # -- statements --------------------------------------------------------
    def _assign(self, target, taint) -> None:
        if isinstance(target, ast.Name):
            self.taint[target.id] = taint
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:  # unpacking yields the elements
                self._assign(el, DEVICE if taint else False)
        elif isinstance(target, ast.Starred):
            self._assign(target.value, SEQ if taint else False)

    def visit_Assign(self, node):
        t = self.t(node.value)
        for target in node.targets:
            self._assign(target, t)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._assign(node.target, self.t(node.value))

    def visit_AugAssign(self, node):
        t = self.t(node.value)
        if isinstance(node.target, ast.Name):
            self.taint[node.target.id] = (
                self.taint.get(node.target.id, False) or t
            )

    def visit_If(self, node):
        if self.t(node.test) == DEVICE:
            self._report("GL503", node.test,
                         "`if` on a device value blocks on the predicate "
                         "fetch — fetch the batch once, branch on numpy")
        self.generic_visit(node)

    def visit_While(self, node):
        if self.t(node.test) == DEVICE:
            self._report("GL503", node.test,
                         "`while` on a device value syncs per iteration")
        self.loop_depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.loop_depth -= 1

    def visit_Assert(self, node):
        if self.t(node.test) == DEVICE:
            self._report("GL503", node.test,
                         "`assert` on a device value is a blocking sync "
                         "(and python -O strips it)")
        self.generic_visit(node)

    def visit_For(self, node):
        it_dev = self.t(node.iter)
        if it_dev == DEVICE:
            self._report(
                "GL503", node.iter,
                "`for` over a device value fetches one element per "
                "iteration — fetch once and iterate the numpy copy",
            )
        self._assign(node.target, DEVICE if it_dev else False)
        self.loop_depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.loop_depth -= 1

    def visit_Return(self, node):
        if node.value is not None:
            self.returns_device = _merge(self.returns_device,
                                         self.t(node.value))

    def visit_With(self, node):
        for item in node.items:
            self.t(item.context_expr)
            if item.optional_vars is not None:
                self._assign(item.optional_vars, False)
        for stmt in node.body:
            self.visit(stmt)

    def _comp(self, node):
        for gen in node.generators:
            self._assign(gen.target, DEVICE if self.t(gen.iter) else False)
            for cond in gen.ifs:
                self.t(cond)

    def _t_ListComp(self, node):
        self._comp(node)
        return SEQ if self.t(node.elt) else False

    _t_SetComp = _t_GeneratorExp = _t_ListComp

    def _t_DictComp(self, node):
        self._comp(node)
        return SEQ if self.t(node.key) or self.t(node.value) else False

    def visit_Expr(self, node):
        self.t(node.value)

    def visit_FunctionDef(self, node):
        pass  # nested scopes are their own FuncNodes

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def generic_visit(self, node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self.t(child)
            else:
                self.visit(child)

    def run(self) -> "_Scan":
        node = self.fn.node
        if isinstance(node, ast.Lambda):
            self.returns_device = self.t(node.body) or False
            return self
        for stmt in node.body:
            self.visit(stmt)
        return self

    def _report(self, rule: str, node: ast.AST, msg: str) -> None:
        if not (self.emit and self.fn.hot):
            return
        self.findings.append(Finding(
            rule, self.fn.module.path, getattr(node, "lineno", 1),
            getattr(node, "col_offset", 0),
            f"{msg} [hot path: {self.fn.qualname}]",
        ))


class _Checker:
    def __init__(self, project):
        self.graph = callgraph.build(project)
        self.facts: dict[callgraph.FuncNode, _FnFacts] = {
            fn: _FnFacts() for fn in self.graph.funcs
        }

    def run(self) -> list[Finding]:
        # fixpoint: which functions return device values
        for _ in range(8):
            changed = False
            for fn in self.graph.funcs:
                rd = _Scan(self, fn, emit=False).run().returns_device
                kind = _merge(rd, self.facts[fn].returns_device)
                if kind != self.facts[fn].returns_device:
                    self.facts[fn].returns_device = kind
                    changed = True
            if not changed:
                break
        findings: list[Finding] = []
        for fn in self.graph.hot_functions():
            findings.extend(_Scan(self, fn, emit=True).run().findings)
        return findings


def check(project) -> list[Finding]:
    return _Checker(project).run()


register_project_checker("GL5", check)
