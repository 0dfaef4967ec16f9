"""Whole-package call graph + hot-path reachability (the GL5xx/GL6xx base).

The paper's design deletes the per-order Redis round trip by keeping book
state device-resident; the residual hazard is *host-side* code on the
order path quietly reintroducing a per-order device round trip. Deciding
"is this line on the order path" is an interprocedural question, so this
module builds a conservative call graph over every module of one analysis
run and computes forward reachability from annotated seeds.

Annotation grammar (documented in ARCHITECTURE.md "Static analysis"):

    def run_once(self) -> int:  # gomelint: hotpath
        ...

    # gomelint: hotpath
    def _loop(self) -> None:
        ...

A ``# gomelint: hotpath`` comment on the ``def`` line, on any decorator
line, or on the line immediately above the first decorator/``def`` marks
the function as a hot-path SEED. Everything reachable from a seed is hot:

  * direct calls (``f(...)``, ``self.m(...)``, ``obj.m(...)``) — names
    resolve same-scope first, then same-module, then project-wide by bare
    name; method names resolve against every class in the project
    (conservative over-approximation: matching is by name, not type);
  * callback/closure edges — a bare REFERENCE to a known function
    (``Thread(target=self._loop)``, ``submit(fn)``, a handler stored in a
    dict) counts as a call edge, because the linter cannot prove it is
    never invoked;
  * nested defs/lambdas inherit an edge from their enclosing function
    (a closure defined on the hot path runs on the hot path unless shown
    otherwise).

The port of ``gome_tpu/analysis/callgraph.py``. The reference stops
reachability at jit/pallas-traced functions, whose bodies run as a
compiled device graph (GL1xx's domain). The port traces nothing: its
device code is eager PyTorch and the CUDA kernels' wrappers
(``ops/match_step.batch_step``, ``ops/hawkes_scan.hawkes_scan``), which
run on the host and queue device work call by call. So reachability
stops nowhere here, and every hot function is GL5xx-scanned.
"""

from __future__ import annotations

import ast
import re

_HOTPATH_RE = re.compile(r"#\s*gomelint:\s*hotpath\b")


class FuncNode:
    """One function/method/lambda in the project."""

    __slots__ = ("module", "node", "qualname", "name", "cls",
                 "hot", "seed", "enclosing")

    def __init__(self, module, node, qualname: str, name: str,
                 cls: str | None, enclosing: "FuncNode | None"):
        self.module = module
        self.node = node
        self.qualname = qualname  # module-relative dotted scope
        self.name = name  # bare name ("<lambda:LINE>" for lambdas)
        self.cls = cls  # enclosing class name for methods
        self.enclosing = enclosing  # lexically enclosing FuncNode
        self.hot = False
        self.seed = False

    @property
    def ref(self) -> str:
        return f"{self.module.path}::{self.qualname}"

    def __repr__(self):  # pragma: no cover - debug aid
        flags = "".join(
            f for f, on in (("H", self.hot), ("S", self.seed)) if on
        )
        return f"<FuncNode {self.ref} {flags}>"


def _is_hotpath_annotated(module, node) -> bool:
    lines = [node.lineno]
    first = node.lineno
    for dec in getattr(node, "decorator_list", ()):
        lines.append(dec.lineno)
        first = min(first, dec.lineno)
    lines.append(first - 1)  # the line immediately above
    return any(_HOTPATH_RE.search(module.line_comment(ln)) for ln in lines)


class _Collector(ast.NodeVisitor):
    """Collect every function of one module with scope/class context and
    mark hotpath seeds."""

    def __init__(self, graph: "CallGraph", module):
        self.g = graph
        self.module = module
        self._scope: list[str] = []
        self._cls: list[str] = []
        self._func: list[FuncNode] = []

    def _add(self, node, name: str) -> FuncNode:
        qual = ".".join(self._scope + [name])
        fn = FuncNode(
            self.module, node, qual, name,
            self._cls[-1] if self._cls else None,
            self._func[-1] if self._func else None,
        )
        self.g._add(fn)
        return fn

    def visit_ClassDef(self, node):
        self._scope.append(node.name)
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()
        self._scope.pop()

    def _visit_func(self, node):
        fn = self._add(node, node.name)
        if _is_hotpath_annotated(self.module, node):
            fn.seed = True
        self._scope.append(node.name)
        self._func.append(fn)
        cls = self._cls
        self._cls = []  # nested defs inside a method are plain functions
        self.generic_visit(node)
        self._cls = cls
        self._func.pop()
        self._scope.pop()

    def visit_FunctionDef(self, node):
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node):
        self._visit_func(node)

    def visit_Lambda(self, node):
        self._add(node, f"<lambda:{node.lineno}>")
        self.generic_visit(node)


class _EdgeScan(ast.NodeVisitor):
    """Record call/reference edges out of ONE function body. Nested defs
    are separate nodes (an enclosing→nested closure edge is added by the
    builder); their bodies are not re-walked here."""

    def __init__(self, graph: "CallGraph", fn: FuncNode):
        self.g = graph
        self.fn = fn

    def visit_FunctionDef(self, node):
        if node is not self.fn.node:
            return  # nested scope: its own _EdgeScan walks it

        # arguments' defaults evaluate in the enclosing scope
        for d in node.args.defaults + [
            d for d in node.args.kw_defaults if d is not None
        ]:
            self.visit(d)
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        if node is not self.fn.node:
            return
        self.visit(node.body)

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            for target in self.g.resolve_name(node.id, self.fn):
                self.g.add_edge(self.fn, target)

    def visit_Attribute(self, node):
        # self.m / obj.m — method reference by name (call or callback)
        for target in self.g.resolve_method(node.attr, self.fn):
            self.g.add_edge(self.fn, target)
        self.visit(node.value)


class CallGraph:
    """Project-wide function index + conservative call/reference edges."""

    def __init__(self, project):
        self.funcs: list[FuncNode] = []
        self.by_node: dict[ast.AST, FuncNode] = {}
        self.by_name: dict[str, list[FuncNode]] = {}
        self.methods: dict[str, list[FuncNode]] = {}
        self.edges: dict[FuncNode, set[FuncNode]] = {}
        for module in project.modules:
            _Collector(self, module).visit(module.tree)
        for fn in self.funcs:
            if fn.enclosing is not None:
                self.add_edge(fn.enclosing, fn)  # closure edge
            _EdgeScan(self, fn).visit(fn.node)
        self._propagate()

    # -- construction ------------------------------------------------------
    def _add(self, fn: FuncNode) -> None:
        self.funcs.append(fn)
        self.by_node[fn.node] = fn
        self.by_name.setdefault(fn.name, []).append(fn)
        if fn.cls is not None:
            self.methods.setdefault(fn.name, []).append(fn)

    def add_edge(self, src: FuncNode, dst: FuncNode) -> None:
        self.edges.setdefault(src, set()).add(dst)

    # -- name resolution ---------------------------------------------------
    def resolve_name(self, name: str, ctx: FuncNode) -> list[FuncNode]:
        cands = self.by_name.get(name, ())
        if not cands:
            return []
        scope = ctx.qualname.rsplit(".", 1)[0]
        sibs = [c for c in cands
                if c.module is ctx.module
                and c.qualname.rsplit(".", 1)[0] == scope]
        if sibs:
            return sibs
        local = [c for c in cands if c.module is ctx.module]
        return local or list(cands)

    def resolve_method(self, name: str, ctx: FuncNode) -> list[FuncNode]:
        cands = self.methods.get(name, ())
        if cands:
            same_cls = [c for c in cands
                        if ctx.cls is not None and c.cls == ctx.cls
                        and c.module is ctx.module]
            return same_cls or list(cands)
        # not a method anywhere: a module-attribute call like
        # `frames.submit_frame(...)` — fall back to plain functions
        return [c for c in self.by_name.get(name, ()) if c.cls is None]

    # -- hot-path reachability ---------------------------------------------
    def _propagate(self) -> None:
        work = [fn for fn in self.funcs if fn.seed]
        for fn in work:
            fn.hot = True
        while work:
            fn = work.pop()
            for nxt in self.edges.get(fn, ()):
                if not nxt.hot:
                    nxt.hot = True
                    work.append(nxt)

    def hot_functions(self) -> list[FuncNode]:
        """Hot functions — the GL5xx scan set (all host-side here)."""
        return [fn for fn in self.funcs if fn.hot]


def build(project) -> CallGraph:
    """Build (or reuse) the project's call graph — several rule families
    consume it, and one project build per run is enough."""
    cached = getattr(project, "_callgraph", None)
    if cached is None:
        cached = project._callgraph = CallGraph(project)
    return cached
