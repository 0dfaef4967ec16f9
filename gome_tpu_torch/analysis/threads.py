"""GL7xx thread-escape analysis: find shared state with NO sharing contract.

The port of ``gome_tpu/analysis/threads.py``, unchanged in what it
reports.

GL4xx (analysis.locks) enforces the `# guarded by` contract on attributes
that *declare* one — it says nothing about shared attributes that never
declared anything. This pass closes that hole. It computes the project's
*thread-escape set*: classes whose instances are reachable by more than
one thread, because the class

  * owns a thread — any ``threading.Thread(...)`` constructed in its body
    (the daemon-loop pattern: batcher deadline loop, consumer, matchfeed
    fan-out, watchdog, samplers, broker accept loops);
  * is published as a module-level singleton — ``FAULTS = FaultRegistry()``
    style ALL-CAPS assignments, reachable from every thread that imports
    the module (FAULTS/HOSTPROF/TIMELINE/PROFILER/TRACER/REGISTRY/...);
  * is constructed INTO an escaped class — ``self.seq = SeqTracker()``
    inside MatchFeed escapes SeqTracker too (transitively).

Within an escaped class, every attribute **mutation** outside
``__init__``/``__new__`` must carry a sharing contract:

  * ``# guarded by self._lock`` on the attribute's declaration — GL4xx
    then enforces the lock on every touch (the strong contract);
  * ``# single-writer: <who>`` on the declaration line — documents that
    exactly one thread mutates it (readers tolerate staleness; a GIL-
    atomic store is never torn). A class-level claim on the ``class`` line
    (or the line above) covers every attribute of the class;
  * neither ⇒ GL701. A mutation that happens to sit under a ``with
    self.<lock>:`` the declaration never mentions ⇒ GL702 (annotation
    drift: the code locks, the contract doesn't say so).

The single-writer claim is *checked*, not just trusted, where the writer
thread is statically known: for a thread-owning class, methods reachable
from the ``Thread(target=...)`` entry (over the interprocedural call
graph, analysis.callgraph) are thread-side; a single-writer attribute
mutated BOTH thread-side and from outside that reach has two writers ⇒
GL704 at the outside site.
Pre-start recovery hooks (a real happens-before edge the AST cannot see)
suppress with justification: ``# gomelint: disable=GL704 — called before
start()``.

Known lexical limits (same trade as GL4xx, documented not hidden):
container mutation through method calls (``self._buf.append(x)``) is a
Load of the attribute, not a Store — the guard contract for containers
lives in GL4xx once declared; mutations of a singleton's attributes from
*outside* its class (``FAULTS.enabled = True`` in a script) are not
scanned; and reads are never flagged (a stale read of one attribute is a
semantics question, not a torn-write question).

Rules:

  GL701  thread-escaped attribute mutated with no lock held and no
         sharing contract
  GL702  thread-escaped attribute mutated under a lock its declaration
         does not name
  GL703  attribute declares BOTH `# guarded by` and `# single-writer`
  GL704  single-writer attribute mutated outside the writer thread's
         reach while the writer thread also mutates it

The dynamic half of this story is analysis.racecheck (Eraser-style
lockset detection at runtime) — GL7xx is the cheap always-on gate, the
lockset detector is the witness generator.
"""

from __future__ import annotations

import ast
import re

from .callgraph import build
from .core import Finding, register_project_checker, register_rules
from .locks import _GUARD_RE, _holds_from_comment, _self_attr

register_rules({
    "GL701": "thread-escaped attribute mutated with no sharing contract",
    "GL702": "thread-escaped attribute mutated under an undeclared lock",
    "GL703": "attribute declares both `# guarded by` and `# single-writer`",
    "GL704": "single-writer attribute also mutated outside the writer "
             "thread's reach",
})

_SINGLE_RE = re.compile(r"#\s*single-writer\b(?::\s*(\S[^#]*))?")
_SINGLETON_NAME_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _dotted_tail(node: ast.AST) -> str | None:
    """Bare name of a Name/Attribute callee ('Thread' for threading.Thread)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


class _Cls:
    """One class of the project: attribute contracts + escape evidence."""

    def __init__(self, module, node: ast.ClassDef):
        self.module = module
        self.node = node
        self.name = node.name
        self.assigned: set[str] = set()
        self.guards: dict[str, str] = {}  # attr -> lock attr (GL4 grammar)
        self.single: dict[str, str] = {}  # attr -> documented writer
        self.decl_lines: dict[str, int] = {}
        self.class_single: str | None = None  # class-wide single-writer
        #: Thread(target=...) entries: ("method", name) | ("name", name)
        self.thread_targets: list[tuple[str, str]] = []
        self.constructs: list[str] = []  # class names built into self.<attr>
        self.escape: str | None = None  # reason, once escaped

    def contract(self, attr: str) -> str | None:
        if attr in self.guards:
            return "guarded"
        if attr in self.single or self.class_single is not None:
            return "single-writer"
        return None


class _Mut:
    """One attribute mutation site inside an escaped class."""

    __slots__ = ("attr", "node", "func_ast", "held")

    def __init__(self, attr, node, func_ast, held):
        self.attr = attr
        self.node = node
        self.func_ast = func_ast  # enclosing function's AST node
        self.held = held  # lock attrs lexically held at the site


def _class_body_nodes(cls_node: ast.ClassDef):
    """Walk a class body without descending into nested classes."""
    stack = list(cls_node.body)
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, ast.ClassDef):
            stack.extend(ast.iter_child_nodes(n))


def _collect_class(module, node: ast.ClassDef) -> _Cls:
    cls = _Cls(module, node)
    for ln in (node.lineno, node.lineno - 1):
        m = _SINGLE_RE.search(module.line_comment(ln))
        if m:
            cls.class_single = (m.group(1) or "").strip()
            break
    for n in _class_body_nodes(node):
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                cls.assigned.add(attr)
                comment = module.line_comment(n.lineno)
                gm = _GUARD_RE.search(comment)
                sm = _SINGLE_RE.search(comment)
                if gm and attr not in cls.guards:
                    cls.guards[attr] = gm.group(1)
                    cls.decl_lines.setdefault(attr, n.lineno)
                if sm and attr not in cls.single:
                    cls.single[attr] = (sm.group(1) or "").strip()
                    cls.decl_lines.setdefault(attr, n.lineno)
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and _self_attr(n.targets[0]) is not None \
                    and isinstance(n.value, ast.Call):
                callee = _dotted_tail(n.value.func)
                if callee and callee[:1].isupper():
                    cls.constructs.append(callee)
        elif isinstance(n, ast.Call):
            callee = _dotted_tail(n.func)
            if callee == "Thread":
                for kw in n.keywords:
                    if kw.arg != "target":
                        continue
                    tattr = _self_attr(kw.value)
                    if tattr is not None:
                        cls.thread_targets.append(("method", tattr))
                    elif isinstance(kw.value, ast.Name):
                        cls.thread_targets.append(("name", kw.value.id))
                if not any(kw.arg == "target" for kw in n.keywords):
                    cls.thread_targets.append(("name", "<unknown>"))
                cls.escape = cls.escape or "owns a thread"
    return cls


class _MutScan(ast.NodeVisitor):
    """Collect mutations of one method body with the lexically-held lock
    set — the GL4xx _MethodScan discipline (with-blocks, `_locked` suffix,
    `# holds:` annotations; closures start fresh, `__init__` is exempt)."""

    def __init__(self, cls: _Cls, out: list[_Mut], held: set[str],
                 exempt: bool, func_ast):
        self.cls = cls
        self.out = out
        self.held = held
        self.exempt = exempt
        self.func_ast = func_ast

    def visit_With(self, node):
        added = {a for item in node.items
                 if (a := _self_attr(item.context_expr)) is not None}
        self.held |= added
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        self.held -= added

    def _nested(self, node, name: str):
        held = _holds_from_comment(
            self.cls.module.line_comment(node.lineno))
        if not held and node.lineno > 1:
            held = _holds_from_comment(
                self.cls.module.line_comment(node.lineno - 1))
        if name.endswith("_locked"):
            held |= set(self.cls.guards.values())
        scan = _MutScan(self.cls, self.out, held, exempt=False,
                        func_ast=node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for stmt in node.body:
                scan.visit(stmt)
        else:  # Lambda
            scan.visit(node.body)

    def visit_FunctionDef(self, node):
        self._nested(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._nested(node, node.name)

    def visit_Lambda(self, node):
        self._nested(node, "<lambda>")

    def visit_Attribute(self, node):
        attr = _self_attr(node)
        if attr is not None and not self.exempt \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            self.out.append(
                _Mut(attr, node, self.func_ast, frozenset(self.held)))
        self.generic_visit(node)


def _escape_classes(classes: list[_Cls], modules) -> None:
    """Mark escaped classes: thread owners (done at collect), module-level
    ALL-CAPS singletons, then transitive construction into escaped ones."""
    by_name: dict[str, list[_Cls]] = {}
    for c in classes:
        by_name.setdefault(c.name, []).append(c)
    for module in modules:
        for stmt in module.tree.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and _SINGLETON_NAME_RE.match(stmt.targets[0].id)
                    and isinstance(stmt.value, ast.Call)):
                continue
            callee = _dotted_tail(stmt.value.func)
            for c in by_name.get(callee or "", ()):
                c.escape = c.escape or \
                    f"module-level singleton {stmt.targets[0].id}"
    work = [c for c in classes if c.escape]
    seen = set(id(c) for c in work)
    while work:
        c = work.pop()
        for built in c.constructs:
            for d in by_name.get(built, ()):
                if id(d) not in seen:
                    seen.add(id(d))
                    d.escape = d.escape or f"constructed into escaped " \
                                           f"{c.name}"
                    work.append(d)


def _thread_side(cls: _Cls, graph) -> set:
    """FuncNodes reachable from the class's Thread(target=...) entries."""
    roots = []
    for kind, name in cls.thread_targets:
        if kind == "method":
            roots += [f for f in graph.methods.get(name, ())
                      if f.cls == cls.name and f.module is cls.module]
        else:
            roots += [f for f in graph.by_name.get(name, ())
                      if f.module is cls.module]
    seen = set(roots)
    work = list(roots)
    while work:
        fn = work.pop()
        for nxt in graph.edges.get(fn, ()):
            if nxt not in seen:
                seen.add(nxt)
                work.append(nxt)
    return seen


def _check_class(cls: _Cls, graph, findings: list[Finding]) -> None:
    # GL703 — contradictory contracts, flagged even for non-escaped
    # classes (the annotation is wrong wherever it is).
    for attr in sorted(set(cls.guards) & set(cls.single)):
        findings.append(Finding(
            "GL703", cls.module.path, cls.decl_lines[attr], 0,
            f"self.{attr} declares both `# guarded by self."
            f"{cls.guards[attr]}` and `# single-writer` — a guarded "
            f"attribute has many writers by design; pick one contract "
            f"[class {cls.name}]",
        ))
    if cls.escape is None:
        return
    muts: list[_Mut] = []
    for node in cls.node.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        held = _holds_from_comment(cls.module.line_comment(node.lineno))
        if not held and node.lineno > 1:
            held |= _holds_from_comment(
                cls.module.line_comment(node.lineno - 1))
        if node.name.endswith("_locked"):
            held |= set(cls.guards.values())
        exempt = node.name in ("__init__", "__new__")
        scan = _MutScan(cls, muts, held, exempt, func_ast=node)
        for stmt in node.body:
            scan.visit(stmt)

    single_sites: dict[str, list[_Mut]] = {}
    for m in muts:
        contract = cls.contract(m.attr)
        if contract == "guarded":
            continue  # GL4xx enforces the declared lock on this site
        if contract == "single-writer":
            single_sites.setdefault(m.attr, []).append(m)
            continue
        if m.held:
            lock = sorted(m.held)[0]
            findings.append(Finding(
                "GL702", cls.module.path, m.node.lineno, m.node.col_offset,
                f"self.{m.attr} is thread-shared ({cls.escape}) and "
                f"mutated under self.{lock}, but its declaration has no "
                f"`# guarded by self.{lock}` — declare the guard so GL4xx "
                f"enforces it everywhere [class {cls.name}]",
            ))
        else:
            findings.append(Finding(
                "GL701", cls.module.path, m.node.lineno, m.node.col_offset,
                f"self.{m.attr} is thread-shared ({cls.escape}) but "
                f"mutated with no lock held and no sharing contract — "
                f"declare `# guarded by self.<lock>` or `# single-writer: "
                f"<who>` on its declaration [class {cls.name}]",
            ))

    # GL704 — verify single-writer claims where the writer thread is
    # statically known (the class spawns it).
    if not cls.thread_targets or not single_sites:
        return
    reach = _thread_side(cls, graph)
    if not reach:
        return
    for attr, sites in sorted(single_sites.items()):
        inside = [m for m in sites if graph.by_node.get(m.func_ast) in reach]
        outside = [m for m in sites
                   if graph.by_node.get(m.func_ast) not in reach]
        if not inside or not outside:
            continue  # one side only: the claim is consistent
        witness = inside[0].node.lineno
        for m in outside:
            findings.append(Finding(
                "GL704", cls.module.path, m.node.lineno, m.node.col_offset,
                f"self.{m.attr} is declared single-writer but this "
                f"mutation is outside the spawned thread's reach while "
                f"the thread also writes it (line {witness}) — two "
                f"writers contradict the claim; lock it, or suppress "
                f"with the happens-before justification "
                f"[class {cls.name}]",
            ))


def check(project) -> list[Finding]:
    graph = build(project)
    classes: list[_Cls] = []
    for module in project.modules:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                classes.append(_collect_class(module, node))
    _escape_classes(classes, project.modules)
    findings: list[Finding] = []
    for cls in classes:
        _check_class(cls, graph, findings)
    return findings


register_project_checker("GL7", check)
