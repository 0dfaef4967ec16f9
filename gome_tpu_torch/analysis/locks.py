"""GL4xx lock-discipline: annotation-driven shared-state race detection.

The port of ``gome_tpu/analysis/locks.py`` (a copy).

The service layer is deliberately multi-threaded — gRPC handler threads
feed the FrameBatcher, AMQP reader threads append arrivals, the
supervised-reconnect path swaps connections, background deadline/consume
loops mutate cursors — and each class documents its sharing contract with
one lock (or two, like SupervisedAmqpQueue's `_state`/`_io` split). This
checker makes that contract *machine-checked*: declare an attribute's
guard once, and every other touch of it must hold the declared lock.

Declaration (a trailing comment on any `self.<attr> = ...` line, usually
in `__init__`):

    self._buf = []          # guarded by self._lock
    self._committed = 0     # guarded by self._state

Enforcement — any load/store of a declared attribute in the class must be
lexically inside one of:

  * a `with self.<declared lock>:` block (Condition objects count — they
    are locks with waiters);
  * a method whose name ends in `_locked` (the codebase's caller-holds-
    the-lock convention: `_flush_locked`, `_reconnect_locked`, ...), which
    asserts the DECLARED lock of each attribute it touches is held;
  * a method annotated `# holds: self._lock` on (or immediately above)
    its `def` line, naming the held lock(s) explicitly;
  * `__init__`/`__new__` (construction happens-before publication).

Nested functions and lambdas do NOT inherit the enclosing `with` block or
the `__init__` exemption: a callback defined under the lock runs later,
off the lock — exactly the escape that makes lexical checking of
closures unsound, so the closure body must take (or be annotated to
hold, or suppress with justification) the lock itself.

Rules:

  GL401  guarded attribute written outside its declared lock
  GL402  guarded attribute read outside its declared lock
  GL403  `# guarded by self.X` names a lock never assigned in the class

The opt-in *runtime* assertion mode (tests) is analysis.runtime: swap the
lock for an `OwnedLock` and `instrument()` the instance, and off-lock
writes raise at the exact line instead of losing updates silently.
"""

from __future__ import annotations

import ast
import re

from .core import Finding, register_checker, register_rules

register_rules({
    "GL401": "guarded attribute written outside its declared lock",
    "GL402": "guarded attribute read outside its declared lock",
    "GL403": "guard annotation names a lock the class never assigns",
})

_GUARD_RE = re.compile(r"#\s*guarded\s+by\s+self\.([A-Za-z_]\w*)")
_HOLDS_RE = re.compile(r"#\s*holds:?\s+(self\.[A-Za-z_]\w*"
                       r"(?:\s*,\s*self\.[A-Za-z_]\w*)*)")


def _holds_from_comment(comment: str) -> set[str]:
    m = _HOLDS_RE.search(comment)
    if not m:
        return set()
    return {part.strip()[len("self."):] for part in m.group(1).split(",")}


class _ClassInfo:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.guards: dict[str, str] = {}  # attr -> lock attr
        self.decl_lines: dict[str, int] = {}
        self.assigned_attrs: set[str] = set()


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _MethodScan(ast.NodeVisitor):
    """Scan one method (or one nested scope within it) for guarded-attr
    touches, tracking the lexically-held lock set."""

    def __init__(self, checker, cls: _ClassInfo, held: set[str],
                 exempt: bool):
        self.c = checker
        self.cls = cls
        self.held = held
        self.exempt = exempt  # __init__/__new__ top-level scope

    def visit_With(self, node):
        added = set()
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None:
                added.add(attr)
        self.held |= added
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        self.held -= added

    def _nested(self, node, name: str):
        # a closure: runs later, off the lexical lock; fresh scope, and the
        # __init__ exemption does not follow it. An explicit `# holds:`
        # annotation on the def line still applies.
        held = _holds_from_comment(self.c.module.line_comment(node.lineno))
        if not held and node.lineno > 1:
            held = _holds_from_comment(
                self.c.module.line_comment(node.lineno - 1))
        if name.endswith("_locked"):
            held |= set(self.cls.guards.values())
        scan = _MethodScan(self.c, self.cls, held, exempt=False)
        for stmt in node.body if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)) else []:
            scan.visit(stmt)
        if isinstance(node, ast.Lambda):
            scan.visit(node.body)

    def visit_FunctionDef(self, node):
        self._nested(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._nested(node, node.name)

    def visit_Lambda(self, node):
        self._nested(node, "<lambda>")

    def visit_Attribute(self, node):
        attr = _self_attr(node)
        if attr is not None and attr in self.cls.guards and not self.exempt:
            lock = self.cls.guards[attr]
            if lock not in self.held:
                if isinstance(node.ctx, (ast.Store, ast.Del)):
                    rule, verb = "GL401", "written"
                else:
                    rule, verb = "GL402", "read"
                self.c.report(
                    rule, node,
                    f"self.{attr} is declared `# guarded by self.{lock}` "
                    f"but {verb} without holding it "
                    f"[class {self.cls.node.name}]",
                )
        self.generic_visit(node)


class _Checker:
    def __init__(self, module):
        self.module = module
        self.findings: list[Finding] = []

    def report(self, rule, node, msg) -> None:
        self.findings.append(Finding(
            rule, self.module.path, node.lineno, node.col_offset, msg))

    def run(self) -> list[Finding]:
        for node in ast.walk(self.module.tree):
            if isinstance(node, ast.ClassDef):
                self._check_class(node)
        return self.findings

    def _collect(self, cls_node: ast.ClassDef) -> _ClassInfo:
        info = _ClassInfo(cls_node)
        for node in ast.walk(cls_node):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    info.assigned_attrs.add(attr)
                    m = _GUARD_RE.search(
                        self.module.line_comment(node.lineno))
                    if m:
                        info.guards[attr] = m.group(1)
                        info.decl_lines[attr] = node.lineno
        return info

    def _check_class(self, cls_node: ast.ClassDef) -> None:
        info = self._collect(cls_node)
        if not info.guards:
            return
        for attr, lock in info.guards.items():
            if lock not in info.assigned_attrs:
                line = info.decl_lines[attr]
                self.findings.append(Finding(
                    "GL403", self.module.path, line, 0,
                    f"self.{attr} declared guarded by self.{lock}, but "
                    f"{cls_node.name} never assigns self.{lock}",
                ))
        for node in cls_node.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            held = _holds_from_comment(
                self.module.line_comment(node.lineno))
            if not held and node.lineno > 1:
                held |= _holds_from_comment(
                    self.module.line_comment(node.lineno - 1))
            if node.name.endswith("_locked"):
                held |= set(info.guards.values())
            exempt = node.name in ("__init__", "__new__")
            scan = _MethodScan(self, info, held, exempt)
            for stmt in node.body:
                scan.visit(stmt)


def check(module) -> list[Finding]:
    return _Checker(module).run()


register_checker("GL4", check)
