"""gomelint core: findings, rule registry, suppressions, and the runner.

The port of ``gome_tpu/analysis/core.py``: the same Finding, suppression
grammar and runner, so a source gives the same findings (rule, line,
column, message) under either package's families that both have. A
*checker* is a function ``check(module: SourceModule) -> list[Finding]``
registered in :data:`CHECKERS`. Every checker here is a pure AST pass;
the one traced audit, GL2xx (``analysis/envelope.py``, the CLI's
``--traced``), reports outside this pipeline and goes through
:func:`apply_file_suppressions` (see ``analysis/__init__.py``).

Suppression syntax (mirrors the familiar ``# noqa`` shape but namespaced,
so ruff/flake8 never eat our directives and vice versa):

  * line:  ``x = float(v)  # gomelint: disable=GL101`` — suppresses the
           listed rules (comma-separated) on that physical line; ``all``
           suppresses every rule. The justification convention is a
           trailing `` — why`` clause after the rule list.
  * file:  ``# gomelint: disable-file=GL104`` anywhere in the file.

Suppressed findings are dropped at collection time; ``--show-suppressed``
in the CLI resurfaces them for audits.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable

#: Tool version (CLI --version, SARIF tool.driver.version, baseline
#: provenance): the reference's, whose fingerprint scheme (file-scoped
#: occurrence indices since 2.1.0) this package shares.
TOOL_VERSION = "2.2.0"

#: rule id -> one-line description (the catalogue; checkers register into
#: this at import time so the CLI's --list-rules stays complete).
ALL_RULES: dict[str, str] = {}


def register_rules(rules: dict[str, str]) -> None:
    ALL_RULES.update(rules)


def rule_catalogue() -> dict[str, str]:
    return dict(sorted(ALL_RULES.items()))


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # stable id, e.g. "GL101"
    path: str  # file path as given to the runner
    line: int  # 1-based
    col: int  # 0-based
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


_DIRECTIVE = re.compile(r"#\s*gomelint:\s*(disable(?:-file)?)\s*=\s*([A-Za-z0-9_,\s]+)")


def _parse_rules(blob: str) -> set[str]:
    return {r.strip().upper() for r in blob.split(",") if r.strip()}


class SourceModule:
    """One parsed source file plus its suppression tables."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.line_disable: dict[int, set[str]] = {}
        self.file_disable: set[str] = set()
        for i, line in enumerate(self.lines, 1):
            m = _DIRECTIVE.search(line)
            if not m:
                continue
            rules = _parse_rules(m.group(2))
            if m.group(1) == "disable-file":
                self.file_disable |= rules
            else:
                self.line_disable.setdefault(i, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        rule = rule.upper()
        for table in (self.file_disable, self.line_disable.get(line, ())):
            if rule in table or "ALL" in table:
                return True
        return False

    # -- comment helpers (annotation-driven checkers) ----------------------
    def line_comment(self, line: int) -> str:
        """The comment tail of one physical line ('' when none). A '#'
        inside a string literal can false-positive here; annotation
        directives are short ASCII tails, so in practice the regexes the
        checkers apply to this are unambiguous."""
        if not 1 <= line <= len(self.lines):
            return ""
        text = self.lines[line - 1]
        idx = text.find("#")
        return text[idx:] if idx >= 0 else ""


#: A module checker: fn(module) -> findings.
Checker = Callable[[SourceModule], list[Finding]]
#: A project checker: fn(project) -> findings.
ProjectChecker = Callable[["Project"], list[Finding]]

#: registered checkers: (family, fn). Family is the id prefix ("GL1") used
#: by --select; fn(module) -> findings.
CHECKERS: list[tuple[str, Checker]] = []


def register_checker(family: str, fn: Checker) -> None:
    CHECKERS.append((family, fn))


#: project-scope checkers: (family, fn); fn(project) -> findings. These see
#: EVERY module of the run at once — the interprocedural passes (hot-path
#: reachability, donation call-site liveness) need the whole-package call
#: graph, which no single-module pass can build.
PROJECT_CHECKERS: list[tuple[str, ProjectChecker]] = []


def register_project_checker(family: str, fn: ProjectChecker) -> None:
    PROJECT_CHECKERS.append((family, fn))


class Project:
    """One analysis run's worth of parsed modules plus per-module
    suppression routing for project-scope findings."""

    def __init__(self, modules: list[SourceModule]):
        self.modules = list(modules)
        self.by_path = {m.path: m for m in self.modules}

    def suppressed(self, rule: str, path: str, line: int) -> bool:
        m = self.by_path.get(path)
        return m is not None and m.suppressed(rule, line)


def _selected(rule: str, select: set[str] | None) -> bool:
    if not select:
        return True
    return any(rule.upper().startswith(s) for s in select)


def _collect(module: SourceModule, select: set[str] | None,
             keep_suppressed: bool = False) -> list[Finding]:
    out: list[Finding] = []
    for family, fn in CHECKERS:
        if select and not any(s.startswith(family) or family.startswith(s)
                              for s in select):
            continue
        for f in fn(module):
            if not _selected(f.rule, select):
                continue
            if not keep_suppressed and module.suppressed(f.rule, f.line):
                continue
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def _ensure_checkers_loaded() -> None:
    # Import-time registration; local imports avoid a hard cycle.
    from . import locks, sharding, surface, threads, transfers  # noqa: F401


def _run_project(modules: list[SourceModule], select: set[str] | None,
                 keep_suppressed: bool) -> list[Finding]:
    """Module checkers per module + project checkers over the whole set."""
    findings: list[Finding] = []
    for module in modules:
        findings.extend(_collect(module, select, keep_suppressed))
    project = Project(modules)
    for family, fn in PROJECT_CHECKERS:
        if select and not any(s.startswith(family) or family.startswith(s)
                              for s in select):
            continue
        for f in fn(project):
            if not _selected(f.rule, select):
                continue
            if not keep_suppressed and project.suppressed(f.rule, f.path,
                                                          f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def run_source(text: str, path: str = "<memory>",
               select: set[str] | None = None,
               keep_suppressed: bool = False) -> list[Finding]:
    """Analyze one source string (golden-fixture tests use this)."""
    return run_sources({path: text}, select, keep_suppressed)


def run_sources(sources: dict[str, str], select: set[str] | None = None,
                keep_suppressed: bool = False) -> list[Finding]:
    """Analyze a set of in-memory modules as ONE project — the fixture
    surface for the interprocedural passes (cross-module hot-path
    reachability needs at least two modules to mean anything)."""
    _ensure_checkers_loaded()
    sel = {s.upper() for s in select} if select else None
    modules = [SourceModule(path, text) for path, text in sources.items()]
    return _run_project(modules, sel, keep_suppressed)


def iter_python_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs
                if d not in ("__pycache__", ".git", ".ruff_cache")
            )
            for name in sorted(files):
                if name.endswith(".py") and name != "order_pb2.py":
                    # order_pb2 is protoc output; generated code answers to
                    # protoc, not to this linter.
                    out.append(os.path.join(root, name))
    return out


def apply_file_suppressions(findings: list[Finding],
                            root: str = "") -> list[Finding]:
    """Drop findings silenced by ``# gomelint: disable`` directives in
    their anchor files. The traced audit (GL2xx) produces findings
    outside the module-checker pipeline, so the CLI routes them through
    this to honor the same suppression syntax."""
    cache: dict[str, SourceModule | None] = {}
    out: list[Finding] = []
    for f in findings:
        path = f.path
        if root and not os.path.isabs(path):
            path = os.path.join(root, path)
        if path not in cache:
            try:
                with open(path, encoding="utf-8") as fh:
                    cache[path] = SourceModule(path, fh.read())
            except (OSError, SyntaxError):
                cache[path] = None
        mod = cache[path]
        if mod is not None and mod.suppressed(f.rule, f.line):
            continue
        out.append(f)
    return out


def run_paths(paths: list[str], select: set[str] | None = None,
              keep_suppressed: bool = False) -> list[Finding]:
    """Analyze files/directories as one project; returns sorted findings."""
    _ensure_checkers_loaded()
    sel = {s.upper() for s in select} if select else None
    findings: list[Finding] = []
    modules: list[SourceModule] = []
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        try:
            modules.append(SourceModule(path, text))
        except SyntaxError as e:
            findings.append(Finding(
                "GL000", path, e.lineno or 1, e.offset or 0,
                f"syntax error: {e.msg}",
            ))
    findings.extend(_run_project(modules, sel, keep_suppressed))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _dotted(node: ast.AST) -> str | None:
    """a.b.c -> 'a.b.c' (Names/Attributes only)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


register_rules({"GL000": "file does not parse (syntax error)"})
