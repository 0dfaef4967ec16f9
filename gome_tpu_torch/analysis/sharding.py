"""GL8xx sharding & partition-consistency, the rules whose subject exists
in the port.

The port of ``gome_tpu/analysis/sharding.py``'s AST rules GL802, GL803 and
GL805 (rule ids and meanings the reference's). The port's mesh
(``parallel/mesh.py``) has no partition specs: a sharded tree is D row
blocks on their devices (``Sharded``), so the reference's spec-flow
rules have no subject here and are not ported: GL801 (out-spec →
in-spec mismatch between chained entries), GL804 (donation across a
sharding boundary; the port donates nothing) and GL806 (the committed
manifest derived from the engine's jaxprs).

  GL802  global-max padding: a per-shard row block derived from a
         reduction over ALL shards' live counts and multiplied by the
         mesh size — every shard pays the hottest shard's rows
         (``BatchEngine._grid_geometry``'s R_s; pure AST, a copy).
  GL803  ad-hoc partition hashing: a symbol→partition/lane mapping via a
         private hash (``crc32(s) % n``, ``hash(s) % n``, a local fnv)
         outside the blessed placement helpers (``fleet/router.py``'s
         ``partition_of``, ``parallel/router.py``'s ``fnv1a`` and
         ``ShardRouter``) — two hash policies in one fleet double-route
         symbols (pure AST, a copy).
  GL805  host materialization between shard-resident frames: a device
         tensor is fetched to the host (``.cpu()``, ``.numpy()``,
         ``.tolist()``, ``.to("cpu")``, ``np.asarray``/``np.array``) and
         then re-dispatched to the mesh (``shard_batch``, ``to_device``,
         ``.to(device)``/``.cuda()``, a ``sharded_batch_step`` /
         ``sharded_dense_step`` stepper) — a device→host→device round
         trip; keep it resident and move it on the card. Device values
         are analysis.transfers' sources (a ``torch.*`` call given a
         device, ``.to(device)``, ``.cuda()``, the kernel wrappers) and
         ``shard_batch`` / stepper results.

Documented limits (a linter, not a partitioner): GL805's taint is per
function and lexical (a fetch returned from a helper and re-dispatched
by its caller is missed), as the reference's.
"""

from __future__ import annotations

import ast
import os

from . import callgraph
from .core import (
    Finding,
    _dotted,
    register_checker,
    register_project_checker,
    register_rules,
)
from .transfers import _is_cpu, _kw

register_rules({
    "GL802": "per-shard row block derived from a reduction over ALL "
             "shards (global-max padding, the MULTICHIP skew tax)",
    "GL803": "ad-hoc symbol->partition hashing outside the blessed "
             "placement helpers (fleet.router.partition_of)",
    "GL805": "host materialization of device-resident state re-"
             "dispatched to the mesh (device->host->device round trip)",
})

#: Modules allowed to implement hash->partition maps: the blessed
#: placement helpers everything else must route through.
_BLESSED_PARTITION_MODULES = ("fleet/router.py", "parallel/router.py")

_HASH_LEAVES = {"crc32", "adler32", "md5", "sha1", "sha256", "blake2b",
                "fnv1a", "hash"}

#: Calls that put a value on the mesh's devices.
_PLACEMENT_LEAVES = {"shard_batch", "to_device"}
#: Factories whose result is a sharded entry (calling it dispatches).
_STEPPER_LEAVES = {"sharded_batch_step", "sharded_dense_step"}
#: Device sources (analysis.transfers' model) plus placement results.
_DEVICE_LEAVES = {"batch_step", "hawkes_scan", "shard_batch", "cuda"}
#: Host materializations: tensor methods and numpy coercions.
_FETCH_METHODS = {"cpu", "numpy", "tolist"}


def _to_target(call: ast.Call) -> ast.AST | None:
    """The device a `.to(...)` call names (None when it names none)."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return None
    target = call.args[0] if call.args else _kw(call, "device")
    if target is None:
        return None
    d = _dotted(target) or ""
    if d.startswith("torch.") and "device" not in d:
        return None  # a dtype conversion
    return target


# --- GL805: fetch-then-redispatch (project checker) -----------------------

class _RoundTripScan(ast.NodeVisitor):
    """One function body: lexical device/fetch taint. dev = values from
    the device sources and mesh placements; fetched = host
    materializations OF dev values; flag a fetched value handed to a
    mesh placement call or a sharded stepper."""

    def __init__(self, fn: callgraph.FuncNode):
        self.fn = fn
        self.dev: set[str] = set()
        self.fetched: set[str] = set()
        self.dispatch: set[str] = set()  # names bound to steppers
        self.findings: list[Finding] = []

    # -- expression classification ----------------------------------------
    def _mentions(self, node: ast.AST, names: set[str]) -> bool:
        return any(isinstance(n, ast.Name) and n.id in names
                   for n in ast.walk(node))

    def _is_device(self, node: ast.AST) -> bool:
        if self._mentions(node, self.dev):
            return True
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            d = _dotted(n.func) or ""
            leaf = d.rsplit(".", 1)[-1]
            if isinstance(n.func, ast.Attribute):
                leaf = n.func.attr
            if leaf in _DEVICE_LEAVES:
                return True
            if d.startswith("torch.") and not d.startswith("torch.cuda.") \
                    and (dev := _kw(n, "device")) is not None \
                    and not _is_cpu(dev):
                return True
            target = _to_target(n)
            if target is not None and not _is_cpu(target):
                return True
            if isinstance(n.func, ast.Name) and n.func.id in self.dispatch:
                return True  # a sharded entry's result is resident
            if isinstance(n.func, ast.Call) and (
                    _dotted(n.func.func) or "").rsplit(".", 1)[-1] \
                    in _STEPPER_LEAVES:
                return True
        return False

    def _fetch_of_device(self, node: ast.AST) -> str | None:
        """How `node` materializes a device value on the host, or None."""
        if not isinstance(node, ast.Call):
            return None
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in _FETCH_METHODS and self._is_device(func.value):
                return f".{func.attr}()"
            target = _to_target(node)
            if target is not None and _is_cpu(target) \
                    and self._is_device(func.value):
                return '.to("cpu")'
        d = _dotted(func) or ""
        leaf = d.rsplit(".", 1)[-1]
        root = d.split(".", 1)[0]
        if root in ("np", "numpy") and leaf in ("asarray", "array") \
                and node.args and (self._is_device(node.args[0])
                                   or self._fetch_of_device(node.args[0])):
            return d
        return None

    def _is_fetched(self, node: ast.AST) -> bool:
        return self._mentions(node, self.fetched) \
            or self._fetch_of_device(node) is not None

    # -- statements --------------------------------------------------------
    def _assign(self, targets, value) -> None:
        fetched = self._is_fetched(value)
        dev = not fetched and self._is_device(value)
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    self.fetched.discard(n.id)
                    self.dev.discard(n.id)
                    if fetched:
                        self.fetched.add(n.id)
                    elif dev:
                        self.dev.add(n.id)

    def visit_Assign(self, node):
        self.generic_visit(node)
        value = node.value
        if isinstance(value, ast.Call) and (
                _dotted(value.func) or "").rsplit(".", 1)[-1] \
                in _STEPPER_LEAVES:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.dispatch.add(t.id)
            return
        self._assign(node.targets, value)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self.generic_visit(node)
            self._assign([node.target], node.value)

    def _placement(self, node: ast.Call) -> tuple[str, list] | None:
        """(what, the values it places) when `node` puts values on the
        mesh's devices, else None."""
        func = node.func
        leaf = (_dotted(func) or "").rsplit(".", 1)[-1]
        if leaf in _PLACEMENT_LEAVES:
            return f"{leaf}()", list(node.args)
        if isinstance(func, ast.Name) and func.id in self.dispatch:
            return f"{func.id}()", list(node.args)
        if isinstance(func, ast.Call) and (
                _dotted(func.func) or "").rsplit(".", 1)[-1] \
                in _STEPPER_LEAVES:
            return f"{_dotted(func.func)}(...)()", list(node.args)
        if isinstance(func, ast.Attribute):
            if func.attr == "cuda":
                return ".cuda()", [func.value]
            target = _to_target(node)
            if target is not None and not _is_cpu(target):
                return ".to(device)", [func.value]
        return None

    def visit_Call(self, node):
        self.generic_visit(node)
        placed = self._placement(node)
        if placed is None:
            return
        what, args = placed
        for arg in args:
            how = self._fetch_of_device(arg)
            if how is None and self._mentions(arg, self.fetched):
                how = "a host copy"
            if how is not None:
                self.findings.append(Finding(
                    "GL805", self.fn.module.path, node.lineno,
                    node.col_offset,
                    f"{what} re-dispatches a value materialized to "
                    f"host via {how} — device->host->device round trip; "
                    "keep it device-resident (move the original on the "
                    "card, or shard the host source before upload) "
                    f"[in {self.fn.qualname}]",
                ))

    def visit_FunctionDef(self, node):
        if node is self.fn.node:
            for stmt in node.body:
                self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        if node is self.fn.node:
            self.visit(node.body)

    def run(self) -> list[Finding]:
        node = self.fn.node
        if isinstance(node, ast.Lambda):
            self.visit(node.body)
        else:
            for stmt in node.body:
                self.visit(stmt)
        return self.findings


def check_round_trips(project) -> list[Finding]:
    findings: list[Finding] = []
    for fn in callgraph.build(project).funcs:
        findings.extend(_RoundTripScan(fn).run())
    return findings


register_project_checker("GL8", check_round_trips)


# --- GL802/GL803: module checkers (copies) --------------------------------

def _is_mesh_size(node: ast.expr) -> bool:
    """`<something>.mesh.size` / `mesh.size` — the shard count."""
    if isinstance(node, ast.Attribute) and node.attr == "size":
        d = _dotted(node.value) or ""
        return d.split(".")[-1].endswith("mesh")
    return False


class _GeometryScan(ast.NodeVisitor):
    """GL802 within one function: a variable reduced over ALL shards'
    counts (bincount -> .max()/np.max) that is later multiplied by the
    mesh size is the global-max padding idiom. One finding per derived
    variable, anchored at its derivation."""

    def __init__(self, module, fn_node):
        self.module = module
        self.fn = fn_node
        self.counts: set[str] = set()     # np.bincount products
        self.gmax: dict[str, int] = {}    # global-max vars -> def line
        self.mesh: set[str] = set()       # mesh-size vars
        self.findings: list[Finding] = []
        self.reported: set[str] = set()

    def _has_global_reduction(self, node: ast.AST) -> bool:
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            # counts.max() — argless full reduction of a shard histogram
            if isinstance(n.func, ast.Attribute) and n.func.attr == "max" \
                    and not n.args and not n.keywords:
                recv = _dotted(n.func.value) or ""
                if recv.split(".")[-1] in self.counts:
                    return True
            d = _dotted(n.func) or ""
            if d in ("np.max", "numpy.max") and n.args:
                first = _dotted(n.args[0]) or ""
                if first.split(".")[-1] in self.counts:
                    return True
        return False

    def visit_Assign(self, node):
        self.generic_visit(node)
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not names:
            return
        value = node.value
        d = _dotted(value.func) if isinstance(value, ast.Call) else None
        if d and d.rsplit(".", 1)[-1] == "bincount":
            self.counts.update(names)
            return
        if _is_mesh_size(value):
            self.mesh.update(names)
            return
        if self._has_global_reduction(value) \
                or any(isinstance(n, ast.Name) and n.id in self.gmax
                       for n in ast.walk(value)):
            for name in names:
                self.gmax.setdefault(name, node.lineno)

    def visit_BinOp(self, node):
        self.generic_visit(node)
        if not isinstance(node.op, ast.Mult):
            return
        sides = (node.left, node.right)
        mesh_side = any(
            (isinstance(s, ast.Name) and s.id in self.mesh)
            or _is_mesh_size(s) for s in sides)
        gm = next((s.id for s in sides if isinstance(s, ast.Name)
                   and s.id in self.gmax), None)
        if mesh_side and gm is not None and gm not in self.reported:
            self.reported.add(gm)
            self.findings.append(Finding(
                "GL802", self.module.path, self.gmax[gm], 0,
                f"per-shard row block {gm!r} is a reduction over ALL "
                f"shards' live counts and is multiplied by the mesh size "
                f"(line {node.lineno}) — every shard pads to the hottest "
                "shard's rows (the MULTICHIP_r06 skew tax); derive the "
                "block per shard",
            ))

    def visit_FunctionDef(self, node):
        if node is self.fn:
            for stmt in node.body:
                self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def run(self) -> list[Finding]:
        for stmt in self.fn.body:
            self.visit(stmt)
        return self.findings


def _check_geometry(module) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.extend(_GeometryScan(module, node).run())
    return findings


def _check_partition_hash(module) -> list[Finding]:
    """GL803: `hashlike(sym) % n` outside the blessed router modules."""
    path = module.path.replace(os.sep, "/")
    if path.endswith(_BLESSED_PARTITION_MODULES):
        return []
    findings: list[Finding] = []
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.Mod)):
            continue
        left = node.left
        if isinstance(left, ast.Call):
            leaf = (_dotted(left.func) or "").rsplit(".", 1)[-1]
            if leaf in _HASH_LEAVES:
                findings.append(Finding(
                    "GL803", module.path, node.lineno, node.col_offset,
                    f"ad-hoc {leaf}()-modulo partition map — route "
                    "symbol placement through gome_tpu_torch.fleet.router."
                    "partition_of (one policy tree-wide; a private hash "
                    "double-routes symbols)",
                ))
    return findings


def _check_module(module) -> list[Finding]:
    return _check_geometry(module) + _check_partition_hash(module)


register_checker("GL8", _check_module)
