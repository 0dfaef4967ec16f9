"""The port's gomelint (gome_tpu_torch.analysis) against gome_tpu's
(gome_tpu.analysis): tests/test_analysis.py's fixture sources for GL4xx,
GL7xx and hot-path reachability through both packages' run_source /
run_sources (equal findings: rule, path, line, column, message; equal
fingerprints), the suppression grammar, baselines and SARIF; every GL5xx
fixture's torch twin firing the reference's rule ids at the same lines;
the port's tree clean under its own analyzer (with its committed
baseline) and under gome_tpu's AST families (the 19 lint contracts the
port had dropped, each a case); the CLI."""

import json
import os
import subprocess
import sys
import threading

import pytest

import test_analysis as ref
from gome_tpu.analysis import callgraph as jcallgraph
from gome_tpu.analysis import core as jcore
from gome_tpu.analysis.baseline import fingerprint_findings as jfingerprint
from gome_tpu.analysis.sarif import validate_sarif
from gome_tpu_torch.analysis import callgraph as tcallgraph
from gome_tpu_torch.analysis import core as tcore
from gome_tpu_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    fingerprint_findings as tfingerprint,
    load_baseline,
    partition,
    save_baseline,
)
from gome_tpu_torch.analysis.runtime import (
    LockDisciplineError,
    OwnedLock,
    instrument,
)
from gome_tpu_torch.analysis.sarif import to_sarif

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gome_tpu_torch")


def keys(findings):
    return [(f.rule, f.path, f.line, f.col, f.message) for f in findings]


def rules_of(findings):
    return sorted({f.rule for f in findings})


# --- GL4xx / GL7xx: the reference's fixtures through both packages ---------

SINGLETON = '''
class Registry:
    def __init__(self):
        self.installed = False

    def install(self):
        self.installed = True

REGISTRY = Registry()
'''

CONDITION = '''
import threading

class Q:
    def __init__(self):
        self._cond = threading.Condition()
        self._n = 0  # guarded by self._cond

    def bump(self):
        with self._cond:
            self._n += 1
            self._cond.notify_all()
'''

TRANSITIVE = '''
import threading

class Tracker:
    def __init__(self):
        self.seen = 0

    def observe(self):
        self.seen += 1

class Feed:
    def __init__(self):
        self.seq = Tracker()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        self.seq.observe()
'''

BOTH_CONTRACTS = '''
import threading

class Both:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0  # guarded by self._lock; also  # single-writer: loop
'''

SECOND_WRITER = '''
import threading

class Sampler:
    def __init__(self):
        self.count = 0  # single-writer: the tick thread
        self._thread = threading.Thread(target=self._tick, daemon=True)

    def _tick(self):
        self.count += 1

    def reset(self):
        self.count = 0
'''

CLASS_CLAIM = '''
class Tracker:  # single-writer: the observe() caller
    def __init__(self):
        self.seen = 0

    def observe(self):
        self.seen += 1

TRACKER = Tracker()
'''

HANDOFF = '''
import threading

class Feed:
    def __init__(self):
        self._lock = threading.Lock()
        self.events = 0  # guarded by self._lock
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        self.events += 1
'''

CONTRACT_FIXTURES = {
    "bad_locks": ref.BAD_LOCKS,
    "good_locks": ref.GOOD_LOCKS,
    "condition_lock": CONDITION,
    "bad_threads": ref.BAD_THREADS,
    "good_threads": ref.GOOD_THREADS,
    "singleton": SINGLETON,
    "lowercase_module_var": SINGLETON.replace("REGISTRY", "_registry"),
    "transitive": TRANSITIVE,
    "gl703": BOTH_CONTRACTS,
    "gl704": SECOND_WRITER,
    "gl704_suppressed": SECOND_WRITER.replace(
        "    def reset(self):\n        self.count = 0\n",
        "    def reset(self):\n"
        "        self.count = 0  # gomelint: disable=GL704 — before start()\n"),
    "class_claim": CLASS_CLAIM,
    "guarded_handoff": HANDOFF,
    "line_suppression": ref.BAD_LOCKS.replace(
        "        self.total += 1",
        "        self.total += 1  # gomelint: disable=GL401 — fixture"),
    "file_suppression": "# gomelint: disable-file=GL402, GL403\n"
                        + ref.BAD_LOCKS,
    "disable_all": ref.BAD_THREADS.replace(
        "            self.state = s",
        "            self.state = s  # gomelint: disable=all"),
}


@pytest.mark.parametrize("name", sorted(CONTRACT_FIXTURES))
@pytest.mark.parametrize("keep_suppressed", [False, True])
def test_contract_families_equal_the_reference(name, keep_suppressed):
    src = CONTRACT_FIXTURES[name]
    want = jcore.run_source(src, keep_suppressed=keep_suppressed)
    got = tcore.run_source(src, keep_suppressed=keep_suppressed)
    assert keys(got) == keys(want)
    assert all(f.rule[:3] in ("GL4", "GL7") for f in got)


def test_contract_fixtures_fire_what_the_reference_tests_expect():
    """The fixtures still say what tests/test_analysis.py asserts of them
    (so the equality above is not two empty lists)."""
    run = tcore.run_source
    assert rules_of(run(ref.BAD_LOCKS)) == ["GL401", "GL402", "GL403"]
    assert rules_of(run(ref.BAD_THREADS)) == ["GL701", "GL702"]
    assert rules_of(run(SINGLETON)) == ["GL701"]
    assert rules_of(run(BOTH_CONTRACTS)) == ["GL703"]
    assert [f.line for f in run(SECOND_WRITER)] == [13]
    assert run(CONTRACT_FIXTURES["gl704_suppressed"]) == []
    assert rules_of(run(HANDOFF)) == ["GL401"]
    assert "GL401" not in rules_of(run(CONTRACT_FIXTURES["line_suppression"]))
    assert rules_of(run(CONTRACT_FIXTURES["file_suppression"])) == ["GL401"]
    assert rules_of(run(CONTRACT_FIXTURES["disable_all"])) == ["GL701"]


def test_select_composes_with_both_families():
    src = ref.BAD_LOCKS + ref.BAD_THREADS.replace("import threading\n", "")
    for select in ({"GL4"}, {"GL402"}, {"GL7"}, {"GL701", "GL403"}):
        assert keys(tcore.run_source(src, select=select)) == keys(
            jcore.run_source(src, select=select))


# --- hot-path reachability -------------------------------------------------

HOT_SOURCES = {
    "bad_transfers": ref.BAD_TRANSFERS,
    "preceding_line": ref.HOT_PREAMBLE + '''
# gomelint: hotpath
def loop(x):
    outs = device_step(x)
    return float(outs)
''',
    "through_calls": ref.HOT_PREAMBLE + '''
def loop(x):  # gomelint: hotpath
    return helper(x)

def helper(x):
    outs = device_step(x)
    return outs.tolist()
''',
    "callback": ref.HOT_PREAMBLE + '''
import threading

class Consumer:
    def start(self):  # gomelint: hotpath
        t = threading.Thread(target=self._loop)
        t.start()

    def _loop(self):
        outs = device_step(1)
        while outs.any():
            pass
''',
    "closure": ref.HOT_PREAMBLE + '''
def loop(x):  # gomelint: hotpath
    def inner():
        outs = device_step(x)
        return int(outs)
    return inner()
''',
    "cold": ref.BAD_TRANSFERS.replace("  # gomelint: hotpath", ""),
}


def hot_set(mod_core, mod_graph, sources):
    modules = [mod_core.SourceModule(p, s) for p, s in sources.items()]
    graph = mod_graph.build(mod_core.Project(modules))
    return sorted((f.module.path, f.qualname) for f in graph.funcs if f.hot)


@pytest.mark.parametrize("name", sorted(HOT_SOURCES) + ["cross_module"])
def test_hot_path_reachability_equals_the_reference(name):
    """The same functions are hot in both call graphs (the reference's
    jitted device_step is hot too: reached, though not scanned)."""
    sources = CROSS_MODULE[0] if name == "cross_module" else {
        "<memory>": HOT_SOURCES[name]}
    got = hot_set(tcore, tcallgraph, sources)
    assert got == hot_set(jcore, jcallgraph, sources)
    assert (got == []) == (name == "cold")


def test_port_tree_seeds_reach_the_engine():
    """The port's hotpath annotations cover its order path (the
    reference's test_hot_path_seeds_reach_the_engine on the port)."""
    mods = []
    for path in tcore.iter_python_files([PORT]):
        with open(path, encoding="utf-8") as fh:
            mods.append(tcore.SourceModule(path, fh.read()))
    graph = tcallgraph.build(tcore.Project(mods))
    hot = {fn.name for fn in graph.hot_functions()}
    for must in ("run_once", "_run_exact", "submit_frame", "resolve_frame",
                 "feed", "batch_step", "process_frame"):
        assert must in hot, f"{must} fell off the hot path"


# --- GL5xx: torch twins of the reference's fixtures ------------------------

# Eight lines, as ref.HOT_PREAMBLE, so a twin's findings land on the
# reference's lines.
TORCH_PREAMBLE = '''
import numpy as np
import torch


# a device producer: its result lives on the card
def device_step(x):
    return x.to("cuda") * 2
'''

TWINS = {
    "every_rule": (ref.BAD_TRANSFERS, TORCH_PREAMBLE + '''
def hot(engine, orders):  # gomelint: hotpath
    outs = device_step(orders)
    total = outs[0].item()                      # GL501
    host = outs.cpu()                           # GL502
    if outs.sum() > 0:                          # GL503
        total += 1
    for i in range(4):
        torch.cuda.synchronize()                # GL504
        up = torch.as_tensor(np.zeros(8), device="cuda")  # GL505
    return total, host, up
'''),
    "good_twin": (ref.GOOD_TRANSFERS, TORCH_PREAMBLE + '''
def hot(engine, orders):  # gomelint: hotpath
    grid = torch.as_tensor(np.zeros(8), device="cuda")  # outside the loop
    outs = device_step(grid)
    host = outs.to("cpu", non_blocking=True)    # the sanctioned fetch
    torch.cuda.current_stream().synchronize()   # drain once, not per-item
    if host.sum() > 0:                          # host-side branch
        return float(host[0])                   # host scalar: no sync
    return 0.0
'''),
    "suppression": (ref.HOT_PREAMBLE + '''
def hot(x):  # gomelint: hotpath
    outs = device_step(x)
    return outs.item()  # gomelint: disable=GL501 — single drain point
''', TORCH_PREAMBLE + '''
def hot(x):  # gomelint: hotpath
    outs = device_step(x)
    return outs.item()  # gomelint: disable=GL501 — single drain point
'''),
}
for _name in ("preceding_line", "through_calls", "callback", "closure"):
    TWINS[_name] = (HOT_SOURCES[_name],
                    HOT_SOURCES[_name].replace(ref.HOT_PREAMBLE,
                                               TORCH_PREAMBLE))
TWINS["off_hot_path"] = (
    TWINS["every_rule"][0].replace("  # gomelint: hotpath", ""),
    TWINS["every_rule"][1].replace("  # gomelint: hotpath", ""))

CROSS_MODULE = [
    {
        "svc/consumer.py": pre + '''
from engine import apply

def run_once(x):  # gomelint: hotpath
    return apply(x)
''',
        "engine/impl.py": pre + '''
def apply(x):
    outs = device_step(x)
    return float(outs)                           # GL501, hot via consumer
''',
    }
    for pre in (ref.HOT_PREAMBLE, TORCH_PREAMBLE)
]


def rule_lines(findings):
    return [(f.rule, f.path, f.line) for f in findings]


@pytest.mark.parametrize("name", sorted(TWINS) + ["cross_module"])
def test_gl5_twin_fires_the_reference_rules_at_its_lines(name):
    if name == "cross_module":
        want = jcore.run_sources(CROSS_MODULE[0])
        got = tcore.run_sources(CROSS_MODULE[1])
    else:
        want = jcore.run_source(TWINS[name][0])
        got = tcore.run_source(TWINS[name][1])
    assert rule_lines(got) == rule_lines(want)
    assert all(f.rule.startswith("GL5") for f in got)


def test_gl5_every_rule_fires():
    got = tcore.run_source(TWINS["every_rule"][1])
    assert rules_of(got) == ["GL501", "GL502", "GL503", "GL504", "GL505"]
    assert "helper" in tcore.run_source(TWINS["through_calls"][1])[0].message


@pytest.mark.parametrize("line, rule", [
    ("    return int(batch_step(cfg, books, ops)[1].n_fills[0, 0])",
     "GL501"),
    ("    return hawkes_scan(cfg, *args).lam.tolist()", "GL501"),
    ("    return np.asarray(torch.zeros(4, device=dev))", "GL502"),
    ("    return torch.zeros(4, device=dev).numpy()", "GL502"),
    ("    return torch.zeros(4, device=dev).to('cpu')", "GL502"),
    ("    return bool(x.cuda().any())", "GL503"),
    ("    assert x.to(dev).all()", "GL503"),
    ("    for v in x.to(dev): pass", "GL503"),
    ("    return 1 if x.cuda().any() else 0", "GL503"),
])
def test_gl5_torch_idioms(line, rule):
    """Each taint source (the kernel wrappers, a factory given a device,
    .to(device), .cuda()) and each sync idiom."""
    src = f"def hot(cfg, books, ops, args, x, dev):  # gomelint: hotpath\n" \
          f"{line}\n"
    assert rules_of(tcore.run_source(src)) == [rule]


@pytest.mark.parametrize("line", [
    "    return torch.zeros(4, device=dev).shape[0] + int(x.size(0))",
    "    return float(torch.zeros(4, device='cpu').sum())",
    "    return x.to(torch.int64).numpy()",
    "    return torch.zeros(4, device=dev).to('cpu', non_blocking=True)",
    "    return len(x.cuda()) + x.cuda().numel()",
    "    return x.cuda() is None",
])
def test_gl5_metadata_host_values_and_the_sanctioned_fetch_are_clean(line):
    src = f"def hot(x, dev):  # gomelint: hotpath\n{line}\n"
    assert tcore.run_source(src) == []


GL5_HELPERS = '''
import numpy as np
import torch


def gather(x, device=None):
    return torch.cat([x.cuda(), x.cuda()]).to(device)


def blocks(x):
    return [x.cuda(), x.cuda()]


def hot(x, dev):  # gomelint: hotpath
'''


@pytest.mark.parametrize("line, rules", [
    # a container of device values: iteration and truthiness read none
    ("    for b in [x.cuda(), x.cuda()]: b.add_(1)", []),
    ("    for b in blocks(x): b.add_(1)", []),
    ("    bufs = [torch.empty_like(b) for b in blocks(x)]\n"
     "    if bufs: return len(bufs)", []),
    ("    return {0: x.cuda()} or None", []),
    # its elements and what is made of it are device values
    ("    for b in blocks(x): float(b)", ["GL501"]),
    ("    return np.asarray(blocks(x))", ["GL502"]),
    ("    if blocks(x)[0].any(): pass", ["GL503"]),
    ("    a, b = blocks(x)\n    return a.item()", ["GL501"]),
    ("    return torch.cat(blocks(x)).numpy()", ["GL502"]),
    # a helper told to put its result on the CPU returns host values
    ("    return gather(x, 'cpu').numpy()", []),
    ("    return gather(x, device=torch.device('cpu')).numpy()", []),
    ("    return gather(x, dev).numpy()", ["GL502"]),
])
def test_gl5_sequences_and_cpu_results(line, rules):
    """The port's taint kinds: a Python container of device values syncs
    only where an element is read as a value, and a call given the CPU as
    a device argument returns host values."""
    assert rules_of(tcore.run_source(GL5_HELPERS + line + "\n")) == rules


def test_gl5_loop_rules_are_lexical():
    src = '''
import torch

def hot(xs, dev, ev):  # gomelint: hotpath
    for x in xs:
        ev.synchronize()
        y = x.to(dev)
        z = torch.tensor([1], device=dev)
        w = x.cuda()
    ev.synchronize()
    return y.to(dev), z, w
'''
    assert rule_lines(tcore.run_source(src)) == [
        ("GL504", "<memory>", 6), ("GL505", "<memory>", 7),
        ("GL505", "<memory>", 8), ("GL505", "<memory>", 9)]


# --- fingerprints, baselines, SARIF ----------------------------------------


@pytest.mark.parametrize("name", ["bad_locks", "bad_threads",
                                  "transitive", "singleton"])
def test_fingerprints_equal_the_reference(tmp_path, name):
    path = tmp_path / "m.py"
    src = CONTRACT_FIXTURES[name]
    path.write_text(src)
    findings = jcore.run_paths([str(path)])
    assert findings and keys(tcore.run_paths([str(path)])) == keys(findings)
    fps = [fp for _, fp in tfingerprint(findings)]
    assert fps == [fp for _, fp in jfingerprint(findings)]
    # line drift keeps them
    path.write_text("# pad\n" + src)
    drifted = tcore.run_paths([str(path)])
    assert [fp for _, fp in tfingerprint(drifted)] == fps


def test_fingerprint_occurrence_index_is_file_scoped(tmp_path):
    from gome_tpu_torch.analysis.core import Finding

    a, b = tmp_path / "a.py", tmp_path / "b.py"
    a.write_text("v = s()\nv = s()\n")
    b.write_text("v = s()\n")
    fs = [Finding("GL501", str(a), 1, 0, "m"), Finding("GL501", str(a), 2, 0,
                                                       "m"),
          Finding("GL501", str(b), 1, 0, "m")]
    got = [fp for _, fp in tfingerprint(fs)]
    assert got == [fp for _, fp in jfingerprint(fs)]
    assert len(set(got[:2])) == 2 and got[2] == got[0]


def test_baseline_roundtrip_and_partition(tmp_path):
    from gome_tpu_torch.analysis.core import Finding

    a = tmp_path / "a.py"
    a.write_text("old = sync()\nnew = sync2()\n")
    old = Finding("GL501", str(a), 1, 0, "old debt")
    new = Finding("GL502", str(a), 2, 0, "new debt")
    path = tmp_path / "baseline.json"
    save_baseline(str(path), tfingerprint([old]))
    doc = json.loads(path.read_text())
    assert doc["version"] == 1 and len(doc["fingerprints"]) == 1
    fresh, known = partition(tfingerprint([old, new]), load_baseline(
        str(path)))
    assert [f.rule for f, _ in known] == ["GL501"]
    assert [f.rule for f, _ in fresh] == ["GL502"]


def test_sarif_passes_the_reference_validator():
    from gome_tpu_torch.analysis.core import Finding

    fs = [Finding("GL501", "gome_tpu_torch/x.py", 10, 4, "a sync"),
          Finding("GL701", "gome_tpu_torch/y.py", 1, 0, "a race")]
    fps = tfingerprint(fs)
    doc = to_sarif(fps, baselined={fps[1][1]})
    assert validate_sarif(doc) == []
    res = doc["runs"][0]["results"]
    assert res[0]["level"] == "error" and res[0]["baselineState"] == "new"
    assert res[1]["suppressions"][0]["kind"] == "external"
    assert res[0]["partialFingerprints"]["gomelint/v1"] == fps[0][1]
    rules = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert {"GL401", "GL501", "GL701"} <= rules


# --- the GL4xx runtime assertion mode --------------------------------------


class _Thing:
    def __init__(self):
        self._lock = threading.Lock()
        self.counter = 0

    def bump(self):
        with self._lock:
            self.counter += 1

    def racy_bump(self):
        self.counter += 1


def test_runtime_instrument_catches_off_lock_write():
    t = _Thing()
    lock = instrument(t, ("counter",))
    t.bump()
    with pytest.raises(LockDisciplineError):
        t.racy_bump()
    assert t.counter == 1 and isinstance(lock, OwnedLock)
    assert not lock.held_by_me()


def test_runtime_instrument_on_the_ports_batcher():
    from gome_tpu_torch.bus.memory import MemoryQueue
    from gome_tpu_torch.service.batcher import FrameBatcher
    from gome_tpu_torch.types import Action, Order, OrderType, Side

    b = FrameBatcher(MemoryQueue("doOrder"), max_n=2, max_wait_s=60)
    try:
        instrument(b, ("_buf", "_spill", "_oldest", "_degraded_since"))
        for i in range(4):
            b.submit(Order(uuid="u", oid=f"o{i}", symbol="S", side=Side.BUY,
                           price=100, volume=1, action=Action.ADD,
                           order_type=OrderType.LIMIT))
        b.flush()
    finally:
        b.close()


# --- the port's tree --------------------------------------------------------


@pytest.fixture(scope="module")
def reference_on_port():
    """gome_tpu's analyzer (every AST family) over the port's tree."""
    return jcore.run_paths([PORT])


def test_port_tree_clean_under_the_reference(reference_on_port):
    assert reference_on_port == [], "\n".join(
        f.format() for f in reference_on_port)


#: The 19 findings gome_tpu's analyzer reported on the port before its
#: contracts were restored: (file, rule, the flagged line's code).
REPAIRED = [
    ("engine/batch.py", "GL802",
     "r_s = max(8, bucket(int(counts.max())), floor)"),
    ("obs/compile_journal.py", "GL402", "return self._entries is not None"),
    ("obs/compile_journal.py", "GL402", "if self._entries is None:"),
    ("obs/fleet.py", "GL402", "return self._members is not None"),
    ("obs/fleet.py", "GL402", "members = self._members"),
    ("obs/fleet.py", "GL402", "t = self._last_ok.get(name)"),
    ("obs/fleet.py", "GL402", "st = self._last.get(name)"),
    ("obs/fleet.py", "GL402", "if self._members is None:"),
    ("obs/fleet.py", "GL402", "lambda: len(self._members or ()),"),
    ("obs/fleet.py", "GL402", "lambda: self._polls,"),
    ("obs/fleet.py", "GL402", "lambda: self._unhealthy_polls,"),
    ("obs/fleet.py", "GL402", "lambda: self._degraded_polls,"),
    ("obs/fleet.py", "GL402", "lambda: self._fetch_errors,"),
    ("obs/fleet.py", "GL402", "for name in (self._members or {}):"),
    ("obs/profiler.py", "GL402", "return self._reports is not None"),
    ("obs/profiler.py", "GL402", "shards = self._shards"),
    ("obs/profiler.py", "GL402", "lambda: self._captures,"),
    ("persist/respserver.py", "GL704", "self.port = port"),
]


@pytest.mark.parametrize("path, rule, code", REPAIRED,
                         ids=[f"{p}:{r}:{c[:24]}" for p, r, c in REPAIRED])
def test_repaired_contract_holds(reference_on_port, path, rule, code):
    """Each dropped contract is back: no finding of its rule on a line
    with its code (obs/fleet.py's `members = self._members` stands twice:
    poll()'s and _poll_once()'s)."""
    full = os.path.join(PORT, path)
    with open(full, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    sites = [i + 1 for i, text in enumerate(lines)
             if text.split("#")[0].strip() == code]
    assert sites, f"{code!r} is not in {path}"
    hit = [f for f in reference_on_port
           if f.path == full and f.rule == rule and f.line in sites]
    assert hit == [], "\n".join(f.format() for f in hit)


def test_port_tree_clean_under_its_analyzer_with_its_baseline():
    findings = tcore.run_paths([PORT])
    fps = tfingerprint(findings, root=ROOT)
    base = load_baseline(os.path.join(ROOT, DEFAULT_BASELINE))
    new, known = partition(fps, base)
    assert new == [], "\n".join(f.format() for f, _ in new)
    # every baselined AST entry is a GL5 finding that still stands (the
    # GL2 entries are the traced audit's: tests/test_torch_envelope.py)
    assert {f.rule[:3] for f, _ in known} <= {"GL5"}
    assert len(known) == sum(not e["rule"].startswith("GL2")
                             for e in base.values())


# --- the CLI ----------------------------------------------------------------


def cli(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", "gome_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd)


def test_cli_exits_zero_on_the_tree_and_lists_rules(tmp_path):
    report = tmp_path / "report.json"
    r = cli("gome_tpu_torch", "--report", str(report))
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(report.read_text())
    assert doc["new"] == 0 and doc["count"] == doc["baselined"]
    rules = cli("--list-rules")
    assert rules.returncode == 0
    for rule in ("GL201", "GL202", "GL203", "GL401", "GL501", "GL505",
                 "GL701", "GL704"):
        assert rule in rules.stdout
    assert "GL101" not in rules.stdout  # no subject in the port
    assert cli("--version").stdout.startswith("gomelint 2.")
    assert cli().returncode == 2  # no paths: a usage error


def test_cli_ratchet_and_sarif(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(TWINS["suppression"][1].replace(
        "  # gomelint: disable=GL501 — single drain point", ""))
    base = tmp_path / "baseline.json"
    r = cli(str(bad), "--baseline", str(base))
    assert r.returncode == 1 and "GL501" in r.stdout
    assert cli(str(bad), "--baseline", str(base),
               "--update-baseline").returncode == 0
    r = cli(str(bad), "--baseline", str(base))
    assert r.returncode == 0 and "baselined" in r.stdout
    assert cli(str(bad), "--no-baseline").returncode == 1
    sarif = tmp_path / "out.sarif"
    r = cli(str(bad), "--no-baseline", "--format", "sarif", "--sarif",
            str(sarif))
    assert r.returncode == 1
    assert validate_sarif(json.loads(r.stdout)) == []
    assert json.loads(sarif.read_text())["runs"][0]["results"][0][
        "ruleId"] == "GL501"
    assert cli(str(bad), "--select", "GL4", "--no-baseline").returncode == 0


# --- GL8xx: the rules whose subject exists in the port ---------------------

TELEMETRY = '''
import numpy as np

def observe(skew, live, mesh):
    d = mesh.size
    counts = np.bincount(live, minlength=d)
    skew.observe(int(counts.max()) * d / len(live))
'''

GL8_SHARED = {
    "gl802_bad": (ref.GL802_BAD, "<memory>"),
    "gl802_good": (ref.GL802_GOOD, "<memory>"),
    "gl802_telemetry": (TELEMETRY, "<memory>"),
    "gl803_bad": (ref.GL803_BAD, "<memory>"),
    "gl803_fleet_router": (ref.GL803_BAD, "gome_tpu_torch/fleet/router.py"),
    "gl803_parallel_router": (ref.GL803_BAD,
                              "gome_tpu_torch/parallel/router.py"),
    "gl803_drill": (ref.GL803_BAD, "gome_tpu_torch/fleet/drill.py"),
    "gl803_suppressed": (ref.GL803_BAD.replace(
        "% n           # GL803", "% n  # gomelint: disable=GL803 — fixture"),
        "<memory>"),
}


@pytest.mark.parametrize("name", sorted(GL8_SHARED))
def test_gl802_gl803_equal_the_reference(name):
    """GL802 and GL803 are pure AST: the same findings at the same places
    as gome_tpu's (GL803's message names the port's router)."""
    src, path = GL8_SHARED[name]
    want = jcore.run_source(src, path=path, select={"GL8"})
    got = tcore.run_source(src, path=path, select={"GL8"})
    assert [k[:4] for k in keys(got)] == [k[:4] for k in keys(want)]
    if got and got[0].rule == "GL802":
        assert keys(got) == keys(want)
    assert (got != []) == (name in ("gl802_bad", "gl803_bad",
                                    "gl803_drill"))


GL805_TWINS = {
    "bad": (ref.GL805_BAD, '''
import torch
import numpy as np

def frame(mesh, books):
    books = books.to("cuda")
    host = books.cpu().numpy()
    return shard_batch(mesh, host)              # GL805
'''),
    "good": (ref.GL805_GOOD, '''
import torch
import numpy as np

def frame(mesh, books):
    books = books.to("cuda")
    return shard_batch(mesh, books)             # on-device reshard: fine
'''),
    "host_source": ('''
import numpy as np

def place(mesh, lane_ids):
    ids_np = np.asarray(lane_ids)               # param: host-born
    return shard_batch(mesh, ids_np)
''', '''
import numpy as np

def place(mesh, lane_ids):
    ids_np = np.asarray(lane_ids)               # param: host-born
    return shard_batch(mesh, ids_np)
'''),
    "through_stepper": ('''
import jax
import numpy as np
from jax.sharding import PartitionSpec as P

def make_step(impl):
    return jax.jit(impl, in_shardings=(P('sym'),), out_shardings=(P('sym'),))

def frame(impl, books):
    stepper = make_step(impl)
    books = stepper(books)
    host = np.asarray(books)
    return stepper(host)                        # GL805
''', '''
import numpy as np
import torch
from gome_tpu_torch.parallel import sharded_batch_step

# (the reference's make_step factory: the port's is sharded_batch_step)


def frame(cfg, mesh, books, ops):
    stepper = sharded_batch_step(cfg, mesh)
    books, _ = stepper(books, ops)
    host = np.asarray(books)
    return stepper(host, ops)                   # GL805
'''),
}


@pytest.mark.parametrize("name", sorted(GL805_TWINS))
def test_gl805_twin_fires_the_reference_rule_at_its_line(name):
    want = jcore.run_source(GL805_TWINS[name][0], select={"GL8"})
    got = tcore.run_source(GL805_TWINS[name][1], select={"GL8"})
    assert rule_lines(got) == rule_lines(want)


@pytest.mark.parametrize("line", [
    "    return to_device(torch.zeros(4, device=dev).tolist(), dev)",
    "    return x.cuda().to('cpu').to(dev)",
    "    return np.asarray(batch_step(c, b, o)[0]).cuda()",
])
def test_gl805_torch_round_trips(line):
    src = f"def f(x, dev, c, b, o):\n{line}\n"
    assert rules_of(tcore.run_source(src, select={"GL8"})) == ["GL805"]
    assert "round trip" in tcore.run_source(src)[0].message


def test_gl8_select_keeps_families_apart():
    assert tcore.run_source(ref.GL803_BAD, select={"GL5"}) == []
    assert rules_of(tcore.run_source(ref.GL803_BAD)) == ["GL803"]
