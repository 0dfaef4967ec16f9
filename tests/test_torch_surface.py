"""The port's GL9xx compile-surface family (gome_tpu_torch.analysis
.surface) against gome_tpu's (tests/test_analysis.py's GL9xx cases): each
case's twin in the port's idiom (no jax.jit: the device entries are the
port's declared DEVICE_ENTRIES) firing the same rule on the same defect,
the port's tree clean under its own family, the port's combo universe
against gome_tpu's committed one, and compile-journal exports of the same
frames through both packages inside both universes."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from gome_tpu.analysis import core as jcore
from gome_tpu.analysis import surface as jsurface
from gome_tpu.utils.metrics import Registry as JRegistry
from gome_tpu_torch.analysis import core as tcore
from gome_tpu_torch.analysis import surface
from gome_tpu_torch.analysis.surface import (
    DEVICE_ENTRIES,
    check_journal_escape,
    check_universe,
    combo_escapes,
    extract_universe,
    journal_escapes,
    load_universe,
    save_universe,
)
from gome_tpu_torch.engine.frames import COMBO_FIELDS
from gome_tpu_torch.utils.metrics import Registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gome_tpu_torch")
REF_UNIVERSE = os.path.join(ROOT, "gome_tpu", "analysis",
                            "combo_universe.json")
PORT_UNIVERSE = os.path.join(PORT, "analysis", "combo_universe.json")

#: The fixtures' module path: compact_accum there is a declared device
#: entry (DEVICE_ENTRIES), the twin of the reference fixture's jit factory.
FRAMES = "engine/frames.py"


def rules_of(findings):
    return sorted({f.rule for f in findings})


def keys(findings):
    return [(f.rule, f.path, f.line, f.col, f.message) for f in findings]


def _gl9(src, path=FRAMES, **kw):
    return tcore.run_source(src, path=path, select={"GL9"}, **kw)


SURFACE_OK = '''
import torch

# gomesurface: quantizer
def _pow2(n):
    return 1 << max(n - 1, 0).bit_length()

# gomesurface: quantizer
def _pow4(n):
    v = 1
    while v < n:
        v *= 4
    return v

COMBO_FIELDS = ("n_rows", "cap_g")

def compact_accum(outs, acc, rows, cap):
    acc[:rows, :cap] = outs[:rows, :cap]
    return acc

# gomesurface: combo(build)
def submit(eng, ops, counts):  # gomelint: hotpath
    rows = _pow2(len(ops))
    cap = _pow2(counts.max())
    combo = (rows, cap)
    eng.record_combo(combo)
    return compact_accum(ops, torch.zeros((rows, cap)), rows, cap)

# gomesurface: combo(replay), precompile
def boot_replay(eng):
    for combo in eng.combos():
        (n_rows, cap_g) = combo
        compact_accum(torch.zeros((n_rows, cap_g)),
                      torch.zeros((n_rows, cap_g)), n_rows, cap_g)

# gomesurface: combo(persist)
def manifest(eng):
    return {"combos": sorted(eng.combos())}
'''

#: A combo from the committed universe's interior (engine defaults: 8
#: rows, full 8-step grid, cap class 64, dense, the floors).
COMBO_IN = (8, 8, 64, True, 64, 4, 64, 64, 8)


# --- GL901–GL904: the reference's fixtures, twinned ------------------------

def test_surface_complete_fixture_is_clean(tmp_path):
    """The whole contract composed: quantized build, agreeing replay
    unpack, persist through combos(), precompile covering the device
    entry — silent for GL901–GL904, and for GL905 (a universe saved from
    the extraction) and GL906 (a journal of an interior combo)."""
    assert _gl9(SURFACE_OK) == []
    universe = str(tmp_path / "universe.json")
    save_universe(universe, extract_universe())
    assert check_universe(universe) == []
    journal = tmp_path / "journal.json"
    journal.write_text(json.dumps(
        {"schema": "gome-compile-journal/1",
         "entries": [{"entry": "frame_dispatch", "key": list(COMBO_IN)}]}))
    assert check_journal_escape(str(journal), universe) == []


def test_gl901_raw_reduction_to_combo():
    bad = SURFACE_OK.replace("_pow2(len(ops))", "len(ops)")
    findings = _gl9(bad)
    assert rules_of(findings) == ["GL901"]
    msgs = "\n".join(f.message for f in findings)
    assert "combo dimension 'n_rows'" in msgs
    assert "a recorded combo" in msgs  # record_combo's argument: the sink
    assert "[in submit]" in msgs


def test_gl901_attribute_reduction_is_a_source():
    bad = SURFACE_OK.replace("_pow2(counts.max())", "counts.max()")
    findings = _gl9(bad)
    assert rules_of(findings) == ["GL901"]
    assert any("combo dimension 'cap_g'" in f.message for f in findings)


@pytest.mark.parametrize("expr", [
    "counts.item()",
    "torch.count_nonzero(counts)",
    "int(torch.cumsum(counts, 0)[-1])",
    "max(torch.bincount(counts))",
])
def test_gl901_tensor_reductions_are_sources(expr):
    """The PyTorch forms: `.item()`, torch's reductions, and int()/max()
    of a tensor-valued expression all read per-frame data."""
    bad = SURFACE_OK.replace("_pow2(counts.max())", expr)
    findings = _gl9(bad)
    assert rules_of(findings) == ["GL901"], expr
    assert any("combo dimension 'cap_g'" in f.message for f in findings)


def test_gl901_tensor_names_and_shapes():
    """A name bound from a torch call is a tensor; int() of it is a
    source, int() of its .shape is not (buffer shapes are lattice
    values); the quantizer launders either."""
    src = SURFACE_OK.replace(
        "    cap = _pow2(counts.max())\n",
        "    acc = torch.zeros((64, 8))\n"
        "    cap = int(acc.shape[0])\n")
    assert _gl9(src) == []
    raw = src.replace("int(acc.shape[0])", "int(acc[0, 0])")
    findings = _gl9(raw)
    assert rules_of(findings) == ["GL901"]
    laundered = src.replace("int(acc.shape[0])", "_pow2(int(acc[0, 0]))")
    assert _gl9(laundered) == []


def test_gl901_quantizer_alias_launders():
    """`bucket = _pow2 if first else _pow4; bucket(len(ops))` — an alias of
    a quantizer is a quantizer (the batch.py first-grow idiom)."""
    src = SURFACE_OK + '''
def resize(eng, ops, first):  # gomelint: hotpath
    bucket = _pow2 if first else _pow4
    m = bucket(len(ops))
    combo = (m, 8)
    eng.record_combo(combo)
'''
    assert _gl9(src) == []
    raw = src.replace("bucket(len(ops))", "len(ops)")
    assert rules_of(_gl9(raw)) == ["GL901"]


def test_gl902_build_arity_drift():
    bad = SURFACE_OK.replace("combo = (rows, cap)", "combo = (rows, cap, 7)")
    findings = _gl9(bad)
    assert rules_of(findings) == ["GL902"]
    assert "3 element(s)" in findings[0].message
    assert "COMBO_FIELDS declares 2" in findings[0].message


def test_gl902_build_order_drift_via_provenance():
    bad = SURFACE_OK.replace("combo = (rows, cap)", "combo = (cap, rows)")
    findings = _gl9(bad)
    assert rules_of(findings) == ["GL902"]
    assert all("drifted" in f.message for f in findings)


def test_gl902_replay_unpack_drift_and_oob_subscript():
    bad = SURFACE_OK.replace("(n_rows, cap_g) = combo",
                             "(cap_g, n_rows) = combo")
    findings = _gl9(bad)
    assert rules_of(findings) == ["GL902"]
    assert "replay unpack binds (cap_g, n_rows)" in findings[0].message

    oob = SURFACE_OK.replace("n_rows, cap_g)\n\n# gomesurface: combo(persist)",
                             "n_rows, combo[5])\n\n# gomesurface: "
                             "combo(persist)")
    assert oob != SURFACE_OK
    findings = _gl9(oob)
    assert rules_of(findings) == ["GL902"]
    assert "combo[5] is outside the 2-field combo layout" \
        in findings[0].message


def test_gl902_persist_must_read_the_combo_set():
    bad = SURFACE_OK.replace('{"combos": sorted(eng.combos())}', "{}")
    findings = _gl9(bad)
    assert rules_of(findings) == ["GL902"]
    assert "never reads the recorded combo set" in findings[0].message


def test_gl902_missing_role_annotation():
    bad = SURFACE_OK.replace("# gomesurface: combo(persist)\n", "")
    findings = _gl9(bad)
    assert rules_of(findings) == ["GL902"]
    assert "combo(persist)" in findings[0].message


def test_gl902_seen_combos_reach_through_regression():
    """A `_seen_combos` read anywhere outside engine/batch.py (the
    chokepoint's home) fires; the port's obs/timeline.py reads
    combo_count() instead."""
    reach = '''
def rollup(eng):
    return {"combos": len(eng._seen_combos)}
'''
    findings = _gl9(reach, path="obs/timeline.py")
    assert rules_of(findings) == ["GL902"]
    assert "record_combo" in findings[0].message
    assert _gl9(reach, path="engine/batch.py") == []


def test_gl903_uncovered_hot_entry():
    bad = SURFACE_OK.replace("# gomesurface: combo(replay), precompile",
                             "# gomesurface: combo(replay)")
    findings = _gl9(bad)
    assert rules_of(findings) == ["GL903"]
    assert [f.line for f in findings] == [
        SURFACE_OK.splitlines().index(
            "def compact_accum(outs, acc, rows, cap):") + 1]
    assert "device entry compact_accum" in findings[0].message
    assert "precompile" in findings[0].message


def test_gl903_only_declared_entries_count():
    """compact_accum outside a declared module is no device entry."""
    bad = SURFACE_OK.replace("# gomesurface: combo(replay), precompile",
                             "# gomesurface: combo(replay)")
    assert _gl9(bad, path="obs/other.py") == []
    assert ("engine/frames.py", "compact_accum") in DEVICE_ENTRIES


def test_gl903_silent_without_a_replay_system():
    """No precompile annotation AND no COMBO_FIELDS: no replay system to
    register into, so GL903 would be unactionable."""
    src = '''
def compact_accum(x):
    return x

def hot(x):  # gomelint: hotpath
    return compact_accum(x)
'''
    assert _gl9(src) == []


GL904_BAD = '''
def drain(eng):  # gomelint: hotpath
    reap(eng)

def reap(eng):
    eng.reset_geometry_floors()
    eng._seen_combos.clear()
'''


def test_gl904_hot_path_resets():
    findings = _gl9(GL904_BAD, path="engine/batch.py")
    assert rules_of(findings) == ["GL904"]
    msgs = "\n".join(f.message for f in findings)
    assert "reset_geometry_floors()" in msgs
    assert "_seen_combos.clear()" in msgs
    good = GL904_BAD.replace("  # gomelint: hotpath", "")
    assert _gl9(good, path="engine/batch.py") == []


def test_gl9_suppression_composes():
    src = '''
def drain(eng):  # gomelint: hotpath
    eng.reset_geometry_floors()  # gomelint: disable=GL904 — boot drain
'''
    assert _gl9(src, path="engine/batch.py") == []


@pytest.mark.parametrize("name, src, path", [
    ("gl904", GL904_BAD, "engine/batch.py"),
    ("reach-through", "def r(eng):\n    return len(eng._seen_combos)\n",
     "obs/timeline.py"),
    ("arity", SURFACE_OK.replace("import torch\n", "").replace(
        "combo = (rows, cap)", "combo = (rows, cap, 7)"), "x/build.py"),
    ("unpack", SURFACE_OK.replace("import torch\n", "").replace(
        "(n_rows, cap_g) = combo", "(cap_g, n_rows) = combo"), "x/build.py"),
])
def test_shared_rules_give_the_references_findings(name, src, path):
    """GL902 and GL904 have one subject in both packages: the same
    source gives the same findings (rule, path, line, column, message)."""
    want = jcore.run_source(src, path=path, select={"GL902", "GL904"})
    got = tcore.run_source(src, path=path, select={"GL902", "GL904"})
    assert want, name
    assert keys(got) == keys(want)


# --- the port's tree ---------------------------------------------------------

@pytest.fixture(scope="module")
def port_sources():
    return {p: open(p, encoding="utf-8").read()
            for p in tcore.iter_python_files([PORT])}


def test_whole_tree_clean_for_surface_family(port_sources):
    """Every quantizer annotated, the combo sites agree with COMBO_FIELDS,
    every declared device entry replays from precompile_combos, no reset
    is hot-reachable: no GL9xx finding and no GL9xx baseline entry."""
    findings = tcore.run_sources(port_sources, select={"GL9"})
    assert findings == [], "\n".join(f.format() for f in findings)
    with open(os.path.join(PORT, "analysis", "baseline.json")) as fh:
        assert "GL9" not in fh.read()


def test_every_declared_entry_is_a_hot_function(port_sources):
    project = tcore.Project([tcore.SourceModule(p, t)
                             for p, t in port_sources.items()])
    idx = surface._Surface(project)
    found = {(f.module.path.replace(os.sep, "/").split("gome_tpu_torch/")[1],
              f.qualname) for f in idx.entries}
    assert found == set(DEVICE_ENTRIES)
    assert all(f.hot for f in idx.entries)


@pytest.mark.parametrize("mutation", [
    "no-precompile", "raw-m_pad", "swapped", "raw-totals"])
def test_tree_mutation_fires(port_sources, mutation):
    """The family is not blind on the real tree: each defect injected into
    the port's engine fires its rule."""
    frames = os.path.join(PORT, "engine", "frames.py")
    src = port_sources[frames]
    edit = {
        "no-precompile": ("# gomesurface: combo(replay), precompile",
                          "# gomesurface: combo(replay)", "GL903"),
        "raw-m_pad": ('m_pad = _packed_axis(len(meta["arrival"]))',
                      'm_pad = len(meta["arrival"])', "GL901"),
        "swapped": ("m_pad, k_rec, e_fills, e_cancels,",
                    "k_rec, m_pad, e_fills, e_cancels,", "GL902"),
        "raw-totals": ("e_cancels, int(totals_acc.shape[0]),",
                       "e_cancels, len(totals_acc),", "GL901"),
    }[mutation]
    assert edit[0] in src
    mutated = dict(port_sources, **{frames: src.replace(edit[0], edit[1])})
    findings = tcore.run_sources(mutated, select={"GL9"})
    assert rules_of(findings) == [edit[2]], [f.format() for f in findings]
    if mutation == "no-precompile":
        assert {f.message.split()[2] for f in findings} == {
            q for _, q in DEVICE_ENTRIES}


# --- GL905: the combo universe ----------------------------------------------

def test_universe_extract_is_deterministic_and_total():
    u = extract_universe()
    assert u["fields"] == list(COMBO_FIELDS)
    assert list(u["dimensions"]) == list(COMBO_FIELDS)
    for name, dim in u["dimensions"].items():
        assert dim["cardinality"] >= 1, name
        assert "UNKNOWN" not in dim["generator"], name
    assert u["cardinality_log2_bound"] > 0
    assert u["bounds"]["max_frame_ops"] == 1 << 20
    assert extract_universe() == u


def test_committed_universe_matches_tree():
    findings = check_universe()
    assert findings == [], "\n".join(f.format() for f in findings)
    assert load_universe(PORT_UNIVERSE) == json.loads(
        json.dumps(extract_universe()))


#: Fields of the port's universe that differ from gome_tpu's committed
#: one, with the reason. The bounds and every dimension's kind, min, max
#: and cardinality agree; only prose differs.
UNIVERSE_DIFFERENCES = {
    "note": "names the port's CLI (python -m gome_tpu_torch.analysis) "
            "instead of scripts/gomelint.py --jaxpr",
    "generator": "each dimension's generator is written from the port's "
                 "code (e.g. n_rows' floor is max(8, ...) in "
                 "BatchEngine._grid_geometry, not a Pallas sublane floor)",
}


def test_universe_parity_with_the_reference():
    port, ref = extract_universe(), load_universe(REF_UNIVERSE)
    assert ref is not None
    assert port["bounds"] == ref["bounds"]
    assert port["fields"] == ref["fields"]
    assert port["cardinality_log2_bound"] == ref["cardinality_log2_bound"]
    assert port["version"] == ref["version"] and port["tool"] == ref["tool"]
    differ = {k for k in set(port) | set(ref) if port.get(k) != ref.get(k)}
    assert differ - {"dimensions"} == set(UNIVERSE_DIFFERENCES) - {
        "generator"}
    for name in COMBO_FIELDS:
        p, r = port["dimensions"][name], ref["dimensions"][name]
        for key in ("kind", "min", "max", "cardinality", "values"):
            assert p.get(key) == r.get(key), (name, key)
        assert {k for k in set(p) | set(r) if p.get(k) != r.get(k)} <= {
            "generator"}, name
    # The reference's own extraction agrees with its committed file.
    assert jsurface.check_universe(REF_UNIVERSE) == []


def test_universe_missing_drift_and_dimension_churn(tmp_path):
    path = str(tmp_path / "universe.json")
    missing = check_universe(path)
    assert rules_of(missing) == ["GL905"]
    assert "no committed combo universe" in missing[0].message

    save_universe(path, extract_universe())
    assert check_universe(path) == []

    doc = load_universe(path)
    doc["dimensions"]["t_grid"]["max"] = 2048
    save_universe(path, doc)
    drift = check_universe(path)
    assert rules_of(drift) == ["GL905"]
    assert "t_grid" in drift[0].message and "max" in drift[0].message

    doc["dimensions"]["t_grid"]["max"] = 1024
    doc["bounds"]["max_t"] = 64
    doc["dimensions"].pop("m_pad")
    doc["dimensions"]["imaginary"] = {"kind": "enum", "values": [1]}
    save_universe(path, doc)
    msgs = [f.message for f in check_universe(path)]
    assert any("bounds changed" in m for m in msgs)
    assert any("m_pad: dimension is new" in m for m in msgs)
    assert any("imaginary: dimension vanished" in m for m in msgs)


def cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "gome_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=ROOT)


def test_cli_universe_flow(tmp_path):
    """A missing universe fails the GL9 gate with GL905 (by default: no
    --jaxpr in the port); --update-universe writes it and exits 0."""
    path = str(tmp_path / "universe.json")
    r = cli("gome_tpu_torch/analysis", "--select", "GL9", "--universe",
            path, "--no-baseline")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "GL905" in r.stdout

    r = cli("gome_tpu_torch/analysis", "--select", "GL9", "--universe",
            path, "--update-universe")
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(open(path).read())
    assert len(doc["dimensions"]) == 9
    assert doc["tool"].startswith("gomelint 2.")

    r = cli("gome_tpu_torch/analysis", "--select", "GL9", "--universe",
            path, "--no-baseline")
    assert r.returncode == 0, r.stdout + r.stderr
    # Another family selected: GL905 does not run.
    r = cli("gome_tpu_torch/analysis", "--select", "GL4", "--universe",
            str(tmp_path / "absent.json"), "--no-baseline")
    assert r.returncode == 0, r.stdout + r.stderr


# --- GL906: runtime escape ---------------------------------------------------

def test_combo_escapes_against_committed_universe():
    u = load_universe(PORT_UNIVERSE)
    assert u is not None
    assert combo_escapes(COMBO_IN, u) == []

    off_lattice = (8, 48) + COMBO_IN[2:]
    [why] = combo_escapes(off_lattice, u)
    assert "t_grid=48" in why and "pow2" in why

    not_pow4 = COMBO_IN[:4] + (128,) + COMBO_IN[5:]
    [why] = combo_escapes(not_pow4, u)
    assert "m_pad=128" in why

    assert "arity" in combo_escapes(COMBO_IN[:3], u)[0]


def test_journal_escapes_wire_forms():
    entry = {"entry": "frame_dispatch", "key": list(COMBO_IN)}
    for doc in ([entry],
                {"entries": [entry]},
                {"schema": "gome-compile-journal/1", "entries": [entry]},
                {"compile_journal": {"entries": [entry]}},
                {"journal": {"entries": [entry]}}):
        assert surface._journal_entries(doc) == [entry]
    assert surface._journal_entries({"other": 1}) == []
    assert surface._journal_entries("junk") == []

    u = {"fields": ["n"], "dimensions": {"n": {"kind": "pow2",
                                               "min": 8, "max": 64,
                                               "cardinality": 4}}}
    entries = [
        {"entry": "frame_dispatch", "key": [32]},
        {"entry": "frame_dispatch", "key": [48]},
        {"entry": "frame_dispatch", "key": [48]},
        {"entry": "nvcc_build", "key": ["match_step"]},
        {"entry": "frame_dispatch", "key": "notakey"},
    ]
    assert journal_escapes(entries, u) == [((48,), ["n=48 outside pow2 "
                                                    "[8..64]"])]


def test_check_journal_escape_files(tmp_path):
    journal = tmp_path / "journal.json"
    journal.write_text(json.dumps(
        {"entries": [{"entry": "frame_dispatch", "key": list(COMBO_IN)}]}))
    assert check_journal_escape(str(journal)) == []

    missing = check_journal_escape(str(journal),
                                   str(tmp_path / "absent.json"))
    assert rules_of(missing) == ["GL906"]
    assert "no committed combo universe" in missing[0].message

    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    broken = check_journal_escape(str(bad))
    assert rules_of(broken) == ["GL906"]
    assert "unreadable" in broken[0].message

    journal.write_text(json.dumps(
        {"entries": [{"entry": "frame_dispatch",
                      "key": [8, 48] + list(COMBO_IN[2:])}]}))
    escape = check_journal_escape(str(journal))
    assert rules_of(escape) == ["GL906"]
    assert "escapes the predicted universe" in escape[0].message
    assert "t_grid=48" in escape[0].message


def test_cli_journal_flag(tmp_path):
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps(
        {"entries": [{"entry": "frame_dispatch", "key": list(COMBO_IN)}]}))
    r = cli("gome_tpu_torch/analysis/surface.py", "--select", "GL9",
            "--no-baseline", "--journal", str(ok))
    assert r.returncode == 0, r.stdout + r.stderr

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(
        {"entries": [{"entry": "frame_dispatch",
                      "key": [8, 48] + list(COMBO_IN[2:])}]}))
    r = cli("gome_tpu_torch/analysis/surface.py", "--select", "GL9",
            "--no-baseline", "--journal", str(bad))
    assert r.returncode == 1
    assert "GL906" in r.stdout


def mixed_frames():
    """tests/test_analysis.py's witness frames: adds and dels over six
    symbols, frames of 64, 17 and 128 ops."""
    out = []
    rng = np.random.default_rng(7)
    for i, n in enumerate((64, 17, 128)):
        action = np.ones(n, np.int64)
        action[rng.random(n) < 0.25] = 2
        out.append(dict(
            n=n,
            action=action,
            side=rng.integers(0, 2, n).astype(np.int64),
            kind=np.zeros(n, np.int64),
            price=rng.integers(99_000, 101_000, n).astype(np.int64),
            volume=rng.integers(1, 10, n).astype(np.int64),
            symbols=[f"s{j}" for j in range(6)],
            symbol_idx=rng.integers(0, 6, n).astype(np.int64),
            uuids=["u0"],
            uuid_idx=np.zeros(n, np.int64),
            oids=np.char.add(
                "w", np.arange(i * 4096, i * 4096 + n).astype("U8")
            ).astype("S"),
        ))
    return out


def test_gl906_dynamic_witness_drill():
    """On a live port engine: every combo a discovery run records lies
    inside the committed universe, and a fresh engine that precompiles
    them replays the flow with the journal armed and silent."""
    from gome_tpu_torch.engine import frames
    from gome_tpu_torch.engine.batch import BatchEngine
    from gome_tpu_torch.engine.book import BookConfig
    from gome_tpu_torch.obs import CompileJournal

    def mk():
        return BatchEngine(BookConfig(cap=64, max_fills=4, dtype="int32"),
                           n_slots=16, max_t=8, device="cpu")

    universe = load_universe(PORT_UNIVERSE)
    e1 = mk()
    for f in mixed_frames():
        frames.apply_frame_fast(e1, f)
    discovered = sorted(e1.combos())
    assert discovered
    for combo in discovered:
        assert combo_escapes(combo, universe) == [], combo

    e2 = mk()
    assert frames.precompile_combos(e2, e1.shape_manifest()["combos"]) \
        == len(discovered)
    journal = CompileJournal().install(keep_n=64, registry=Registry())
    old = frames.JOURNAL
    frames.JOURNAL = journal
    try:
        for f in mixed_frames():
            frames.apply_frame_fast(e2, f)
    finally:
        frames.JOURNAL = old
        journal.disable()
    assert [e for e in journal.entries()
            if e["entry"] == "frame_dispatch"] == []
    assert journal_escapes(journal.export()["entries"], universe) == []


def test_injected_escape_is_reported():
    """A combo injected off the lattice into a real export is reported by
    both packages' checks against both universes."""
    from gome_tpu_torch.engine import frames
    from gome_tpu_torch.engine.batch import BatchEngine
    from gome_tpu_torch.engine.book import BookConfig
    from gome_tpu_torch.obs import CompileJournal

    eng = BatchEngine(BookConfig(cap=64, max_fills=4, dtype="int32"),
                      n_slots=16, max_t=8, device="cpu")
    journal = CompileJournal().install(keep_n=64, registry=Registry())
    old = frames.JOURNAL
    frames.JOURNAL = journal
    try:
        for f in mixed_frames():
            frames.apply_frame_fast(eng, f)
        inside = journal.export()
        # n_rows 24: a row count no quantizer makes.
        journal.record("frame_dispatch", (24,) + COMBO_IN[1:], 0.0)
        export = journal.export()
    finally:
        frames.JOURNAL = old
        journal.disable()
    for u in (load_universe(PORT_UNIVERSE), load_universe(REF_UNIVERSE)):
        assert journal_escapes(inside["entries"], u) == []
        for check in (journal_escapes, jsurface.journal_escapes):
            [(combo, why)] = check(export["entries"], u)
            assert combo == (24,) + COMBO_IN[1:]
            assert why == ["n_rows=24 outside pow2 [8..65536]"]


def test_journal_parity_across_packages(tmp_path):
    """The same Zipf frames through gome_tpu's engine and the port's, each
    with its compile journal armed: the same first-seen dispatch combos,
    and each export has 0 GL906 escapes under both universes (both
    packages' checks, the CLI's file form included)."""
    import gome_tpu.obs.compile_journal as jcj
    from gome_tpu.engine import BookConfig as JConfig
    from gome_tpu.engine.orchestrator import MatchEngine as JEngine
    from gome_tpu.utils.streams import multi_symbol_stream
    from gome_tpu_torch.engine import BookConfig, MatchEngine
    from gome_tpu_torch.obs import JOURNAL
    from test_torch_frames import frame_of

    orders = multi_symbol_stream(n=1600, n_symbols=96, zipf_a=1.2,
                                 cancel_prob=0.3, seed=11)
    frames = [frame_of(orders[i:i + 400]) for i in range(0, 1600, 400)]
    j = JEngine(JConfig(cap=128, max_fills=4, dtype=jnp.int32),
                n_slots=128, max_t=8)
    t = MatchEngine(BookConfig(cap=128, max_fills=4, dtype="int32"),
                    n_slots=128, max_t=8, device="cpu")
    exports = {}
    for side, eng, journal, reg in (("j", j, jcj.JOURNAL, JRegistry()),
                                    ("t", t, JOURNAL, Registry())):
        journal.install(keep_n=256, registry=reg)
        try:
            for cols in frames:
                eng.mark_frame(cols)
                eng.process_frame(cols, fast=True)
            exports[side] = journal.export()
        finally:
            journal.disable()
    combos = {side: sorted(tuple(e["key"]) for e in doc["entries"]
                           if e["entry"] == "frame_dispatch")
              for side, doc in exports.items()}
    assert combos["t"] == combos["j"] and len(combos["t"]) > 1
    for side, doc in exports.items():
        path = tmp_path / f"{side}.json"
        path.write_text(json.dumps(doc, default=list))
        for u in (PORT_UNIVERSE, REF_UNIVERSE):
            assert check_journal_escape(str(path), u) == [], (side, u)
            assert jsurface.check_journal_escape(str(path), u) == [], \
                (side, u)
