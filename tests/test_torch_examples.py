"""The port's examples (gome_tpu_torch/examples) against the reference's
(examples/): each reference example runs as the README runs it (JAX on
the CPU), the port's with --device cpu, each in its own interpreter, all
started at once. embed's and migrate_from_gome's printed lines are equal
(the RESP server's ephemeral port left out); sim_rollout at 8 lanes x 20
steps gives the reference's manifest (config and its hash) and the
reference's report keys (the values come from another generator and are
not compared)."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_ARGS = ("--steps", "20", "--lanes", "8", "--seed", "0")
RUNS = {
    "embed": ((), ()),
    "migrate_from_gome": ((), ()),
    "sim_rollout": (SIM_ARGS, SIM_ARGS),
}


def _start(cmd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def outputs():
    """{(name, "reference" | "port"): stdout lines}, every run exit 0."""
    procs = {}
    for name, (ref_args, port_args) in RUNS.items():
        procs[name, "reference"] = _start(
            [sys.executable, os.path.join("examples", f"{name}.py"),
             *ref_args])
        procs[name, "port"] = _start(
            [sys.executable, "-m", f"gome_tpu_torch.examples.{name}",
             "--device", "cpu", *port_args])
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, f"{key}: {stdout}\n{stderr}"
        out[key] = stdout.splitlines()
    return out


EMBED_KINDS = {
    "events": lambda s: s.startswith(("FILL", "CANCEL")),
    "depth": lambda s: s.startswith(("bids:", "asks:")),
    "stats": lambda s: s.startswith("stats:"),
    "invariants": lambda s: s == "book invariants OK",
}


@pytest.mark.parametrize("kind", EMBED_KINDS)
def test_embed_prints_the_reference_lines(outputs, kind):
    keep = EMBED_KINDS[kind]
    ref = [s for s in outputs["embed", "reference"] if keep(s)]
    port = [s for s in outputs["embed", "port"] if keep(s)]
    assert ref and port == ref
    if kind == "events":
        assert sum(s.startswith("FILL") for s in port) == 3
        assert sum(s.startswith("CANCEL") for s in port) == 1


def _no_port(line):
    return re.sub(r"\(port \d+\)", "(port P)", line)


MIGRATE_KINDS = {
    "imported": lambda s: s.startswith("imported "),
    "fills": lambda s: s.lstrip().startswith("FILL"),
    "cancel": lambda s: s.lstrip().startswith("CANCEL"),
    "re-exported": lambda s: s.startswith("re-exported "),
}


@pytest.mark.parametrize("kind", MIGRATE_KINDS)
def test_migrate_prints_the_reference_lines(outputs, kind):
    keep = MIGRATE_KINDS[kind]
    ref = [_no_port(s) for s in outputs["migrate_from_gome", "reference"]
           if keep(s)]
    port = [_no_port(s) for s in outputs["migrate_from_gome", "port"]
            if keep(s)]
    assert ref and port == ref
    assert len(outputs["migrate_from_gome", "port"]) == len(
        outputs["migrate_from_gome", "reference"])


def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_sim_rollout_manifest_and_report_keys(outputs):
    ref = json.loads(outputs["sim_rollout", "reference"][-1])
    port = json.loads(outputs["sim_rollout", "port"][-1])
    assert port["manifest"] == ref["manifest"]
    assert _keys(port) == _keys(ref)
    assert port["metric"].startswith("sim env rollout, 8 lanes x 20 steps")
    assert port["steps_per_sec"] > 0 and port["events_per_step"] > 0
    assert port["book_overflow"] == port["fill_overflow"] == 0
    assert port["stats"]["n_sample_grids"] == ref["stats"]["n_sample_grids"]
    assert port["stats"]["zipf_a_configured"] == \
        ref["stats"]["zipf_a_configured"]
    assert port["stats"]["branching_configured"] == \
        ref["stats"]["branching_configured"]


def test_sim_rollout_writes_out(tmp_path):
    out = tmp_path / "sim.json"
    from gome_tpu_torch.examples import sim_rollout

    assert sim_rollout.main(["--device", "cpu", "--steps", "2", "--lanes",
                             "4", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["manifest"]["n_steps"] == 2
    assert doc["manifest"]["config"]["flow"]["n_lanes"] == 4


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_wants_the_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    r = subprocess.run([sys.executable, "-m",
                        f"gome_tpu_torch.examples.{name}"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
