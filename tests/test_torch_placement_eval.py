"""The port's what-if placement evaluator (gome_tpu_torch/scripts/
placement_eval.py) and the artifact lookups of obs.placement against
gome_tpu's, on the CPU: the verdict equal to the reference's (artifact
names and the method text mapped), deterministic to the byte, the
committed PLACEMENT_CUDA_r01.json the port's verdict, and the three
lookups reading only the port's own files."""

import builtins
import importlib.util
import json
import os
import pathlib

import pytest

from gome_tpu.obs import placement as jplacement
from gome_tpu_torch.obs import placement as tplacement
from gome_tpu_torch.scripts import placement_eval

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: reference artifact -> the port's artifact in its place
NAMES = {"PLACEMENT_r01": "PLACEMENT_CUDA_r01",
         "MULTICHIP_r06": "MULTICHIP_CUDA_r01",
         "FLEET_r01": "FLEET_CUDA_r01"}


def _ref_eval():
    """scripts/placement_eval.py as a module (tests/test_placement.py's
    idiom: scripts/ is not a package)."""
    path = ROOT / "scripts" / "placement_eval.py"
    spec = importlib.util.spec_from_file_location("_ref_placement_eval", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rename(doc):
    """A reference document with its artifact names mapped to the
    port's."""
    text = json.dumps(doc)
    for ref, port in NAMES.items():
        text = text.replace(ref, port)
    return json.loads(text)


@pytest.fixture
def port_root(tmp_path):
    """An artifact root holding the reference's three files under the
    port's names (the same numbers: both evaluators anchor on one curve
    row); the lookups read it, then the repo root again."""
    for ref, port in NAMES.items():
        doc = json.loads((ROOT / f"{ref}.json").read_text())
        (tmp_path / f"{port}.json").write_text(json.dumps(_rename(doc)))
    tplacement.set_artifact_root(tmp_path)
    yield tmp_path
    tplacement.set_artifact_root(None)


@pytest.fixture
def empty_root(tmp_path):
    tplacement.set_artifact_root(tmp_path)
    yield tmp_path
    tplacement.set_artifact_root(None)


def test_verdict_equals_the_reference(port_root):
    got = placement_eval.build_verdict()
    want = _rename(_ref_eval().build_verdict())
    assert got.pop("method") != want.pop("method")
    assert got == want
    assert got["attribution"]["observed"]["artifact"] == "MULTICHIP_CUDA_r01"
    assert got["checks"]["pass"]


@pytest.mark.parametrize("policy", [p for p, _ in placement_eval.POLICIES])
def test_policy_rows_equal_the_reference(policy, port_root):
    got = {r["policy"]: r for r in placement_eval.build_verdict()["policies"]}
    want = {r["policy"]: r for r in _ref_eval().build_verdict()["policies"]}
    assert got[policy] == want[policy]


def test_two_runs_are_byte_equal(port_root):
    a = placement_eval.verdict_text(placement_eval.build_verdict())
    tplacement.set_artifact_root(port_root)  # a fresh memo
    b = placement_eval.verdict_text(placement_eval.build_verdict())
    assert a == b


def test_committed_verdict_is_the_ports():
    tplacement.set_artifact_root(None)
    text = (ROOT / "PLACEMENT_CUDA_r01.json").read_text()
    assert placement_eval.verdict_text(placement_eval.build_verdict()) == text
    doc = json.loads(text)
    assert doc["artifact"] == "PLACEMENT_CUDA_r01"
    assert doc["attribution"]["observed"]["artifact"] == "MULTICHIP_CUDA_r01"
    assert doc["checks"]["pass"]


def test_main_writes_the_verdict(port_root, tmp_path):
    out = tmp_path / "v.json"
    assert placement_eval.main(["--device", "cpu", "--out", str(out)]) == 0
    assert out.read_text() == placement_eval.verdict_text(
        placement_eval.build_verdict())


@pytest.mark.parametrize("lookup", ["default_verdict", "shard_skew_baseline",
                                    "partition_imbalance_baseline"])
def test_lookups_give_the_reference_shapes(lookup, port_root):
    got = getattr(tplacement, lookup)()
    want = getattr(jplacement, lookup)()
    assert want is not None
    assert got == _rename(want)


@pytest.mark.parametrize("lookup", ["default_verdict", "shard_skew_baseline",
                                    "partition_imbalance_baseline"])
def test_lookups_without_artifacts_give_none(lookup, empty_root):
    assert getattr(tplacement, lookup)() is None


def test_malformed_artifacts_give_none(empty_root):
    for port in NAMES.values():
        (empty_root / f"{port}.json").write_text("[1, 2")
    tplacement.set_artifact_root(empty_root)
    assert tplacement.default_verdict() is None
    assert tplacement.shard_skew_baseline() is None
    assert tplacement.partition_imbalance_baseline() is None
    for port in NAMES.values():
        (empty_root / f"{port}.json").write_text("[1, 2]")
    tplacement.set_artifact_root(empty_root)
    assert tplacement.shard_skew_baseline() is None
    assert tplacement.partition_imbalance_baseline() is None


def test_no_lookup_opens_a_reference_file(monkeypatch):
    """From the repo root, where both packages' artifacts lie, the
    lookups open the port's names and never the reference's."""
    opened = []
    real_open = builtins.open

    def spy(file, *a, **kw):
        opened.append(os.path.basename(str(file)))
        return real_open(file, *a, **kw)

    tplacement.set_artifact_root(None)
    monkeypatch.setattr(builtins, "open", spy)
    tplacement.default_verdict()
    tplacement.shard_skew_baseline()
    tplacement.partition_imbalance_baseline()
    monkeypatch.undo()
    assert sorted(opened) == sorted(f"{p}.json" for p in NAMES.values())
    assert not {f"{r}.json" for r in NAMES} & set(opened)
