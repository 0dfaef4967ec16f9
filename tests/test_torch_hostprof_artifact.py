"""The port's host-profile artifact functions (obs.hostprof:
hostprof_artifact, bench_host, bench_admit, _artifact_value, _repo_root)
against gome_tpu's on the CPU: the same key sets and the same
deterministic fields (seed, orders, batch_n, stage names from the one
taxonomy, the roofline's keys less the benchmark's rows, which wait for
the port's benchmark outputs). Times are the host's."""

import json

import pytest

from gome_tpu.obs import hostprof as jhostprof
from gome_tpu_torch.obs import hostprof as thostprof

SMALL = dict(n_orders=1024, min_samples=0, max_rounds=1)


@pytest.mark.parametrize("path", ["scalar", "columnar"])
def test_hostprof_artifact_keys_and_fields(path):
    got = thostprof.hostprof_artifact(path=path, batch_n=256,
                                      artifact="HOSTPROF_CUDA_r01", **SMALL)
    want = jhostprof.hostprof_artifact(path=path, batch_n=256,
                                       artifact="HOSTPROF_r01", **SMALL)
    assert got.keys() == want.keys()
    assert got["artifact"] == "HOSTPROF_CUDA_r01"
    assert got["python"] == want["python"]
    assert got["method"].split(" mode @")[1] == want["method"].split(
        " mode @")[1]
    gd, wd = got["drill"], want["drill"]
    assert gd.pop("prepool") in ("native", "local")
    assert gd.keys() == wd.keys()
    for k in ("kind", "path", "seed", "orders", "rounds", "note"):
        assert gd[k] == wd[k], k
    if path == "columnar":
        assert gd["batch_n"] == wd["batch_n"] == 256
    assert set(gd["stages"]) <= set(thostprof.HOST_STAGES)
    assert list(thostprof.HOST_STAGES) == list(jhostprof.HOST_STAGES)
    # The benchmark's rows (consumer drain, device matching) wait for the
    # port's benchmark outputs.
    assert set(got["roofline"]) == set(want["roofline"]) - {
        "host_consumer_drain", "device_matching",
        "front_door_mismatch_consumer_vs_gateway",
        "front_door_mismatch_device_vs_gateway"}
    assert got["roofline"]["host_gateway_admit"].keys() == \
        want["roofline"]["host_gateway_admit"].keys()


def test_bench_host_keys_and_fields():
    got = thostprof.bench_host(n_orders=1024, min_samples=0)
    want = jhostprof.bench_host(n_orders=1024, min_samples=0)
    assert got.keys() == want.keys()
    assert set(got["stage_ns_per_order"]) <= set(thostprof.HOST_STAGES)
    assert got["admit_ns_per_order"] > 0


def test_bench_admit_keys_and_fields():
    got = thostprof.bench_admit(n_orders=1024, min_samples=0, batch_n=256)
    want = jhostprof.bench_admit(n_orders=1024, min_samples=0, batch_n=256)
    assert got.keys() == want.keys()
    for k in ("kind", "seed", "batch_n"):
        assert got[k] == want[k], k
    for side in ("scalar", "columnar"):
        assert got[side].keys() == want[side].keys()
        assert got[side]["orders"] == want[side]["orders"]
        assert got[side]["rounds"] == want[side]["rounds"]
    assert got["speedup_x"] > 0


def test_artifact_value_and_repo_root(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps({"x": {"y": [1, 2]}}))
    (tmp_path / "bad.json").write_text("{")
    for mod in (thostprof, jhostprof):
        assert mod._artifact_value(str(tmp_path), "a.json", ("x", "y")) \
            == [1, 2]
        assert mod._artifact_value(str(tmp_path), "a.json", ("z",)) is None
        assert mod._artifact_value(str(tmp_path), "bad.json", ()) is None
        assert mod._artifact_value(str(tmp_path), "none.json", ()) is None
    assert thostprof._repo_root() == jhostprof._repo_root()


@pytest.mark.parametrize("name", ["HOSTPROF_CUDA_r01", "HOSTPROF_CUDA_r02"])
def test_committed_artifacts(name):
    doc = json.loads(open(f"{thostprof._repo_root()}/{name}.json").read())
    path = "columnar" if name.endswith("r02") else "scalar"
    assert doc["artifact"] == name
    assert doc["drill"]["path"] == path
    assert doc["drill"]["coverage_pct"] >= 80.0
    assert list(doc["roofline"]) == ["host_gateway_admit", "note"]
    assert "NVIDIA" in doc["provenance"]["card"]
