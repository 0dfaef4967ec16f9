"""The port's capacity sweep (gome_tpu_torch/scripts/capacity.py) on the
CPU: the single-process open-loop ladder at 32 symbols gives a verdict
with the reference's schema, a monotone ladder, attribution within 5% at
every point, zero seq dupes and gaps, and events equal to the oracle's;
the sweep's pure helpers equal the reference's (scripts/capacity.py)."""

import importlib.util
import pathlib

import pytest

from gome_tpu_torch.obs import capacity as tcap
from gome_tpu_torch.scripts import capacity as cap

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _ref_capacity():
    path = ROOT / "scripts" / "capacity.py"
    spec = importlib.util.spec_from_file_location("_ref_capacity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def verdict():
    return cap.run_single_sweep("cpu", seconds=3.0, points=3, symbols=32,
                                cap=64, batch_n=256)


def test_verdict_schema_and_checks(verdict):
    assert verdict["schema"] == tcap.SCHEMA == "gome-capacity-verdict-v1"
    assert verdict["mode"] == "single"
    assert set(verdict) >= {"schema", "mode", "config", "ladder", "knee",
                            "checks", "pass", "oracle", "seq"}
    assert verdict["config"]["device"] == "cpu"
    assert all(verdict["checks"].values()), verdict["checks"]


def test_ladder_is_monotone_and_exactly_once(verdict):
    ladder = verdict["ladder"]
    assert len(ladder) == 3
    offered = [p["offered_per_sec"] for p in ladder]
    assert all(b > a for a, b in zip(offered, offered[1:]))
    for p in ladder:
        eo = p["exactly_once"]
        assert eo["dupes"] == 0 and eo["gaps"] == 0 and eo["drained"]
        assert eo["consumed"] == eo["sent"] == p["sent"]
        assert p["corrected"]["count"] == p["sent"]
    assert verdict["seq"]["dupes"] == 0 and verdict["seq"]["gaps"] == 0


@pytest.mark.parametrize("i", range(3))
def test_attribution_within_5_percent(verdict, i):
    attr = verdict["ladder"][i]["attribution"]
    assert attr["rows"] and attr["within_tol"] and attr["frac_err"] <= 0.05
    stages = [r["stage"] for r in attr["rows"]]
    assert stages[:3] == ["arrival_accumulation", "send_backlog",
                          "gateway_step"]
    assert stages[-1] == "bus_wait"


def test_events_equal_the_oracle(verdict):
    o = verdict["oracle"]
    assert o["equal"] and o["events"] == o["oracle_events"] > 0
    assert o["orders"] == sum(p["sent"] for p in verdict["ladder"])


@pytest.mark.parametrize("lo, hi, k", [(300.0, 1600.0, 6), (1.0, 2.0, 2),
                                       (5.0, 5.0, 1)])
def test_geometric_ladder_equals_the_reference(lo, hi, k):
    assert cap.geometric_ladder(lo, hi, k) == \
        _ref_capacity().geometric_ladder(lo, hi, k)


@pytest.mark.parametrize("done", [[0.1, 0.2, 0.35, 0.5], [0.2], []])
def test_steady_delivered_equals_the_reference(done):
    ref = _ref_capacity()
    for end in (0.3, 1.0):
        assert cap.steady_delivered(done, end, 256, 0.0) == \
            ref.steady_delivered(done, end, 256, 0.0)


def test_completion_inversion_equals_the_reference():
    samples = [(0.0, 10, 0.0), (0.1, 14, 2.0), (0.25, 14, 1.0),
               (0.3, 25, 0.0), (0.5, 31, 0.0)]
    ref = _ref_capacity()
    for base, n in ((10, 21), (12, 5), (20, 11)):
        assert cap._completion_times(samples, base, n) == \
            ref._completion_times(samples, base, n)


def test_metric_parsers_equal_the_reference():
    text = ("gome_orders_consumed_total 1234\n"
            'gome_bus_depth{queue="doOrder"} 7\n'
            'gome_stage_seconds_sum{stage="decode"} 0.5\n'
            'gome_stage_seconds_count{stage="decode"} 10\n'
            'gome_stage_seconds_sum{stage="publish"} 0.25\n')
    ref = _ref_capacity()
    assert cap._parse_consumed(text) == ref._parse_consumed(text) == 1234
    assert cap._parse_depth(text) == ref._parse_depth(text) == 7.0
    assert cap._parse_stages(text) == ref._parse_stages(text)


def test_fleet_requests_route_like_the_fleet():
    from gome_tpu.fleet.router import partition_of as jpartition_of

    parts = cap.synth_requests(600, 100, 64)
    assert sum(map(len, parts)) == 600
    for p, items in enumerate(parts):
        assert all(jpartition_of(r.symbol, 2) == p for _, _, r in items)
        assert not any(c for _, c, _ in items)
        ranks = [k for k, _, _ in items]
        assert ranks == sorted(ranks)


def _fleet_point(little_s: float):
    """A synthetic fleet point for fleet_attribution: two partitions of 4
    orders at 100/s, one batch each, completions 50 ms after each order's
    admit slot, consumer stages of 10 ms, and a Little's-law wait of
    little_s for both partitions."""
    from gome_tpu_torch.obs.capacity import OpenLoopSchedule

    sched = OpenLoopSchedule(100.0, t0=0.0)
    parts = [[(0, False, None), (2, False, None), (4, False, None),
              (6, False, None)],
             [(1, False, None), (3, False, None), (5, False, None),
              (7, False, None)]]
    drive, comps = {}, {}
    for i, items in enumerate(parts):
        due = sched.intended(items[-1][0])
        t_send, wall = due + 0.002, 0.004
        drive[i] = {"batches": [{"first_rank": 0, "n": 4, "due": due,
                                 "t_send": t_send, "t_ret": t_send + wall,
                                 "accepted": 4}]}
        comps[i] = [t_send + wall * (k + 1) / 4 + 0.05 for k in range(4)]
    stages0 = {"c0": {"decode": (0.0, 0.0)}, "c1": {"decode": (0.0, 0.0)}}
    stages1 = {"c0": {"decode": (4.0, 0.04)}, "c1": {"decode": (4.0, 0.04)}}
    e2e = sum(comps[i][r] - sched.intended(parts[i][r][0])
              for i in range(2) for r in range(4)) / 8
    return dict(parts=parts, drive=drive, sched=sched, comps=comps,
                little_wait=[(4, little_s), (4, little_s)], stages0=stages0,
                stages1=stages1, members=["c0", "c1"], busy_s=0.2,
                e2e_mean_s=e2e)


@pytest.mark.parametrize("little_s, within", [
    (0.04, True),     # Little's law and the residual agree
    (0.041, True),    # 1 ms off a ~0.09 s mean: inside 5%
    (0.09, False),    # the estimate overshoots: the check fails
    (0.0, False),     # the estimate undershoots: the check fails
])
def test_fleet_attribution_holds_littles_law_to_the_measured_mean(
        little_s, within):
    """The fleet row set is the reference's: bus_wait is Little's law on
    the sampled depth (an estimate of its own), the residual only rides
    beside it, and the 5% check judges their sum, so it can fail."""
    pt = _fleet_point(little_s)
    attr = cap.fleet_attribution(**pt)
    rows = {r["stage"]: r for r in attr["rows"]}
    assert [r["stage"] for r in attr["rows"]] == [
        "arrival_accumulation", "send_backlog", "admit", "bus_wait",
        "decode"]
    assert rows["bus_wait"]["seconds_per_order"] == little_s
    assert rows["bus_wait"]["residual_s"] == pytest.approx(0.05 - 0.01)
    assert rows["decode"]["seconds_per_order"] == pytest.approx(0.01)
    assert rows["send_backlog"]["seconds_per_order"] == pytest.approx(0.002)
    assert rows["admit"]["seconds_per_order"] == pytest.approx(
        0.004 * 5 / 8)
    assert attr["e2e_mean_s"] == pt["e2e_mean_s"]
    assert attr["within_tol"] is within


@pytest.mark.parametrize("name, argv", [
    ("capacity", ["--seconds", "1"]), ("capacity", ["--fleet"]),
    ("fleet_drill", []), ("mesh_overhead", []), ("mesh_overhead", ["--skew"]),
    ("mesh_overhead", ["--curve"]), ("placement_eval", []),
    ("profile_consumer", ["--gateway"]), ("obs_snapshot", [])])
def test_driver_refuses_without_a_card_unless_cpu(name, argv, monkeypatch):
    """Every driver raises before it does any work when the card is asked
    for (the default) and there is none; no CPU fallback."""
    import importlib

    import torch

    mod = importlib.import_module(f"gome_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(argv)


def _ladder_point(rate, delivered, p99, within):
    return {"offered_per_sec": rate, "delivered_per_sec": delivered,
            "sent": 10,
            "corrected": {"p99_s": p99, "count": 10, "p50_s": p99 / 2,
                          "mean_s": p99 / 2},
            "exactly_once": {"dupes": 0, "gaps": 0, "drained": True},
            "attribution": {"rows": [{"stage": "admit",
                                      "seconds_per_order": 0.01,
                                      "utilization": 0.5}],
                            "frac_err": 0.01 if within else 0.2,
                            "within_tol": within}}


@pytest.mark.parametrize("knee_within, other_within", [
    (True, True), (True, False), (False, True)])
def test_verdict_checks_equal_the_reference(knee_within, other_within):
    """build_verdict's checks are the reference's: the attribution is
    judged at the knee (a point before it may miss 5%)."""
    points = [_ladder_point(100.0, 100.0, 0.1, other_within),
              _ladder_point(200.0, 199.0, 0.1, True),
              _ladder_point(400.0, 300.0, 0.5, knee_within),
              _ladder_point(800.0, 310.0, 2.0, True),
              _ladder_point(1600.0, 300.0, 4.0, True)]
    got = cap.build_verdict("fleet", {}, points, 0.98, 1.0)
    want = _ref_capacity().build_verdict("fleet", {}, points, 0.98, 1.0)
    assert got["checks"] == want["checks"]
    assert got["knee"] == want["knee"]
    assert got["pass"] is want["pass"] is knee_within


def _committed_capacity():
    import json

    return json.loads((ROOT / "CAPACITY_CUDA_r01.json").read_text())


def test_committed_fleet_verdict_recomputes_from_its_ladder():
    """CAPACITY_CUDA_r01.json's knee and checks are what build_verdict
    gives on its own ladder, and every point's bus_wait row is Little's
    law with the residual beside it."""
    doc = _committed_capacity()
    cfg = doc["config"]
    got = cap.build_verdict("fleet", cfg, doc["ladder"],
                            cfg["delivered_floor"], cfg["p99_budget_s"])
    assert got["knee"] == doc["knee"]
    assert {k: v for k, v in doc["checks"].items() if k in got["checks"]} \
        == got["checks"]
    assert cfg["ladder_span"] == list(cap.FLEET_SPAN)
    for p in doc["ladder"]:
        rows = p["attribution"]["rows"]
        bw = rows[3]
        assert bw["stage"] == "bus_wait" and "residual_s" in bw
        assert bw["source"].startswith("Little's law")
        total = sum(r["seconds_per_order"] for r in rows)
        assert total == pytest.approx(p["attribution"]["sum_s"])


@pytest.mark.parametrize("mutation", [None, "dupe", "knee0", "other_check",
                                      "attr_miss"])
def test_phase17c_capacity_artifact_check(mutation):
    """chip_smoke's phase 17 (c) holds the committed capacity verdict to
    every check (the attribution at the knee among them), a knee past
    point 0 and zero seq dupes and gaps."""
    import copy

    import chip_smoke

    doc = copy.deepcopy(_committed_capacity())
    if mutation == "dupe":
        doc["ladder"][1]["exactly_once"]["dupes"] = 1
    elif mutation == "knee0":
        doc["knee"]["index"] = 0
    elif mutation == "other_check":
        doc["checks"]["exactly_once_all_points"] = False
    elif mutation == "attr_miss":
        doc["checks"]["attribution_within_tol_at_knee"] = False
    if mutation is None:
        chip_smoke.capacity_artifact_check(doc)
    else:
        with pytest.raises(SystemExit, match="CAPACITY_CUDA_r01"):
            chip_smoke.capacity_artifact_check(doc)
