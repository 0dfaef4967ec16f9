"""The port's observability plane (gome_tpu_torch/obs) against gome_tpu's on
the same seeded inputs, on the CPU: the capacity helpers, the compile
journal, pytree_stats of the books, the Space-Saving sketch (its wire
blob byte for byte), the occupancy ledger's attribution, the host
sampler's walk, collapsed output and stage join, the admit drill's keys,
and the disabled hooks' zero-allocation contract. Exact equality, except
where a field is named below with the reason."""

import json
import pathlib
import sys

import numpy as np
import pytest

from gome_tpu.engine.book import BookConfig as JConfig
from gome_tpu.engine.book import init_books as jinit_books
from gome_tpu.obs import capacity as jcap
from gome_tpu.obs import compile_journal as jjournal
from gome_tpu.obs import hostprof as jhostprof
from gome_tpu.obs import live as jlive
from gome_tpu.obs import placement as jplacement
from gome_tpu.obs import timeline as jtimeline
from gome_tpu.utils.metrics import Registry as JRegistry
from gome_tpu_torch.engine.book import BookConfig, init_books
from gome_tpu_torch.obs import capacity as tcap
from gome_tpu_torch.obs import compile_journal as tjournal
from gome_tpu_torch.obs import hostprof as thostprof
from gome_tpu_torch.obs import live as tlive
from gome_tpu_torch.obs import placement as tplacement
from gome_tpu_torch.obs import timeline as ttimeline
from gome_tpu_torch.utils.metrics import Registry as TRegistry
from test_torch_bridge import jnp_dtype, torch_dtype

# -- capacity -------------------------------------------------------------


def seeded_values(seed: int, n: int = 5000) -> list[float]:
    rng = np.random.default_rng(seed)
    v = rng.lognormal(mean=-7.0, sigma=2.0, size=n)
    # the edges: underflow, zero, negative, NaN, the clamp above max
    return [float(x) for x in v] + [0.0, -1.0, float("nan"), 1e-9, 900.0]


def histograms(mod, values, **geom):
    a, b, whole = (mod.LogHistogram(**geom) for _ in range(3))
    for i, x in enumerate(values):
        (a if i % 3 else b).record(x)
        whole.record(x)
    whole.record_corrected(0.35, 0.05)
    a.record_corrected(0.35, 0.05)
    a.merge(b)
    back = mod.LogHistogram.from_bytes(a.to_bytes())
    return dict(
        bytes=a.to_bytes(), whole=whole.to_bytes(), back=back.to_bytes(),
        summary=a.summary(), mean=a.mean(), count=a.count,
        pcts=a.percentiles((0.1, 0.5, 0.9, 0.99, 0.999, 1.0)),
        bounds=[a.bucket_bounds(i) for i in range(0, 40, 3)],
        index=[a.index(x) for x in (1e-7, 1e-6, 0.01, 599.0, 1e4)],
    )


@pytest.mark.parametrize("seed, geom", [
    (1, {}), (2, dict(rel_err=0.05, min_value=1e-5, max_value=10.0))])
def test_log_histogram_matches(seed, geom):
    got = histograms(tcap, seeded_values(seed), **geom)
    want = histograms(jcap, seeded_values(seed), **geom)
    assert got == want
    assert got["bytes"] == got["whole"] == got["back"]


def seeded_ladder(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    rates = np.cumsum(rng.integers(1_000, 20_000, size=12)).astype(float)
    points = []
    for r in rates:
        keep = min(1.0, 1.6e5 / r) * float(rng.uniform(0.97, 1.0))
        points.append({"offered_per_sec": float(r),
                       "delivered_per_sec": float(r * keep),
                       "corrected": {"p99_s": float(rng.uniform(0.001,
                                                                0.2))}})
    return points


def seeded_rows(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = [{"stage": f"s{i}",
             "seconds_per_order": float(rng.uniform(1e-6, 1e-4)),
             "utilization": None if i % 3 == 0 else float(rng.uniform())}
            for i in range(6)]
    return rows


def capacity_run(mod, seed):
    ladder = seeded_ladder(seed)
    rows = seeded_rows(seed)
    sched = mod.OpenLoopSchedule(12_500.0, t0=3.0)
    e2e = sum(r["seconds_per_order"] for r in rows) * 1.03
    obs = mod.CapacityObservatory()
    unarmed = obs.payload()
    verdict = {"schema": mod.SCHEMA, "mode": "single", "pass": True,
               "ladder": ladder, "knee": {"index": 4}, "checks": {"a": 1}}
    reg = (TRegistry if mod is tcap else JRegistry)()
    obs.install(verdict, registry=reg)
    return dict(
        monotone=mod.monotone_ladder(ladder),
        knee=mod.find_knee(ladder),
        knee_p99=mod.find_knee(ladder, delivered_floor=0.5,
                               p99_budget_s=0.1),
        attribution=mod.attribution_check(rows, e2e),
        attribution_tight=mod.attribution_check(rows, e2e, tol=0.01),
        saturated=mod.saturated_stage(rows),
        sched=[sched.intended(i) for i in range(5)]
        + [sched.batch_due(7, 4), sched.accumulation_mean(9)],
        unarmed=unarmed, payload=obs.payload(),
        gauges=[obs._gauge(k) for k in ("offered", "delivered", "p99", "x")],
        exposition=reg.render(),
    )


@pytest.mark.parametrize("seed", [4, 5])
def test_capacity_helpers_match(seed):
    assert capacity_run(tcap, seed) == capacity_run(jcap, seed)


def test_capacity_payload_reads_no_artifact():
    """The port's CAPACITY serves nothing until a verdict is installed;
    the module reads no file on its own (the reference's committed
    verdict is a TPU run's)."""
    assert tcap.CAPACITY.payload() == {"enabled": False}
    assert "CAPACITY_r01" not in pathlib.Path(tcap.__file__).read_text()


# -- compile journal ------------------------------------------------------


def journal_run(mod, reg_cls):
    ticks = iter(range(1, 1000))
    j = mod.CompileJournal()
    before = j.as_dict()
    j.install(keep_n=3, registry=reg_cls(), clock=lambda: next(ticks) * 0.5)
    combos = [(8, 16, 64, True, 256, 4, 512, 64, 8),
              (16, 8, 256, False, 64, 16, 1024, 128, 8),
              (8, 32, 64, True, 1024, 4, 2048, 256, 16)]
    for i, combo in enumerate(combos * 2):
        j.record("frame_dispatch", combo, j.clock() - 0.25 * i)
    j.record("other", [1, 2], 0.125, detail={"x": 1})
    out = j.as_dict()
    for e in out["entries"]:
        e.pop("ts")  # wall-clock time.time(): the one clock field
    disabled = mod.CompileJournal()
    disabled.record("frame_dispatch", combos[0], 1.0)
    return dict(before=before, after=out, summary=j.summary(),
                disabled=disabled.as_dict(),
                export_schema=j.export()["schema"])


def test_journal_summary_and_as_dict_match():
    got = journal_run(tjournal, TRegistry)
    assert got == journal_run(jjournal, JRegistry)
    assert got["summary"]["frame_dispatch"]["count"] == 6
    assert len(got["after"]["entries"]) == 3


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_frame_combo_detail_matches(dtype):
    """Every key of the reference's detail block, equal but two:
    scatter_jaxpr_eqns (the reference counts its traced scatter's jaxpr
    equations; the port's scatter is eager torch ops, so it reports the
    reference's own "unavailable" value, -1) and upload_bytes (the port
    uploads int64 flat positions, the reference int32)."""
    for combo in [(8, 16, 64, True, 256, 4, 512, 64, 8),
                  (1024, 8, 256, False, 4096, 16, 8192, 1024, 16)]:
        got = tjournal.frame_combo_detail(dtype, combo)
        want = jjournal.frame_combo_detail(dtype, combo)
        assert got.keys() == want.keys()
        assert got.pop("scatter_jaxpr_eqns") == -1
        assert want.pop("scatter_jaxpr_eqns") > 0
        m_pad = combo[4]
        assert got.pop("upload_bytes") - want.pop("upload_bytes") == 4 * m_pad
        assert got == want


# -- live -----------------------------------------------------------------


@pytest.mark.parametrize("dtype, cap, k, s", [
    ("int32", 16, 4, 8), ("int64", 64, 8, 40), ("int64", 256, 16, 3)])
def test_pytree_stats_of_the_books(dtype, cap, k, s):
    jb = jinit_books(JConfig(cap=cap, max_fills=k, dtype=jnp_dtype(dtype)), s)
    tb = init_books(BookConfig(cap=cap, max_fills=k,
                               dtype=torch_dtype(dtype)), s, "cpu")
    assert tlive.pytree_stats(tb) == jlive.pytree_stats(jb)
    # numpy leaves count too, in both
    host = {f: np.asarray(getattr(jb, f)) for f in jb._fields}
    assert tlive.pytree_stats(host) == jlive.pytree_stats(host)


def test_cpu_live_stats_are_the_registered_trees():
    """Off the card the live totals are the monitors' trees, under the
    allocator's keys; a dropped monitor stops counting."""
    tb = init_books(BookConfig(cap=16, max_fills=4), 8, "cpu")
    base = tlive.live_array_stats()
    mon = tlive.LiveBufferMonitor().register("books", lambda: tb)
    with_books = tlive.live_array_stats(collect=False)
    want = tlive.pytree_stats(tb)
    assert with_books["bytes"] - base["bytes"] == want["bytes"]
    assert with_books["count"] - base["count"] == want["count"]
    cpu = with_books["devices"]["cpu"]
    assert cpu["allocated_bytes"] == cpu["active_bytes"] == with_books[
        "bytes"] - sum(d["allocated_bytes"] for n, d in with_books[
            "devices"].items() if n != "cpu")
    snap = mon.snapshot()
    assert snap["subsystems"] == {"books": want}
    report = tlive.leak_report(lambda: None, steps=3, settle=1)
    assert report["leaked"] == 0 and len(report["counts"]) == 3
    del mon
    import gc

    gc.collect()
    assert tlive.live_array_stats()["bytes"] == base["bytes"]


# -- placement ------------------------------------------------------------


def zipf_symbols(seed: int, n: int = 4000, m: int = 300) -> list[str]:
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, m + 1) ** 1.2
    idx = rng.choice(m, size=n, p=w / w.sum())
    return [f"sym{i}" if i % 7 else f"δ{i}" for i in idx]


def sketch_run(mod, seed):
    syms = zipf_symbols(seed)
    a, b = mod.SpaceSaving(16), mod.SpaceSaving(16)
    for i, s in enumerate(syms):
        (a if i % 2 else b).note(s, 1 + i % 3)
    a.note("zero", 0)
    merged = mod.SpaceSaving(16)
    merged.merge(a)
    merged.merge(b)
    back = mod.SpaceSaving.from_bytes(merged.to_bytes())
    return dict(a=a.to_bytes(), b=b.to_bytes(), merged=merged.to_bytes(),
                back=back.to_bytes(), top=merged.top(10), total=a.total,
                tracked=(a.tracked, merged.tracked),
                est=[a.estimate(s) for s in syms[:20]])


@pytest.mark.parametrize("seed", [6, 7])
def test_space_saving_top_k_and_wire_blob_byte_equal(seed):
    got, want = sketch_run(tplacement, seed), sketch_run(jplacement, seed)
    assert got == want
    assert got["merged"] == got["back"]


def dispatch_script(seed: int):
    """Seeded dense dispatches: unsharded grids, then mesh grids with
    per-shard counts (the geometry _grid_geometry hands the ledger)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        live = np.unique(rng.integers(0, 500, size=int(rng.integers(1, 60))))
        n_rows = max(8, 1 << int(np.ceil(np.log2(len(live)))))
        if i % 3 == 2:
            d = 4
            counts = np.bincount(live // 125, minlength=d)
            r_s = max(8, 1 << int(np.ceil(np.log2(counts.max()))))
            out.append((r_s * d, live, counts, r_s))
        else:
            out.append((n_rows, live, None, None))
    return out


def placement_run(mod, reg_cls, seed):
    obs = mod.PlacementObservatory()
    obs.install(topk=8, ewma_alpha=0.3, row_bytes=28 * 32, partitions=5,
                registry=reg_cls())
    probes = []
    for sym in zipf_symbols(seed, n=600, m=40):
        obs.note_admit(sym)
    obs.note_admit_frame(["a", "b", "c"], np.array([0, 2, 2, 1, 2]))
    for n_rows, live, counts, r_s in dispatch_script(seed):
        obs.note_dispatch(n_rows, live, counts, r_s)
        probes.append(obs.occupancy_probe())
        probes.append(obs.attribution())
    obs.note_dispatch(8, np.zeros(0, np.int64))  # no live lanes: ignored
    return obs.payload(), probes


def strip_baselines(x):
    """The attribution's "baseline" fields: the reference reads them from
    its TPU artifacts (its mesh and fleet runs), the port from its own
    (MULTICHIP_CUDA_r01, FLEET_CUDA_r01); compared apart."""
    if isinstance(x, dict):
        return {k: (None if k == "baseline" else strip_baselines(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [strip_baselines(v) for v in x]
    return x


@pytest.mark.parametrize("seed", [8, 9])
def test_placement_ledger_and_attribution_match(seed):
    (got, got_probes) = placement_run(tplacement, TRegistry, seed)
    (want, want_probes) = placement_run(jplacement, JRegistry, seed)
    assert strip_baselines(want) == strip_baselines(got)
    assert strip_baselines(want_probes) == strip_baselines(got_probes)
    rows = [c for c in got["attribution"]["components"]]
    skew = tplacement.shard_skew_baseline()
    imbalance = tplacement.partition_imbalance_baseline()
    assert [r["baseline"] for r in rows] == [skew, None]
    assert got["attribution"]["hash_partition"]["baseline"] == imbalance
    assert skew["artifact"] == "MULTICHIP_CUDA_r01"
    assert imbalance["artifact"] == "FLEET_CUDA_r01"
    assert got["attribution"]["reconciliation"]["within_tol"]


def test_placement_reads_no_artifact():
    """The port reads no artifact but its own: from the repo root (where
    the reference's TPU artifacts lie too) the verdict and the baselines
    are the port's *_CUDA_r01 files, with the reference's shapes."""
    tplacement.set_artifact_root(None)
    verdict = tplacement.default_verdict()
    skew = tplacement.shard_skew_baseline()
    imbalance = tplacement.partition_imbalance_baseline()
    assert verdict["artifact"] == "PLACEMENT_CUDA_r01"
    assert verdict["schema"] == jplacement.SCHEMA
    assert skew["artifact"] == "MULTICHIP_CUDA_r01"
    assert skew.keys() == jplacement.shard_skew_baseline().keys()
    assert skew["shard_skew"] == 3.6399 and skew["devices"] == 8
    assert imbalance["artifact"] == "FLEET_CUDA_r01"
    assert imbalance.keys() == jplacement.partition_imbalance_baseline().keys()
    text = json.dumps([verdict, skew, imbalance])
    for ref in ("PLACEMENT_r01", "MULTICHIP_r06", "FLEET_r01"):
        assert ref not in text


# -- hostprof -------------------------------------------------------------


def recurse(n, walk):
    if n:
        return recurse(n - 1, walk)
    return walk(sys._getframe())


def test_walk_and_collapsed_on_the_same_frames():
    """Both samplers walk the same live frames to the same nodes (names
    by co_qualname, as the reference's), capped at max_depth from the
    leaf; the same stacks give the same collapsed text and totals."""
    ts = thostprof.HostSampler(mode="thread", max_depth=6, keep=5,
                               max_stacks=3)
    js = jhostprof.HostSampler(mode="thread", max_depth=6, keep=5,
                               max_stacks=3)
    frames = []
    recurse(9, frames.append)
    for depth_cap in (6, 48):
        ts.max_depth = js.max_depth = depth_cap
        assert ts._walk(frames[0]) == js._walk(frames[0])
    stack = ts._walk(frames[0])
    assert stack[-1].endswith(":recurse")
    stacks = [stack, stack[1:], ("a:x", "b:y"), ("a:x",), stack, ("c:z",),
              ("a:x", "b:y"), ()]
    for s in stacks:
        ts._note(s)
        js._note(s)
    assert ts.collapsed() == js.collapsed()
    assert ts.collapsed(max_lines=2) == js.collapsed(max_lines=2)
    assert ts.node_totals() == js.node_totals()
    assert ts.ring() == js.ring() and ts.samples == js.samples == 7
    assert ts.counts() == js.counts()


def admit_stacks(pkg: str) -> dict:
    """Scripted stacks through the gateway, codec, batcher and consumer
    frames of one package (module names carry the package)."""
    g = f"{pkg}.service.gateway"
    return {
        (f"{g}:OrderGateway.DoOrder", f"{g}:OrderGateway._validate_add"): 40,
        (f"{g}:OrderGateway.DoOrder", f"{g}:order_from_request",
         f"{pkg}.fixed:scale"): 25,
        (f"{g}:OrderGateway._apply_columnar", f"{g}:OrderGateway._intern"): 9,
        (f"{g}:OrderGateway.DoOrder", f"{g}:OrderGateway._traced_emit",
         f"{pkg}.bus.codec:encode_order", "json:dumps"): 30,
        (f"{pkg}.service.consumer:OrderConsumer.run_once",
         f"{pkg}.bus.colwire:decode_order_frame"): 12,
        (f"{pkg}.service.consumer:OrderConsumer.run_once",
         f"{pkg}.engine.frames:submit_frame"): 20,
        (f"{pkg}.engine.prepool:LocalPrePool.mark_frame",): 7,
        ("threading:Thread.run", "time:sleep"): 11,
    }


def test_stage_join_matches():
    for n, window in ((None, None), (1000, 2.5e9), (137, 1e6)):
        got = thostprof.stage_join(admit_stacks("gome_tpu_torch"), n, window)
        want = jhostprof.stage_join(admit_stacks("gome_tpu"), n, window)
        assert got == want
    assert got["stages"]["order_build"]["samples"] == 34


def drill_keys(mod, path):
    rep = mod.gateway_drill(n_orders=512, min_samples=0, max_rounds=1,
                            mode="thread", path=path, batch_n=128)
    return rep


@pytest.mark.parametrize("path", ["scalar", "columnar"])
def test_gateway_drill_keys_match(path):
    """The drill's report has the reference's keys plus "prepool" (which
    pre-pool the columnar path marked through: the port records it so a
    run can show the native one ran); counts are equal, times are the
    host's."""
    got, want = drill_keys(thostprof, path), drill_keys(jhostprof, path)
    assert got.pop("prepool") == (
        "native" if path == "columnar" and _native() else "local")
    assert got.keys() == want.keys()
    for k in ("kind", "path", "seed", "orders", "rounds", "note"):
        assert got[k] == want[k], k
    assert got["sampler"].keys() == want["sampler"].keys()
    roof = thostprof.host_roofline(got)
    assert list(roof) == ["host_gateway_admit", "note"]


def _native() -> bool:
    from gome_tpu_torch.engine import nativehost

    return nativehost.available()


# -- the disabled contract --------------------------------------------------


def _disabled_hooks():
    """Each disabled hot-path hook, on a fresh never-armed instance."""
    tl = ttimeline.TimelineSampler()
    jr = tjournal.CompileJournal()
    hp = thostprof.HostProfiler()
    pl = tplacement.PlacementObservatory()
    lanes = np.arange(5, dtype=np.int64)
    syms, idx = ["a", "b"], np.zeros(4, dtype=np.int64)
    combo = (8, 16, 64, True, 256, 4, 512, 64, 8)
    return {
        "timeline.note_frame": lambda: tl.note_frame(64),
        "timeline.sample": tl.sample,
        "journal.record": lambda: jr.record("frame_dispatch", combo, 0.0),
        "hostprof.note_admit": hp.note_admit,
        "placement.note_admit": lambda: pl.note_admit("eth2usdt"),
        "placement.note_admit_frame": lambda: pl.note_admit_frame(syms, idx),
        "placement.note_dispatch": lambda: pl.note_dispatch(8, lanes),
        "placement.occupancy_probe": pl.occupancy_probe,
    }


@pytest.mark.parametrize("name", sorted(_disabled_hooks()))
def test_disabled_hook_allocates_nothing(name):
    hook = _disabled_hooks()[name]

    def drill(n):
        i = 0
        while i < n:
            hook()
            i += 1

    drill(64)  # warm any lazy caches
    before = sys.getallocatedblocks()
    drill(200)
    after = sys.getallocatedblocks()
    assert after - before <= 2, f"{name} allocated {after - before}"


def test_singletons_are_disarmed_at_import():
    from gome_tpu_torch import obs

    assert not obs.TIMELINE.enabled and not obs.JOURNAL.enabled
    assert not obs.HOSTPROF.enabled and not obs.CAPACITY.enabled
    assert obs.TIMELINE.as_dict() == jtimeline.TimelineSampler().as_dict()
    assert obs.HOSTPROF.payload() == {"enabled": False, "live": None,
                                      "drill": None}
    assert obs.placement.PLACEMENT.payload() == {"enabled": False}


def test_gxx_build_is_journaled(tmp_path, monkeypatch):
    """A g++ build that runs at first use lands in the journal as a
    gxx_build entry of its own; a cached library records nothing."""
    import shutil

    from gome_tpu_torch.native import build

    cxx = shutil.which(build.CXX)
    if cxx is None:
        pytest.skip("no g++ on PATH: nothing to build")
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path))
    tjournal.JOURNAL.install(registry=TRegistry())
    try:
        build.build(cxx)
        build.build(cxx)  # cached now
        entries = tjournal.JOURNAL.entries()
    finally:
        tjournal.JOURNAL.disable()
    assert [(e["entry"], e["key"]) for e in entries] == [
        ("gxx_build", (build.LIB,))]
    assert entries[0]["seconds"] == build.build_seconds > 0
