"""Soak on the port, on the CPU: tests/test_soak.py's long mixed stream
with mid-stream snapshot/restore and its steady-state leak check twinned
on gome_tpu_torch's engine (events equal to the oracle's and to gome_tpu's
engine's), chip_smoke's MixedFlow against bench.py's _MixedFlow (the same
frames for a seed), and chip_smoke.soak_drill (phase 16 (b)) for 3 s at a
small width, whose verdict and GL906 check must pass."""

import numpy as np
import pytest

import chip_smoke
from gome_tpu.engine import BatchEngine as JBatchEngine
from gome_tpu.engine import BookConfig as JConfig
from gome_tpu_torch.engine import BatchEngine, BookConfig
from gome_tpu_torch.oracle import OracleEngine
from gome_tpu_torch.utils.streams import multi_symbol_stream


def test_soak_mixed_stream_with_restore_and_invariants():
    """3,000 orders over 40 symbols in chunks of 250, books verified after
    every chunk, a crash/restore into a fresh engine at random chunks:
    events equal to the oracle's and to gome_tpu's uninterrupted
    engine's."""
    import jax.numpy as jnp

    orders = multi_symbol_stream(n=3000, n_symbols=40, seed=17,
                                 cancel_prob=0.15)
    oracle = OracleEngine()
    expected = []
    for o in orders:
        expected.extend(oracle.process(o))

    def fresh():
        return BatchEngine(BookConfig(cap=64, max_fills=8, dtype="int32"),
                           n_slots=8, max_t=32, device="cpu")

    engine = fresh()
    got = []
    rng = np.random.default_rng(0)
    restores = 0
    for i in range(0, len(orders), 250):
        got.extend(engine.process_columnar(orders[i:i + 250]).to_results())
        engine.verify_books()
        if rng.random() < 0.3:
            state = engine.export_state()
            engine = fresh()
            engine.import_state(state)
            restores += 1
    assert got == expected
    assert len(got) > 500 and restores > 0

    from gome_tpu.utils.streams import multi_symbol_stream as jstream

    j = JBatchEngine(JConfig(cap=64, max_fills=8, dtype=jnp.int32),
                     n_slots=8, max_t=32)
    jorders = jstream(n=3000, n_symbols=40, seed=17, cancel_prob=0.15)
    want = []
    for i in range(0, len(jorders), 250):
        want.extend(j.process_columnar(jorders[i:i + 250]).to_results())
    assert [tuple(map(str, (e.__dict__.values()))) for e in got] == \
        [tuple(map(str, (e.__dict__.values()))) for e in want]


def test_soak_steady_state_live_buffers_flat():
    """obs.live's leak detector on real engine steps: after one settling
    pass over a cancel-heavy stationary flow, a second pass leaves the live
    buffer count flat (the CPU count is the registered engine books', via
    obs.live.service_monitor)."""
    from gome_tpu_torch.obs import live

    engine = BatchEngine(BookConfig(cap=64, max_fills=8, dtype="int32"),
                         n_slots=8, max_t=32, device="cpu")
    monitor = live.service_monitor(engine)
    orders = multi_symbol_stream(n=2000, n_symbols=8, seed=23,
                                 cancel_prob=0.5)
    chunks = [orders[i:i + 250] for i in range(0, len(orders), 250)]
    i = 0

    def step():
        nonlocal i
        engine.process_columnar(chunks[i % len(chunks)])
        i += 1

    report = live.assert_steady_state(step, steps=len(chunks),
                                      settle=len(chunks))
    assert report["counts"], report
    assert report["baseline"] >= 5  # the five book leaves are counted
    del monitor


@pytest.mark.parametrize("n_symbols, n", [(16, 512), (256, 4096)])
def test_mixed_flow_is_benchs(n_symbols, n):
    """chip_smoke.MixedFlow gives bench.py's _MixedFlow frames for the
    same seed, frame after frame (pool, same-frame races and all)."""
    from bench import _MixedFlow

    ours = chip_smoke.MixedFlow(np.random.default_rng(11), n_symbols)
    theirs = _MixedFlow(np.random.default_rng(11), n_symbols)
    for _ in range(4):
        a, b = ours.frame(n), theirs.frame(n)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    assert ours.pool_n == theirs.pool_n > 0


def test_soak_drill_short_budget_on_the_cpu(monkeypatch):
    """Phase 16 (b) for 3 s at 64 symbols x cap 64 x K 16, frames of 512,
    depth 2 (settling for 8 frames, not the card's 1,024): every verdict
    passes, no combo is minted in the timed window, the timeline recorded
    a series, the consumer committed every order, the drill kept K1's
    inputs, and the journal's export has no GL906 escape."""
    monkeypatch.setattr(chip_smoke, "SOAK_SETTLE_FRAMES", 8)
    r = chip_smoke.soak_drill("cpu", seconds=3.0, symbols=64, cap=64,
                              frame_n=512, interval=0.25)
    v = r["verdicts"]
    assert v["pass"] is True
    for name in ("live_buffers_flat", "rss_bounded", "geometry_stable",
                 "zero_breaker_trips"):
        assert v[name]["pass"] is True, (name, v[name])
    assert r["orders"] > 0 and r["events"] > 0 and r["frames"] > 0
    assert r["samples"] >= 5
    assert r["dispatches"] > 0  # journal_check raised on any escape
    assert r["settle_frames"] >= 8 and r["new_combos"] == []
    assert v["geometry_stable"]["changed_at_frames"] == []
    assert r["kept_grids"] > 0
    assert r["journal"]["schema"] == "gome-compile-journal/1"
    assert r["launches"] == 0  # the CPU runs K1's plain version
    assert "GL906 escapes" in chip_smoke.soak_text(r)


def test_soak_drill_gate_runs_between_settling_and_timed_loop(monkeypatch):
    """soak_drill's gate (DrillWorker's handshake) is called once, after
    the settling and before the timed loop, with the warm-up's and the
    settling's numbers."""
    monkeypatch.setattr(chip_smoke, "SOAK_SETTLE_FRAMES", 8)
    calls = []

    def gate(info):
        calls.append(dict(info, t=chip_smoke.time.perf_counter()))

    t0 = chip_smoke.time.perf_counter()
    r = chip_smoke.soak_drill("cpu", seconds=1.0, symbols=64, cap=64,
                              frame_n=512, interval=0.25, gate=gate)
    assert len(calls) == 1
    info = calls[0]
    assert info["settle_frames"] == r["settle_frames"] >= 8
    assert info["warmup_frames"] == r["warmup_frames"]
    assert t0 < info["t"] and r["verdicts"]["pass"] is True


def test_drill_worker_without_a_card_fails_before_its_reports():
    """DrillWorker on a machine without CUDA: the worker exits 1 at once,
    and fuzz() and soak() fail with its log instead of waiting."""
    worker = chip_smoke.DrillWorker(seconds=1.0)
    try:
        with pytest.raises(SystemExit, match="(?s)exited 1 before writing "
                                             "fuzz.json.*no CUDA card"):
            worker.fuzz(timeout_s=120)
        with pytest.raises(SystemExit, match="(?s)exited 1 before writing "
                                             "settled.json"):
            worker.soak(timeout_s=120)
    finally:
        worker.stop()
    assert not chip_smoke.os.path.exists(worker.work)
