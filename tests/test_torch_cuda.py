"""Tests that need the CUDA card: the match-step kernel and the Hawkes
bin scan against their plain PyTorch versions, the engine on the card
against the oracle, and the simulator on the card against the CPU. They skip
where torch.cuda.is_available() is False. This file imports no JAX, so on
a machine with the card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gome_tpu_torch.engine import BookConfig, DeviceOp, MatchEngine
from gome_tpu_torch.ops import match_step
from gome_tpu_torch.utils.streams import mixed_stream, multi_symbol_stream

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "cap, k, dtype, fill",
    [
        (16, 4, torch.int32, 0.9),
        (256, 16, torch.int32, 0.6),
        (256, 16, torch.int64, 0.6),
        (64, 64, torch.int64, 0.9),
        (4096, 16, torch.int32, 0.9),
        (8192, 16, torch.int64, 0.9),
    ],
)
def test_kernel_matches_plain_version(cuda, cap, k, dtype, fill):
    rng = np.random.default_rng(cap + k)
    config = BookConfig(cap=cap, max_fills=k, dtype=dtype)
    books, seeded = chip_smoke.deep_books(rng, config, 24, fill, cuda)
    grids = chip_smoke.flow_grids(rng, config, 24, 16, 3, seeded, cuda)
    before = [a.clone() for a in books]
    assert chip_smoke.check_kernel_case(f"cap {cap}", config, books, grids) == 0
    for a, b in zip(books, before):
        assert torch.equal(a, b)  # the kernel never writes its inputs


# (case, rows, T, cap, K, dtype): inputs aimed at the kernel's shortcuts
# (chip_smoke.edge_case), at widths the engine reaches on the card.
EDGE_CASES = [
    ("deep", 1, 512, 2048, 16, torch.int32),
    ("deep", 4, 256, 256, 16, torch.int64),
    ("full", 24, 64, 256, 16, torch.int32),
    ("full", 8, 64, 2048, 16, torch.int32),
    ("full", 8, 64, 64, 64, torch.int64),
    ("wipe", 24, 64, 256, 16, torch.int32),
    ("wipe", 4, 32, 4096, 16, torch.int64),
    ("del_ends", 16, 128, 256, 16, torch.int32),
    ("del_ends", 4, 96, 2048, 16, torch.int64),
    ("dup_oids", 24, 64, 256, 16, torch.int64),
    ("heavy", 24, 64, 256, 16, torch.int32),
    ("heavy", 8, 64, 2048, 16, torch.int32),
    ("stale_tails", 24, 64, 256, 16, torch.int32),
    ("full", 4, 64, 8192, 16, torch.int64),
]


@pytest.mark.parametrize("name, s, t, cap, k, dtype", EDGE_CASES)
def test_kernel_matches_plain_version_on_edge_cases(cuda, name, s, t, cap, k,
                                                    dtype):
    rng = np.random.default_rng(cap * 1000 + t + s)
    config = BookConfig(cap=cap, max_fills=k, dtype=dtype)
    books, grid = chip_smoke.edge_case(rng, config, name, s, t, cuda)
    before = [a.clone() for a in (*books, *grid)]
    assert chip_smoke.check_kernel_case(name, config, books, [grid]) == 0
    for a, b in zip((*books, *grid), before):
        assert torch.equal(a, b)


def test_engine_on_the_card_matches_the_oracle(cuda):
    config = BookConfig(cap=16, max_fills=4, dtype=torch.int32)
    zipf = multi_symbol_stream(n=3000, n_symbols=200, zipf_a=1.2,
                               cancel_prob=0.3, seed=3)
    hot = mixed_stream(n=1500, cancel_prob=0.3, market_prob=0.2, seed=4)
    e1 = MatchEngine(config, n_slots=256, max_t=16)
    e2 = MatchEngine(config, n_slots=4, max_t=16)
    match_step.batch_step.launches = 0
    got1, _ = chip_smoke.run_engine(e1, zipf, 700, columnar=True)
    got2, _ = chip_smoke.run_engine(e2, hot, 500, columnar=False)
    assert got1 == chip_smoke.oracle_events(zipf)
    assert got2 == chip_smoke.oracle_events(hot)
    e1.batch.verify_books()
    e2.batch.verify_books()
    calls = e1.stats.device_calls + e2.stats.device_calls
    assert match_step.batch_step.launches == calls > 0
    assert e2.stats.cap_escalations and e2.stats.fill_record_escalations


def test_frame_scatters_drop_on_the_card(cuda):
    """The frame path's writes through a sentinel column: the grid build
    (padding columns carry flat == R*T) and the event compaction (record
    slots without a fill, appends past the buffer) on the card equal the
    same calls on the CPU and a numpy reference; every grid leaf is
    contiguous for the kernel."""
    from gome_tpu_torch.engine import frames

    rng = np.random.default_rng(5)
    n_rows, t_grid, m, m_pad = 16, 8, 40, 64
    flat = np.full(m_pad, n_rows * t_grid, np.int64)
    flat[:m] = rng.choice(n_rows * t_grid, m, replace=False)
    cols = rng.integers(1, 1000, size=(7, m_pad)).astype(np.int32)
    want = np.zeros((7, n_rows * t_grid), np.int64)
    want[:, flat[:m]] = cols[:, :m]
    ops = frames._scatter_grid_fn(torch.from_numpy(cols).to(cuda),
                               torch.from_numpy(flat).to(cuda), n_rows, t_grid)
    for i, a in enumerate(ops):
        assert a.is_contiguous() and a.shape == (n_rows, t_grid)
        np.testing.assert_array_equal(a.cpu().numpy().reshape(-1), want[i])

    config = BookConfig(cap=256, max_fills=16, dtype=torch.int32)
    books, seeded = chip_smoke.deep_books(rng, config, 64, 0.6, cuda)
    grid = chip_smoke.flow_grids(rng, config, 64, 16, 1, seeded, cuda)[0]
    _, outs = match_step.batch_step(config, books, grid)
    n_fills = int((outs.fill_qty > 0).sum())
    for e_fills in (n_fills // 3, 2 * n_fills):
        bufs = []
        for dev in (cuda, torch.device("cpu")):
            acc = (torch.zeros((7, e_fills + 1), dtype=torch.int32, device=dev),
                   torch.zeros((2, 513), dtype=torch.int32, device=dev),
                   torch.zeros((8, 4), dtype=torch.int32, device=dev))
            o = type(outs)(*(a.to(dev) for a in outs))
            for g in range(2):  # the second grid appends after the first
                frames.compact_accum(o, *acc, g)
            bufs.append([a[..., :-1].cpu() if i < 2 else a.cpu()
                         for i, a in enumerate(acc)])
        for a, b in zip(*bufs):
            assert torch.equal(a, b)
        assert bufs[0][2][:2, 0].tolist() == [n_fills, n_fills]


def test_cap_class_step_on_the_card(cuda):
    """BatchEngine._step at cap class 64 on 256-slot storage, dense and
    full grids, on the card equals the same step on the CPU: every book
    leaf (the storage tail untouched) and every output."""
    rng = np.random.default_rng(9)
    storage = BookConfig(cap=256, max_fills=16, dtype=torch.int32)
    books, seeded = chip_smoke.deep_books(rng, storage, 32, 0.2, cuda)
    grid = chip_smoke.flow_grids(rng, storage, 32, 8, 1, seeded, cuda)[0]
    lane_ids = np.array([5, 0, 31, 7, 12] + [32] * 3)
    rows = DeviceOp(*(a[:8].clone() for a in grid))
    rows = rows._replace(action=torch.where(
        torch.from_numpy(lane_ids < 32)[:, None].to(cuda), rows.action, 0))
    for ids, ops in ((lane_ids, rows), (None, grid)):
        out = []
        for dev in (cuda, torch.device("cpu")):
            eng = MatchEngine(storage, n_slots=32, device=dev).batch
            b = type(books)(*(a.to(dev) for a in books))
            o = DeviceOp(*(a.to(dev) for a in ops))
            new, res = eng._step(b, o, ids, 64)
            out.append([a.cpu() for a in (*new, *res)])
        for a, b in zip(*out):
            assert torch.equal(a, b)
        assert torch.equal(out[0][0][..., 64:], books.price[..., 64:].cpu())


def test_fast_frames_equal_exact_frames_on_the_card(cuda):
    """A Zipf flow through MatchEngine.process_frame on the card, fast
    (cap classes, compaction, two-phase fetch) and exact: equal events,
    equal to the oracle, equal books; launches account for every device
    call."""
    zipf = multi_symbol_stream(n=6000, n_symbols=300, zipf_a=1.2,
                               cancel_prob=0.3, seed=5)
    frames = [chip_smoke.frame_columns(zipf[i:i + 1500])
              for i in range(0, len(zipf), 1500)]
    config = BookConfig(cap=256, max_fills=16, dtype=torch.int32)
    fast = MatchEngine(config, n_slots=512, max_t=16)
    exact = MatchEngine(config, n_slots=512, max_t=16)
    match_step.batch_step.launches = 0
    got_f, _ = chip_smoke.run_frames(fast, frames, fast=True)
    got_e, _ = chip_smoke.run_frames(exact, frames, fast=False)
    assert got_f == got_e == chip_smoke.oracle_events(zipf)
    sf, se = fast.batch.export_state(), exact.batch.export_state()
    for name, a in se["books"].items():
        np.testing.assert_array_equal(sf["books"][name], a, err_msg=name)
    assert (match_step.batch_step.launches
            == fast.stats.device_calls + exact.stats.device_calls)
    fast.batch.verify_books()


def test_sharded_steps_on_the_card_equal_the_cpu(cuda):
    """sharded_batch_step and sharded_dense_step over two shards on
    cuda:0 equal the same steps over two CPU shards (K1's plain version):
    every book leaf and every output."""
    from gome_tpu_torch.parallel import (make_mesh, shard_batch,
                                         sharded_batch_step,
                                         sharded_dense_step)

    rng = np.random.default_rng(11)
    config = BookConfig(cap=256, max_fills=16, dtype=torch.int32)
    books, seeded = chip_smoke.deep_books(rng, config, 64, 0.6, cuda)
    grid = chip_smoke.flow_grids(rng, config, 64, 16, 1, seeded, cuda)[0]
    ids = np.array([3, 0, 9] + [32] * 5 + [40, 33] + [32] * 6)
    rows = DeviceOp(*(a[:16].clone() for a in grid))
    rows = rows._replace(action=torch.where(
        torch.from_numpy(ids < 32)[:, None].to(cuda), rows.action, 0))
    out = []
    for dev in (cuda, torch.device("cpu")):
        mesh = make_mesh(2, devices=[dev] * 2)
        b = shard_batch(mesh, type(books)(*(a.to(dev) for a in books)))
        full = sharded_batch_step(config, mesh)(
            b, shard_batch(mesh, DeviceOp(*(a.to(dev) for a in grid))))
        dense = sharded_dense_step(config, mesh)(
            b, ids, shard_batch(mesh, DeviceOp(*(a.to(dev) for a in rows))))
        out.append([a.cpu() for r in (*full, *dense) for a in r.gather()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fast", [True, False])
def test_two_shards_on_one_card_equal_the_unsharded_engine(cuda, fast):
    """A Zipf flow through process_frame on a D=2 mesh of cuda:0 blocks
    equals the unsharded engine on the card: events (and the oracle's),
    every book leaf; K1 launches once per shard per grid."""
    from gome_tpu_torch.parallel import make_mesh

    zipf = multi_symbol_stream(n=6000, n_symbols=300, zipf_a=1.2,
                               cancel_prob=0.3, seed=6)
    frames = [chip_smoke.frame_columns(zipf[i:i + 1500])
              for i in range(0, len(zipf), 1500)]
    config = BookConfig(cap=256, max_fills=16, dtype=torch.int32)
    single = MatchEngine(config, n_slots=512, max_t=16)
    sharded = MatchEngine(config, n_slots=512, max_t=16,
                          mesh=make_mesh(2, devices=[cuda] * 2))
    got_u, _ = chip_smoke.run_frames(single, frames, fast=fast)
    match_step.batch_step.launches = 0
    got_s, _ = chip_smoke.run_frames(sharded, frames, fast=fast)
    assert got_s == got_u == chip_smoke.oracle_events(zipf)
    # Every leaf equal (at the wider storage cap, should the two engines'
    # different grids have escalated the storage to different widths).
    chip_smoke.same_states("D=2", sharded.batch.export_state(),
                           single.batch.export_state(), widths=False)
    per_row = sharded.stats.fill_record_escalations
    assert match_step.batch_step.launches == (
        2 * (sharded.stats.device_calls - per_row) + per_row)
    sharded.batch.verify_books()


def _consume(cuda, frames, depth, symbols=64):
    """Publish every frame through the gateway step, drain a frame-wire
    OrderConsumer at the given depth; returns the engine, the match-queue
    bodies and the decoded events."""
    eng, bus, consumer = chip_smoke.consumer_stack(cuda, symbols, depth)
    for cols in frames:
        chip_smoke.gateway_step(eng, bus.order_queue, cols)
    consumer.drain()
    assert bus.order_queue.committed() == bus.order_queue.end_offset()
    events, feed = chip_smoke.match_queue_events(bus)
    assert [e.seq for e in events] == list(range(len(events)))
    assert feed.suppressed == 0 and feed.seq_state()["gaps"] == 0
    bodies = [m.body for m in bus.match_queue.read_from(0, 1 << 20)]
    return eng, bodies, chip_smoke.unstamped(events)


def test_pipelined_consumer_equals_synchronous_on_the_card(cuda):
    """A 64-symbol Zipf flow through the consumer on the card at depth 2
    and at depth 0: byte-equal match-queue bodies, equal books, events
    equal to the oracle."""
    zipf = multi_symbol_stream(n=6000, n_symbols=64, zipf_a=1.2,
                               cancel_prob=0.3, seed=8)
    frames = [chip_smoke.frame_columns(zipf[i:i + 500])
              for i in range(0, len(zipf), 500)]
    e2, bodies2, events = _consume(cuda, frames, 2)
    e0, bodies0, _ = _consume(cuda, frames, 0)
    assert bodies2 == bodies0
    assert events == chip_smoke.oracle_events(zipf)
    b2, b0 = e2.batch.lane_books(), e0.batch.lane_books()
    for name in b0._fields:
        np.testing.assert_array_equal(getattr(b2, name), getattr(b0, name),
                                      err_msg=name)
    e2.batch.verify_books()


def test_pipelined_consumer_on_the_second_card_while_the_first_is_current(
        cuda):
    """An engine on cuda:1 behind a depth-2 consumer while cuda:0 stays
    the current card: submit_frame records its fetch event on the
    engine's card, so resolve_frame waits for that card's copies. A spin
    queued on cuda:1 first holds its copies back; an event recorded on
    cuda:0's stream would let resolve read the totals before they land.
    Match-queue bodies byte-equal to depth 0 on cuda:0, events equal to
    the oracle."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    zipf = multi_symbol_stream(n=3000, n_symbols=64, zipf_a=1.2,
                               cancel_prob=0.3, seed=12)
    frames = [chip_smoke.frame_columns(zipf[i:i + 500])
              for i in range(0, len(zipf), 500)]
    second = torch.device("cuda", 1)
    eng, bus, consumer = chip_smoke.consumer_stack(second, 64, 2)
    for cols in frames:
        chip_smoke.gateway_step(eng, bus.order_queue, cols)
    with torch.cuda.device(second):
        torch.cuda._sleep(200_000_000)
    assert torch.cuda.current_device() == 0
    consumer.drain()
    assert eng.batch.device == second
    bodies1 = [m.body for m in bus.match_queue.read_from(0, 1 << 20)]
    events, _ = chip_smoke.match_queue_events(bus)
    _, bodies0, _ = _consume(cuda, frames, 0)
    assert bodies1 == bodies0
    assert chip_smoke.unstamped(events) == chip_smoke.oracle_events(zipf)
    eng.batch.verify_books()


def test_need_exact_with_a_frame_in_flight_on_the_card(cuda):
    """A frame whose fills overflow the compaction buffer resolves while
    the next frames are queued on the card: one fallback, the later frames
    resubmitted, events equal to the oracle."""
    line = chip_smoke.consumer_fill_buffer_check(cuda, 64)
    assert "1 frame fallback" in line


@pytest.mark.parametrize("t_bins, start", [(1, "mu"), (32, "mu"),
                                           (1024, "stationary"),
                                           (3000, "stationary")])
def test_hawkes_scan_kernel_matches_plain_version(cuda, t_bins, start):
    """K5 against its plain version on draws made on the card: occur,
    etype, oid and next_oid equal, lam bit-equal; T = 3,000 crosses the
    kernel's 512-bin staging chunks."""
    from gome_tpu_torch.ops import hawkes_scan
    from gome_tpu_torch.sim import FlowConfig

    config = FlowConfig()
    lam0 = config.mu() if start == "mu" else chip_smoke.stationary_lam(config)
    args = chip_smoke.scan_inputs(config, t_bins, lam0, t_bins, cuda)
    before = [a.clone() for a in args]
    hawkes_scan.hawkes_scan.launches = 0
    chip_smoke.check_scan(f"T={t_bins}", config, args)
    assert hawkes_scan.hawkes_scan.launches == 1
    for a, b in zip(args, before):
        assert torch.equal(a, b)  # the kernel never writes its inputs


@pytest.mark.parametrize("name", chip_smoke.HAWKES_EDGE_CASES)
def test_hawkes_scan_kernel_matches_plain_version_on_edge_inputs(cuda, name):
    """K5 against its plain version at each of chip_smoke's edge inputs
    (an event in every bin, none, u_ev equal to p_event, tied maxima, an
    intensity at 0, a cut last round, T around a warp and a grid): occur,
    etype, oid and next_oid equal, lam bit-equal, one launch."""
    from gome_tpu_torch.ops import hawkes_scan
    from gome_tpu_torch.sim import FlowConfig

    config = FlowConfig()
    args = chip_smoke.hawkes_edge_case(config, name, cuda)
    before = [a.clone() for a in args]
    hawkes_scan.hawkes_scan.launches = 0
    chip_smoke.check_scan(name, config, args)
    assert hawkes_scan.hawkes_scan.launches == 1
    for a, b in zip(args, before):
        assert torch.equal(a, b)


def test_sim_env_on_the_card_equals_the_cpu(cuda):
    """Eight env_steps with a scripted agent at 64 lanes, on the card and
    on the CPU with the same draws: books, Obs and StepInfo equal; then a
    rollout on the card with one K1 and one K5 launch a step."""
    from gome_tpu_torch.ops import hawkes_scan
    from gome_tpu_torch.sim import env_reset, rollout

    config = chip_smoke.sim_env_config(64)
    assert chip_smoke.card_against_cpu("card", config, 8, cuda) > 0
    state, _ = env_reset(config, 1, cuda)
    match_step.batch_step.launches = hawkes_scan.hawkes_scan.launches = 0
    final, (rewards, info) = rollout(config, state, 20)
    assert match_step.batch_step.launches == 20
    assert hawkes_scan.hawkes_scan.launches == 20
    assert int(final.t) == 20 and bool(torch.isfinite(rewards).all())


def test_live_array_stats_on_the_card_cover_the_books(cuda):
    """obs.live on the card: the caching allocator's counters for cuda:0
    hold at least the engine's books, which pytree_stats counts exactly."""
    from gome_tpu_torch.obs import live

    eng = MatchEngine(BookConfig(cap=256, max_fills=16), n_slots=1024,
                      device=cuda)
    books = live.pytree_stats(eng.batch.books)
    assert books["bytes"] == sum(a.numel() * a.element_size()
                                 for a in eng.batch.books)
    stats = live.live_array_stats()
    card = stats["devices"][f"cuda:{torch.cuda.current_device()}"]
    assert card["active_bytes"] >= card["allocated_bytes"] >= books["bytes"]
    assert card["allocated_count"] >= books["count"]
    assert stats["bytes"] >= books["bytes"]


def test_measured_entry_report_on_the_card(cuda, tmp_path):
    """obs.profiler on the card: one capture of the cost model's entries
    gives a cuda_kernels row for each, K1 among batch_step's kernels,
    within the calibrated roofline."""
    from gome_tpu_torch.obs import costmodel, profiler

    rep = profiler.measured_entry_report("int64", repeats=3,
                                         log_dir=str(tmp_path), device=cuda)
    assert rep["platform"] == "cuda"
    assert list(rep["entries"]) == list(costmodel.RATCHET_ENTRIES)
    for row in rep["entries"].values():
        assert row["device_time_source"] == "cuda_kernels", row
        assert row["device_us_per_call"] > 0
        assert 0 < row["efficiency_pct"] <= 105
    events = profiler.load_trace_events(rep["run_dir"])
    assert len(rep["streams"]) == 1
    names = profiler.window_event_names(events, "batch_step",
                                        streams=rep["streams"])
    assert sum("match_step" in n for n in names) == 3
    for row in costmodel.entry_report("int64", cuda):
        assert row["argument_bytes"] > 0
        assert row["peak_hbm_bytes"] == (row["argument_bytes"]
                                         + row["output_bytes"]
                                         - row["alias_bytes"])


def test_capture_with_no_device_records_kernels(cuda, tmp_path):
    """``profiler.capture()`` with no arguments traces the card: a
    matmul run inside it lands as ``kernel`` events."""
    from gome_tpu_torch.obs import profiler

    a = torch.ones((256, 256), device=cuda)
    with profiler.capture(str(tmp_path)) as cap:
        (a @ a).sum().item()
    events = profiler.load_trace_events(cap.run_dir)
    assert any(e.get("cat") == "kernel" for e in events)
    assert profiler.machine_peaks()["peak_gflops"] > 0
