"""The port's cross-frame pipeline (gome_tpu_torch.engine.pipeline.
FramePipeline and the consumer's pipeline_depth) on the CPU against
gome_tpu's: the cases of tests/test_pipeline.py re-run on both packages
with the same inputs. Exact equality, tolerance 0: match-queue bodies,
committed offsets, books, pre-pools, stats, the persist hook's calls, and
the shape and cap class of every grid each engine dispatched."""

import numpy as np
import pytest

import gome_tpu.bus as jbus
import gome_tpu_torch.bus as tbus
from gome_tpu.bus import colwire as jcw
from gome_tpu.engine import frames as jframes
from gome_tpu.engine.book import BookConfig as JConfig
from gome_tpu.engine.orchestrator import MatchEngine as JEngine
from gome_tpu.engine.pipeline import FramePipeline as JPipeline
from gome_tpu.service.consumer import OrderConsumer as JConsumer
from gome_tpu.types import Order, Side
from gome_tpu.utils.streams import multi_symbol_stream
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.engine import frames as tframes
from gome_tpu_torch.engine.batch import BatchEngine
from gome_tpu_torch.engine.pipeline import FramePipeline
from gome_tpu_torch.service import OrderConsumer
from test_cap_classes import _hot_tail_orders
from test_pipeline import _oracle_lines
from test_torch_bridge import HOSTS, assert_host, use_host
from test_torch_bus import port_order
from test_torch_frames import STAT_FIELDS, assert_batches_equal, record_steps

J, T = "gome_tpu", "port"
SIDES = {
    J: dict(bus=jbus, frames=jframes, engine=JEngine, config=JConfig,
            consumer=JConsumer, pipeline=JPipeline, order=lambda o: o),
    T: dict(bus=tbus, frames=tframes, engine=MatchEngine, config=BookConfig,
            consumer=OrderConsumer, pipeline=FramePipeline, order=port_order),
}
ENGINE_KW = dict(cap=32, max_fills=8, n_slots=16, max_t=8)
ESCALATE_KW = dict(cap=8, max_fills=4, n_slots=8, max_t=4)
CHUNK = 40  # orders per ORDER frame


def flow():
    """The flow most cases share (5 symbols, 20% cancels), so gome_tpu
    compiles its grid shapes once per process."""
    return multi_symbol_stream(n=300, n_symbols=5, seed=11, cancel_prob=0.2)


def mixed_payloads(orders):
    """ORDER frames with a run of JSON orders between them."""
    return (frames_for(orders[:160], CHUNK)
            + [jbus.encode_order(o) for o in orders[160:180]]
            + frames_for(orders[180:], CHUNK))


def make_engine(side, cap, max_fills, n_slots, max_t):
    s = SIDES[side]
    kw = dict(device="cpu") if side == T else {}
    return s["engine"](config=s["config"](cap=cap, max_fills=max_fills),
                       n_slots=n_slots, max_t=max_t, **kw)


def frames_for(orders, chunk):
    return [jcw.encode_orders(orders[i:i + chunk])
            for i in range(0, len(orders), chunk)]


def stack(side, kw, depth, match_queue=None, **consumer_kw):
    """Engine, bus and consumer of one package (JSON wire, batch_n 4)."""
    s = SIDES[side]
    engine = make_engine(side, **kw)
    bus = s["bus"].QueueBus(s["bus"].MemoryQueue("doOrder"),
                            match_queue or s["bus"].MemoryQueue("matchOrder"))
    opts = dict(batch_n=4, batch_wait_s=0, match_wire="json",
                pipeline_depth=depth)
    opts.update(consumer_kw)
    return engine, bus, s["consumer"](engine, bus, **opts)


def publish(side, engine, bus, orders, payloads):
    conv = SIDES[side]["order"]
    for o in orders:
        engine.mark(conv(o))
    for p in payloads:
        bus.order_queue.publish(p)


def bodies(bus):
    return [m.body for m in bus.match_queue.read_from(0, 1 << 20)]


def run(side, kw, orders, chunk, depth, **consumer_kw):
    engine, bus, consumer = stack(side, kw, depth, **consumer_kw)
    publish(side, engine, bus, orders, frames_for(orders, chunk))
    n = consumer.drain()
    return engine, n, bodies(bus), consumer


def assert_books_equal(a, b, fields=("price", "lots", "seq", "count",
                                     "next_seq")):
    ba, bb = a.batch.lane_books(), b.batch.lane_books()
    for name in fields:
        np.testing.assert_array_equal(np.asarray(getattr(ba, name)),
                                      np.asarray(getattr(bb, name)),
                                      err_msg=name)
    assert set(a.pre_pool) == set(b.pre_pool)


def assert_pair_equal(t, j):
    """Port engine against gome_tpu's: books, pre-pool, stats, count_ub."""
    assert_books_equal(t, j)
    for f in STAT_FIELDS:
        assert getattr(t.stats, f) == getattr(j.stats, f), f
    np.testing.assert_array_equal(t.batch._ub_base, j.batch._ub_base)
    np.testing.assert_array_equal(t.batch._ub_extra, j.batch._ub_extra)


def step_until_committed(bus, consumer, limit=200):
    total = 0
    end = bus.order_queue.end_offset()
    for _ in range(limit):
        total += consumer.step_with_policy()
        if bus.order_queue.committed() >= end:
            break
    assert bus.order_queue.committed() == end
    return total


def escalation_orders():
    """12 resting SALEs (cap 8 overflows), a BUY that sweeps them (12 fills
    against K 4), then two-sided flow on a second symbol."""
    orders = [Order(uuid="u", oid=str(i), symbol="s", side=Side.SALE,
                    price=100 + i, volume=1) for i in range(12)]
    orders.append(Order(uuid="u", oid="sweep", symbol="s", side=Side.BUY,
                        price=300, volume=1000))
    return orders + [Order(uuid="u", oid=f"post{i}", symbol="s2",
                           side=Side(int(i % 2)), price=200 + (i % 3),
                           volume=2) for i in range(30)]


def test_pipelined_escalation_mid_pipeline():
    """Book overflow and record truncation in a frame mid-span: both
    packages rewind, re-run exactly, resubmit the later frames."""
    orders = escalation_orders()
    t, _, t_events, _ = run(T, ESCALATE_KW, orders, 10, 3)
    j, _, j_events, _ = run(J, ESCALATE_KW, orders, 10, 3)
    sync, _, sync_events, _ = run(T, ESCALATE_KW, orders, 10, 0)
    assert t_events == j_events == sync_events == _oracle_lines(orders)
    assert t.stats.cap_escalations >= 1 and t.stats.frame_fallbacks >= 1
    assert t.stats.fill_record_escalations >= 1
    assert_pair_equal(t, j)
    assert_books_equal(t, sync)
    t.batch.verify_books()


def test_count_ub_with_three_frames_in_flight_and_cap_classes():
    """Cap classes on (storage cap 256: classes 64 and 256) at depth 3:
    every resolve re-anchors count_ub with frames still in flight, so a
    wrong re-anchor would pack a later frame in another class. Every grid
    (shape, class, dense) and count_ub equal gome_tpu's."""
    orders = _hot_tail_orders(n_tail=6, hot_depth=80)
    kw = dict(cap=256, max_fills=16, n_slots=8, max_t=32)
    runs = {}
    for side in (J, T):
        engine, bus, consumer = stack(side, kw, 3)
        steps = record_steps(engine.batch)
        publish(side, engine, bus, orders, frames_for(orders, 20))
        consumer.drain()
        runs[side] = (engine, steps, bodies(bus))
    (j, j_steps, j_bodies), (t, t_steps, t_bodies) = runs[J], runs[T]
    assert t_steps == j_steps
    assert {c for _, c, _ in t_steps} == {64, 256}
    assert t_bodies == j_bodies == _oracle_lines(orders)
    assert_pair_equal(t, j)
    t.batch.verify_books()


@pytest.mark.parametrize("host", HOSTS)
@pytest.mark.parametrize("broken", ["resolve", "exact_rerun", "resubmit"])
def test_pipeline_hard_failures_restore_marks_and_replay(broken, host,
                                                        monkeypatch):
    """Hard failures inside the pipeline, at resolve (twice), in the exact
    re-run after a budget trip, and in the resubmission of the later
    frames after it: each rewinds to the failed frame's checkpoint and
    restores every in-flight frame's marks (a NativeConsumed on the port's
    native host layer, key tuples on its Python branches); the
    at-least-once replay converges to the synchronous result on both
    packages."""
    use_host(monkeypatch, host)
    if broken == "resolve":
        orders, kw, chunk = flow(), ENGINE_KW, CHUNK
    else:
        orders, kw, chunk = escalation_orders(), ESCALATE_KW, 10
    sync, _, sync_events, _ = run(T, kw, orders, chunk, 0)
    results = {}
    for side in (J, T):
        mod = SIDES[side]["frames"]
        engine, bus, consumer = stack(side, kw, 2)
        if side == T:
            assert_host(engine, host)
        publish(side, engine, bus, orders, frames_for(orders, chunk))
        fail = {"left": 2, "tripped": False}
        real_resolve, real_apply = mod.resolve_frame, mod.apply_frame
        real_submit = mod.submit_frame

        def resolve(eng, pend, real=real_resolve, mod=mod, fail=fail):
            if broken == "resolve" and fail["left"] > 0:
                fail["left"] -= 1
                raise RuntimeError("injected resolve failure")
            try:
                return real(eng, pend)
            except mod._NeedExact:
                fail["tripped"] = True
                raise

        def apply(eng, cols, real=real_apply, fail=fail):
            if broken == "exact_rerun" and fail["left"] > 0:
                fail["left"] -= 1
                raise RuntimeError("injected exact re-run failure")
            return real(eng, cols)

        def submit(eng, cols, real=real_submit, fail=fail):
            if broken == "resubmit" and fail["tripped"] and fail["left"] > 0:
                fail["left"] -= 1
                raise RuntimeError("injected resubmit failure")
            return real(eng, cols)

        monkeypatch.setattr(mod, "resolve_frame", resolve)
        monkeypatch.setattr(mod, "apply_frame", apply)
        monkeypatch.setattr(mod, "submit_frame", submit)
        total = step_until_committed(bus, consumer)
        assert fail["left"] == 0
        results[side] = (engine, total, bodies(bus))
    (j, j_total, j_bodies), (t, t_total, t_bodies) = results[J], results[T]
    assert t_total == j_total == len(orders)
    assert t_bodies == j_bodies == sync_events
    assert_pair_equal(t, j)
    assert_books_equal(t, sync)
    t.batch.verify_books()


def test_pipeline_submit_failure_restores_own_marks(monkeypatch):
    orders = flow()
    payloads = frames_for(orders, CHUNK)
    pools = []
    for side in (J, T):
        s = SIDES[side]
        engine = make_engine(side, **ENGINE_KW)
        for o in orders:
            engine.mark(s["order"](o))
        pipe = s["pipeline"](engine, depth=4)
        pipe.feed(jcw.decode_order_frame(payloads[0]), token=0)
        marks_after_first = set(engine.pre_pool)

        def boom(eng, cols):
            raise RuntimeError("injected submit failure")

        monkeypatch.setattr(s["frames"], "submit_frame", boom)
        with pytest.raises(RuntimeError):
            pipe.feed(jcw.decode_order_frame(payloads[1]), token=1)
        assert engine.pre_pool == marks_after_first
        assert len(pipe) == 1
        pools.append(engine.pre_pool)
    assert set(pools[0]) == set(pools[1])


def test_pipeline_feed_flush_step_abort():
    """FramePipeline driven directly: feed returns what resolved (token and
    EventBatch), step resolves the oldest, flush the rest, abort rewinds
    the in-flight span and restores its marks; both packages alike."""
    orders = flow()
    cols = [jcw.decode_order_frame(p) for p in frames_for(orders, CHUNK)]
    out = {}
    for side in (J, T):
        s = SIDES[side]
        engine = make_engine(side, **ENGINE_KW)
        for o in orders:
            engine.mark(s["order"](o))
        marks0 = set(engine.pre_pool)
        with pytest.raises(ValueError):
            s["pipeline"](engine, depth=0)
        pipe = s["pipeline"](engine, depth=2)
        assert pipe.step() is None
        got, lens = [], []
        for i, c in enumerate(cols[:4]):
            got += pipe.feed(c, token=i)
            lens.append(len(pipe))
        got.append(pipe.step())
        lens.append(len(pipe))
        got += pipe.flush()
        lens.append(len(pipe))
        for i, c in enumerate(cols[4:]):
            pipe.feed(c, token=4 + i)
        assert len(pipe) == 2
        pipe.abort()
        assert len(pipe) == 0
        pipe.abort()
        out[side] = (engine, got, lens, marks0)
    (j, j_got, j_lens, _), (t, t_got, t_lens, _) = out[J], out[T]
    assert t_lens == j_lens == [1, 2, 2, 2, 1, 0]
    assert [tok for tok, _ in t_got] == [tok for tok, _ in j_got] == \
        [0, 1, 2, 3]
    for (_, tb), (_, jb) in zip(t_got, j_got):
        assert_batches_equal(tb, jb)
    assert_pair_equal(t, j)


def test_pipeline_abort_restores_in_flight_span():
    orders = flow()
    engines = []
    for side in (J, T):
        s = SIDES[side]
        engine = make_engine(side, **ENGINE_KW)
        for o in orders:
            engine.mark(s["order"](o))
        marks0 = set(engine.pre_pool)
        pipe = s["pipeline"](engine, depth=8)
        for i, p in enumerate(frames_for(orders, CHUNK)):
            pipe.feed(jcw.decode_order_frame(p), token=i)
        assert len(pipe) == 8
        pipe.abort()
        assert len(pipe) == 0 and engine.pre_pool == marks0
        engines.append(engine)
    ref = make_engine(T, **ENGINE_KW)
    for o in orders:
        ref.mark(port_order(o))
    assert_books_equal(engines[1], ref)
    assert_pair_equal(engines[1], engines[0])


def test_pipelined_publish_failure_aborts_and_replays():
    """The match queue fails once while a resolved frame publishes: the
    in-flight span aborts and the replay converges; both packages lose the
    same frame's events and publish the same bytes otherwise."""
    orders = flow()
    results = {}
    for side in (J, T):
        b = SIDES[side]["bus"]

        class FlakyQueue(b.MemoryQueue):
            fail_left = 1

            def publish_batch(self, bodies):
                if self.fail_left > 0 and bodies:
                    self.fail_left -= 1
                    raise RuntimeError("injected publish failure")
                return super().publish_batch(bodies)

        engine, bus, consumer = stack(side, ENGINE_KW, 2,
                                      match_queue=FlakyQueue("matchOrder"))
        publish(side, engine, bus, orders, frames_for(orders, CHUNK))
        step_until_committed(bus, consumer)
        engine.batch.verify_books()
        results[side] = (engine, bodies(bus), consumer.match_seq)
    (j, j_bodies, j_seq), (t, t_bodies, t_seq) = results[J], results[T]
    assert t_bodies == j_bodies and t_seq == j_seq
    assert_pair_equal(t, j)
    sync, _, _, _ = run(T, ENGINE_KW, orders, CHUNK, 0)
    assert_books_equal(t, sync, fields=("price", "lots", "count"))


def test_checkpoint_restorable_twice_after_interim_mutation():
    """The port's _restore copies the host arrays: the pipeline restores
    one checkpoint twice with an exact re-run mutating them between."""
    import torch

    btc = 10_000_000_000_000
    from gome_tpu_torch.types import Order as TOrder
    from gome_tpu_torch.types import Side as TSide

    eng = BatchEngine(BookConfig(cap=8, max_fills=4, dtype=torch.int32),
                      n_slots=4, max_t=4, device="cpu")
    cp = eng._checkpoint()
    base0, set0 = eng.price_base.copy(), eng._base_set.copy()
    eng._restore(cp)
    eng.process([TOrder(uuid="u", oid="1", symbol="btc", side=TSide.BUY,
                        price=btc, volume=5)])
    assert eng._base_set.any()
    eng._restore(cp)
    np.testing.assert_array_equal(eng.price_base, base0)
    np.testing.assert_array_equal(eng._base_set, set0)


def test_pipelined_persist_hook_fires_only_at_consistent_cuts():
    """on_batch (a plain callback standing in for the persist hook) sees
    only pipeline-empty states, with the same counts on both packages."""
    orders = flow()
    calls = {}
    for side in (J, T):
        got = []
        box = {}
        engine, bus, consumer = stack(
            side, ENGINE_KW, 2,
            on_batch=lambda n, e, got=got, box=box: got.append(
                (n, e, len(box["c"]._pipe) if box["c"]._pipe else 0)))
        box["c"] = consumer
        publish(side, engine, bus, orders, frames_for(orders, CHUNK))
        assert consumer.drain() == len(orders)
        calls[side] = got
    assert calls[T] == calls[J]
    assert sum(c[0] for c in calls[T]) == len(orders)
    assert all(c[2] == 0 for c in calls[T])


def test_pipeline_mixed_json_and_frames():
    """JSON messages between ORDER frames drain the pipeline first."""
    orders = flow()
    payloads = mixed_payloads(orders)
    results = {}
    for side in (J, T):
        engine, bus, consumer = stack(side, ENGINE_KW, 2)
        publish(side, engine, bus, orders, payloads)
        assert consumer.drain() == len(orders)
        results[side] = (engine, bodies(bus))
    sync, _, sync_events, _ = run(T, ENGINE_KW, orders, CHUNK, 0)
    assert results[T][1] == results[J][1] == sync_events
    assert_pair_equal(results[T][0], results[J][0])
    assert_books_equal(results[T][0], sync)
