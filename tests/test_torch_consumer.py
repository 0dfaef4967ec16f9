"""The port's order consumer and match feed (gome_tpu_torch.service) on the
CPU against gome_tpu.service: the same published ORDER frames and JSON
orders through both packages' OrderConsumer, at pipeline depths 0-3 and
on both match wires, give byte-identical match-queue bodies, equal books,
pre-pools, committed offsets and seqs; the poison-order quarantine
dead-letters the same orders; a failed commit replays with the same seqs;
both MatchFeeds suppress and count the same duplicates and gaps."""

import queue
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gome_tpu.types as jtypes
from gome_tpu.bus import encode_match_result, encode_order
from gome_tpu.bus.colwire import encode_event_frame as j_encode_event_frame
from gome_tpu.service.matchfeed import MatchFeed as JFeed
from gome_tpu.service.matchfeed import SeqTracker as JTracker
from gome_tpu.utils import faults as jfaults
from gome_tpu_torch.engine import BookConfig
from gome_tpu_torch.engine.batch import BatchEngine
from gome_tpu_torch.service import MatchFeed, OrderConsumer
from gome_tpu_torch.service.matchfeed import SeqTracker
from gome_tpu_torch.utils import faults as tfaults
from test_pipeline import _oracle_lines
from test_torch_bridge import HOSTS, assert_host, use_host
from test_torch_pipeline import (
    CHUNK,
    ENGINE_KW,
    SIDES,
    J,
    T,
    assert_pair_equal,
    bodies,
    flow,
    frames_for,
    mixed_payloads,
    publish,
    stack,
    step_until_committed,
)

FEEDS = {J: JFeed, T: MatchFeed}
FAULTS = {J: jfaults, T: tfaults}


def feed_state(side, bus):
    feed = FEEDS[side](bus, log_events=False)
    feed.drain()
    return feed.seq_state(), feed.events_seen, feed.suppressed


@pytest.mark.parametrize("wire", ["json", "frame"])
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_consumer_matches_gome_tpu(depth, wire):
    orders = flow()
    payloads = mixed_payloads(orders)
    out = {}
    for side in (J, T):
        engine, bus, consumer = stack(side, ENGINE_KW, depth, match_wire=wire)
        publish(side, engine, bus, orders, payloads)
        n = consumer.drain()
        out[side] = (engine, n, bodies(bus), bus.order_queue.committed(),
                     consumer.match_seq, feed_state(side, bus))
    (j, *j_rest), (t, *t_rest) = out[J], out[T]
    assert t_rest == j_rest
    n, t_bodies, committed, seq, (state, seen, suppressed) = t_rest
    assert n == len(orders) and committed == len(payloads)
    if wire == "json":
        assert t_bodies == _oracle_lines(orders)
    assert seq == seen == state["observed"] and suppressed == 0
    assert_pair_equal(t, j)
    t.batch.verify_books()


def _quarantine_stack(side, depth):
    s = SIDES[side]
    dtype = jnp.int32 if side == J else torch.int32
    kw = dict(device="cpu") if side == T else {}
    engine = s["engine"](config=s["config"](cap=32, max_fills=8, dtype=dtype),
                         n_slots=8, max_t=8, **kw)
    bus = s["bus"].QueueBus(s["bus"].MemoryQueue("doOrder"),
                            s["bus"].MemoryQueue("matchOrder"))
    consumer = s["consumer"](engine, bus, batch_n=16, batch_wait_s=0,
                             poison_threshold=3, pipeline_depth=depth)
    return engine, bus, consumer


@pytest.mark.parametrize("depth", [0, 2])
def test_poison_quarantine_dead_letters_the_same_orders(depth):
    """An order over the int32 lot ceiling fails its batch every time: after
    three failures the quarantine replays order by order, dead-letters it
    (its mark cleared) and publishes its neighbours, in a JSON message and
    inside an ORDER frame; both packages alike."""
    lot_max32 = (1 << 30) - 1
    add = lambda oid, side, volume: jtypes.Order(
        uuid="u", oid=oid, symbol="eth2usdt", side=jtypes.Side(side),
        price=100, volume=volume)
    good1, poison, good2 = add("g1", 1, 5), add("poison", 0, lot_max32 + 1), \
        add("g2", 0, 5)
    framed = [add("f1", 1, 3), add("fpoison", 0, lot_max32 + 1),
              add("f2", 0, 2), add("f3", 0, 9)]
    orders = [good1, poison, good2] + framed
    payloads = [encode_order(o) for o in orders[:3]] + frames_for(framed, 4)
    out = {}
    for side in (J, T):
        engine, bus, consumer = _quarantine_stack(side, depth)
        publish(side, engine, bus, orders, payloads)
        steps = [consumer.step_with_policy() for _ in range(8)]
        out[side] = (engine, steps, bodies(bus), bus.order_queue.committed(),
                     consumer.match_seq)
    (j, *j_rest), (t, *t_rest) = out[J], out[T]
    assert t_rest == j_rest
    steps, t_bodies, committed, _ = t_rest
    assert committed == len(payloads) and sum(steps) == 5
    assert len(t_bodies) == 3
    assert_pair_equal(t, j)
    assert ("eth2usdt", "u", "fpoison") not in t.pre_pool


@pytest.mark.parametrize("host", HOSTS)
@pytest.mark.parametrize("depth", [0, 2])
def test_commit_fault_replays_with_the_same_seqs(depth, host, monkeypatch):
    """A raise-mode fault at consumer.commit (the third commit, frames in
    flight at depth 2): step_with_policy rolls match_seq back and the
    pipeline aborts; the replay re-stamps from the last commit. Both
    packages publish the same bytes, and both feeds suppress the same
    re-stamped seqs with no gap; the port on its native host layer and on
    its Python branches."""
    use_host(monkeypatch, host)
    orders = flow()
    out = {}
    for side in (J, T):
        engine, bus, consumer = stack(side, ENGINE_KW, depth,
                                      match_wire="frame", batch_n=1)
        if side == T:
            assert_host(engine, host)
        publish(side, engine, bus, orders, frames_for(orders, CHUNK))
        f = FAULTS[side]
        f.FAULTS.install(f.FaultPlan(faults=(
            f.FaultSpec("consumer.commit", mode="raise", at=(3,)),)))
        try:
            step_until_committed(bus, consumer)
            fired = f.FAULTS.report()["fired"]
        finally:
            f.FAULTS.disable()
        out[side] = (engine, fired, bodies(bus), consumer.match_seq,
                     feed_state(side, bus))
    (j, *j_rest), (t, *t_rest) = out[J], out[T]
    assert t_rest == j_rest
    fired, _, _, (state, seen, suppressed) = t_rest
    assert [x["point"] for x in fired] == ["consumer.commit"]
    assert suppressed == state["dupes"] > 0 and state["gaps"] == 0
    assert seen == state["last_seq"] + 1
    assert_pair_equal(t, j)


def test_seq_tracker_matches():
    rng = np.random.default_rng(3)
    seqs = [int(s) for s in rng.integers(0, 40, size=300)]
    for first in (None, 0, 5):
        a, b = SeqTracker(first_seq=first), JTracker(first_seq=first)
        assert [a.observe(s) for s in seqs] == [b.observe(s) for s in seqs]
        assert a.state() == b.state()


def _snap(types, oid, side):
    return types.OrderSnapshot(uuid="u", oid=oid, symbol="s",
                               side=types.Side(side), price=100, volume=4)


def test_match_feed_suppresses_dupes_and_counts_gaps():
    """JSON lines and EVENT frames with repeated, missing and absent seqs:
    both feeds deliver the same events, suppress and count alike, and fan
    the same pb.MatchEvents, byte for byte, out to a subscriber."""
    from gome_tpu.bus import colwire as jcw
    from gome_tpu.engine import frames as jframes
    from test_torch_frames import batch_pair

    def results(seq):
        return jtypes.MatchResult(node=_snap(jtypes, f"t{seq}", 0),
                                  match_node=_snap(jtypes, f"m{seq}", 1),
                                  match_volume=2, seq=seq)

    lines = [encode_match_result(results(s)) for s in (0, 1, 1, 4, None, 2)]
    j_batch_engine, _ = batch_pair(32, 8, 16, 8)
    batch = jframes.process_frame(
        j_batch_engine, jcw.decode_order_frame(frames_for(flow(), CHUNK)[0]))
    assert len(batch) >= 2
    frames = [j_encode_event_frame(batch, seq0=s) for s in (5, 6, 20)]
    out = {}
    for side in (J, T):
        b = SIDES[side]["bus"]
        bus = b.QueueBus(b.MemoryQueue("doOrder"), b.MemoryQueue("matchOrder"))
        bus.match_queue.publish_batch(lines + frames + [j_encode_event_frame(
            batch)])
        feed = FEEDS[side](bus, log_events=True)
        sub: queue.Queue = queue.Queue()
        feed._subs.append(sub)
        feed.drain()
        fanned = []
        while not sub.empty():
            ev = sub.get()
            fanned.append(ev.SerializeToString())
        out[side] = (feed.seq_state(), feed.events_seen, feed.suppressed,
                     fanned, bus.match_queue.committed())
    assert out[T] == out[J]
    state, seen, suppressed, fanned, _ = out[T]
    assert state["last_seq"] == 20 + len(batch) - 1 and state["gaps"] > 0
    assert suppressed == state["dupes"] > 0
    assert seen == len(fanned) == state["observed"] - suppressed + len(batch) + 1


def test_threaded_consumer_and_feed_start_stop():
    """start()/stop() of the port's consumer and feed: frames published
    while the consumer thread runs all commit, with the same bytes as
    gome_tpu's synchronous drain."""
    orders = flow()
    payloads = frames_for(orders, CHUNK)
    engine, bus, consumer = stack(T, ENGINE_KW, 2, match_wire="frame",
                                  batch_wait_s=0.002)
    feed = MatchFeed(bus, log_events=False)
    for o in orders:
        engine.mark(SIDES[T]["order"](o))
    consumer.start()
    feed.start()
    with pytest.raises(RuntimeError):
        consumer.start()
    try:
        for p in payloads:
            bus.order_queue.publish(p)
        deadline = time.monotonic() + 60
        while (bus.order_queue.committed() < len(payloads)
               or bus.match_queue.committed() < bus.match_queue.end_offset()
               or bus.match_queue.end_offset() == 0):
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        consumer.stop()
        feed.stop()
    consumer.stop()
    j_engine, j_bus, j_consumer = stack(J, ENGINE_KW, 2, match_wire="frame")
    publish(J, j_engine, j_bus, orders, payloads)
    j_consumer.drain()
    assert bodies(bus) == bodies(j_bus)
    assert feed.seq_state()["gaps"] == 0 and feed.suppressed == 0
    assert feed.events_seen == consumer.match_seq > 0
    assert_pair_equal(engine, j_engine)


def test_reset_seq_and_argument_checks():
    engine, bus, consumer = stack(T, ENGINE_KW, 0, match_wire="frame")
    with pytest.raises(ValueError):
        OrderConsumer(engine, bus, match_wire="xml")
    with pytest.raises(ValueError):
        OrderConsumer(engine, bus, pipeline_depth=-1)
    with pytest.raises(ValueError):
        OrderConsumer(BatchEngine(BookConfig(), n_slots=4, device="cpu"),
                      bus, pipeline_depth=2)
    orders = flow()
    consumer.reset_seq(1000)
    j_engine, j_bus, j_consumer = stack(J, ENGINE_KW, 0, match_wire="frame")
    j_consumer.reset_seq(1000)
    for side, eng, b, c in ((T, engine, bus, consumer),
                            (J, j_engine, j_bus, j_consumer)):
        publish(side, eng, b, orders, frames_for(orders, CHUNK))
        c.drain()
    assert bodies(bus) == bodies(j_bus)
    assert consumer.match_seq == j_consumer.match_seq > 1000
