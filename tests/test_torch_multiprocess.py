"""The reference's split deployment on the port, across real processes, on
the CPU: tests/test_multiprocess.py's four topologies with every other
process importing only gome_tpu_torch. A producer process (the gateway
role) publishes orders to a file bus and, over AMQP 0-9-1 through the
port's broker, to doOrder; a gateway process marks the pre-pool in a RESP
marker server process and publishes the reference's cancel-before-consume
race; consumer processes are killed with SIGKILL mid-pipelined-frame and
restarted from a snapshot, unsharded and on four CPU shards. This process
consumes where the reference's does; every matchOrder stream must equal
gome_tpu's oracle on the same seeded inputs, exactly."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from gome_tpu.bus import decode_match_result
from gome_tpu.bus.colwire import decode_event_frame
from gome_tpu.oracle import OracleEngine
from gome_tpu.types import Action as JAction
from gome_tpu.types import Order as JOrder
from gome_tpu.types import Side as JSide
from gome_tpu.utils.streams import doorder_stream, multi_symbol_stream
from gome_tpu_torch.bus import QueueBus, make_bus
from gome_tpu_torch.bus.amqp import AmqpQueue
from gome_tpu_torch.bus.colwire import encode_orders
from gome_tpu_torch.bus.fakebroker import FakeBroker
from gome_tpu_torch.config import BusConfig
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.engine.prepool import RespPrePool
from gome_tpu_torch.persist.resp import RespClient
from gome_tpu_torch.persist.respserver import FakeRedisServer
from gome_tpu_torch.service.consumer import OrderConsumer
from gome_tpu_torch.types import Action
from test_torch_bus import port_order

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Printed last by every subprocess: the modules of the reference it holds.
NO_REFERENCE = r"""
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gome_tpu"))
print("REFERENCE-MODULES", bad, flush=True)
"""

_PRODUCER = r"""
import sys
sys.path.insert(0, {repo!r})
from gome_tpu_torch.bus import encode_order, make_bus
from gome_tpu_torch.bus.amqp import AmqpQueue
from gome_tpu_torch.config import BusConfig
from gome_tpu_torch.engine.prepool import RespPrePool, make_marker
from gome_tpu_torch.persist.resp import RespClient
from gome_tpu_torch.types import Action, Order, Side
from gome_tpu_torch.utils.streams import doorder_stream

# The file bus and the AMQP queue: the same 120 orders.
payloads = [encode_order(o) for o in doorder_stream(n=120)]
make_bus(BusConfig(backend="file", dir={filedir!r})).order_queue \
    .publish_batch(payloads)
q = AmqpQueue("doOrder", port={amqp_port})
for p in payloads:
    q.publish(p)
q.close()

# The gateway of the three-process topology: marks in the RESP server,
# publishes to its own file bus. The race: the gateway accepted
# raced:oid=race (marked it), but its DoOrder publish lost to a
# concurrent DeleteOrder publish, so the DEL lands in doOrder first.
pool = RespPrePool(RespClient(port={resp_port}))
mark = make_marker(pool)
orders = list(doorder_stream(n=80))
add = Order(uuid="u9", oid="race", symbol="raced", side=Side.BUY,
            price=3_000_000, volume=7)
delete = Order(uuid="u9", oid="race", symbol="raced", side=Side.BUY,
               price=3_000_000, volume=0, action=Action.DEL)
mark(add)
for o in orders:
    mark(o)
raced = [encode_order(delete), encode_order(add)]
raced += [encode_order(o) for o in orders]
make_bus(BusConfig(backend="file", dir={racedir!r})).order_queue \
    .publish_batch(raced)
print(len(payloads), len(raced), flush=True)
""" + NO_REFERENCE


def run_port_script(code: str, timeout: float = 120, **kw):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout, cwd=REPO, **kw)
    assert out.returncode == 0, out.stderr
    assert "REFERENCE-MODULES []" in out.stdout, out.stdout
    return out.stdout


def start_respserver():
    """The port's RESP marker server as its own process; -> (proc, port)."""
    srv = subprocess.Popen(
        [sys.executable, "-m", "gome_tpu_torch.persist.respserver",
         "--port", "0"], stdout=subprocess.PIPE, text=True, cwd=REPO)
    ready = srv.stdout.readline().split()
    assert ready and ready[0] == "READY", ready
    return srv, int(ready[1])


@pytest.fixture(scope="module")
def produced(tmp_path_factory):
    """One producer process for the file-bus, AMQP and three-process
    topologies; the broker and the marker server stay up for the module."""
    root = tmp_path_factory.mktemp("multiprocess")
    broker = FakeBroker().start()
    srv, resp_port = start_respserver()
    try:
        dirs = dict(filedir=str(root / "bus"), racedir=str(root / "raced"))
        out = run_port_script(_PRODUCER.format(
            repo=REPO, amqp_port=broker.port, resp_port=resp_port, **dirs))
        n_plain, n_raced = map(int, out.split("\n")[0].split())
        yield dict(dirs, broker=broker, resp_port=resp_port, n_plain=n_plain,
                   n_raced=n_raced)
    finally:
        broker.stop()
        srv.terminate()
        srv.wait(timeout=10)


def oracle_stream(orders) -> list:
    oracle = OracleEngine()
    return [e for o in orders for e in oracle.process(o)]


def port_engine(**kw) -> MatchEngine:
    return MatchEngine(BookConfig(cap=64, max_fills=8), n_slots=4,
                       device="cpu", **kw)


def test_cross_process_file_bus_pipeline(produced):
    """A producer process publishes 120 orders into the shared file bus;
    this process drains them through the port's engine and publishes the
    events, which equal the oracle's."""
    orders = list(doorder_stream(n=120))
    bus = make_bus(BusConfig(backend="file", dir=produced["filedir"]))
    engine = port_engine()
    for o in orders:
        engine.mark(port_order(o))  # gateway-side marks, this process
    drained = OrderConsumer(engine, bus, batch_n=64).drain()
    assert drained == produced["n_plain"] == len(orders)
    msgs = bus.match_queue.read_from(0, 10_000)
    assert [decode_match_result(m.body) for m in msgs] == oracle_stream(
        orders)
    engine.batch.verify_books()


def test_cross_process_amqp_pipeline(produced):
    """The reference's own topology: the producer process spoke AMQP 0-9-1
    over TCP to the port's broker; this process consumes, matches and
    publishes the events back over AMQP."""
    orders = list(doorder_stream(n=120))
    port = produced["broker"].port
    bus = QueueBus(AmqpQueue("doOrder", port=port),
                   AmqpQueue("matchOrder", port=port))
    engine = port_engine()
    for o in orders:
        engine.mark(port_order(o))
    consumer = OrderConsumer(engine, bus, batch_n=64)
    drained = 0
    deadline = time.monotonic() + 30
    while drained < produced["n_plain"] and time.monotonic() < deadline:
        drained += consumer.run_once()
    assert drained == produced["n_plain"] == len(orders)
    msgs = bus.match_queue.read_from(0, 10_000)
    assert [decode_match_result(m.body) for m in msgs] == oracle_stream(
        orders)
    engine.batch.verify_books()
    bus.order_queue.close()
    bus.match_queue.close()


def test_three_process_prepool_reference_topology(produced):
    """A marker server process, a gateway process that marked the pre-pool
    there, and this consumer, which never calls engine.mark: admission
    reads the marker server, and the cancel-before-consume race drops the
    queued ADD as the reference does."""
    bus = make_bus(BusConfig(backend="file", dir=produced["racedir"]))
    engine = port_engine()
    engine.pre_pool = RespPrePool(RespClient(port=produced["resp_port"]))
    assert OrderConsumer(engine, bus, batch_n=64).drain() == \
        produced["n_raced"]

    oracle = OracleEngine()
    add = JOrder(uuid="u9", oid="race", symbol="raced", side=JSide.BUY,
                 price=3_000_000, volume=7)
    delete = JOrder(uuid="u9", oid="race", symbol="raced", side=JSide.BUY,
                    price=3_000_000, volume=0, action=JAction.DEL)
    oracle.pre_pool.add(("raced", "u9", "race"))
    oracle.queue.append(delete)
    oracle.queue.append(add)
    for o in doorder_stream(n=80):
        oracle.submit(o)
    expected = oracle.drain()

    msgs = bus.match_queue.read_from(0, 10_000)
    assert [decode_match_result(m.body) for m in msgs] == expected
    assert engine.stats.dropped_no_prepool == 1
    assert oracle.stats.dropped_no_prepool == 1
    lane = engine.batch.symbol_lane("raced")
    books = engine.batch.lane_books()
    assert int(np.asarray(books.count)[lane].sum()) == 0
    engine.batch.verify_books()


_CRASH_CONSUMER = r"""
import os
import sys
sys.path.insert(0, {repo!r})
import torch
from gome_tpu_torch.bus import make_bus
from gome_tpu_torch.config import BusConfig, PersistConfig
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.engine.prepool import RespPrePool
from gome_tpu_torch.persist.resp import RespClient
from gome_tpu_torch.persist.snapshot import Persister
from gome_tpu_torch.service.consumer import OrderConsumer

mesh_n = {mesh_n}
mesh = None
if mesh_n:
    from gome_tpu_torch.parallel import make_mesh
    mesh = make_mesh(mesh_n, devices=[torch.device("cpu")] * mesh_n)
bus = make_bus(BusConfig(backend="file", dir={busdir!r}))
engine = MatchEngine(BookConfig(cap=64, max_fills=8), n_slots=8, mesh=mesh,
                     device="cpu")
engine.pre_pool = RespPrePool(RespClient(port={resp_port}))
persist = Persister(PersistConfig(dir={snapdir!r}, every_n_batches=1))
persist.attach(engine, bus)
consumer = OrderConsumer(
    engine, bus, batch_n=1, batch_wait_s=0, match_wire="frame",
    pipeline_depth=2, on_batch=persist.on_batch,
)
if {phase!r} == "crash":
    # Drain the first span (2 frames), a consistent cut, a snapshot.
    consumer.drain()
    assert persist.snapshots_taken >= 1, "no snapshot at the cut"
    print("SNAPSHOTTED", flush=True)
    # Two more frames in flight (books advanced, marks consumed in the
    # external store, offsets uncommitted, events unpublished), then die.
    consumer.run_once()
    consumer.run_once()
    os.kill(os.getpid(), 9)
restored = persist.restore_latest()
print(f"RESTORED {{restored}}", flush=True)
consumer.drain()
print("DRAINED", flush=True)
""" + NO_REFERENCE


@pytest.mark.parametrize("mesh_n", [0, 4])
def test_cross_process_crash_drill_external_marker_store(tmp_path, mesh_n):
    """SIGKILL a consumer process mid-pipelined-frame (marker store
    external, order log durable), restart it from its snapshot, unsharded
    and on four CPU shards: the matchOrder stream is exactly the oracle's,
    so recovery re-marked the in-flight frames' consumed ADDs from the
    order log."""
    busdir, snapdir = str(tmp_path / "bus"), str(tmp_path / "snaps")
    orders = list(multi_symbol_stream(n=250, n_symbols=6, seed=33,
                                      cancel_prob=0.2))
    tor = [port_order(o) for o in orders]
    with FakeRedisServer() as srv:
        pool = RespPrePool(RespClient(port=srv.port))
        for o in tor:
            if o.action is Action.ADD:
                pool.add((o.symbol, o.uuid, o.oid))
        bus = make_bus(BusConfig(backend="file", dir=busdir))
        frames = [tor[i:i + 50] for i in range(0, 250, 50)]
        for fr in frames[:2]:
            bus.order_queue.publish(encode_orders(fr))
        script = dict(repo=REPO, busdir=busdir, resp_port=srv.port,
                      snapdir=snapdir, mesh_n=mesh_n)
        crash = subprocess.Popen(
            [sys.executable, "-c",
             _CRASH_CONSUMER.format(phase="crash", **script)],
            stdout=subprocess.PIPE, text=True, cwd=REPO)
        try:
            line = crash.stdout.readline().strip()
            assert line == "SNAPSHOTTED", line
            for fr in frames[2:]:
                bus.order_queue.publish(encode_orders(fr))
            crash.wait(timeout=120)
        finally:
            if crash.poll() is None:
                crash.kill()
        assert crash.returncode == -9, crash.returncode
        committed = make_bus(BusConfig(backend="file", dir=busdir)) \
            .order_queue.committed()
        assert committed == 2, committed
        out = run_port_script(
            _CRASH_CONSUMER.format(phase="restart", **script), timeout=180)
        assert "RESTORED True" in out and "DRAINED" in out

    oracle = OracleEngine()
    for o in orders:
        oracle.submit(o)
    final = make_bus(BusConfig(backend="file", dir=busdir))
    got = [e for m in final.match_queue.read_from(0, 10_000)
           for e in decode_event_frame(m.body).to_results()]
    assert got == oracle.drain()
    assert final.order_queue.committed() == 5


def test_chip_smoke_split_topology_on_the_cpu(tmp_path):
    """chip_smoke.py phase 12 (b) on the CPU at a small size: the port's
    marker server, a `--amqp-consumer` process (depth 2, RespPrePool) and
    a `--amqp-gateway` process around this process's broker; the events
    equal the oracle's under the race, one ADD dropped on each side."""
    import chip_smoke

    b = chip_smoke.split_topology(str(tmp_path), device="cpu",
                                  n_orders=3000, n_symbols=64, frame_n=512,
                                  timeout_s=120)
    assert b["consumer"]["dropped"] == 1 and b["events"] > 1000
    assert b["messages"] == 2 + 6 and b["consumer"]["kernel_worst"] == 0
    assert b["consumer"]["orders"] == b["gateway"]["orders"] + 2 - 1

