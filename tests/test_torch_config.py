"""The port's config (gome_tpu_torch.config) against gome_tpu.config: one
YAML file with every section loads into both packages with equal sections
(dataclasses.asdict), the same checks reject the same bad values with the
same messages, EngineService refuses every section and flag the port
cannot run yet, naming the ROADMAP item that will port it, and the
rabbitmq:, persist: and redis: sections boot (an unusable store keeps the
in-process pool, as in gome_tpu)."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import gome_tpu.config as jconfig
import gome_tpu_torch.config as tconfig
from gome_tpu_torch.service.app import EngineService
from test_torch_service_parts import limited

SECTIONS = [f.name for f in dataclasses.fields(tconfig.Config)]

EVERY_SECTION = """
grpc:
  host: gome
  port: "8089"
redis:
  host: redis
  port: 6380
  password: "123456"
rabbitmq:
  host: rabbitmq
  port: 5673
  username: root
  password: "123456"
mysql:
  host: 127.0.0.1
  port: 3306
bus:
  dir: {bus_dir}
  match_wire: frame
gomengine:
  accuracy: 6
engine:
  cap: 64
  max_fills: 8
  n_slots: 16
  max_t: 8
  dtype: int32
  auto_grow: false
  kernel: pallas
  pipeline_depth: 2
  mesh_devices: 2
persist:
  dir: snaps
  every_n_batches: 8
  keep: 2
ops:
  port: 0
  trace_keep: 16
  slow_ms: 5.0
  cost: false
  timeline_interval_s: 0.5
  placement_alpha: 0.5
fleet:
  members:
    - a=http://127.0.0.1:1
    - b: http://127.0.0.1:2
  interval_s: 0.5
sim:
  n_lanes: 32
  zipf_a: 1.4
  cap: 32
  dtype: int64
faults:
  seed: 7
  points:
    - point: consumer.commit
      mode: raise
      at: [3]
admission:
  max_depth: 128
  retry_after_s: 0.1
"""


def write(tmp_path, text, name="config.yaml"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def both(path):
    return jconfig.load_config(path), tconfig.load_config(path)


def assert_sections_equal(j, t):
    for name in SECTIONS:
        assert dataclasses.asdict(getattr(t, name)) == dataclasses.asdict(
            getattr(j, name)), name


def test_every_section_loads_equal(tmp_path):
    j, t = both(write(tmp_path, EVERY_SECTION.format(bus_dir=tmp_path)))
    assert_sections_equal(j, t)
    assert t.store.enabled and t.bus.backend == "amqp" and t.persist.enabled
    assert t.ops.enabled and t.fleet.enabled and t.faults.enabled
    assert t.admission.enabled and t.grpc.port == 8089
    assert t.fleet.member_map() == j.fleet.member_map()
    assert t.faults.fault_plan().to_dict() == j.faults.fault_plan().to_dict()


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_book_config_differs_only_in_dtype_type(tmp_path, dtype):
    j, t = both(write(tmp_path, f"engine:\n  cap: 64\n  dtype: {dtype}\n"))
    jb, tb = j.engine.book_config(), t.engine.book_config()
    assert (tb.cap, tb.max_fills) == (jb.cap, jb.max_fills) == (64, 16)
    assert tb.dtype == getattr(torch, dtype)
    assert jb.dtype == getattr(jnp, dtype)


def test_defaults_without_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    j, t = jconfig.load_config(), tconfig.load_config()
    assert_sections_equal(j, t)
    assert_sections_equal(jconfig.Config(), tconfig.Config())
    assert t.engine.accuracy == 8 and not t.store.enabled


def test_cwd_config_yaml_is_read(tmp_path, monkeypatch):
    write(tmp_path, "engine:\n  n_slots: 32\n")
    monkeypatch.chdir(tmp_path)
    j, t = jconfig.load_config(), tconfig.load_config()
    assert_sections_equal(j, t)
    assert t.engine.n_slots == 32


@pytest.mark.parametrize("kernel", ["scan", "pallas"])
def test_reference_kernel_values_load(tmp_path, kernel):
    j, t = both(write(tmp_path, f"engine:\n  kernel: {kernel}\n"))
    assert t.engine.kernel == j.engine.kernel == kernel


@pytest.mark.parametrize("text, match", [
    ("engine:\n  cap: -1\n", "cap"),
    ("engine:\n  dtype: int16\n", "dtype"),
    ("engine:\n  kernel: xla\n", "kernel"),
    ("engine:\n  pipeline_depth: -1\n", "pipeline_depth"),
    ("gomengine:\n  accuracy: 19\n", "accuracy"),
    ("bus:\n  backend: zeromq\n", "backend"),
    ("bus:\n  match_wire: xml\n", "match_wire"),
    ("nosuch:\n  a: 1\n", "unknown config sections"),
    ("grpc:\n  hostt: x\n", "unknown key"),
    ("persist:\n  keep: 0\n", "persist"),
    ("ops:\n  trace_keep: 0\n", "trace_keep"),
    ("ops:\n  placement_alpha: 1.5\n", "placement_alpha"),
    ("fleet:\n  interval_s: 1.0\n", "no members"),
    ("fleet:\n  members: [nourl]\n", "fleet.members"),
    ("sim:\n  excite_self: 0.9\n  excite_cross: 0.3\n", "unstable"),
    ("faults:\n  plan: p.json\n  points: [{point: x}]\n", "not both"),
    ("admission:\n  max_depth: 0\n", "max_depth"),
    ("admission:\n  retry_after_max_s: 0.01\n", "retry_after_max_s"),
])
def test_validation_rejects_alike(tmp_path, text, match):
    path = write(tmp_path, text)
    with pytest.raises(ValueError, match=match) as je:
        jconfig.load_config(path)
    with pytest.raises(ValueError, match=match) as te:
        tconfig.load_config(path)
    assert str(te.value) == str(je.value)


def test_fault_plan_file(tmp_path):
    from gome_tpu_torch.utils.faults import FaultPlan, FaultSpec

    plan = FaultPlan(seed=3, faults=(FaultSpec("gateway.emit", mode="raise",
                                               at=(2,)),))
    (tmp_path / "plan.json").write_text(plan.to_json())
    j, t = both(write(tmp_path, f"faults:\n  plan: {tmp_path}/plan.json\n"))
    assert t.faults.fault_plan().to_dict() == j.faults.fault_plan().to_dict()
    assert t.faults.fault_plan() == plan


# -- what the port refuses ---------------------------------------------------

OBS_FLAGS = ("cost", "timeline", "profile", "hostprof", "placement")
# trace off too: an armed tracer is process-wide and would pin later
# tests' gateways to the scalar loop.
QUIET_OPS = "ops:\n  port: 0\n  trace: false\n" + "".join(
    f"  {f}: false\n" for f in OBS_FLAGS)


@pytest.mark.parametrize("text, error, item", [
    *[(QUIET_OPS.replace(f"{f}: false", f"{f}: true"), NotImplementedError,
       "items 3 and 4") for f in OBS_FLAGS],
    ("ops:\n  port: 0\n", NotImplementedError, "items 3 and 4"),
    ("fleet:\n  members: [a=http://x:1]\n", NotImplementedError, "item 5"),
])
def test_unported_parts_are_refused(tmp_path, text, error, item):
    cfg = tconfig.load_config(write(tmp_path, text))
    with pytest.raises(error, match=f"ROADMAP Queue 1 {item}\\b"):
        EngineService(cfg, device="cpu")


@pytest.mark.parametrize("text", ["rabbitmq:\n  port: {port}\n",
                                  "bus:\n  backend: amqp\n  port: {port}\n"])
@pytest.mark.parametrize("listening", [True, False])
def test_rabbitmq_section_boots(tmp_path, text, listening):
    """A rabbitmq: section (or bus.backend amqp) boots both packages'
    services alike: with a broker listening, on two SupervisedAmqpQueues
    that the health view lists with closed breakers; with none, on the
    memory bus after the same RuntimeWarning (these cases were refusals
    before the AMQP port)."""
    import gome_tpu.bus.amqp as jamqp
    import gome_tpu.bus.memory as jmemory
    import gome_tpu.utils.resilience as jresilience
    import gome_tpu_torch.bus.amqp as tamqp
    import gome_tpu_torch.bus.memory as tmemory
    import gome_tpu_torch.utils.resilience as tresilience
    from gome_tpu.service.app import EngineService as JService
    from gome_tpu_torch.bus.fakebroker import FakeBroker

    broker = FakeBroker()
    port = broker.start().port if listening else 1  # nothing at port 1
    sides = ((jconfig, JService, {}, jamqp, jmemory, jresilience),
             (tconfig, EngineService, {"device": "cpu"}, tamqp, tmemory,
              tresilience))
    try:
        path = write(tmp_path, "grpc:\n  port: 0\nengine:\n  n_slots: 8\n"
                     + text.format(port=port))
        for config, service, kw, amqp, memory, resilience in sides:
            cfg = config.load_config(path)
            assert cfg.bus.backend == "amqp"
            if listening:
                svc = service(cfg, **kw)
                queues = (svc.bus.order_queue, svc.bus.match_queue)
                assert all(isinstance(q, amqp.SupervisedAmqpQueue)
                           for q in queues)
                conns = resilience.resilience_snapshot()
                for name in ("doOrder", "matchOrder"):
                    assert conns[f"amqp:{name}"]["breaker"] == "closed"
                for q in queues:
                    q.close()
            else:
                with pytest.warns(RuntimeWarning, match="falling back"):
                    svc = service(cfg, **kw)
                assert isinstance(svc.bus.order_queue, memory.MemoryQueue)
                assert isinstance(svc.bus.match_queue, memory.MemoryQueue)
    finally:
        broker.stop()


def test_mesh_devices_boot_a_cpu_mesh(tmp_path):
    """engine.mesh_devices: 2 with device="cpu" shards the engine's lanes
    over two CPU shards (the mesh replaced the refusal)."""
    cfg = tconfig.load_config(write(
        tmp_path, "grpc:\n  port: 0\nengine:\n  n_slots: 8\n"
        "  mesh_devices: 2\n"))
    svc = EngineService(cfg, device="cpu")
    mesh = svc.engine.batch.mesh
    assert mesh.size == 2 and mesh.devices == (torch.device("cpu"),) * 2
    assert [b.count.shape[0] for b in svc.engine.books.blocks] == [4, 4]


def test_mesh_devices_beyond_the_cards_raise(tmp_path):
    """On the card (no device=), a mesh wider than the visible CUDA cards
    raises rather than building a smaller mesh or falling back to the
    CPU."""
    from gome_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"only {n} are available"):
        make_mesh(n + 1)
    cfg = tconfig.load_config(write(
        tmp_path, f"engine:\n  n_slots: 8\n  mesh_devices: {n + 1}\n"))
    with pytest.raises(ValueError, match="devices"):
        EngineService(cfg)


@limited(60)
def test_persist_section_boots(tmp_path, monkeypatch):
    """A persist: section: main() builds a Persister from it, start()
    restores (nothing to restore yet), and its probe() is the
    /durability payload's "persist"."""
    from gome_tpu_torch.persist import Persister
    from gome_tpu_torch.service import app
    from gome_tpu_torch.service.ops import OpsServer

    path = write(tmp_path, f"grpc:\n  host: 127.0.0.1\n  port: 0\n"
                 f"bus:\n  backend: file\n  dir: {tmp_path}/bus\n"
                 f"persist:\n  dir: {tmp_path}/snaps\n  every_n_batches: 2\n")
    built = []

    class OnTheCpu(EngineService):
        def __init__(self, config, persist=None):
            super().__init__(config, persist=persist, device="cpu")
            built.append(self)

        def wait(self):
            pass

    monkeypatch.setattr(app, "EngineService", OnTheCpu)
    app.main([path])
    (svc,) = built
    try:
        assert isinstance(svc.persist, Persister)
        assert svc.persist.every_n == 2 and svc.persist.engine is svc.engine
        assert svc.consumer.on_batch == svc.persist.on_batch
        payload = OpsServer(svc).durability_payload()
        assert payload["persist"] == svc.persist.probe()
        assert payload["persist"]["last_restore"] == "none"
    finally:
        svc.stop()


def test_redis_section_uses_the_store(tmp_path):
    """A redis: section naming a live FakeRedisServer: both packages put
    the marks in the store (RespPrePool), with the same keyspace, and the
    port's /healthz lists the supervised client as resp:store."""
    import gome_tpu.types as jtypes
    import gome_tpu_torch.types as ttypes
    from gome_tpu.service.app import EngineService as JService
    from gome_tpu_torch.engine.prepool import RespPrePool
    from gome_tpu_torch.persist.respserver import FakeRedisServer
    from gome_tpu_torch.service.health import HealthMonitor

    keyspaces = []
    for config, service, types in (
            (tconfig, lambda c: EngineService(c, device="cpu"), ttypes),
            (jconfig, JService, jtypes)):
        with FakeRedisServer() as srv:
            path = write(tmp_path, f"redis:\n  host: 127.0.0.1\n"
                         f"  port: {srv.port}\n")
            svc = service(config.load_config(path))
            assert type(svc.engine.pre_pool).__name__ == "RespPrePool"
            svc.engine.mark(types.Order(uuid="u", oid="o1", symbol="s",
                                        side=types.Side.BUY, price=100,
                                        volume=1))
            keyspaces.append(dict(srv.store.hashes))
            if types is ttypes:
                assert isinstance(svc.engine.pre_pool, RespPrePool)
                detail = HealthMonitor(svc).check().detail
                assert detail["connections"]["resp:store"]["breaker"] \
                    == "closed"
            svc.engine.pre_pool.client.close()
    assert keyspaces[0] == keyspaces[1] == {"s:comparison": {"s:u:o1": "1"}}


@pytest.mark.parametrize("package", ["gome_tpu", "port"])
def test_unreachable_store_keeps_the_in_process_pool(tmp_path, package,
                                                     caplog):
    """A redis: section naming a port nobody listens on: the service
    boots, warns, and keeps its in-process pool — in both packages."""
    import logging
    import socket

    from gome_tpu.service.app import EngineService as JService

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = write(tmp_path, f"redis:\n  host: 127.0.0.1\n  port: {port}\n")
    with caplog.at_level(logging.WARNING):
        if package == "port":
            svc = EngineService(tconfig.load_config(path), device="cpu")
        else:
            svc = JService(jconfig.load_config(path))
    assert type(svc.engine.pre_pool).__name__ in ("LocalPrePool",
                                                  "NativePrePool")
    assert any(f"redis store 127.0.0.1:{port} unusable" in r.getMessage()
               for r in caplog.records)


def test_cfile_without_gpp_raises(tmp_path, monkeypatch):
    import gome_tpu_torch.bus as tbus

    monkeypatch.setattr(tbus, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tbus.make_bus(tconfig.BusConfig(backend="cfile", dir=str(tmp_path)))


def test_quiet_ops_section_boots(tmp_path):
    cfg = tconfig.load_config(write(tmp_path, QUIET_OPS))
    svc = EngineService(cfg, device="cpu")
    assert svc.ops is not None and svc.engine.batch.device.type == "cpu"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineService(tconfig.Config(engine=tconfig.EngineConfig(
            cap=16, n_slots=4, max_t=4)))


def test_durable_service_wants_the_card_or_cpu(tmp_path):
    """With persist: and redis: sections (the store live) and a
    Persister, EngineService still runs on the card by default: without
    one it raises, and it builds only when told device="cpu"."""
    from gome_tpu_torch.engine.prepool import RespPrePool
    from gome_tpu_torch.persist import Persister
    from gome_tpu_torch.persist.respserver import FakeRedisServer

    with FakeRedisServer() as srv:
        cfg = tconfig.load_config(write(
            tmp_path, f"bus:\n  backend: file\n  dir: {tmp_path}/bus\n"
            f"persist:\n  dir: {tmp_path}/snaps\n"
            f"redis:\n  host: 127.0.0.1\n  port: {srv.port}\n"))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                EngineService(cfg, persist=Persister(cfg.persist))
        svc = EngineService(cfg, persist=Persister(cfg.persist),
                            device="cpu")
        assert isinstance(svc.engine.pre_pool, RespPrePool)
        assert svc.persist.engine is svc.engine
        assert svc.engine.batch.device.type == "cpu"
        svc.engine.pre_pool.client.close()
