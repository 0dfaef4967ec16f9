"""The port stands alone: no file under gome_tpu_torch/, and not
chip_smoke.py, imports jax or anything of gome_tpu, nor the reference's
bench.py or scripts/ (an AST scan: absolute imports, __import__, and any
load by file path through importlib), and importing the port loads
neither."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "gome_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
)
FORBIDDEN = ("jax", "jaxlib", "gome_tpu")
#: The reference's top-level driver modules: refused as absolute (level 0)
#: imports; the port's drivers are gome_tpu_torch.scripts.
REFERENCE_DRIVERS = ("bench", "scripts")


def imported_modules(path: pathlib.Path) -> set[str]:
    """Absolute module names a file imports (relative imports resolve
    inside its own package and are skipped)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return names


def is_forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".")
               for f in FORBIDDEN + REFERENCE_DRIVERS)


def file_loads(path: pathlib.Path) -> list[str]:
    """Calls that load a module from a file path
    (importlib.util.spec_from_file_location, SourceFileLoader): the way
    around an import statement."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if name in ("spec_from_file_location", "SourceFileLoader"):
                names.append(name)
    return names


def test_port_files_were_found():
    assert "chip_smoke.py" in PORT_FILES
    assert "gome_tpu_torch/ops/match_step.py" in PORT_FILES
    assert "gome_tpu_torch/ops/hawkes_scan.py" in PORT_FILES
    for name in ("__init__", "flow", "env", "replay", "stats"):
        assert f"gome_tpu_torch/sim/{name}.py" in PORT_FILES
    for name in ("__init__", "mesh", "router"):
        assert f"gome_tpu_torch/parallel/{name}.py" in PORT_FILES
    for name in ("amqp", "fakebroker"):
        assert f"gome_tpu_torch/bus/{name}.py" in PORT_FILES
    for name in ("__init__", "capacity", "compile_journal", "costmodel",
                 "fleet", "hostprof", "live", "placement", "profiler",
                 "timeline"):
        assert f"gome_tpu_torch/obs/{name}.py" in PORT_FILES
    for name in ("__init__", "router"):
        assert f"gome_tpu_torch/fleet/{name}.py" in PORT_FILES
    for name in ("__init__", "common", "placement_eval", "mesh_overhead",
                 "fleet_drill", "capacity", "profile_consumer",
                 "obs_snapshot", "chaos", "fleet_chaos", "prepool_rate",
                 "marker_bench"):
        assert f"gome_tpu_torch/scripts/{name}.py" in PORT_FILES
    for name in ("__init__", "embed", "migrate_from_gome", "sim_rollout"):
        assert f"gome_tpu_torch/examples/{name}.py" in PORT_FILES
    assert "gome_tpu_torch/analysis/envelope.py" in PORT_FILES
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("rel", PORT_FILES)
def test_file_imports_neither_jax_nor_gome_tpu(rel):
    bad = sorted(m for m in imported_modules(ROOT / rel) if is_forbidden(m))
    assert not bad, f"{rel} imports {bad}"


def test_scan_recognises_forbidden_imports():
    assert is_forbidden("jax.numpy") and is_forbidden("gome_tpu.engine")
    assert not is_forbidden("gome_tpu_torch.engine")
    assert not is_forbidden("jaxtyping_like")
    assert is_forbidden("bench") and is_forbidden("scripts.capacity")
    assert not is_forbidden("gome_tpu_torch.scripts.capacity")
    assert not is_forbidden("benchmark_like")


def test_scan_sees_relative_and_absolute_driver_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("from . import scripts\nfrom .scripts import capacity\n"
                 "import bench\nfrom scripts.capacity import run\n"
                 "import importlib.util as u\n"
                 "u.spec_from_file_location('x', 'scripts/capacity.py')\n")
    assert sorted(m for m in imported_modules(f) if is_forbidden(m)) == [
        "bench", "scripts.capacity"]
    assert file_loads(f) == ["spec_from_file_location"]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_file_loads_no_module_by_path(rel):
    assert not file_loads(ROOT / rel), f"{rel} loads a module by file path"


def test_importing_the_port_loads_neither():
    code = (
        "import sys, gome_tpu_torch.engine, gome_tpu_torch.ops, "
        "gome_tpu_torch.oracle, gome_tpu_torch.utils.streams, chip_smoke, "
        "gome_tpu_torch.bus, gome_tpu_torch.service, "
        "gome_tpu_torch.engine.pipeline, gome_tpu_torch.native, "
        "gome_tpu_torch.engine.nativehost, gome_tpu_torch.config, "
        "gome_tpu_torch.api, gome_tpu_torch.clients, "
        "gome_tpu_torch.service.app, gome_tpu_torch.service.gateway, "
        "gome_tpu_torch.persist, gome_tpu_torch.persist.respserver, "
        "gome_tpu_torch.sim, gome_tpu_torch.sim.stats, "
        "gome_tpu_torch.ops.hawkes_scan, gome_tpu_torch.parallel, "
        "gome_tpu_torch.parallel.mesh, gome_tpu_torch.parallel.router, "
        "gome_tpu_torch.bus.amqp, gome_tpu_torch.bus.fakebroker, "
        "gome_tpu_torch.obs, gome_tpu_torch.obs.live, "
        "gome_tpu_torch.obs.placement, gome_tpu_torch.fleet, "
        "gome_tpu_torch.obs.costmodel, gome_tpu_torch.obs.profiler, "
        "gome_tpu_torch.obs.fleet, gome_tpu_torch.scripts.capacity, "
        "gome_tpu_torch.scripts.fleet_drill, gome_tpu_torch.scripts.obs_snapshot, "
        "gome_tpu_torch.scripts.mesh_overhead, "
        "gome_tpu_torch.scripts.placement_eval, "
        "gome_tpu_torch.scripts.profile_consumer, "
        "gome_tpu_torch.scripts.chaos, gome_tpu_torch.scripts.fleet_chaos, "
        "gome_tpu_torch.scripts.prepool_rate, "
        "gome_tpu_torch.scripts.marker_bench, "
        "gome_tpu_torch.analysis.envelope, gome_tpu_torch.examples.embed, "
        "gome_tpu_torch.examples.migrate_from_gome, "
        "gome_tpu_torch.examples.sim_rollout\n"
        "bad = [m for m in sys.modules if m in ('jax', 'gome_tpu', 'bench', "
        "'scripts') or m.startswith(('jax.', 'gome_tpu.', 'scripts.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_service_app_loads_neither_jax_nor_gome_tpu():
    code = (
        "import sys, gome_tpu_torch.service.app\n"
        "from gome_tpu_torch.service import EngineService, OrderGateway\n"
        "bad = [m for m in sys.modules if m in ('jax', 'gome_tpu') or "
        "m.startswith(('jax.', 'gome_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad or 'grpc' not in sys.modules else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


BLOCKED = ("grpc", "google.protobuf", "yaml")
NEEDS_NONE_OF_THEM = (
    "gome_tpu_torch.config", "gome_tpu_torch.bus",
    "gome_tpu_torch.service.consumer", "gome_tpu_torch.service.matchfeed",
    "gome_tpu_torch.service.admission", "gome_tpu_torch.service.health",
    "gome_tpu_torch.service.ops",
)


def test_service_parts_import_without_grpc_protobuf_yaml():
    """With grpc, protobuf and yaml blocked (None in sys.modules), the
    config, the bus, the consumer, the feed (with no subscriber it never
    converts an event to protobuf), admission, health and the ops
    endpoint still import, defaults load and a feed drains; the gateway
    does not import."""
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {NEEDS_NONE_OF_THEM!r}: importlib.import_module(m)\n"
        "from gome_tpu_torch.config import Config, load_config\n"
        "from gome_tpu_torch.bus import make_bus\n"
        "from gome_tpu_torch.bus.codec import encode_match_result\n"
        "from gome_tpu_torch.service import MatchFeed\n"
        "from gome_tpu_torch.types import MatchResult, OrderSnapshot, Side\n"
        "assert load_config(None) == Config()\n"
        "bus = make_bus(Config().bus)\n"
        "s = OrderSnapshot('u', 'o', 's', Side.BUY, 100, 5)\n"
        "bus.match_queue.publish(encode_match_result(MatchResult(s, s, 5)))\n"
        "feed = MatchFeed(bus, log_events=False)\n"
        "assert feed.drain() == 1 and feed.events_seen == 1\n"
        "try:\n"
        "    import gome_tpu_torch.service.gateway\n"
        "except ImportError:\n"
        "    print('gateway needs grpc')\n"
        "else:\n"
        "    sys.exit('the gateway imported without grpc')\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('grpc', 'yaml') or m.startswith('google.protobuf')]\n"
        "sys.exit(f'loaded {loaded}' if any(sys.modules[m] is not None "
        "for m in loaded) else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "gateway needs grpc" in proc.stdout
