"""Typed YAML configuration — the framework's equivalent of the reference's
config system (gomengine/util/conf.go:3-30 + config.yaml.example).

The port of ``gome_tpu/config.py``: every section keeps its fields, its
defaults and its checks, so one YAML file loads into both packages. What
differs: `EngineConfig.book_config()` and `SimConfig.env_config()` return
the port's BookConfig and EnvConfig (torch dtypes); `yaml` is imported only
when there is a file to read, so the port imports without it. EngineService
(service/app.py) runs every section.

Reference parity: the same four YAML sections are accepted with the same keys
(`grpc`, `redis`, `rabbitmq`, `gomengine.accuracy` — conf.go:3-30; the dead
`mysql` block of config.yaml.example:16-21 is ignored here too). Differences,
deliberate (SURVEY §5.6 called out every weakness we fix):

  * one explicit `load_config()` call instead of four independent package
    `init()`s reading a CWD-relative path with errors ignored
    (engine.go:30-33, grpc/grpc.go:19-22, redis/redis.go:12-15);
  * validation with loud errors instead of silent zero-values;
  * new sections for what the device engine adds: `engine` (book geometry,
    micro-batch shape), `bus` (queue backend selection), `persist`
    (snapshot cadence/location). All have working defaults so a reference
    config.yaml loads unchanged.
"""

from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Any, TypeVar

if TYPE_CHECKING:
    from .engine.book import BookConfig
    from .sim.env import EnvConfig
    from .utils.faults import FaultPlan

from .fixed import DEFAULT_ACCURACY


@dataclasses.dataclass(frozen=True)
class GrpcConfig:
    """conf.go:24-27 (GRPC{host, port})."""

    host: str = "127.0.0.1"
    port: int = 8088


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """conf.go:11-15 (Cache = the Redis durability tier). In this build
    Redis is optional (snapshots can target the local filesystem instead);
    `enabled` gates it so environments without a Redis server still run
    (the reference hard-requires Redis because Redis IS its book). An
    enabled section puts the pre-pool markers in the store (RespPrePool);
    an unusable store keeps the in-process pool, with a warning."""

    host: str = "127.0.0.1"
    port: int = 6379
    password: str = ""
    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class BusConfig:
    """conf.go:17-22 (RabbitMQ) generalized: the queue topology (two named
    queues, "doOrder" inbound / "matchOrder" outbound — rabbitmq.go:60-84)
    is preserved; the transport is pluggable (bus backends):
      memory — in-process deques (single-binary deployments, tests)
      file   — durable append-only log segments (crash-safe, replayable)
      cfile  — the same log format via the port's native C++ library
               (batch-amortized fsync; a failed build raises, and without
               g++ make_bus raises: it never falls back to `file`)
      amqp   — external RabbitMQ via the dependency-free AMQP 0-9-1
               client (bus/amqp.py); boots on the memory backend with a
               loud warning when no broker is listening
    """

    backend: str = "memory"
    dir: str = "bus_data"
    host: str = "127.0.0.1"
    port: int = 5672
    username: str = ""
    password: str = ""
    order_queue: str = "doOrder"  # rabbitmq.go: queue names
    match_queue: str = "matchOrder"
    # matchOrder payload: "json" = one reference-shape document per event
    # (rabbitmq.go parity); "frame" = one binary EVENT frame per batch
    # (bus.colwire, the high-throughput internal transport).
    match_wire: str = "json"

    _BACKENDS = ("memory", "file", "cfile", "amqp")

    def __post_init__(self) -> None:
        if self.backend not in self._BACKENDS:
            raise ValueError(
                f"bus.backend must be one of {self._BACKENDS}, "
                f"got {self.backend!r}"
            )
        if self.match_wire not in ("json", "frame"):
            raise ValueError(
                f"bus.match_wire must be json|frame, got {self.match_wire!r}"
            )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's single semantic knob (`gomengine.accuracy`,
    conf.go:29-30) plus the device engine's geometry: book capacity per side,
    fill-record budget, provisioned symbol lanes, micro-batch depth."""

    accuracy: int = DEFAULT_ACCURACY
    cap: int = 256
    max_fills: int = 16
    n_slots: int = 1024
    max_t: int = 32
    dtype: str = "int64"  # "int32" halves HBM traffic when ranges allow
    auto_grow: bool = True
    # scan | pallas, the reference's two TPU step strategies; accepted so
    # a reference config loads. The port has one step whatever the value:
    # the CUDA match-step kernel on the card, its plain version on the CPU.
    kernel: str = "scan"
    # Cross-frame pipelining depth for ORDER-frame traffic (0 = synchronous;
    # N > 0 keeps up to N frames in flight on the device while the host
    # packs the next — engine.pipeline.FramePipeline).
    pipeline_depth: int = 0
    # Shard the lane axis over the first N local CUDA cards
    # (gome_tpu_torch.parallel.make_mesh; raises when fewer exist), K1
    # launched once per shard on its own card. 0 = no mesh (single card).
    # n_slots must be a multiple of mesh_devices.
    mesh_devices: int = 0

    def __post_init__(self) -> None:
        if not 0 <= self.accuracy <= 18:
            raise ValueError(f"accuracy must be in [0, 18], got {self.accuracy}")
        for name in ("cap", "max_fills", "n_slots", "max_t"):
            v = getattr(self, name)
            if v <= 0:
                raise ValueError(f"engine.{name} must be positive, got {v}")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"engine.pipeline_depth must be >= 0, got {self.pipeline_depth}"
            )
        if self.dtype not in ("int32", "int64"):
            raise ValueError(f"engine.dtype must be int32|int64, got {self.dtype}")
        from .types import KERNELS

        if self.kernel not in KERNELS:
            raise ValueError(
                f"engine.kernel must be one of {KERNELS}, got {self.kernel}"
            )

    def book_config(self) -> "BookConfig":
        import torch

        from .engine.book import BookConfig

        return BookConfig(
            cap=self.cap,
            max_fills=self.max_fills,
            dtype=torch.int32 if self.dtype == "int32" else torch.int64,
        )


@dataclasses.dataclass(frozen=True)
class PersistConfig:
    """Snapshot/recovery cadence (new — the reference needs none because
    every Redis write is instantly durable, SURVEY §5.4). `enabled` defaults
    off; a `persist:` section in config.yaml switches it on (like `redis:`
    implies store.enabled); service.app.main then builds a
    persist.Persister from it."""

    enabled: bool = False
    dir: str = "snapshots"
    every_n_batches: int = 64
    keep: int = 4

    def __post_init__(self) -> None:
        if self.every_n_batches <= 0 or self.keep <= 0:
            raise ValueError("persist cadence/keep must be positive")


@dataclasses.dataclass(frozen=True)
class OpsConfig:
    """Operator HTTP endpoint (/metrics Prometheus text + /healthz JSON +
    /trace Chrome trace-event dump + /durability) — an extension beyond
    the reference (which has logging only, SURVEY §5.5). Disabled unless
    an `ops:` section appears in config.yaml.

    trace/trace_keep/slow_ms configure the order-lifecycle tracer
    (utils.trace): with trace on, every order gets a trace id at the
    gateway and the flight recorder keeps the last `trace_keep` complete
    journeys plus every journey slower than `slow_ms` end to end.

    The other flags arm the reference's obs/ surfaces: the compile journal
    (cost/cost_keep), the host timeline sampler (timeline*), the measured
    roofline profiler (profile*), the host-CPU sampling profiler
    (hostprof*) and the placement observatory (placement*). The fields,
    defaults and checks are the reference's, so a config loads into both
    packages, and EngineService arms each (obs/: /cost, /timeline,
    /profile, /hostprof, /placement, and /capacity beside them)."""

    host: str = "127.0.0.1"
    port: int = 9109
    enabled: bool = False
    trace: bool = True  # arm the order-lifecycle tracer with the endpoint
    trace_keep: int = 64  # flight-recorder ring size (journeys)
    slow_ms: float = 50.0  # slow-order threshold (pinned in the slow ring)
    cost: bool = True  # arm the compile journal with the endpoint
    cost_keep: int = 256  # compile-journal ring size (events)
    timeline: bool = True  # arm the host-side timeline sampler
    timeline_interval_s: float = 1.0  # sampling period (seconds)
    timeline_keep: int = 512  # timeline ring size (samples)
    profile: bool = True  # arm the measured-roofline profiler
    profile_keep: int = 8  # profiler report ring size (captures)
    hostprof: bool = True  # arm the host-CPU sampling profiler
    hostprof_hz: float = 67.0  # live wall-sampler cadence (Hz)
    hostprof_keep: int = 4096  # raw-stack ring size (samples)
    placement: bool = True  # arm the placement observatory
    placement_topk: int = 64  # Space-Saving sketch capacity (symbols)
    placement_alpha: float = 0.2  # per-lane EWMA smoothing factor
    placement_partitions: int = 8  # what-if hash-imbalance partitions

    def __post_init__(self) -> None:
        if self.trace_keep <= 0:
            raise ValueError(
                f"ops.trace_keep must be positive, got {self.trace_keep}"
            )
        if self.slow_ms < 0:
            raise ValueError(
                f"ops.slow_ms must be >= 0, got {self.slow_ms}"
            )
        if self.cost_keep <= 0:
            raise ValueError(
                f"ops.cost_keep must be positive, got {self.cost_keep}"
            )
        if self.timeline_interval_s <= 0:
            raise ValueError(
                f"ops.timeline_interval_s must be positive, got "
                f"{self.timeline_interval_s}"
            )
        if self.timeline_keep <= 0:
            raise ValueError(
                f"ops.timeline_keep must be positive, got "
                f"{self.timeline_keep}"
            )
        if self.profile_keep <= 0:
            raise ValueError(
                f"ops.profile_keep must be positive, got "
                f"{self.profile_keep}"
            )
        if self.hostprof_hz <= 0:
            raise ValueError(
                f"ops.hostprof_hz must be positive, got "
                f"{self.hostprof_hz}"
            )
        if self.hostprof_keep <= 0:
            raise ValueError(
                f"ops.hostprof_keep must be positive, got "
                f"{self.hostprof_keep}"
            )
        if self.placement_topk <= 0:
            raise ValueError(
                f"ops.placement_topk must be positive, got "
                f"{self.placement_topk}"
            )
        if not (0.0 < self.placement_alpha <= 1.0):
            raise ValueError(
                f"ops.placement_alpha must be in (0, 1], got "
                f"{self.placement_alpha}"
            )
        if self.placement_partitions <= 0:
            raise ValueError(
                f"ops.placement_partitions must be positive, got "
                f"{self.placement_partitions}"
            )


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet aggregation (obs/fleet.py) — this process polls the
    listed member processes' ops endpoints and serves the merged view
    under its own ops server's /fleet. Disabled unless a `fleet:`
    section appears in config.yaml (requires `ops:` too — the merged
    view needs an HTTP surface to live on). `members` is a YAML list of
    "name=http://host:port" strings (or {name: url} mappings)."""

    enabled: bool = False
    members: Any = ()  # "name=url" strings or {name: url} dicts
    interval_s: float = 1.0  # poll period (seconds)
    timeout_s: float = 2.0  # per-endpoint fetch timeout (seconds)

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError(
                f"fleet.interval_s must be positive, got {self.interval_s}"
            )
        if self.timeout_s <= 0:
            raise ValueError(
                f"fleet.timeout_s must be positive, got {self.timeout_s}"
            )
        if self.enabled and not self.members:
            raise ValueError("fleet: enabled but no members listed")
        self.member_map()  # malformed entries fail at load, not at poll

    def member_map(self) -> dict[str, str]:
        """{member name: base URL} from the YAML-friendly `members`
        forms; names must be unique (they become the `proc` label)."""
        out: dict[str, str] = {}
        for entry in self.members or ():
            if isinstance(entry, dict):
                items = list(entry.items())
            elif isinstance(entry, str) and "=" in entry:
                items = [tuple(entry.split("=", 1))]
            else:
                raise ValueError(
                    f"fleet.members entries must be 'name=url' or "
                    f"{{name: url}}, got {entry!r}"
                )
            for name, url in items:
                if name in out:
                    raise ValueError(f"fleet.members: duplicate name {name!r}")
                out[str(name)] = str(url)
        return out


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The on-device market simulator (the reference's sim/): Hawkes/Zipf flow
    parameters + environment geometry. New — the reference has no
    simulator; bench.py's `--flow sim` and the RL environment read this
    section. Scalars only so the block stays YAML-friendly; the derived
    excitation matrix lives in sim.flow.FlowConfig."""

    n_lanes: int = 256
    t_bins: int = 32
    dt: float = 0.02
    submit_rate: float = 2.0
    cancel_rate: float = 1.4
    market_rate: float = 0.6
    excite_self: float = 0.25
    excite_cross: float = 0.10
    excite_kind: float = 0.05
    decay: float = 2.0
    zipf_a: float = 1.1
    offset_p: float = 0.35
    max_offset: int = 200
    ref_price: int = 100_000
    ref_spread: int = 20
    vol_max: int = 100
    n_uids: int = 256
    seed: int = 0
    # Environment geometry (sim.env.EnvConfig).
    cap: int = 16
    max_fills: int = 4
    dtype: str = "int32"
    n_agent_ops: int = 2
    obs_levels: int = 4

    def __post_init__(self) -> None:
        for name in ("n_lanes", "t_bins", "max_offset", "ref_price",
                     "ref_spread", "vol_max", "n_uids", "cap", "max_fills",
                     "n_agent_ops", "obs_levels"):
            if getattr(self, name) <= 0:
                raise ValueError(
                    f"sim.{name} must be positive, got {getattr(self, name)}"
                )
        if self.dt <= 0 or self.decay <= 0:
            raise ValueError("sim.dt and sim.decay must be positive")
        if self.dtype not in ("int32", "int64"):
            raise ValueError(
                f"sim.dtype must be int32|int64, got {self.dtype}"
            )
        # The structured excitation matrix's Perron eigenvector is the
        # all-ones vector, so the spectral radius has this closed form
        # (sim.flow.FlowConfig re-checks the general eigenvalue bound).
        br = self.excite_self + self.excite_cross + 4 * self.excite_kind
        if br >= 1.0:
            raise ValueError(
                f"sim Hawkes parameters are unstable: branching ratio "
                f"{br:.3f} >= 1 (lower excite_* or raise decay)"
            )

    def env_config(self) -> "EnvConfig":
        """Build the sim.env.EnvConfig."""
        from .engine.book import BookConfig
        from .sim.env import EnvConfig
        from .sim.flow import FlowConfig

        flow = FlowConfig(
            n_lanes=self.n_lanes, t_bins=self.t_bins, dt=self.dt,
            submit_rate=self.submit_rate, cancel_rate=self.cancel_rate,
            market_rate=self.market_rate, excite_self=self.excite_self,
            excite_cross=self.excite_cross, excite_kind=self.excite_kind,
            decay=self.decay, zipf_a=self.zipf_a, offset_p=self.offset_p,
            max_offset=self.max_offset, ref_price=self.ref_price,
            ref_spread=self.ref_spread, vol_max=self.vol_max,
            n_uids=self.n_uids,
        )
        book = BookConfig(
            cap=self.cap, max_fills=self.max_fills, dtype=self.dtype,
        )
        return EnvConfig(
            flow=flow, book=book, n_agent_ops=self.n_agent_ops,
            obs_levels=self.obs_levels,
        )


@dataclasses.dataclass(frozen=True)
class FaultsConfig:
    """Deterministic fault injection (utils.faults) — chaos/test tooling
    only; production configs omit the section and the FAULTS singleton
    stays a zero-allocation no-op. A `faults:` block arms the registry at
    EngineService boot so a fault *plan* (seed + schedule) travels with
    the config as a reproducible artifact. Give either `plan` (path to a
    FaultPlan JSON written by scripts/chaos.py) or `points` (inline list
    of FaultSpec dicts, YAML-friendly), not both."""

    enabled: bool = False
    seed: int = 0
    plan: str = ""  # path to a FaultPlan JSON file
    # Inline FaultSpec dicts straight from YAML; validated when the plan
    # is built (FaultSpec.from_dict), not here, so config loading stays
    # import-light.
    points: Any = ()

    def __post_init__(self) -> None:
        if self.plan and self.points:
            raise ValueError(
                "faults: give plan (file) or points (inline), not both"
            )

    def fault_plan(self) -> "FaultPlan":
        """Materialize the schedule (reads the plan file when given)."""
        from .utils.faults import FaultPlan

        if self.plan:
            with open(self.plan) as f:
                return FaultPlan.from_json(f.read())
        return FaultPlan.from_dict(
            {"seed": self.seed, "faults": list(self.points)}
        )


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Gateway admission control (service.admission) — depth/deadline
    load shedding with retryable status + retry-after hint (round 12).
    Off by default: without an `admission:` section the gateway admits
    unconditionally, exactly the pre-round-12 behavior."""

    enabled: bool = False
    #: shed (code 14) once order-queue consumer lag reaches this many
    #: orders — bounds worst-case queueing delay at max_depth/drain-rate.
    max_depth: int = 16384
    #: shed requests whose remaining gRPC deadline is below this (s);
    #: 0 disables the deadline check.
    min_deadline_s: float = 0.0
    #: retry-after hint at the ceiling (s); scales with overshoot.
    retry_after_s: float = 0.05
    retry_after_max_s: float = 2.0
    #: consumer-lag sample cache window (s) — admission is per-RPC.
    cache_s: float = 0.005

    def __post_init__(self) -> None:
        if self.max_depth < 1:
            raise ValueError("admission.max_depth must be >= 1")
        if self.min_deadline_s < 0:
            raise ValueError("admission.min_deadline_s must be >= 0")
        if self.retry_after_s <= 0:
            raise ValueError("admission.retry_after_s must be positive")
        if self.retry_after_max_s < self.retry_after_s:
            raise ValueError(
                "admission.retry_after_max_s must be >= retry_after_s"
            )


@dataclasses.dataclass(frozen=True)
class Config:
    grpc: GrpcConfig = GrpcConfig()
    store: StoreConfig = StoreConfig()
    bus: BusConfig = BusConfig()
    engine: EngineConfig = EngineConfig()
    persist: PersistConfig = PersistConfig()
    ops: OpsConfig = OpsConfig()
    fleet: FleetConfig = FleetConfig()
    sim: SimConfig = SimConfig()
    faults: FaultsConfig = FaultsConfig()
    admission: AdmissionConfig = AdmissionConfig()


_C = TypeVar("_C")


def _build(cls: type[_C], raw: dict[str, Any], section: str) -> _C:
    fields = {f.name: f for f in dataclasses.fields(cls)}  # type: ignore[arg-type]
    kwargs = {}
    for key, value in raw.items():
        if key not in fields:
            raise ValueError(f"unknown key {section}.{key}")
        ftype = fields[key].type
        # YAML strings for numeric fields (the reference's conf.go keeps
        # ports as strings) are coerced here.
        if ftype in (int, "int") and isinstance(value, str):
            value = int(value)
        kwargs[key] = value
    return cls(**kwargs)


def _read_yaml(path: str) -> dict[str, Any]:
    import yaml  # only here: the port imports without PyYAML

    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(path: str | None = None) -> Config:
    """Load config from a YAML file; missing file ⇒ all defaults (unlike the
    reference, which silently zeroes every field on a missing config.yaml).
    Reference-shaped files load unchanged: `redis`/`rabbitmq` sections map to
    store/bus, `gomengine.accuracy` to engine.accuracy."""
    raw: dict[str, Any] = {}
    if path is not None:
        raw = _read_yaml(path)
    elif os.path.exists("config.yaml"):
        raw = _read_yaml("config.yaml")

    grpc_raw = raw.get("grpc", {}) or {}
    store_raw = dict(raw.get("redis", {}) or {})
    if store_raw:
        store_raw.setdefault("enabled", True)
    bus_raw = dict(raw.get("rabbitmq", {}) or {})
    if bus_raw:
        bus_raw.setdefault("backend", "amqp")
    bus_raw.update(raw.get("bus", {}) or {})
    engine_raw = dict(raw.get("gomengine", {}) or {})
    engine_raw.update(raw.get("engine", {}) or {})
    persist_raw = dict(raw.get("persist", {}) or {})
    if persist_raw:
        persist_raw.setdefault("enabled", True)
    ops_raw = dict(raw.get("ops", {}) or {})
    if ops_raw:
        ops_raw.setdefault("enabled", True)
    fleet_raw = dict(raw.get("fleet", {}) or {})
    if fleet_raw:
        fleet_raw.setdefault("enabled", True)
    sim_raw = dict(raw.get("sim", {}) or {})
    faults_raw = dict(raw.get("faults", {}) or {})
    if faults_raw:
        faults_raw.setdefault("enabled", True)
    admission_raw = dict(raw.get("admission", {}) or {})
    if admission_raw:
        admission_raw.setdefault("enabled", True)
    raw.pop("mysql", None)  # dead section, config.yaml.example:16-21

    known = {
        "grpc", "redis", "rabbitmq", "bus", "gomengine", "engine",
        "persist", "ops", "fleet", "sim", "faults", "admission",
    }
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"unknown config sections: {sorted(unknown)}")

    return Config(
        grpc=_build(GrpcConfig, grpc_raw, "grpc"),
        store=_build(StoreConfig, store_raw, "redis"),
        bus=_build(BusConfig, bus_raw, "bus"),
        engine=_build(EngineConfig, engine_raw, "engine"),
        persist=_build(PersistConfig, persist_raw, "persist"),
        ops=_build(OpsConfig, ops_raw, "ops"),
        fleet=_build(FleetConfig, fleet_raw, "fleet"),
        sim=_build(SimConfig, sim_raw, "sim"),
        faults=_build(FaultsConfig, faults_raw, "faults"),
        admission=_build(AdmissionConfig, admission_raw, "admission"),
    )
