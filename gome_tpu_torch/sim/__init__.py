"""The market simulator on torch tensors (the port of ``gome_tpu/sim``): the
RL/simulation workload of JAX-LOB (arXiv:2308.13289), driven by the Hawkes
order-flow model of arXiv:2510.08085.

Layout:

  flow.py   — Hawkes/Zipf order-flow generator emitting engine op grids on
              the device (the bin scan is the CUDA kernel
              ops/csrc/hawkes_scan.cu on the card)
  env.py    — gym-style vectorized environment over the stacked books
              (`reset`/`step`/`rollout`, no host sync in a rollout)
  replay.py — seeded deterministic replay manifests + GCO record mode
  stats.py  — host-side empirical diagnostics (Zipf fit, branching
              ratio, clustering) for statistical assertions
"""

from .env import (
    AgentAction,
    EnvConfig,
    EnvState,
    MarketEnv,
    Obs,
    StepInfo,
    env_reset,
    env_step,
    null_action,
    rollout,
)
from .flow import (
    N_EVENT_TYPES,
    FlowConfig,
    FlowState,
    flow_init,
    gen_ops,
    gen_ops_jit,
)
from .replay import (
    grid_to_columns,
    make_manifest,
    orders_from_grid,
    record_frames,
    run_from_manifest,
)

__all__ = [
    "AgentAction",
    "EnvConfig",
    "EnvState",
    "FlowConfig",
    "FlowState",
    "MarketEnv",
    "N_EVENT_TYPES",
    "Obs",
    "StepInfo",
    "env_reset",
    "env_step",
    "flow_init",
    "gen_ops",
    "gen_ops_jit",
    "grid_to_columns",
    "make_manifest",
    "null_action",
    "orders_from_grid",
    "record_frames",
    "rollout",
    "run_from_manifest",
]
