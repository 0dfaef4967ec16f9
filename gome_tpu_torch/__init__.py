"""gome_tpu_torch — the matching engine on PyTorch and CUDA.

A port of `gome_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA Hopper
card. Module names mirror `gome_tpu`'s, so each counterpart is easy to
find; the package imports nothing of `gome_tpu` or JAX.

Layout:
  gome_tpu_torch.types    — domain types (Side, Action, Order, MatchResult)
  gome_tpu_torch.fixed    — fixed-point scaling
  gome_tpu_torch.oracle   — pure-Python executable model of the semantics
  gome_tpu_torch.engine   — torch book state, the step, BatchEngine, the
                            frame path and the MatchEngine facade
  gome_tpu_torch.ops      — the hand-written CUDA kernels (the match step,
                            the simulator's Hawkes bin scan), each beside
                            its plain PyTorch version
  gome_tpu_torch.config   — the typed YAML configuration (the same file
                            loads into gome_tpu's)
  gome_tpu_torch.bus      — memory and file queues, the JSON codecs and the
                            columnar ORDER/EVENT frames (host numpy), and
                            make_bus
  gome_tpu_torch.api      — the gRPC wire contract (order.proto's messages,
                            the Order service, server reflection)
  gome_tpu_torch.service  — the gRPC gateway, admission control, the order
                            consumer (cross-frame pipelining), the
                            match-event feed, health, the ops endpoint and
                            EngineService (python -m
                            gome_tpu_torch.service.app)
  gome_tpu_torch.persist  — snapshots and crash replay, the Redis key
                            schema both ways, the RESP client and its
                            stand-in server
  gome_tpu_torch.clients  — the gRPC load and cancel clients
  gome_tpu_torch.sim      — the market simulator: Hawkes/Zipf order flow,
                            the RL environment, seeded replay and record
                            mode, flow statistics
  gome_tpu_torch.utils    — synthetic order streams, logging, metrics,
                            fault injection, tracing (torch.profiler)

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; CPU tensors take the kernels' plain versions.
"""

__version__ = "0.1.0"
