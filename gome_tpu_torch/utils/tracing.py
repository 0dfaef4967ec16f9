"""Profiling hooks — torch.profiler integration (the port of
``gome_tpu/utils/tracing.py``, whose hooks wrap jax.profiler).

  trace(dir)        — context manager around torch.profiler.profile (CPU
                      and, where there is a card, CUDA activity); exports
                      one Chrome trace into dir, loadable in Perfetto or
                      chrome://tracing.
  annotate(name)    — torch.profiler.record_function for host-side phases,
                      so batch packing/decoding shows up on the trace
                      alongside the card's kernels.
  maybe_trace(dir)  — no-op unless dir is set (config/env-driven).
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    )


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def maybe_trace(log_dir: str | None):
    if not log_dir:
        yield
        return
    with trace(log_dir):
        yield
