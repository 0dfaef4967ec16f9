"""Hand-written CUDA kernels, each beside its plain PyTorch version: the
batched match step (K1, ``ops.match_step``) and the simulator's Hawkes bin
scan (K5, ``ops.hawkes_scan``)."""

from .match_step import batch_step, batch_step_reference

__all__ = ["batch_step", "batch_step_reference"]
