"""Hand-written CUDA kernels for the matching hot path, each beside its plain
PyTorch version."""

from .match_step import batch_step, batch_step_reference

__all__ = ["batch_step", "batch_step_reference"]
