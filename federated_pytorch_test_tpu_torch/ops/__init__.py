"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from .compact_cuda import (
    LAUNCHES,
    compact_direction_cuda,
    fused_direction_assembly,
    fused_gram_projections,
    reset_launch_counts,
)

__all__ = [
    "LAUNCHES",
    "compact_direction_cuda",
    "fused_direction_assembly",
    "fused_gram_projections",
    "reset_launch_counts",
]
