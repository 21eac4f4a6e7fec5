"""Device selection and numeric settings shared by every entry point.

The port runs on the card unless the caller asks for the CPU: a request
for CUDA on a machine without one raises instead of quietly moving to the
CPU. Float32 matrix products and convolutions run in full float32 (no
TF32), matching the JAX package's `Precision.HIGHEST` contractions, and
cuDNN runs deterministically without autotuning, so that a run repeats bit
for bit (the JAX package is deterministic by construction; its crash and
resume contracts rest on it).
"""

from __future__ import annotations

import torch


def configure_precision() -> None:
    """Full-f32 matmuls and convolutions (TF32 off); cuDNN's deterministic
    algorithms only, chosen without benchmarking (an autotuned choice may
    differ between runs, and cuDNN's fastest convolution weight gradients
    add in an order that changes from run to run)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`, checked to exist; sets full-f32
    precision and deterministic cuDNN (`configure_precision`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA or CPU device, got {str(device)!r}")
    configure_precision()
    return dev
