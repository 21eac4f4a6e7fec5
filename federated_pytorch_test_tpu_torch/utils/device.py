"""Device selection and numeric settings shared by every entry point.

The port runs on the card unless the caller asks for the CPU: a request
for CUDA on a machine without one raises instead of quietly moving to the
CPU. Float32 matrix products and convolutions run in full float32 (no
TF32), matching the JAX package's `Precision.HIGHEST` contractions.
"""

from __future__ import annotations

import torch


def configure_precision() -> None:
    """Full-f32 matmuls and convolutions (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`, checked to exist; sets full-f32 precision."""
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
