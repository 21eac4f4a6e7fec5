"""Plain dense attention: the port's copy of the JAX package's reference.

Counterpart of `dense_attention` in the JAX package's `parallel/ring.py`:
the whole `[B, H, S, S]` score matrix, a `-1e30` causal fill and scale
`1/sqrt(D)` by default. It is the `'dense'` attention of the transformer
models and the yardstick the flash kernels are held to.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_BIG = -1e30


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, sm_scale: Optional[float] = None
) -> torch.Tensor:
    """Reference single-device attention. q, k, v: `[B, S, H, D]` -> `[B, S, H, D]`."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        keep = torch.arange(s_k, device=q.device)[None, :] <= torch.arange(s_q, device=q.device)[:, None]
        scores = torch.where(keep, scores, torch.full((), NEG_BIG, dtype=scores.dtype, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
