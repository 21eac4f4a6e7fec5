"""Parameter dict <-> flat-vector codec.

Counterpart of the JAX package's `partition/flat.py`, which ravels a Flax
params tree with `ravel_pytree`. That order is the tree's sorted-key
order at every level of nesting: layers sorted by name and, inside a
layer, `bias` before `kernel` (or `scale`); a nested tree such as the
TransformerLM's (`block0/attn/qkv/kernel`, a bare `pos_embed` at the root)
sorts each level in turn. The port keeps PyTorch's dotted parameter names
(`conv1.bias`, `block0.attn.qkv.weight`) and sorts them by their dotted
parts, the same order, so both packages cut the flat vector at the same
leaf boundaries: every partition group, L-BFGS vector and consensus slice
covers the same coordinates' span in both. Only the element order INSIDE
a leaf may differ (OIHW/[out,in] here, HWIO/[in,out] there); `convert.py`
maps one to the other.

Every function takes tensors with any number of leading batch axes, so
the same codec serves one client `[N]` and the stacked clients `[K, N]`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

Shapes = Mapping[str, Tuple[int, ...]]


def leaf_order(names) -> List[str]:
    """Parameter names in the flat vector's order: sorted by their dotted
    parts, as ravel_pytree sorts each level of a nested tree (a plain
    string sort would put `a-b` before `a.c`; the tree puts `a/c` first)."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def leaf_offsets(shapes: Shapes) -> List[Tuple[Tuple[str, ...], int, int]]:
    """`(path, start, size)` per leaf in flat order; `path` splits the
    dotted name (`"fc1.weight"` -> `("fc1", "weight")`)."""
    out = []
    start = 0
    for name in leaf_order(shapes):
        size = math.prod(shapes[name])
        out.append((tuple(name.split(".")), start, size))
        start += size
    return out


def total_size(shapes: Shapes) -> int:
    return sum(math.prod(s) for s in shapes.values())


def flatten_params(params: Mapping[str, torch.Tensor], batch_dims: int = 0) -> torch.Tensor:
    """Concatenate the leaves in flat order into `[*batch, N]`.

    `batch_dims` leading axes (e.g. 1 for stacked `[K, ...]` clients) are
    kept; the rest of each leaf is raveled row-major.
    """
    parts = []
    for name in leaf_order(params):
        p = params[name]
        parts.append(p.reshape(*p.shape[:batch_dims], -1))
    return torch.cat(parts, dim=-1)


def unflatten_params(flat: torch.Tensor, shapes: Shapes) -> Dict[str, torch.Tensor]:
    """Views of `flat [*batch, N]` shaped like `shapes` (no copy)."""
    batch = flat.shape[:-1]
    out = {}
    for path, start, size in leaf_offsets(shapes):
        name = ".".join(path)
        out[name] = flat[..., start : start + size].reshape(*batch, *shapes[name])
    return out


def param_shapes(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """`{name: shape}` of a module's parameters."""
    return {n: tuple(p.shape) for n, p in module.named_parameters()}

