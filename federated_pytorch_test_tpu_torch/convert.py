"""Parameters between the JAX package's layout and this package's.

The JAX package keeps a (possibly nested) Flax params tree; this package
keeps dotted names on PyTorch modules. Each leaf has a kind
(`PartitionedModel.leaf_kinds`, read from the module that owns it), and
the kind, never the number of dimensions, fixes its name and layout on
either side:

| kind        | JAX leaf      | JAX layout | port leaf | port layout |
|-------------|---------------|------------|-----------|-------------|
| `dense`     | `kernel`      | `[in, out]`| `weight`  | `[out, in]` |
| `conv`      | `kernel`      | HWIO       | `weight`  | OIHW        |
| `bias`      | `bias`        | as is      | `bias`    | as is       |
| `embed`     | `embedding`   | `[vocab, dim]` | `weight` | as is    |
| `scale`     | `scale`       | as is      | `weight`  | as is       |
| `norm_bias` | `bias`        | as is      | `bias`    | as is       |
| `array`     | (bare leaf)   | as is      | same name | as is       |

(`array` is a parameter registered on a container, such as the LM's
`pos_embed` at the root of its tree, or the ViT's `[1, T, dim]` one; the
ViT's patch embedding is a `conv`.)

Both flat vectors list the leaves in the same order with the same sizes
(`partition/flat.py`), so converting a flat vector permutes elements
inside each leaf and nothing else. The simple CNNs flatten the last feature
map channels-last in both packages, so `fc1` needs no row permutation
beyond the transpose.

Arrays are numpy on the JAX side; any number of leading batch axes (e.g.
the stacked clients `[K, ...]`) is carried through.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from .models.base import ARRAY, BIAS, CONV, DENSE, EMBED, NORM_BIAS, SCALE, PartitionedModel
from .partition import leaf_offsets

_JAX_LEAF = {DENSE: "kernel", CONV: "kernel", BIAS: "bias", EMBED: "embedding", SCALE: "scale",
             NORM_BIAS: "bias"}


def jax_path(name: str, kind: str) -> Tuple[str, ...]:
    """The JAX tree path of the port's parameter `name` of `kind`."""
    parts = tuple(name.split("."))
    return parts if kind == ARRAY else (*parts[:-1], _JAX_LEAF[kind])


def _to_torch_leaf(a: np.ndarray, kind: str) -> np.ndarray:
    """One JAX leaf (any leading batch axes) to the port's layout."""
    if kind == CONV:  # HWIO -> OIHW
        b = a.ndim - 4
        return np.transpose(a, tuple(range(b)) + (b + 3, b + 2, b, b + 1))
    if kind == DENSE:  # [in, out] -> [out, in]
        return np.swapaxes(a, -1, -2)
    return a


def _to_jax_leaf(a: np.ndarray, kind: str) -> np.ndarray:
    """One port leaf (any leading batch axes) to the JAX layout."""
    if kind == CONV:  # OIHW -> HWIO
        b = a.ndim - 4
        return np.transpose(a, tuple(range(b)) + (b + 2, b + 3, b + 1, b))
    if kind == DENSE:
        return np.swapaxes(a, -1, -2)
    return a


def _jax_shape(shape, kind: str) -> tuple:
    if kind == CONV:
        o, i, h, w = shape
        return (h, w, i, o)
    if kind == DENSE:
        return (shape[1], shape[0])
    return tuple(shape)


def _leaves(model: PartitionedModel) -> List[Tuple[str, str, Tuple[int, ...], int, int]]:
    """`(name, kind, port shape, start, size)` per leaf in flat order.

    Checks that the JAX paths sort into the same order, so one set of
    offsets serves both flat vectors.
    """
    shapes, kinds = model.shapes(), model.leaf_kinds()
    offsets = leaf_offsets(shapes)
    names = [".".join(path) for path, _, _ in offsets]
    paths = [jax_path(n, kinds[n]) for n in names]
    if paths != sorted(paths):
        raise ValueError(f"the JAX tree's leaf order differs from the port's: {paths}")
    return [(n, kinds[n], tuple(shapes[n]), start, size) for n, (_, start, size) in zip(names, offsets)]


def _count_leaves(tree: Any) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def params_from_jax(tree: Mapping, model: PartitionedModel) -> Dict[str, torch.Tensor]:
    """A Flax params tree (optionally under `"params"`) of numpy arrays ->
    the port's `{name: float32 tensor}` for `model` (a `state_dict`)."""
    tree = tree.get("params", tree)
    leaves = _leaves(model)
    if _count_leaves(tree) != len(leaves):
        raise ValueError(f"tree has {_count_leaves(tree)} leaves, {type(model).__name__} has {len(leaves)}")
    out = {}
    for name, kind, shape, _, _ in leaves:
        node = tree
        for key in jax_path(name, kind):
            node = node[key]
        a = np.asarray(node, np.float32)
        if a.shape != _jax_shape(shape, kind):
            raise ValueError(f"{name}: JAX leaf has shape {a.shape}, want {_jax_shape(shape, kind)}")
        out[name] = torch.from_numpy(np.array(_to_torch_leaf(a, kind), order="C"))  # a writable copy
    return out


def params_to_jax(params: Mapping[str, torch.Tensor], model: PartitionedModel) -> Dict[str, Any]:
    """The port's named parameters -> a nested Flax-layout tree of numpy arrays."""
    kinds = model.leaf_kinds()
    out: Dict[str, Any] = {}
    for name, t in params.items():
        *parents, leaf = jax_path(name, kinds[name])
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(_to_jax_leaf(t.detach().cpu().numpy(), kinds[name]))
    return out


def flat_from_jax(flat: np.ndarray, model: PartitionedModel) -> np.ndarray:
    """A JAX flat vector `[..., N]` -> this package's flat order for `model`."""
    flat = np.asarray(flat, np.float32)
    batch = flat.shape[:-1]
    out = np.empty_like(flat)
    for _, kind, shape, start, size in _leaves(model):
        seg = flat[..., start : start + size].reshape(*batch, *_jax_shape(shape, kind))
        out[..., start : start + size] = _to_torch_leaf(seg, kind).reshape(*batch, size)
    return out


def flat_to_jax(flat: np.ndarray, model: PartitionedModel) -> np.ndarray:
    """This package's flat vector `[..., N]` for `model` -> the JAX flat order."""
    flat = np.asarray(flat, np.float32)
    batch = flat.shape[:-1]
    out = np.empty_like(flat)
    for _, kind, shape, start, size in _leaves(model):
        seg = flat[..., start : start + size].reshape(*batch, *shape)
        out[..., start : start + size] = _to_jax_leaf(seg, kind).reshape(*batch, size)
    return out
