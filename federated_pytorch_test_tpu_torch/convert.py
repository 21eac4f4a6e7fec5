"""Parameters between the JAX package's layout and this package's.

The JAX package keeps a Flax params tree `{layer: {"bias", "kernel"}}`
with conv kernels HWIO and dense kernels `[in, out]`; this package keeps
`{"layer.bias", "layer.weight"}` with conv weights OIHW and dense
weights `[out, in]`. Both flat vectors list the leaves in the same sorted
order with the same sizes (`partition/flat.py`), so converting a flat
vector permutes elements inside each leaf and nothing else. The models
flatten the last feature map channels-last in both packages, so `fc1`
needs no row permutation beyond the transpose.

Arrays are numpy on the JAX side; any number of leading batch axes (e.g.
the stacked clients `[K, ...]`) is carried through.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .partition import leaf_offsets


def _to_torch_leaf(a: np.ndarray, nd: int) -> np.ndarray:
    """One JAX leaf with `nd` trailing dims to the port's layout."""
    b = a.ndim - nd
    lead = tuple(range(b))
    if nd == 4:  # HWIO -> OIHW
        return np.transpose(a, lead + (b + 3, b + 2, b, b + 1))
    if nd == 2:  # [in, out] -> [out, in]
        return np.swapaxes(a, -1, -2)
    return a


def _to_jax_leaf(a: np.ndarray, nd: int) -> np.ndarray:
    """One port leaf with `nd` trailing dims to the JAX layout."""
    b = a.ndim - nd
    lead = tuple(range(b))
    if nd == 4:  # OIHW -> HWIO
        return np.transpose(a, lead + (b + 2, b + 3, b + 1, b))
    if nd == 2:
        return np.swapaxes(a, -1, -2)
    return a


def _jax_shape(shape) -> tuple:
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    if len(shape) == 2:
        return (shape[1], shape[0])
    return tuple(shape)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """`{layer: {"bias", "kernel"}}` (optionally under `"params"`) of numpy
    arrays -> `{"layer.bias", "layer.weight"}` float32 tensors."""
    tree = tree.get("params", tree)
    out = {}
    for layer, leaves in tree.items():
        for leaf, arr in leaves.items():
            a = np.asarray(arr, np.float32)
            if leaf == "kernel":
                nd = 4 if layer.startswith("conv") else 2
                out[f"{layer}.weight"] = torch.from_numpy(np.ascontiguousarray(_to_torch_leaf(a, nd)))
            elif leaf == "bias":
                out[f"{layer}.bias"] = torch.from_numpy(np.array(a))
            else:
                raise ValueError(f"unexpected leaf {layer}/{leaf}")
    return out


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's named parameters -> a Flax-layout `{layer: {...}}` of numpy arrays."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in params.items():
        layer, leaf = name.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            nd = 4 if layer.startswith("conv") else 2
            out.setdefault(layer, {})["kernel"] = np.ascontiguousarray(_to_jax_leaf(a, nd))
        else:
            out.setdefault(layer, {})["bias"] = a
    return out


def flat_from_jax(flat: np.ndarray, shapes: Mapping[str, tuple]) -> np.ndarray:
    """A JAX flat vector `[..., N]` -> this package's flat order.

    `shapes` are the port's parameter shapes (`model.shapes()`).
    """
    flat = np.asarray(flat, np.float32)
    batch = flat.shape[:-1]
    out = np.empty_like(flat)
    for path, start, size in leaf_offsets(shapes):
        shape = tuple(shapes[".".join(path)])
        seg = flat[..., start : start + size].reshape(*batch, *_jax_shape(shape))
        out[..., start : start + size] = _to_torch_leaf(seg, len(shape)).reshape(*batch, size)
    return out


def flat_to_jax(flat: np.ndarray, shapes: Mapping[str, tuple]) -> np.ndarray:
    """This package's flat vector `[..., N]` -> the JAX flat order."""
    flat = np.asarray(flat, np.float32)
    batch = flat.shape[:-1]
    out = np.empty_like(flat)
    for path, start, size in leaf_offsets(shapes):
        shape = tuple(shapes[".".join(path)])
        seg = flat[..., start : start + size].reshape(*batch, *shape)
        out[..., start : start + size] = _to_jax_leaf(seg, len(shape)).reshape(*batch, size)
    return out
