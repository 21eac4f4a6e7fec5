"""Shared model protocol: partition metadata + common-seed client init.

Counterpart of the JAX package's `models/base.py`. A model is an
`nn.Module` that knows its own layer partition (three class attributes,
as in the JAX package) and has two forwards:

* `forward(x)` — one client, on the module's own parameters;
* `forward_batched(params, x)` — K clients at once, on stacked
  `[K, ...]` parameter tensors. This is what the engine runs: the client
  axis the JAX package `vmap`s is written out here (grouped convolutions
  and batched matmuls), so one kernel launch serves every client.

Both take NHWC images, the JAX package's layout, at the public boundary.

Every model carries a compute dtype (`dtype`, the engine's
`compute_dtype`), as the JAX package's models do: parameters stay f32
(the engine may hand them over already cast), and each layer casts its
weights and input to `dtype` for its convolutions and matmuls; each
model's docstring says what else runs in it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..partition import Partition, build_partition, flatten_params, leaf_order, param_shapes
from ..utils.device import resolve_device

# Reference init (the JAX package's models/base.py and models/transformer.py):
# xavier_uniform on conv/dense weights, dense/conv bias = 0.01, embeddings
# and learned positions normal(0.02), LayerNorm and BatchNorm scale 1 and
# bias 0 (BatchNorm's running averages are client state, `init_stats`).
BIAS_INIT = 0.01
EMBED_STD = 0.02

# Leaf kinds (`PartitionedModel.leaf_kinds`): each fixes a leaf's init and
# its layout in the JAX package's tree (`convert.py`). The MoE's stacked
# expert leaves (`models/moe.py`) are bare leaves like `ARRAY`, initialised
# as Flax initialises them: `EXPERT_WEIGHT` xavier-uniform over `[E, in,
# out]` (E counts as receptive field), `EXPERT_BIAS` the constant 0.01.
DENSE, CONV, BIAS, EMBED, SCALE, NORM_BIAS, ARRAY, EXPERT_WEIGHT, EXPERT_BIAS = (
    "dense", "conv", "bias", "embed", "scale", "norm_bias", "array", "expert_weight", "expert_bias"
)
BARE_KINDS = (ARRAY, EXPERT_WEIGHT, EXPERT_BIAS)  # bare leaves of the JAX tree, converted as they are

# the JAX package's `compute_dtype` values
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype: torch.dtype) -> torch.dtype:
    """`dtype`, checked to be one of `COMPUTE_DTYPES`' values."""
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"dtype must be one of {list(COMPUTE_DTYPES.values())}, got {dtype!r}")
    return dtype


def xavier_bound(shape: Tuple[int, ...]) -> float:
    """Glorot-uniform bound for an OIHW conv or `[out, in]` dense weight.

    fan_in = in·kh·kw and fan_out = out·kh·kw — the same fans Flax reads
    from the HWIO / `[in, out]` layouts, so both draw from one interval.
    """
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return math.sqrt(6.0 / (fan_in + fan_out))


def expert_xavier_bound(shape: Tuple[int, ...]) -> float:
    """Flax's xavier_uniform bound for a stacked `[E, in, out]` expert weight:
    fan_in = E·in, fan_out = E·out."""
    e, fan_in, fan_out = shape
    return math.sqrt(6.0 / (e * fan_in + e * fan_out))


def _module_leaf_kinds(module: nn.Module) -> Dict[str, str]:
    """Kinds of one module's own parameters (not its children's)."""
    if isinstance(module, nn.Linear):
        return {"weight": DENSE, "bias": BIAS}
    if isinstance(module, nn.Conv2d):
        return {"weight": CONV, "bias": BIAS}
    if isinstance(module, nn.Embedding):
        return {"weight": EMBED}
    if isinstance(module, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
        return {"weight": SCALE, "bias": NORM_BIAS}
    return getattr(module, "LEAF_KINDS", {})


class PartitionedModel(nn.Module):
    """An `nn.Module` that knows its own layer/block partition.

    GROUP_PATHS:      per-group list of parameter-path prefixes
    LINEAR_GROUP_IDS: groups that receive the elastic-net penalty
    TRAIN_ORDER:      default group visit order per outer loop
    """

    GROUP_PATHS: Tuple = ()
    LINEAR_GROUP_IDS: Tuple[int, ...] = ()
    TRAIN_ORDER: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32  # compute dtype; each model's constructor takes it

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        return param_shapes(self)

    def leaf_kinds(self) -> Dict[str, str]:
        """`{name: kind}` of every parameter, from the module that owns it.

        A parameter registered directly on a container module (the LM's
        `pos_embed`) is a bare `ARRAY`, as it is a bare leaf in the JAX tree,
        unless the module names its kind in `LEAF_KINDS` (the MoE's experts).
        """
        kinds = {}
        for prefix, mod in self.named_modules():
            own = _module_leaf_kinds(mod)
            for leaf, _ in mod.named_parameters(recurse=False):
                name = f"{prefix}.{leaf}" if prefix else leaf
                kinds[name] = own.get(leaf, ARRAY)
        return kinds

    def partition(self) -> Partition:
        return build_partition(
            self.shapes(),
            self.GROUP_PATHS,
            linear_group_ids=self.LINEAR_GROUP_IDS,
            train_order=self.TRAIN_ORDER,
        )

    @torch.no_grad()
    def reset_parameters_(self, generator: torch.Generator) -> "PartitionedModel":
        """The reference init, drawn from `generator`.

        Draws happen on the CPU in flat (sorted-name) order and are then
        copied, so a seed gives the same weights on every device.
        """
        params = dict(self.named_parameters())
        kinds = self.leaf_kinds()
        for name in leaf_order(params):
            p, kind = params[name], kinds[name]
            if kind in (BIAS, EXPERT_BIAS):
                p.fill_(BIAS_INIT)
            elif kind == SCALE:
                p.fill_(1.0)
            elif kind == NORM_BIAS:
                p.zero_()
            elif kind in (EMBED, ARRAY):
                p.copy_(EMBED_STD * torch.randn(p.shape, generator=generator, dtype=torch.float32))
            else:
                a = expert_xavier_bound(tuple(p.shape)) if kind == EXPERT_WEIGHT else xavier_bound(tuple(p.shape))
                u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                p.copy_(u * (2.0 * a) - a)
        return self

    def init_stats(self, n_clients: int, device="cuda") -> Dict[str, torch.Tensor]:
        """Client-local statistics `{name: [K, ...]}` that live outside the
        flat parameter vector (BatchNorm's running averages); none here."""
        return {}

    def forward_batched(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One client's logits `[B, classes]` from NHWC images `[B, H, W, C]`."""
        params = {n: p[None] for n, p in self.named_parameters()}
        return self.forward_batched(params, x[None])[0]


def init_client_params(
    model: PartitionedModel, n_clients: int, seed: int = 0, device="cuda", common: bool = True
) -> torch.Tensor:
    """K clients' initial parameters as a flat `[K, N]` tensor on `device`
    (the card unless the caller asks for the CPU).

    `common=True`: every client gets the same draw, from `seed`. Otherwise
    each client k draws from its own generator, seeded from `(seed, k)`
    (the reference's independently constructed networks).

    The JAX package draws with `jax.random` (and runs a forward pass to
    learn the shapes); the port draws from a `torch.Generator` and runs
    none, so the two inits differ. Parity tests convert the JAX init
    (`convert.py`) instead of comparing draws.
    """
    dev = resolve_device(device)

    def draw(gen_seed: int) -> torch.Tensor:
        model.reset_parameters_(torch.Generator().manual_seed(gen_seed))
        return flatten_params({n: p.detach() for n, p in model.named_parameters()})

    if common:
        return draw(seed)[None].expand(n_clients, -1).contiguous().to(dev)
    seeds = [int(np.random.SeedSequence([seed, k]).generate_state(1, np.uint64)[0]) for k in range(n_clients)]
    return torch.stack([draw(s) for s in seeds]).to(dev)
