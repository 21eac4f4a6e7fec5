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
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..partition import Partition, build_partition, flatten_params, param_shapes

# Reference init: xavier_uniform on conv/linear weights, bias = 0.01
# (the JAX package's models/base.py kernel_init / bias_init).
BIAS_INIT = 0.01


def xavier_bound(shape: Tuple[int, ...]) -> float:
    """Glorot-uniform bound for an OIHW conv or `[out, in]` dense weight.

    fan_in = in·kh·kw and fan_out = out·kh·kw — the same fans Flax reads
    from the HWIO / `[in, out]` layouts, so both draw from one interval.
    """
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return math.sqrt(6.0 / (fan_in + fan_out))


class PartitionedModel(nn.Module):
    """An `nn.Module` that knows its own layer/block partition.

    GROUP_PATHS:      per-group list of parameter-path prefixes
    LINEAR_GROUP_IDS: groups that receive the elastic-net penalty
    TRAIN_ORDER:      default group visit order per outer loop
    """

    GROUP_PATHS: Tuple = ()
    LINEAR_GROUP_IDS: Tuple[int, ...] = ()
    TRAIN_ORDER: Tuple[int, ...] = ()

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        return param_shapes(self)

    def partition(self) -> Partition:
        return build_partition(
            self.shapes(),
            self.GROUP_PATHS,
            linear_group_ids=self.LINEAR_GROUP_IDS,
            train_order=self.TRAIN_ORDER,
        )

    @torch.no_grad()
    def reset_parameters_(self, generator: torch.Generator) -> "PartitionedModel":
        """Xavier-uniform weights and 0.01 biases, drawn from `generator`.

        Draws happen on the CPU in flat (sorted-name) order and are then
        copied, so a seed gives the same weights on every device.
        """
        params = dict(self.named_parameters())
        for name in sorted(params):
            p = params[name]
            if name.endswith(".bias"):
                p.fill_(BIAS_INIT)
            else:
                a = xavier_bound(tuple(p.shape))
                u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                p.copy_(u * (2.0 * a) - a)
        return self

    def forward_batched(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One client's logits `[B, classes]` from NHWC images `[B, H, W, C]`."""
        params = {n: p[None] for n, p in self.named_parameters()}
        return self.forward_batched(params, x[None])[0]


def init_client_params(
    model: PartitionedModel, n_clients: int, seed: int = 0, device="cpu"
) -> torch.Tensor:
    """K identical clients (common-seed init) as a flat `[K, N]` tensor.

    The JAX package draws with `jax.random`; the port draws from a
    `torch.Generator`, so the two inits differ. Parity tests convert the
    JAX init (`convert.py`) instead of comparing draws.
    """
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters_(gen)
    flat = flatten_params({n: p.detach() for n, p in model.named_parameters()})
    return flat[None].expand(n_clients, -1).contiguous().to(device)
