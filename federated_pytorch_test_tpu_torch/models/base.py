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

Probe fans (`client_fold='gemm'`, `engine/steps.py`). A fan of P line-
search probes gives the probe axis only to the active group's parameters:
their leaves arrive with K·P clients (client-major, row k·P + p), every
other leaf with K. `client_linear`, `client_affine` and `client_conv2d`
take activations of either width against weights of either width: a
narrow activation meets P-wide weights by being repeated P times (the
first active layer: below it the forward runs once a fan), and a P-wide
activation meets frozen weights as K clients on a P-times-wider batch.
Layers whose result depends on the whole batch — BatchNorm's statistics,
the switch MoE's capacity — instead repeat their frozen parameters P
times, so that each (client, probe) keeps its own.

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
import torch.nn.functional as F
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


def widen_clients(h: torch.Tensor, k: int) -> torch.Tensor:
    """`h [Kc, ...]` repeated to `k` clients where `k` is wider, each
    client's rows P = k/Kc times in a row (client-major, as a fan's widened
    leaves); `h` itself where it already has `k` or more."""
    return h if h.shape[0] >= k else h.repeat_interleave(k // h.shape[0], dim=0)


def client_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Per-client dense layer `x [Kc, M, in] -> [max(Kc, Kw), M, out]` with
    `weight [Kw, out, in]`, `bias [Kw, out]`, where Kc and Kw may differ by
    a fan's factor P (module docstring)."""
    kc, kw = x.shape[0], weight.shape[0]
    if kw > kc:
        x, kc = widen_clients(x, kw), kw
    if kc == kw:
        return torch.baddbmm(bias[:, None, :], x, weight.transpose(1, 2))
    _, m, n_in = x.shape  # frozen weights: K clients on a P-times-wider batch
    out = torch.baddbmm(bias[:, None, :], x.reshape(kw, (kc // kw) * m, n_in), weight.transpose(1, 2))
    return out.reshape(kc, m, -1)


def client_affine(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """`y [Kc, M, D] · scale + bias` with per-client `[Kw, D]` terms, Kc and
    Kw as in `client_linear`."""
    kc, kw = y.shape[0], scale.shape[0]
    if kw > kc:
        y, kc = widen_clients(y, kw), kw
    if kc == kw:
        return y * scale[:, None, :] + bias[:, None, :]
    m = y.shape[1]
    return (y.reshape(kw, (kc // kw) * m, -1) * scale[:, None, :] + bias[:, None, :]).reshape(y.shape)


def widen_channels(h: torch.Tensor, kc: int, k: int) -> torch.Tensor:
    """A grouped-channel activation `[B, Kc·C, H, W]` of `kc` clients
    repeated to `k` clients where `k` is wider (each client's channels P
    times in a row)."""
    if k <= kc:
        return h
    b, ch, hh, ww = h.shape
    return h.reshape(b, kc, 1, ch // kc, hh, ww).expand(b, kc, k // kc, ch // kc, hh, ww).reshape(b, k * (ch // kc),
                                                                                                    hh, ww)


def client_conv2d(h: torch.Tensor, kc: int, weight: torch.Tensor, bias=None, **kw) -> Tuple[torch.Tensor, int]:
    """Grouped convolution of `kc` clients' channels `h [B, Kc·C, H, W]`
    with `weight [Kw, O, I, kh, kw]` (and `bias [Kw, O]`); returns the
    output `[B, Kc'·O, H', W']` and its client count Kc' = max(Kc, Kw).
    Frozen weights under a P-wide activation run on the P probes' images
    as one batch of P·B (`kw` are `F.conv2d`'s keyword arguments)."""
    n_w, o, i, kh, kww = weight.shape
    if n_w > kc:
        h, kc = widen_channels(h, kc, n_w), n_w
    w = weight.reshape(n_w * o, i, kh, kww)
    b2 = None if bias is None else bias.reshape(n_w * o)
    if kc == n_w:
        return F.conv2d(h, w, b2, groups=n_w, **kw), kc
    p = kc // n_w
    b, _, hh, ww = h.shape
    folded = h.reshape(b, n_w, p, i, hh, ww).permute(2, 0, 1, 3, 4, 5).reshape(p * b, n_w * i, hh, ww)
    out = F.conv2d(folded, w, b2, groups=n_w, **kw)
    _, _, oh, ow = out.shape
    out = out.reshape(p, b, n_w, o, oh, ow).permute(1, 2, 0, 3, 4, 5).reshape(b, kc * o, oh, ow)
    return out, kc


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
