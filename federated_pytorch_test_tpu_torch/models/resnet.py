"""ResNet18 (ELU) with the reference's 10-block partition and client-local BatchNorm.

Counterpart of the JAX package's `models/resnet.py`: BasicBlock with two
3x3 convs (no bias) and BatchNorm, ELU where ResNet has ReLU, a 1x1-conv
shortcut where the shape changes, a 4x4 average pool and a linear head.
The 10 groups are the reference's `upidx` table read structurally:
[stem, block0, ..., block7, linear].

`forward_batched` runs K clients at once, as `SimpleCNN` does: the client
axis rides the channel axis of grouped convolutions, and BatchNorm over
K·C channels gives each client its own statistics. Under a probe fan
(`models/base.py`) a BatchNorm above the active group runs over K·P·C
channels, its scale and bias repeated, so each probe keeps its own
statistics, and the new running averages come out for K·P clients there.

BatchNorm follows Flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` in
f32 (`use_fast_variance=True`):
* train mode normalizes with the batch statistics (one `F.batch_norm`
  call) and returns new running averages
  `0.9·old + 0.1·batch`, where the batch variance is the biased
  E[x²] − E[x]² that Flax uses. Torch's own running update would take the
  unbiased variance, so the update is written here, and the running
  averages are values passed in and returned, never module buffers;
* eval mode normalizes with the running averages.
Torch computes the normalizing batch variance by another formula than
E[x²] − E[x]²; at f32 the two agree to a few ulps of the variance
(tests/test_torch_resnet.py states the logits' tolerance).

Mixed precision (`dtype=torch.bfloat16`, the JAX model's `dtype`,
`resnet.py:51-72,97`): the convolutions, BatchNorm's normalization, ELU,
the residual sum (the shortcut cast to the block's dtype), the pooling
and the head run in bf16; BatchNorm's scale and bias stay f32 and its
running averages are kept in f32, updated from statistics taken in f32
of the bf16 activations. One difference from the JAX model: there the
bf16 layer also takes its batch statistics in bf16
(`force_float32_reductions=False`, a two-pass variance — a fusion choice
measured on a v5e); here `F.batch_norm` (cuDNN on the card) accumulates
them in f32. The two agree within the JAX package's own bf16-vs-f32 bound
(tests/test_torch_mixed_precision.py).

Padding. Flax's "SAME" pads `(k − 1 + (out − 1)·s − in)` in total, the
smaller half first: symmetric (1, 1) for the stride-1 3x3 convs but (0, 1)
for stride 2 on an even input, which torch's `padding=` cannot express, so
those convs take an explicit `F.pad`. The 1x1 shortcut is "VALID".
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .base import PartitionedModel, client_conv2d, client_linear, resolve_dtype, widen_channels, widen_clients

MOMENTUM = 0.9  # Flax's: new = MOMENTUM·old + (1 − MOMENTUM)·batch
EPS = 1e-5
STEM_PLANES = 64


def _bn(c: int) -> nn.BatchNorm2d:
    # scale and bias only: the running averages are client state
    return nn.BatchNorm2d(c, eps=EPS, track_running_stats=False)


class BasicBlock(nn.Module):
    """Two 3x3 conv + BN with ELU and an optional 1x1-conv shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, bias=False)
        self.bn2 = _bn(planes)
        self.shortcut = stride != 1 or in_planes != planes
        if self.shortcut:
            self.sc_conv = nn.Conv2d(in_planes, planes, 1, bias=False)
            self.sc_bn = _bn(planes)


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax "SAME" padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ResNet18(PartitionedModel):
    """ResNet18 for 32x32 NHWC inputs, ELU activations."""

    # (planes, stride) of the eight blocks; a class attribute, as in the JAX
    # package, so tests narrow both models the same way
    STAGES: Tuple[Tuple[int, int], ...] = (
        (64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1),
    )
    GROUP_PATHS = (
        (("conv1",), ("bn1",)),
        (("block0",),),
        (("block1",),),
        (("block2",),),
        (("block3",),),
        (("block4",),),
        (("block5",),),
        (("block6",),),
        (("block7",),),
        (("linear",),),
    )
    LINEAR_GROUP_IDS = ()  # the reference's ResNet scripts put no elastic net in their closures
    TRAIN_ORDER = tuple(range(10))  # the presets shuffle it (`shuffle_group_order`)

    def __init__(self, num_classes: int = 10, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = resolve_dtype(dtype)
        self.conv1 = nn.Conv2d(3, STEM_PLANES, 3, bias=False)
        self.bn1 = _bn(STEM_PLANES)
        self.stages = tuple(self.STAGES)  # fixed at construction
        in_planes = STEM_PLANES
        for i, (planes, stride) in enumerate(self.stages):
            setattr(self, f"block{i}", BasicBlock(in_planes, planes, stride))
            in_planes = planes
        self.linear = nn.Linear(in_planes, num_classes)

    def init_stats(self, n_clients: int, device="cuda") -> Dict[str, torch.Tensor]:
        """Flax's initial running averages, per client: mean 0, variance 1,
        keyed `<layer>.mean`, `<layer>.var` in sorted layer order."""
        out = {}
        for name, m in sorted(self.named_modules()):
            if isinstance(m, nn.BatchNorm2d):
                out[f"{name}.mean"] = torch.zeros((n_clients, m.num_features), device=device)
                out[f"{name}.var"] = torch.ones((n_clients, m.num_features), device=device)
        return out

    def forward_batched(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                        stats: Optional[Dict[str, torch.Tensor]] = None, train: bool = True):
        """K clients on NHWC images `[K, B, H, W, C]`.

        Train mode returns `(logits [K, B, classes], new_stats)`: the batch
        statistics normalize, and `new_stats` holds the running averages
        updated from `stats` (None when `stats` is None). Eval mode returns
        the logits, normalized with the running averages `stats`.
        """
        k, b, hh, ww, c = x.shape
        dt = self.dtype
        if not train and stats is None:
            raise ValueError("eval mode normalizes with the running averages: pass `stats`")
        new_stats = {} if train and stats is not None else None
        # clients of the activation: K, or K·P from a probe fan's first active layer on
        kc = k

        def conv(h, name, stride):
            nonlocal kc
            w = params[f"{name}.weight"].to(dt)
            kh, kw = w.shape[-2:]
            if kh == 1:  # the shortcut: "VALID"
                out, kc = client_conv2d(h, kc, w, stride=stride)
                return out
            (top, bottom), (left, right) = _same_pads(h.shape[2], kh, stride), _same_pads(h.shape[3], kw, stride)
            if top == bottom and left == right:
                out, kc = client_conv2d(h, kc, w, stride=stride, padding=(top, left))
            else:
                out, kc = client_conv2d(F.pad(h, (left, right, top, bottom)), kc, w, stride=stride)
            return out

        def bn(h, name):
            # frozen scale and bias under a P-wide activation are repeated, so
            # that each (client, probe) normalizes with its own batch statistics
            w = widen_clients(params[f"{name}.weight"], kc).reshape(-1).float()
            bias = widen_clients(params[f"{name}.bias"], kc).reshape(-1).float()
            if not train:
                return F.batch_norm(h, stats[f"{name}.mean"].reshape(-1), stats[f"{name}.var"].reshape(-1),
                                    w, bias, training=False, eps=EPS)
            if new_stats is not None:
                with torch.no_grad():
                    hd = h.detach().float()
                    mean = hd.mean(dim=(0, 2, 3))
                    var = torch.clamp((hd * hd).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
                    for key, batch in (("mean", mean), ("var", var)):
                        old = widen_clients(stats[f"{name}.{key}"], kc)
                        new_stats[f"{name}.{key}"] = MOMENTUM * old + (1.0 - MOMENTUM) * batch.reshape(old.shape)
            return F.batch_norm(h, None, None, w, bias, training=True, eps=EPS)

        h = x.permute(1, 0, 4, 2, 3).reshape(b, k * c, hh, ww).to(dt)
        h = F.elu(bn(conv(h, "conv1", 1), "bn1"))
        for i, (_, stride) in enumerate(self.stages):
            name = f"block{i}"
            # a block's leaves share one width: widen the input, shortcut included
            kb = params[f"{name}.conv1.weight"].shape[0]
            if kb > kc:
                h, kc = widen_channels(h, kc, kb), kb
            out = F.elu(bn(conv(h, f"{name}.conv1", stride), f"{name}.bn1"))
            out = bn(conv(out, f"{name}.conv2", 1), f"{name}.bn2")
            if getattr(self, name).shortcut:
                h = bn(conv(h, f"{name}.sc_conv", stride), f"{name}.sc_bn")
            h = F.elu(out + h)
        h = F.avg_pool2d(h, 4, 4)  # 4x4 -> 1x1
        _, kch, fh, fw = h.shape
        # NHWC flatten, as the JAX model does before the head
        h = h.reshape(b, kc, kch // kc, fh, fw).permute(1, 0, 3, 4, 2).reshape(kc, b, -1)
        logits = client_linear(h, params["linear.weight"].to(dt), params["linear.bias"].to(dt))
        return (logits, new_stats) if train else logits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One client's train-mode logits `[B, classes]` (batch statistics)."""
        params = {n: p[None] for n, p in self.named_parameters()}
        return self.forward_batched(params, x[None])[0][0]
