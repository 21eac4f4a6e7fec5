"""The three simple CNN clients (ELU) with partition metadata.

Counterpart of the JAX package's `models/simple.py` (`Net`, `Net1`,
`Net2`): same layer shapes, ELU activations, 2x2/2 max-pooling and the
same layer-numbering universe — group g is the (weight, bias) pair of the
g-th layer in construction order.

The JAX models flatten the last feature map in NHWC order (h, w, c)
before `fc1`. `forward_batched` permutes to channels-last before its
flatten, so `fc1.weight` is the plain transpose of the Flax kernel.

With `dtype=torch.bfloat16` every layer — convolutions, dense layers,
ELU and pooling — runs in bf16 and the logits come out bf16, as the JAX
models with `dtype=bfloat16` do (`simple.py:62-68`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .base import PartitionedModel, client_conv2d, client_linear, resolve_dtype

# (name, in_channels, out_channels, kernel, padding, pool_after)
ConvSpec = Tuple[str, int, int, int, int, bool]
# (name, in_features, out_features)
DenseSpec = Tuple[str, int, int]


class SimpleCNN(PartitionedModel):
    """Convs (ELU, optional max-pool) then dense layers (ELU but the last)."""

    CONVS: Tuple[ConvSpec, ...] = ()
    DENSES: Tuple[DenseSpec, ...] = ()

    def __init__(self, num_classes: int = 10, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = resolve_dtype(dtype)
        for name, cin, cout, k, _pad, _pool in self.CONVS:
            setattr(self, name, nn.Conv2d(cin, cout, k))
        for i, (name, fin, fout) in enumerate(self.DENSES):
            last = i == len(self.DENSES) - 1
            setattr(self, name, nn.Linear(fin, num_classes if last else fout))

    def forward_batched(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """Logits `[K, B, classes]` of K clients on NHWC images `[K, B, H, W, C]`.

        The client axis rides the channel axis of a grouped convolution
        (`groups=K`) and the batch axis of `bmm`, so each layer is one
        launch for all clients, and client k only ever reads its own
        weights. Under a probe fan (`models/base.py`) the logits come out
        for K·P clients.
        """
        k, b, hh, ww, c = x.shape
        dt = self.dtype
        h = x.permute(1, 0, 4, 2, 3).reshape(b, k * c, hh, ww).to(dt)
        cout, kc = c, k
        for name, cin, cout, ks, pad, pool in self.CONVS:
            h, kc = client_conv2d(h, kc, params[f"{name}.weight"].to(dt), params[f"{name}.bias"].to(dt), padding=pad)
            h = F.elu(h)
            if pool:
                h = F.max_pool2d(h, 2, 2)
        _, _, fh, fw = h.shape
        # NHWC flatten, as the JAX models do before fc1
        h = h.reshape(b, kc, cout, fh, fw).permute(1, 0, 3, 4, 2).reshape(kc, b, fh * fw * cout)
        for i, (name, _fin, _fout) in enumerate(self.DENSES):
            h = client_linear(h, params[f"{name}.weight"].to(dt), params[f"{name}.bias"].to(dt))
            if i < len(self.DENSES) - 1:
                h = F.elu(h)
        return h


def _groups(names):
    return tuple(((n,),) for n in names)


class Net(SimpleCNN):
    """LeNet-style 5-layer CNN (62,006 params)."""

    CONVS = (
        ("conv1", 3, 6, 5, 0, True),  # 32->28->14
        ("conv2", 6, 16, 5, 0, True),  # 14->10->5
    )
    DENSES = (("fc1", 400, 120), ("fc2", 120, 84), ("fc3", 84, 10))
    GROUP_PATHS = _groups(("conv1", "conv2", "fc1", "fc2", "fc3"))
    LINEAR_GROUP_IDS = (2, 3, 4)
    TRAIN_ORDER = (2, 0, 1, 3, 4)


class Net1(SimpleCNN):
    """6-layer CNN (~890K params)."""

    CONVS = (
        ("conv1", 3, 32, 3, 0, False),  # 32->30
        ("conv2", 32, 32, 3, 0, True),  # 30->28->14
        ("conv3", 32, 64, 3, 0, False),  # 14->12
        ("conv4", 64, 64, 3, 0, True),  # 12->10->5
    )
    DENSES = (("fc1", 1600, 512), ("fc2", 512, 10))
    GROUP_PATHS = _groups(("conv1", "conv2", "conv3", "conv4", "fc1", "fc2"))
    LINEAR_GROUP_IDS = (4, 5)
    TRAIN_ORDER = (2, 5, 1, 3, 0, 4)


class Net2(SimpleCNN):
    """9-layer CNN (~2.5M params); 3x3 "SAME" convs (stride 1: pad 1)."""

    CONVS = (
        ("conv1", 3, 64, 3, 1, True),  # 32->16
        ("conv2", 64, 128, 3, 1, True),  # 16->8
        ("conv3", 128, 256, 3, 1, True),  # 8->4
        ("conv4", 256, 512, 3, 1, True),  # 4->2
    )
    DENSES = (
        ("fc1", 2048, 128),
        ("fc2", 128, 256),
        ("fc3", 256, 512),
        ("fc4", 512, 1024),
        ("fc5", 1024, 10),
    )
    GROUP_PATHS = _groups(
        ("conv1", "conv2", "conv3", "conv4", "fc1", "fc2", "fc3", "fc4", "fc5")
    )
    LINEAR_GROUP_IDS = (4, 5, 6, 7, 8)
    TRAIN_ORDER = (7, 2, 1, 4, 8, 6, 3, 0, 5)
