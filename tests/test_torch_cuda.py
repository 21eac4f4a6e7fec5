"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where `torch.cuda.is_available()` is
false, since a CUDA kernel has no CPU mode. This file imports no JAX, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are `chip_smoke.py`'s: relative 1e-5 of the largest reference
entry for the flash forward, 1e-4 for its gradients (sums over up to S
keys in another order).
"""

import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu_torch.ops import flash_cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(128, 16), (256, 32), (384, 64)])
def test_flash_kernels_match_plain(s, d):
    _card()
    rng = np.random.default_rng(s + d)
    q, k, v, do = (torch.tensor(rng.normal(size=(4, s, d)).astype(np.float32), device="cuda") for _ in range(4))
    o, lse = flash_cuda.flash_fwd(q, k, v, 0.25)
    o_ref, lse_ref = flash_cuda.flash_fwd_plain(q, k, v, 0.25)
    assert _rel(o, o_ref) <= 1e-5 and _rel(lse, lse_ref) <= 1e-5
    got = flash_cuda.flash_bwd(q, k, v, o_ref, lse_ref, do, 0.25)
    for a, b in zip(got, flash_cuda.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, 0.25)):
        assert _rel(a, b) <= 1e-4
