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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s_q,s_kv,d,causal,q_off,k_off",
    [(256, 256, 16, False, 0, 0), (128, 384, 32, False, 0, 0), (256, 256, 64, True, 0, 64),
     (128, 128, 16, True, 0, 128), (128, 384, 32, True, 256, 64)],
)
def test_rect_kernels_match_plain(s_q, s_kv, d, causal, q_off, k_off):
    # both modes of the rectangular family; rows that see no key are exact
    _card()
    rng = np.random.default_rng(s_q + s_kv + d + q_off + k_off)
    q, do = (torch.tensor(rng.normal(size=(4, s_q, d)).astype(np.float32), device="cuda") for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(4, s_kv, d)).astype(np.float32), device="cuda") for _ in range(2))
    args = (0.25, causal, q_off, k_off)
    o, lse = flash_cuda.flash_fwd_rect(q, k, v, *args)
    o_ref, lse_ref = flash_cuda.flash_fwd_rect_plain(q, k, v, *args)
    live = lse_ref > -1e29
    assert _rel(o, o_ref) <= 1e-5 and (not live.any() or _rel(lse[live], lse_ref[live]) <= 1e-5)
    assert bool((o[~live] == 0).all()) and bool((lse[~live] == -1e30).all())
    delta = (do * o_ref).sum(-1)
    got = (flash_cuda.flash_bwd_dq_rect(q, k, v, do, lse_ref, delta, *args),
           *flash_cuda.flash_bwd_dkv_rect(q, k, v, do, lse_ref, delta, *args))
    want = (flash_cuda.flash_bwd_dq_rect_plain(q, k, v, do, lse_ref, delta, *args),
            *flash_cuda.flash_bwd_dkv_rect_plain(q, k, v, do, lse_ref, delta, *args))
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-4
