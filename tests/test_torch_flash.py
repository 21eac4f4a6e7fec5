"""Port parity: causal flash attention (plain versions of the CUDA kernels).

On CPU tensors `ops.flash_cuda` runs the kernels' plain PyTorch versions;
they are held here against the JAX package's `flash_attention`, run in
Pallas interpret mode as its own tests run it, and against the dense
references of both packages. Same seeded numpy inputs on both sides.
Tolerances are the JAX package's flash tests': forward relative 2e-5 /
absolute 2e-6, gradients relative 5e-4 / absolute 5e-5 (float32 products
summed in other orders). The kernels themselves run only on the card:
`tests/test_torch_cuda.py` (marker `cuda`) and `chip_smoke.py` hold them
to these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.ops.flash_attention import flash_attention as j_flash
from federated_pytorch_test_tpu.parallel import dense_attention as j_dense
from federated_pytorch_test_tpu_torch.ops import flash_cuda
from federated_pytorch_test_tpu_torch.ops.attention import dense_attention
from federated_pytorch_test_tpu_torch.ops.flash_cuda import flash_attention

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
SHAPES = [(128, 16), (128, 32), (256, 16), (256, 32)]


def _qkv(s, d, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


def _t(arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("s,d", SHAPES)
def test_forward_matches_jax_flash(s, d):
    q, k, v = _qkv(s, d, seed=s + d)
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), causal=True))
    with torch.no_grad():
        out = flash_attention(*_t((q, k, v)), causal=True).numpy()
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    np.testing.assert_allclose(out, np.asarray(j_dense(*map(jnp.asarray, (q, k, v)), causal=True)), **FWD_TOL)


@pytest.mark.parametrize("s,d", SHAPES)
def test_gradients_match_jax_flash(s, d):
    q, k, v = _qkv(s, d, seed=7 * s + d)

    def j_loss(q, k, v):
        return jnp.sum(j_flash(q, k, v, causal=True) ** 2)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t((q, k, v), grad=True)
    (flash_attention(tq, tk, tv, causal=True) ** 2).sum().backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}", **GRAD_TOL)


def test_lse_is_the_row_logsumexp():
    # the forward's second output: natural-log logsumexp of the scaled,
    # causally masked scores, per (batch·head) row (float64 reference)
    q, k, v = (a.transpose(0, 2, 1, 3).reshape(4, 256, 16) for a in _qkv(256, 16, seed=3))
    o, lse = flash_cuda.flash_fwd(*_t((q, k, v)), 0.25)
    sc = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k.astype(np.float64)) * 0.25
    sc = np.where(np.tril(np.ones((256, 256), bool)), sc, -np.inf)
    mx = sc.max(-1, keepdims=True)
    ref = (mx + np.log(np.exp(sc - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref, **FWD_TOL)
    p = np.exp(sc - ref[..., None])
    np.testing.assert_allclose(o.numpy(), p @ v.astype(np.float64), **FWD_TOL)


def test_port_dense_matches_jax_dense():
    q, k, v = _qkv(64, 16, seed=5)  # dense takes any length
    for causal in (False, True):
        ref = np.asarray(j_dense(*map(jnp.asarray, (q, k, v)), causal=causal))
        out = dense_attention(*_t((q, k, v)), causal=causal).numpy()
        np.testing.assert_allclose(out, ref, **FWD_TOL)


def test_custom_scale():
    q, k, v = _qkv(128, 16, seed=2)
    ref = np.asarray(j_dense(*map(jnp.asarray, (q, k, v)), causal=True, sm_scale=0.07))
    with torch.no_grad():
        out = flash_attention(*_t((q, k, v)), causal=True, sm_scale=0.07).numpy()
    np.testing.assert_allclose(out, ref, **FWD_TOL)


def test_rejects_what_the_kernels_do_not_take():
    q, k, v = _t(_qkv(64, 16))
    with pytest.raises(ValueError, match="divisible by 128"):
        flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="head dim 24 not ported"):
        flash_attention(*_t(_qkv(128, 24)), causal=True)
    with pytest.raises(ValueError, match="head dim 128 not ported"):  # the JAX entry takes D <= 256
        flash_attention(*_t(_qkv(128, 128, b=1, h=1)), causal=False)


def test_cpu_tensors_launch_no_kernel():
    flash_cuda.reset_launch_counts()
    q, k, v = _t(_qkv(128, 16), grad=True)
    flash_attention(q, k, v, causal=True).sum().backward()
    assert set(flash_cuda.CAUSAL_KERNELS) <= set(flash_cuda.LAUNCHES)
    assert all(n == 0 for n in flash_cuda.LAUNCHES.values()), flash_cuda.LAUNCHES
