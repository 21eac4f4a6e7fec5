"""Port parity: the rectangular flash family (plain versions of the CUDA kernels).

Non-causal `flash_attention` (the ViT's path) and `flash_block` (global
offsets, `s_q != s_kv`, the masked-row guards, the lse cotangent) on CPU
tensors, where `ops.flash_cuda` runs the kernels' plain PyTorch versions,
held against the JAX package's `flash_attention` / `flash_block` in Pallas
interpret mode (as its own tests run them) and against dense references.
Same seeded numpy inputs on both sides. Tolerances are the JAX package's
flash tests': forward relative 2e-5 / absolute 2e-6, gradients relative
5e-4 / absolute 5e-5 (float32 products summed in other orders). Rows that
see no key are held exactly: o = 0, lse = -1e30, dq = 0. The kernels run
only on the card: `tests/test_torch_cuda.py` (marker `cuda`) and
`chip_smoke.py` hold them to these plain versions there.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.ops.flash_attention import flash_attention as j_flash
from federated_pytorch_test_tpu.ops.flash_attention import flash_block as j_block
from federated_pytorch_test_tpu.parallel import dense_attention as j_dense
from federated_pytorch_test_tpu_torch.ops import flash_cuda
from federated_pytorch_test_tpu_torch.ops.flash_cuda import flash_attention, flash_block

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
SHAPES = [(128, 16), (128, 32), (256, 16), (256, 32)]
NEG_BIG = np.float32(-1e30)


def _qkv(s, d, b=2, h=2, seed=0, s_kv=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s_kv or s, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _t(arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("s,d", SHAPES)
def test_noncausal_forward_matches_jax_flash(s, d):
    q, k, v = _qkv(s, d, seed=3 * s + d)
    ref = np.asarray(j_flash(*_j((q, k, v)), causal=False))
    with torch.no_grad():
        out = flash_attention(*_t((q, k, v)), causal=False).numpy()
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    np.testing.assert_allclose(out, np.asarray(j_dense(*_j((q, k, v)), causal=False)), **FWD_TOL)


@pytest.mark.parametrize("s,d", SHAPES)
def test_noncausal_gradients_match_jax_flash(s, d):
    q, k, v = _qkv(s, d, seed=5 * s + d)

    def j_loss(q, k, v):
        return jnp.sum(j_flash(q, k, v, causal=False) ** 2)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(*_j((q, k, v)))
    tq, tk, tv = _t((q, k, v), grad=True)
    (flash_attention(tq, tk, tv, causal=False) ** 2).sum().backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}", **GRAD_TOL)


def test_default_causal_matches_jax():
    # both entries default to bidirectional attention
    port_default = inspect.signature(flash_attention).parameters["causal"].default
    jax_default = inspect.signature(j_flash).parameters["causal"].default
    assert port_default is jax_default is False
    q, k, v = _qkv(128, 16, seed=11)
    with torch.no_grad():
        out = flash_attention(*_t((q, k, v))).numpy()
    np.testing.assert_allclose(out, np.asarray(j_flash(*_j((q, k, v)))), **FWD_TOL)
    assert inspect.signature(flash_block).parameters["causal"].default is False


def test_flash_block_two_block_merge():
    # mirror of the JAX package's test: folding the two partials of a split
    # K/V axis with the online-softmax merge gives full causal attention
    q, k, v = _qkv(256, 16, b=1, seed=7)
    ref = np.asarray(j_dense(*_j((q, k, v)), causal=True))
    qb = q[:, 128:]
    o_parts, lse_parts = [], []
    for j in (0, 1):
        kb, vb = k[:, 128 * j : 128 * (j + 1)], v[:, 128 * j : 128 * (j + 1)]
        with torch.no_grad():
            o, lse = flash_block(*_t((qb, kb, vb)), 128, 128 * j, causal=True)
        jo, jlse = j_block(*_j((qb, kb, vb)), jnp.int32(128), jnp.int32(128 * j), causal=True)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
        o_parts.append(o)
        lse_parts.append(lse)
    m = torch.maximum(*lse_parts)
    w0, w1 = (torch.exp(lse - m) for lse in lse_parts)
    merged = (o_parts[0] * w0[..., None] + o_parts[1] * w1[..., None]) / (w0 + w1)[..., None]
    np.testing.assert_allclose(merged.permute(0, 2, 1, 3).numpy(), ref[:, 128:], **FWD_TOL)


def test_flash_block_fully_future_block_is_exact():
    # a K/V block entirely in the causal future: o = 0 and lse = -1e30
    # exactly, and no gradient flows
    q, k, v = _qkv(256, 16, b=1, seed=7)
    tq, tk, tv = _t((q[:, :128], k[:, 128:], v[:, 128:]), grad=True)
    o, lse = flash_block(tq, tk, tv, 0, 128, causal=True)
    assert float(o.detach().abs().max()) == 0.0
    assert bool((lse == NEG_BIG).all())
    (o.sum() + lse.sum()).backward()
    assert all(float(g.abs().max()) == 0.0 for g in (tq.grad, tk.grad, tv.grad))


def test_flash_block_unaligned_offsets():
    # k_off - q_off = 64, not a multiple of the 128-row block: a kept block
    # holds rows that see no key (the in-tile masked-row guard)
    off = 64
    q, k, v = _qkv(128, 16, b=1, h=1, seed=9)
    tq, tk, tv = _t((q, k, v), grad=True)
    o, lse = flash_block(tq, tk, tv, 0, off, causal=True)
    assert float(o.detach()[:, :, :off].abs().max()) == 0.0
    assert bool((lse[:, :, :off] == NEG_BIG).all())
    jo, jlse = j_block(*_j((q, k, v)), jnp.int32(0), jnp.int32(off), causal=True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), **FWD_TOL)

    (o**2).sum().backward()
    assert float(tq.grad[:, :off].abs().max()) == 0.0

    def j_loss(q, k, v):
        o, _ = j_block(q, k, v, jnp.int32(0), jnp.int32(off), causal=True)
        return jnp.sum(o**2)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(*_j((q, k, v)))
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_lse_gradient(causal):
    # a loss over both outputs: the lse cotangent folds into delta
    q, k, v = _qkv(128, 16, b=1, h=1, seed=8)

    def j_loss(q, k, v):
        o, lse = j_block(q, k, v, jnp.int32(0), jnp.int32(0), causal=causal)
        return jnp.sum(o**2) + jnp.sum(jnp.sin(lse))

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(*_j((q, k, v)))
    tq, tk, tv = _t((q, k, v), grad=True)
    o, lse = flash_block(tq, tk, tv, 0, 0, causal=causal)
    ((o**2).sum() + torch.sin(lse).sum()).backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}", **GRAD_TOL)

    # only lse used: the o cotangent is missing and counts as zero
    tq, tk, tv = _t((q, k, v), grad=True)
    torch.sin(flash_block(tq, tk, tv, 0, 0, causal=causal)[1]).sum().backward()
    ref = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(j_block(q, k, v, 0, 0, causal=causal)[1])),
                   argnums=(0, 1, 2))(*_j((q, k, v)))
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name} (lse only)", **GRAD_TOL)


@pytest.mark.parametrize("causal,q_off,k_off", [(False, 0, 0), (True, 256, 0), (True, 128, 64)])
def test_flash_block_rectangular(causal, q_off, k_off):
    # s_q = 128 queries against s_kv = 256 keys, forward and gradients
    q, k, v = _qkv(128, 32, seed=13, s_kv=256)

    def j_loss(q, k, v):
        o, lse = j_block(q, k, v, jnp.int32(q_off), jnp.int32(k_off), causal=causal)
        return jnp.sum(o**2) + jnp.sum(jnp.where(lse > -1e29, lse, 0.0))

    jo, jlse = j_block(*_j((q, k, v)), jnp.int32(q_off), jnp.int32(k_off), causal=causal)
    ref = jax.grad(j_loss, argnums=(0, 1, 2))(*_j((q, k, v)))
    tq, tk, tv = _t((q, k, v), grad=True)
    o, lse = flash_block(tq, tk, tv, q_off, k_off, causal=causal)
    assert o.shape == (2, 2, 128, 32) and lse.shape == (2, 2, 128)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), **FWD_TOL)
    ((o**2).sum() + torch.where(lse > -1e29, lse, 0.0).sum()).backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("causal,q_off,k_off", [(False, 0, 0), (True, 0, 64), (True, 0, 128), (True, 128, 0)])
def test_backward_matches_autograd_of_the_plain_forward(causal, q_off, k_off):
    # the custom backward (the dq and dk/dv plain versions, dlse folded into
    # delta) against autograd through the plain forward, with non-zero
    # cotangents on both outputs: `chip_smoke.py` makes the same check
    # with the kernels on the card
    rng = np.random.default_rng(q_off + k_off + causal)
    q, k, v, do = (torch.tensor(rng.normal(size=(3, 128, 16)).astype(np.float32)) for _ in range(4))
    dlse = torch.tensor(rng.normal(size=(3, 128)).astype(np.float32))
    grads = []
    for fwd in (lambda *a: flash_cuda._FlashRect.apply(*a), flash_cuda.flash_fwd_rect_plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o, lse = fwd(*leaves, 0.25, causal, q_off, k_off)
        ((o * do).sum() + (lse * dlse).sum()).backward()
        grads.append([t.grad for t in leaves])
    for name, got, want in zip("qkv", *grads):
        assert bool(torch.isfinite(want).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=f"d{name}", **GRAD_TOL)


def test_rect_causal_at_zero_offsets_is_the_aligned_family():
    # the two plain families agree where both apply: causal, aligned, s_q == s_kv
    q, k, v, do = (torch.tensor(a) for a in np.random.default_rng(4).normal(size=(4, 3, 256, 16)).astype(np.float32))
    o, lse = flash_cuda.flash_fwd_plain(q, k, v, 0.25)
    o_r, lse_r = flash_cuda.flash_fwd_rect_plain(q, k, v, 0.25, causal=True)
    np.testing.assert_allclose(o_r.numpy(), o.numpy(), **FWD_TOL)
    np.testing.assert_allclose(lse_r.numpy(), lse.numpy(), **FWD_TOL)
    delta = (do * o).sum(-1)
    got = (flash_cuda.flash_bwd_dq_rect_plain(q, k, v, do, lse, delta, 0.25, True),
           *flash_cuda.flash_bwd_dkv_rect_plain(q, k, v, do, lse, delta, 0.25, True))
    want = (flash_cuda.flash_bwd_dq_plain(q, k, v, do, lse, delta, 0.25),
            *flash_cuda.flash_bwd_dkv_plain(q, k, v, do, lse, delta, 0.25))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_rect_checks():
    with pytest.raises(ValueError, match="divisible by 128"):
        flash_block(*_t(_qkv(128, 16, s_kv=192)), 0, 0)
    # D 24 (padded to the D 32 instance) and D 128 run and match JAX's flash_block
    for d in (24, 128):
        q, k, v = _qkv(128, d, s_kv=256, seed=d)
        o_ref, lse_ref = j_block(*map(jnp.asarray, (q, k, v)), 128, 64, causal=True)
        with torch.no_grad():
            o, lse = flash_block(*_t((q, k, v)), 128, 64, causal=True)
        assert o.shape == o_ref.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **FWD_TOL)
    with pytest.raises(ValueError, match="head dim 160 not ported.*ROADMAP B.2"):
        flash_block(*_t(_qkv(128, 160)), 0, 0)
    with pytest.raises(ValueError, match="head dim 320 too large for a single VMEM tile"):
        flash_block(*_t(_qkv(128, 320)), 0, 0)


def test_cpu_tensors_launch_no_rect_kernel():
    flash_cuda.reset_launch_counts()
    q, k, v = _t(_qkv(128, 16), grad=True)
    flash_attention(q, k, v).sum().backward()
    o, lse = flash_block(q, k, v, 0, 64, causal=True)
    (o.sum() + lse.sum()).backward()
    assert all(n == 0 for n in flash_cuda.LAUNCHES.values()), flash_cuda.LAUNCHES
