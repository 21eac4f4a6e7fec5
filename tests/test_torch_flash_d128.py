"""Port parity at head dim 128, and at head dims the kernels reach by padding.

The port's flash kernels have instances at D in {16, 32, 64, 128}; the
public entries zero-pad any other D up to 128 to the next instance and
slice the padding off (`ops/flash_cuda.py`). On CPU tensors the wrappers
take their plain versions (fed the same padding), held here against the
JAX package's `flash_attention` and `flash_block` in Pallas interpret mode,
as its own tests run them, on the same seeded numpy inputs:

* D = 128, causal and non-causal, forward and gradients: at 'highest'
  within the flash tests' tolerances (forward relative 2e-5 / absolute
  2e-6, gradients 5e-4 / 5e-5, as tests/test_torch_flash.py); at 'default'
  (the one-pass plain versions, which round every operand to TF32 and run
  the forward tile by tile at the D-128 kernel's 32 keys a tile) within
  rtol = atol = 2e-2 of JAX's 'default', which is full f32 on the CPU (the
  JAX package's own 'default' contract, as tests/test_torch_flash_default.py);
* `flash_block` at D = 128, causal on offsets, with an lse cotangent;
* the bf16 trio (`cast16`) at D = 128, where the JAX package sums the
  softmax denominator in its l scratch (`fuse_l` is false at D % 128 == 0):
  within rtol = atol = 1e-2, two bf16 units at magnitude one
  (tests/test_torch_mixed_precision.py's bound);
* padded D 24 and 80 (to the D 32 and D 128 instances) against JAX at the
  true D, forward and gradients, the scale 1/sqrt(D) of the true D;
* a `TransformerLM` (dim 256, 2 heads) and a `ViT` (dim 256, 2 heads,
  patch 2) with 'flash' attention against the JAX models, weights carried
  across by `convert.py`: logits and the loss at the LM's and the ViT's
  tolerances (tests/test_torch_transformer.py, tests/test_torch_vit.py),
  and one partition group's gradient of the loss (relative 2e-3 /
  absolute 2e-4, the JAX package's flash-vs-dense bound for a model's
  gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.models import TransformerLM as JLM
from federated_pytorch_test_tpu.models import ViT as JViT
from federated_pytorch_test_tpu.ops.flash_attention import flash_attention as j_flash
from federated_pytorch_test_tpu.ops.flash_attention import flash_block as j_block
from federated_pytorch_test_tpu.partition import flatten_params as jflatten
from federated_pytorch_test_tpu_torch.convert import flat_from_jax, params_from_jax
from federated_pytorch_test_tpu_torch.models import TransformerLM, ViT
from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
from federated_pytorch_test_tpu_torch.partition import flatten_params

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
DEFAULT_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
TOLS = {"highest": (FWD_TOL, GRAD_TOL), "default": (DEFAULT_TOL, DEFAULT_TOL)}


def _inputs(s, d, seed, b=1, h=2, s_kv=None):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s_kv or s, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _port(fn, q, k, v, do, dtype=torch.float32):
    leaves = [torch.tensor(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, torch.tensor(do).to(out.dtype))


def _jax(fn, q, k, v, do, dtype=jnp.float32):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return out, vjp(jnp.asarray(do, out.dtype))


def _close(got, want, fwd_tol, grad_tol):
    (out, grads), (jout, jgrads) = got, want
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), **fwd_tol)
    for a, b in zip(grads, jgrads):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **grad_tol)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("causal", [True, False])
def test_d128_plain_versions_match_jax_flash(causal, precision):
    q, k, v, do = _inputs(256, 128, seed=causal + 2 * (precision == "default"))
    got = _port(lambda *a: fc.flash_attention(*a, causal=causal, precision=precision), q, k, v, do)
    want = _jax(lambda *a: j_flash(*a, causal=causal, precision=precision), q, k, v, do)
    _close(got, want, *TOLS[precision])


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_d128_flash_block_matches_jax(precision):
    # the rectangular kernels causal on offsets (queries 192.., keys 64..), with an lse cotangent
    q, k, v, do = _inputs(128, 128, seed=5, s_kv=256)
    do = np.moveaxis(do, 2, 1)  # o is head-major, [B, H, Sq, D]
    dlse = np.random.default_rng(6).normal(size=do.shape[:3]).astype(np.float32)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o, lse = fc.flash_block(*leaves, 192, 64, causal=True, precision=precision)
    grads = torch.autograd.grad((o, lse), leaves, (torch.tensor(do), torch.tensor(dlse)))
    (jo, jlse), vjp = jax.vjp(lambda *a: j_block(*a, 192, 64, causal=True, precision=precision),
                              *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    fwd_tol, grad_tol = TOLS[precision]
    for a, b in ((o, jo), (lse, jlse)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **fwd_tol)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **grad_tol)


def test_d128_bf16_trio_matches_jax_cast16():
    q, k, v, do = _inputs(256, 128, seed=7)
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (q, k, v))  # the same bf16 values
    got = _port(lambda *a: fc.flash_attention(*a, causal=True, precision="default"), q, k, v, do, torch.bfloat16)
    want = _jax(lambda *a: j_flash(*a, causal=True, precision="default"), q, k, v, do, jnp.bfloat16)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in got[1])
    _close(got, want, BF16_TOL, BF16_TOL)


@pytest.mark.parametrize("d,causal", [(24, True), (80, True), (80, False)])
def test_padded_head_dims_match_jax(d, causal, monkeypatch):
    seen = []
    plain = fc.flash_fwd_plain if causal else fc.flash_fwd_rect_plain

    def recorded(q3, *args):
        seen.append(q3.shape[-1])
        return plain(q3, *args)

    monkeypatch.setattr(fc, plain.__name__, recorded)
    q, k, v, do = _inputs(128, d, seed=d)
    got = _port(lambda *a: fc.flash_attention(*a, causal=causal), q, k, v, do)
    want = _jax(lambda *a: j_flash(*a, causal=causal), q, k, v, do)
    assert seen == [fc.padded_dim(d)] and fc.padded_dim(d) in fc.HEAD_DIMS and fc.padded_dim(d) > d
    assert got[0].shape == q.shape
    _close(got, want, FWD_TOL, GRAD_TOL)


def _group_grad(model, flat_grad, gid):
    return torch.cat([flat_grad[s.start:s.start + s.size] for s in model.partition().groups[gid]]).numpy()


def test_lm_at_head_dim_128_matches_jax():
    cfg = dict(vocab=32, dim=256, num_heads=2, max_len=128)
    jparams = JLM(**cfg, attn_impl="dense").init(jax.random.PRNGKey(4), jnp.zeros((1, 64), jnp.int32))["params"]
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg["vocab"], size=(2, 128)).astype(np.int32)
    labels = rng.integers(0, cfg["vocab"], size=(2, 128)).astype(np.int32)
    jlm = JLM(**cfg, attn_impl="flash")

    def jloss(p):
        logits = jlm.apply({"params": p}, jnp.asarray(tokens))
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(labels)[..., None], -1)), logits

    (jl, jlogits), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    model = TransformerLM(**cfg, attn_impl="flash")
    params = {n: t.requires_grad_(True) for n, t in params_from_jax(jax.tree.map(np.asarray, jparams), model).items()}
    logits = model.forward_batched({n: t[None] for n, t in params.items()}, torch.from_numpy(tokens)[None])[0]
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, cfg["vocab"]), torch.from_numpy(labels).long().reshape(-1))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **LOGIT_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOGIT_TOL)
    grad = flatten_params({n: t.grad for n, t in params.items()})
    jflat = torch.from_numpy(flat_from_jax(np.asarray(jflatten(jgrad)[0]), model))
    gid = 2  # block1's group: the gradient crosses blocks 1-3 and the head
    np.testing.assert_allclose(_group_grad(model, grad, gid), _group_grad(model, jflat, gid), **MODEL_GRAD_TOL)


def test_vit_at_head_dim_128_matches_jax():
    cfg = dict(dim=256, num_heads=2, patch=2)
    jparams = JViT(**cfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=2)
    jvit = JViT(**cfg, attn_impl="flash")

    def jloss(p):
        logits = jvit.apply({"params": p}, jnp.asarray(images))
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(labels)[:, None], -1)), logits

    (jl, jlogits), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    model = ViT(**cfg, attn_impl="flash")
    params = {n: t.requires_grad_(True) for n, t in params_from_jax(jax.tree.map(np.asarray, jparams), model).items()}
    logits = model.forward_batched({n: t[None] for n, t in params.items()}, torch.from_numpy(images)[None])[0]
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **LOGIT_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOGIT_TOL)
    grad = flatten_params({n: t.grad for n, t in params.items()})
    jflat = torch.from_numpy(flat_from_jax(np.asarray(jflatten(jgrad)[0]), model))
    gid = 2  # block1's group
    np.testing.assert_allclose(_group_grad(model, grad, gid), _group_grad(model, jflat, gid), **MODEL_GRAD_TOL)
