"""Port parity for the flash kernels at precision 'default' and on bf16 inputs.

On the CPU the wrappers take their plain versions, which repeat the
kernels' arithmetic: the one-pass ('default') versions round both operands
of every product to TF32 (`tf32_round`, the kernels' `tf32()` on the int32
view) and run the forward tile by tile as the kernel does; the bf16 trio
(`cast16`) rounds P and dS to bf16 before their products. Held here:

* the one-pass plain versions of all six kernels, through `flash_attention`
  (causal: the aligned trio; non-causal: the rectangular one) and
  `flash_block` (causal on offsets, with an lse cotangent), against the JAX
  package's kernels at precision='default' in interpret mode — which
  compute full f32 on the CPU — within rtol = atol = 2e-2, the JAX
  package's own 'default' contract (tests/test_flash.py:127-134);
* the one-pass plain versions against the port's plain 'highest' versions
  kernel by kernel, within 4e-3 of the largest entry: a TF32 operand keeps
  10 mantissa bits (unit roundoff 2^-11 ≈ 4.9e-4), and a product of two
  rounded operands summed over a softmax stays within a few units of that;
* the bf16 trio against `flash_attention(q16, k16, v16, causal=True,
  precision='default')` in interpret mode at S = 256, D = 16 (the JAX path
  with `fuse_l`): the output and the bf16 cotangents within
  rtol = atol = 1e-2 (two bf16 units at magnitude one), all in bf16 — the
  plain forward so at both key tiles the kernel has (64, 128) — and
  both packages within the JAX package's bounds from float64 dense
  attention (values rtol 0.06 / atol 0.03, gradients 0.08 of max(|ref|, 1);
  tests/test_flash.py:338-367);
* bf16 inputs at 'highest' (and non-causal bf16 at 'default') equal, in
  bits, the f32 path on the upcast inputs: the JAX package keeps f32
  probabilities there and its rectangular kernels have no `cast16` branch;
* the transformer's 'auto' crossover, mirrored from tests/test_flash.py:147-176.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.ops.flash_attention import flash_attention as j_flash
from federated_pytorch_test_tpu.ops.flash_attention import flash_block as j_block
from federated_pytorch_test_tpu_torch.models.transformer import (
    AUTO_FLASH_FROM,
    MultiHeadAttention,
    resolve_attn_impl,
    resolve_attn_precision,
)
from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
from federated_pytorch_test_tpu_torch.ops.attention import dense_attention

DEFAULT_TOL = 2e-2  # the JAX package's 'default' contract
TF32_CLASS = 4e-3  # one pass against 'highest', of the largest entry
BF16_TOL = 1e-2  # two bf16 units at magnitude one


def _qkv(s, d, seed, b=1, h=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4)]


def _port_grads(fn, q, k, v, do, dtype=torch.float32):
    leaves = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.tensor(do, dtype=out.dtype))
    return out.detach(), grads


def _jax_grads(fn, q, k, v, do, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(jnp.asarray(do, out.dtype))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32])
def test_one_pass_plain_versions_match_jax_default(causal, d):
    q, k, v, do = _qkv(256, d, seed=d + causal)
    out, grads = _port_grads(lambda *a: fc.flash_attention(*a, causal=causal, precision="default"), q, k, v, do)
    jout, jgrads = _jax_grads(lambda *a: j_flash(*a, causal=causal, precision="default"), q, k, v, do)
    readings = {"o": _rel(out, jout), **{f"d{n}": _rel(a, b) for n, a, b in zip("qkv", grads, jgrads)}}
    print(f"one pass vs JAX default (causal={causal}, D={d}): " + " ".join(f"{n}={r:.2e}" for n, r in readings.items()))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=DEFAULT_TOL, atol=DEFAULT_TOL)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=DEFAULT_TOL, atol=DEFAULT_TOL)


def test_one_pass_flash_block_matches_jax_default():
    # the rectangular kernels causal on offsets, with a cotangent on lse too
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 128, 2, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 256, 2, 16)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(1, 2, 128, 16)).astype(np.float32)
    dlse = rng.normal(size=(1, 2, 128)).astype(np.float32)

    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o, lse = fc.flash_block(*leaves, 192, 64, causal=True, precision="default")
    grads = torch.autograd.grad((o, lse), leaves, (torch.tensor(do), torch.tensor(dlse)))
    (jo, jlse), vjp = jax.vjp(lambda *a: j_block(*a, 192, 64, causal=True, precision="default"),
                              *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    for a, b in ((o, jo), (lse, jlse), *zip(grads, jgrads)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=DEFAULT_TOL, atol=DEFAULT_TOL)
    assert o.dtype == lse.dtype == torch.float32


@pytest.mark.parametrize("aligned", [True, False])
def test_one_pass_plain_versions_stay_in_the_tf32_class_of_highest(aligned):
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.tensor(rng.normal(size=(4, 256, 16)), dtype=torch.float32) for _ in range(4))
    scale = 0.25
    if aligned:
        one = (fc.flash_fwd_1pass_plain, fc.flash_bwd_dq_1pass_plain, fc.flash_bwd_dkv_1pass_plain)
        high = (fc.flash_fwd_plain, fc.flash_bwd_dq_plain, fc.flash_bwd_dkv_plain)
        mode_one, mode_high = (), ()
    else:  # the rectangular family, causal on offsets (rows 0..63 see no key)
        one = (fc.flash_fwd_1pass_plain, fc.flash_bwd_dq_1pass_plain, fc.flash_bwd_dkv_1pass_plain)
        high = (fc.flash_fwd_rect_plain, fc.flash_bwd_dq_rect_plain, fc.flash_bwd_dkv_rect_plain)
        mode_one = mode_high = (True, 0, 64)
    o1, lse1 = one[0](q, k, v, scale, *mode_one)
    oh, lseh = high[0](q, k, v, scale, *mode_high)
    delta = (do * oh).sum(-1)
    g1 = (one[1](q, k, v, do, lseh, delta, scale, *mode_one), *one[2](q, k, v, do, lseh, delta, scale, *mode_one))
    gh = (high[1](q, k, v, do, lseh, delta, scale, *mode_high), *high[2](q, k, v, do, lseh, delta, scale, *mode_high))
    live = lseh > -1e29
    readings = {"o": _rel(o1, oh), "lse": _rel(lse1[live], lseh[live]),
                **{n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), g1, gh)}}
    print(f"one pass vs highest (aligned={aligned}): " + " ".join(f"{n}={r:.2e}" for n, r in readings.items()))
    assert max(readings.values()) <= TF32_CLASS
    assert min(readings.values()) > 0  # the roundings are made
    if not aligned:
        assert torch.equal(lse1[~live], lseh[~live]) and bool((o1[~live] == 0).all())


def test_tf32_round_matches_the_kernels_rounding():
    # the kernels' tf32(): +0x1000 on the bits, then the low 13 bits cleared
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -11 - 2 ** -23, -3.0000002, 2 ** -130, 0.0], dtype=torch.float32)
    bits = x.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF
    want = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(fc.tf32_round(x).numpy(), want)
    assert fc.tf32_round(x)[1] == 1.0 + 2 ** -10 and fc.tf32_round(x)[2] == 1.0


def test_bf16_trio_matches_jax_cast16():
    q, k, v, do = _qkv(256, 16, seed=14)
    q16, k16, v16 = (x.astype(jnp.bfloat16) for x in (q, k, v))  # the same bf16 values in both

    def port(*a):
        return fc.flash_attention(*a, causal=True, precision="default")

    leaves = [torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_(True) for x in (q16, k16, v16)]
    out = port(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.tensor(do).to(torch.bfloat16))
    out = out.detach()
    jout, vjp = jax.vjp(lambda *a: j_flash(*a, causal=True, precision="default"), q16, k16, v16)
    jgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    assert out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    assert jout.dtype == jnp.bfloat16 and all(g.dtype == jnp.bfloat16 for g in jgrads)
    readings = {"o": _rel(out.float(), np.asarray(jout, np.float32)),
                **{f"d{n}": _rel(a.float(), np.asarray(b, np.float32)) for n, a, b in zip("qkv", grads, jgrads)}}
    print("bf16 trio vs JAX cast16: " + " ".join(f"{n}={r:.2e}" for n, r in readings.items()))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), rtol=BF16_TOL, atol=BF16_TOL)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=BF16_TOL, atol=BF16_TOL)
    # the plain forward at every key tile the kernel has (64, 128; BF16_FWD_KEYS picks one a head
    # dim): the tile sets how P rounds
    qs = fc.prescale_q(fc._to3(leaves[0].detach(), torch.bfloat16), 1.0 / 16 ** 0.5)
    k3, v3 = (fc._to3(x.detach(), torch.bfloat16) for x in leaves[1:])
    for keys in sorted({64, 128} | set(fc.BF16_FWD_KEYS.values())):
        o3, _ = fc.flash_fwd_bf16_plain(qs, k3, v3, keys=keys)
        o_keys = o3.reshape(1, 2, 256, 16).permute(0, 2, 1, 3).to(torch.bfloat16)
        np.testing.assert_allclose(o_keys.float().numpy(), np.asarray(jout, np.float32), rtol=BF16_TOL,
                                   atol=BF16_TOL)

    # both against float64 dense attention of the unrounded inputs, at the JAX package's bounds
    leaves64 = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v)]
    ref_t = dense_attention(*leaves64, causal=True)
    ref = ref_t.detach().numpy()
    ref_grads = [g.numpy() for g in torch.autograd.grad(ref_t, leaves64, torch.tensor(do, dtype=torch.float64))]
    for o_side, g_side in ((out.float().numpy(), [g.float().numpy() for g in grads]),
                           (np.asarray(jout, np.float32), [np.asarray(g, np.float32) for g in jgrads])):
        np.testing.assert_allclose(o_side, np.asarray(ref), rtol=0.06, atol=0.03)
        for a, b in zip(g_side, ref_grads):
            assert np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)) < 0.08


def test_bf16_at_highest_and_non_causal_take_the_f32_path_exactly():
    q, k, v, do = _qkv(256, 16, seed=21)
    q16, k16, v16 = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    for causal, precision in ((True, "highest"), (False, "default"), (False, "highest")):
        def run(dtype):
            leaves = [t.to(dtype).requires_grad_(True) for t in (q16, k16, v16)]
            out = fc.flash_attention(*leaves, causal=causal, precision=precision)
            grads = torch.autograd.grad(out, leaves, torch.tensor(do).to(torch.bfloat16).to(out.dtype))
            return out, grads

        out16, g16 = run(torch.bfloat16)
        out32, g32 = run(torch.float32)  # the cotangent rounded to bf16 first, as the bf16 output's is
        assert out16.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in g16)
        assert torch.equal(out16, out32.to(torch.bfloat16))
        for a, b in zip(g16, g32):
            assert torch.equal(a, b.to(torch.bfloat16))


def test_precision_names_are_checked():
    q, k, v, _ = (torch.tensor(x) for x in _qkv(128, 16, seed=1))
    with pytest.raises(ValueError, match="precision"):
        fc.flash_attention(q, k, v, precision="fast")
    with pytest.raises(ValueError, match="attn_precision"):
        resolve_attn_precision("fast")
    assert resolve_attn_precision(None) == "highest"
    assert set(fc.ONE_PASS.values()) | set(fc.BF16_KERNELS) <= set(fc.LAUNCHES)


def test_auto_attn_dispatch_follows_the_precision_dependent_crossover():
    # the JAX package's crossovers: flash from S=1024 at 'default', from 2048 at 'highest'
    assert AUTO_FLASH_FROM == {"default": 1024, "highest": 2048}
    table = {(256, "highest"): "dense", (1024, "highest"): "dense", (2048, "highest"): "flash",
             (256, "default"): "dense", (1024, "default"): "flash", (2048, "default"): "flash",
             (1100, "default"): "dense"}  # ragged lengths take dense, whatever their size
    for (s, prec), want in table.items():
        assert resolve_attn_impl("auto", s, prec) == want, (s, prec)

    rng = np.random.default_rng(12)

    def outs(s, prec):
        x = torch.tensor(rng.normal(size=(1, 1, s, 32)), dtype=torch.float32)
        mods = {name: MultiHeadAttention(32, 2, causal=True) for name in ("auto", "dense", "flash")}
        base = mods["dense"]
        params = {f"attn.{n}": p.detach()[None] for n, p in base.named_parameters()}
        with torch.no_grad():
            return {name: base.forward_batched(params, "attn", x,
                                               resolve_attn_impl(name, s, resolve_attn_precision(prec)) if name == "auto"
                                               else name, resolve_attn_precision(prec)) for name in mods}

    o = outs(256, None)  # short, 'highest': auto is dense
    assert torch.equal(o["auto"], o["dense"])
    o = outs(1024, "default")  # the 'default' crossover: flash
    assert torch.equal(o["auto"], o["flash"]) and not torch.equal(o["flash"], o["dense"])
    o = outs(1024, None)  # 'highest' at S=1024: dense
    assert torch.equal(o["auto"], o["dense"])
