"""Port parity: `ops/grouped_gemm.py` against the JAX package's grouped GEMM.

The port's `grouped_matmul` on CPU tensors takes its plain version
(`torch.bmm`); it is held against `grouped_matmul_pallas`, the TPU kernel,
which runs in interpret mode off the TPU as in the JAX package's own tests,
at its tail shapes (M, N not multiples of the 256 tiles, K odd). The
autograd gradients of both operands are held against `jax.grad` of the
einsum backend.

Two kinds of inputs, both drawn from a numpy seed:

* on a 1/8 grid in [-4, 4]: every product and partial sum is exact in f32,
  so any order of summation gives the same number, and the comparison at
  rtol 1e-6 / atol 1e-5 sees the indexing, the tails and the transposes;
* standard normal: f32 sums of up to 400 terms in two orders differ by
  more than that (readings, `PYTHONPATH=. python
  tests/test_torch_grouped_gemm.py`: the two sides up to 5.7e-5 apart, the
  JAX side up to 6.3e-5 from float64, the port up to 5.2e-5), so each side
  is held against float64 instead: the port within 1e-5 of the largest
  float64 entry (the kernel's tolerance on the card), or no further from
  float64 than twice the JAX side is (`chip_smoke.py`'s LARGE_SLACK rule
  for two f32 sums in other orders).

The kernel's split of long contractions (`split_k`) is a function of the
shapes alone and covers the contraction exactly.

On bf16 operands (the MoE under `compute_dtype="bfloat16"`) the port's
plain version sums the exact products in f32 and rounds once to bf16, as
the Pallas kernel does (f32 accumulation, the output in lhs's dtype). It is
held against `grouped_matmul_pallas` in interpret mode on the same bf16
operands within 2^-8 (one bf16 unit) of the largest entry: the two sum in
other orders, so an output may round to the neighbouring bf16 value. Its
autograd gradients, bf16 as JAX's, are held against `jax.vjp` of the
einsum backend on bf16 within two bf16 units of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.ops.grouped_gemm import grouped_matmul as j_grouped_matmul
from federated_pytorch_test_tpu.ops.grouped_gemm import grouped_matmul_pallas
from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

SHAPES = [(4, 160, 400, 120), (3, 13, 257, 9), (3, 300, 40, 270)]  # (G, M, K, N)
BF16_SHAPES = [(3, 13, 257, 9), (3, 300, 40, 270), (2, 64, 64, 256)]
BF16_UNIT = 2.0 ** -8
TOL = dict(rtol=1e-6, atol=1e-5)
SLACK = 2.0  # the port's distance from float64 may reach this multiple of the JAX side's
REL_FLOOR = 1e-5  # ... or this much of the largest float64 entry


def _operands(g, m, k, n, seed, grid):
    rng = np.random.default_rng(seed)
    draw = (lambda *s: np.round(rng.uniform(-4, 4, size=s) * 8) / 8) if grid else (lambda *s: rng.normal(size=s))
    return tuple(draw(*s).astype(np.float32) for s in ((g, m, k), (g, k, n), (g, m, n)))


def _no_further_from_f64(got, want, exact, label):
    err, ref_err = np.abs(got - exact).max(), np.abs(want - exact).max()
    assert err <= max(SLACK * ref_err, REL_FLOOR * np.abs(exact).max()), (label, err, ref_err)


def _jax_side(lhs, rhs, cot):
    out = grouped_matmul_pallas(jnp.asarray(lhs), jnp.asarray(rhs))
    grads = jax.grad(lambda a, b: jnp.sum(j_grouped_matmul(a, b) * cot), argnums=(0, 1))(
        jnp.asarray(lhs), jnp.asarray(rhs))
    return [np.asarray(t) for t in (out, *grads)]


def _port_side(lhs, rhs, cot):
    a, b = (torch.from_numpy(t).requires_grad_(True) for t in (lhs, rhs))
    out = gg.grouped_matmul(a, b)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(cot)).sum().backward()
    return [t.detach().numpy() for t in (out, a.grad, b.grad)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_and_gradients_match_jax_on_exact_inputs(shape):
    lhs, rhs, cot = _operands(*shape, seed=sum(shape), grid=True)
    for name, got, want in zip(("out", "dlhs", "drhs"), _port_side(lhs, rhs, cot), _jax_side(lhs, rhs, cot)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_and_gradients_match_jax_against_float64(shape):
    lhs, rhs, cot = _operands(*shape, seed=sum(shape) + 1, grid=False)
    l64, r64, c64 = (t.astype(np.float64) for t in (lhs, rhs, cot))
    exact = (l64 @ r64, c64 @ np.swapaxes(r64, 1, 2), np.swapaxes(l64, 1, 2) @ c64)
    for name, got, want, ex in zip(("out", "dlhs", "drhs"), _port_side(lhs, rhs, cot), _jax_side(lhs, rhs, cot),
                                   exact):
        _no_further_from_f64(got, want, ex, name)


def test_only_the_gradients_asked_for_are_computed(monkeypatch):
    calls = []
    for role in ("grouped_matmul_dlhs", "grouped_matmul_drhs"):
        fn = getattr(gg, role)
        monkeypatch.setattr(gg, role, lambda *a, _fn=fn, _role=role: calls.append(_role) or _fn(*a))
    lhs, rhs, _ = (torch.from_numpy(t) for t in _operands(2, 8, 5, 3, seed=0, grid=False))
    gg.grouped_matmul(lhs.requires_grad_(True), rhs).sum().backward()  # frozen weights: no dB
    assert calls == ["grouped_matmul_dlhs"] and rhs.grad is None
    calls.clear()
    gg.grouped_matmul(lhs.detach(), rhs.requires_grad_(True)).sum().backward()
    assert calls == ["grouped_matmul_drhs"]


def test_validation_raises_as_the_jax_kernel_does():
    with pytest.raises(ValueError, match="shapes"):
        grouped_matmul_pallas(jnp.zeros((2, 4, 3)), jnp.zeros((3, 3, 5)))
    with pytest.raises(ValueError, match="shapes"):
        gg.grouped_matmul(torch.zeros(2, 4, 3), torch.zeros(3, 3, 5))
    with pytest.raises(ValueError, match="shapes"):
        gg.grouped_matmul(torch.zeros(2, 4, 3), torch.zeros(2, 4, 5))
    with pytest.raises(ValueError, match="shapes"):
        gg.grouped_matmul(torch.zeros(4, 3), torch.zeros(3, 5))
    out = gg.grouped_matmul(torch.zeros(2, 4, 3, dtype=torch.bfloat16), torch.zeros(2, 3, 5, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 5)  # bf16 is taken, as the Pallas kernel takes it
    with pytest.raises(ValueError, match="float32"):
        gg.grouped_matmul(torch.zeros(2, 4, 3), torch.zeros(2, 3, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="bfloat16"):  # mixed dtypes
        gg.grouped_matmul(torch.zeros(2, 4, 3, dtype=torch.bfloat16), torch.zeros(2, 3, 5))
    with pytest.raises(ValueError, match="float32"):
        gg.grouped_matmul(torch.zeros(2, 4, 3, dtype=torch.float16), torch.zeros(2, 3, 5, dtype=torch.float16))


def test_cpu_calls_launch_no_kernel():
    gg.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        lhs, rhs, _ = (torch.from_numpy(t).to(dtype).requires_grad_(True)
                       for t in _operands(2, 8, 5, 3, seed=1, grid=False))
        gg.grouped_matmul(lhs, rhs).float().sum().backward()
        assert lhs.grad.dtype == rhs.grad.dtype == dtype
    assert all(n == 0 for n in gg.LAUNCHES.values()), gg.LAUNCHES
    assert set(gg.LAUNCHES) == {*gg.ROLES, *(f"{r}_bf16" for r in gg.ROLES)}


@pytest.mark.parametrize("g,m,n,k,splits", [
    (24, 20480, 256, 64, 1),  # the MoE ViT's forward: 3,840 tiles
    (24, 64, 256, 20480, 20),  # its weight gradients: 48 tiles over 20,480 slots
    (24, 256, 64, 20480, 20),
    (24, 64, 256, 20000, 20),  # an evaluation-sized contraction
    (3, 64, 64, 1024, 1),  # one chunk long: not split
    (1, 8, 8, 1_000_000, 977),  # a long contraction into one tile: chunks of SPLIT_CHUNK
])
def test_split_k_covers_the_contraction(g, m, n, k, splits):
    s, chunk = gg.split_k(g, m, n, k)
    assert s == splits and (s - 1) * chunk < k <= s * chunk
    assert s == 1 or chunk % gg.TK == 0


def test_split_sum_adds_the_chunks_in_order():
    part = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 2, 3, 4)).astype(np.float32))
    got = gg.grouped_sum(part)  # the CPU takes the plain version: ((p0 + p1) + p2) + ...
    want = (((part[0] + part[1]) + part[2]) + part[3]) + part[4]
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), part.double().sum(0).numpy(), rtol=1e-6, atol=1e-6)


def _bf16_operands(g, m, k, n, seed):
    """lhs, rhs, cotangent drawn in f32 from a numpy seed, rounded to bf16 once,
    as float32 numpy arrays holding bf16 values."""
    return tuple(torch.from_numpy(t).bfloat16().float().numpy() for t in _operands(g, m, k, n, seed, grid=False))


def _within_bf16_units(got, want, units, label):
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= units * BF16_UNIT * scale, (label, err / (BF16_UNIT * scale))


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_plain_matches_the_pallas_kernel(shape):
    lhs, rhs, _ = _bf16_operands(*shape, seed=sum(shape) + 2)
    want = grouped_matmul_pallas(jnp.asarray(lhs, jnp.bfloat16), jnp.asarray(rhs, jnp.bfloat16))
    got = gg.grouped_matmul(torch.from_numpy(lhs).bfloat16(), torch.from_numpy(rhs).bfloat16())
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _within_bf16_units(got.float().numpy(), np.asarray(want, np.float64), 1.0, "out")


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_gradients_match_jax_vjp(shape):
    lhs, rhs, cot = _bf16_operands(*shape, seed=sum(shape) + 3)
    j16 = [jnp.asarray(t, jnp.bfloat16) for t in (lhs, rhs, cot)]
    _, vjp = jax.vjp(lambda a, b: j_grouped_matmul(a, b, backend="einsum"), j16[0], j16[1])
    want = vjp(j16[2])
    a, b = (torch.from_numpy(t).bfloat16().requires_grad_(True) for t in (lhs, rhs))
    gg.grouped_matmul(a, b).backward(torch.from_numpy(cot).bfloat16())
    for name, got, w in zip(("dlhs", "drhs"), (a.grad, b.grad), want):
        assert got.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        _within_bf16_units(got.float().numpy(), np.asarray(w, np.float64), 2.0, name)


def test_bf16_split_sum_rounds_once():
    part = torch.from_numpy(np.random.default_rng(4).normal(size=(5, 2, 3, 4)).astype(np.float32))
    got = gg.grouped_sum(part, torch.empty(part.shape[1:], dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, gg.grouped_sum(part).to(torch.bfloat16))  # the f32 sum in split order, rounded once


def test_layout_reads_views_in_place():
    w = torch.zeros(6, 64, 256)
    for t, want in ((w, (0, 64 * 256, 256)), (w.transpose(1, 2), (1, 64 * 256, 256))):
        out, transposed, g_stride, ld = gg._layout(t)
        assert out is t and (transposed, g_stride, ld) == want
    strided = torch.zeros(6, 64, 512)[:, :, ::2]  # neither axis contiguous: copied
    out, transposed, g_stride, ld = gg._layout(strided)
    assert out.is_contiguous() and (transposed, g_stride, ld) == (0, 64 * 256, 256)


if __name__ == "__main__":
    # the readings behind the docstring: each side's distance from float64 on normal inputs
    for shape in SHAPES:
        lhs, rhs, cot = _operands(*shape, seed=sum(shape) + 1, grid=False)
        l64, r64, c64 = (t.astype(np.float64) for t in (lhs, rhs, cot))
        exact = (l64 @ r64, c64 @ np.swapaxes(r64, 1, 2), np.swapaxes(l64, 1, 2) @ c64)
        for name, got, want, ex in zip(("out", "dlhs", "drhs"), _port_side(lhs, rhs, cot),
                                       _jax_side(lhs, rhs, cot), exact):
            print(f"{shape} {name} port_vs_f64={np.abs(got - ex).max():.2e} jax_vs_f64={np.abs(want - ex).max():.2e} "
                  f"port_vs_jax={np.abs(got - want).max():.2e}")
