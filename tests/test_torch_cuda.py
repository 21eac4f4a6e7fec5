"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where `torch.cuda.is_available()` is
false, since a CUDA kernel has no CPU mode. This file imports no JAX, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are `chip_smoke.py`'s: relative 1e-5 of the largest reference
entry for the flash forward, 1e-4 for its gradients (sums over up to S
keys in another order), the aligned backward also at the LM's S = 2048. With q, k x 8 (scores x 64) the f32 rounding of the
scores alone moves o by ~1e-5 of its largest entry, so there the forward is
held against the plain version in float64: within 1e-5 of it, or no further
from it than twice the plain version in f32 is; the rectangular backward
likewise, within 1e-4.
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
@pytest.mark.parametrize("s,d", [(128, 16), (256, 32), (384, 64), (256, 128)])
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
@pytest.mark.parametrize("d", [16, 64, 128])
def test_aligned_backward_at_the_lm_length_matches_plain(d):
    # the LM's S = 2048, where dq, dk and dv each sum 2048 keys or queries
    _card()
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.tensor(rng.normal(size=(4, 2048, d)).astype(np.float32), device="cuda") for _ in range(4))
    scale = 1.0 / d ** 0.5
    o, lse = flash_cuda.flash_fwd_plain(q, k, v, scale)
    got = flash_cuda.flash_bwd(q, k, v, o, lse, do, scale)
    for a, b in zip(got, flash_cuda.flash_bwd_plain(q, k, v, o, lse, do, scale)):
        assert bool(torch.isfinite(a).all()) and _rel(a, b) <= 1e-4


@pytest.mark.cuda
def test_aligned_backward_repeats_bitwise():
    _card()
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.tensor(rng.normal(size=(4, 2048, 16)).astype(np.float32), device="cuda") for _ in range(4))
    o, lse = flash_cuda.flash_fwd_plain(q, k, v, 0.25)
    delta = (do * o).sum(-1)
    first, second = ((flash_cuda.flash_bwd_dq(q, k, v, do, lse, delta, 0.25),
                      *flash_cuda.flash_bwd_dkv(q, k, v, do, lse, delta, 0.25)) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "s_q,s_kv,d,causal,q_off,k_off",
    [(256, 256, 16, False, 0, 0), (128, 384, 32, False, 0, 0), (256, 256, 64, True, 0, 64),
     (128, 128, 16, True, 0, 128), (128, 384, 32, True, 256, 64), (128, 256, 16, True, 37, 0),
     (256, 256, 128, False, 0, 0), (128, 384, 128, True, 256, 64), (256, 256, 128, True, 0, 64),
     (256, 256, 128, True, 0, 32)],  # the last: blocks of an odd count of the D-128 forward's 32-key tiles
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


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", [("flash_fwd", ()), ("flash_fwd_rect", (False, 0, 0)),
                                       ("flash_fwd_rect", (True, 64, 0))])
def test_forward_repeats_bitwise_and_holds_large_scores(name, mode):
    _card()
    rng = np.random.default_rng(11)
    q, k, v = (torch.tensor(rng.normal(size=(8, 512, 16)).astype(np.float32), device="cuda") for _ in range(3))
    kernel, plain = getattr(flash_cuda, name), getattr(flash_cuda, name + "_plain")
    first, second = kernel(q, k, v, 0.25, *mode), kernel(q, k, v, 0.25, *mode)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    q8, k8 = 8 * q, 8 * k
    got = kernel(q8, k8, v, 0.25, *mode)
    f32 = plain(q8, k8, v, 0.25, *mode)
    f64 = plain(q8.double(), k8.double(), v.double(), 0.25, *mode)
    for a, b, ref in zip(got, f32, f64):
        assert bool(torch.isfinite(a).all())
        assert _rel(a.double(), ref) <= max(1e-5, 2 * _rel(b.double(), ref))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(False, 0, 0), (True, 64, 0)])
def test_rect_backward_repeats_bitwise_and_holds_large_scores(mode):
    _card()
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.tensor(rng.normal(size=(8, 512, 16)).astype(np.float32), device="cuda") for _ in range(4))

    def grads(dq_fn, dkv_fn, q, k, v, do, lse, delta):
        return (dq_fn(q, k, v, do, lse, delta, 0.25, *mode), *dkv_fn(q, k, v, do, lse, delta, 0.25, *mode))

    def stats(q, k):
        o, lse = flash_cuda.flash_fwd_rect_plain(q, k, v, 0.25, *mode)
        return lse, (do * o).sum(-1)

    kernels = (flash_cuda.flash_bwd_dq_rect, flash_cuda.flash_bwd_dkv_rect)
    plains = (flash_cuda.flash_bwd_dq_rect_plain, flash_cuda.flash_bwd_dkv_rect_plain)
    first, second = (grads(*kernels, q, k, v, do, *stats(q, k)) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    q8, k8 = 8 * q, 8 * k
    lse, delta = stats(q8, k8)
    got = grads(*kernels, q8, k8, v, do, lse, delta)
    f32 = grads(*plains, q8, k8, v, do, lse, delta)
    f64 = grads(*plains, *(t.double() for t in (q8, k8, v, do, lse, delta)))
    for a, b, ref in zip(got, f32, f64):
        assert bool(torch.isfinite(a).all())
        assert _rel(a.double(), ref) <= max(1e-4, 2 * _rel(b.double(), ref))


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k,n", [(4, 160, 400, 120), (3, 13, 257, 9), (3, 300, 40, 270), (6, 8192, 64, 256)])
def test_grouped_matmul_roles_match_float64_and_repeat_bitwise(g, m, k, n):
    # every role of the grouped GEMM, its operand views as autograd passes
    # them; the last shape splits the weight gradient's contraction
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    _card()
    rng = np.random.default_rng(g + m + k + n)
    a, b, dc = (torch.tensor(rng.normal(size=s).astype(np.float32), device="cuda")
                for s in ((g, m, k), (g, k, n), (g, m, n)))
    cases = ((gg.grouped_matmul_fwd, (a, b), a.double() @ b.double()),
             (gg.grouped_matmul_dlhs, (dc, b), dc.double() @ b.double().transpose(1, 2)),
             (gg.grouped_matmul_drhs, (a, dc), a.double().transpose(1, 2) @ dc.double()))
    for fn, args, ref in cases:
        first, second = fn(*args), fn(*args)
        assert torch.equal(first.view(torch.int32), second.view(torch.int32))
        assert first.shape == ref.shape and _rel(first.double(), ref) <= 1e-5
    with pytest.raises(ValueError, match="float32"):
        gg.grouped_matmul(a.double(), b.double())


@pytest.mark.cuda
def test_grouped_matmul_autograd_takes_strided_and_transposed_operands():
    # a strided lhs (copied row-major) and an output the caller transposes:
    # the backward then gets a transposed dC beside the transposed Bᵀ and Aᵀ
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    _card()
    rng = np.random.default_rng(7)
    a_full, b, w = (torch.tensor(rng.normal(size=s).astype(np.float32), device="cuda")
                    for s in ((3, 96, 2 * 80), (3, 80, 72), (3, 72, 96)))
    a = a_full[:, :, ::2].requires_grad_(True)
    b.requires_grad_(True)
    (gg.grouped_matmul(a, b).transpose(1, 2) * w).sum().backward()
    a64, b64 = a.detach().double().requires_grad_(True), b.detach().double().requires_grad_(True)
    (torch.bmm(a64, b64).transpose(1, 2) * w.double()).sum().backward()
    assert _rel(a.grad.double(), a64.grad) <= 1e-5 and _rel(b.grad.double(), b64.grad) <= 1e-5


def _bf16_units(a, ref):
    """Distance of bf16 `a` from the float64 `ref` rounded to bf16, in bf16
    units (2^-8) of the largest entry (`chip_smoke.bf16_units`)."""
    r = ref.to(torch.bfloat16).double()
    return float((a.double() - r).abs().max()) / (2.0 ** -8 * max(float(r.abs().max()), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k,n", [(4, 160, 400, 120), (3, 13, 257, 9), (3, 300, 40, 270), (6, 8192, 64, 256)])
def test_grouped_matmul_bf16_roles_match_float64_and_repeat_bitwise(g, m, k, n):
    # the bf16 kernel (csrc/grouped_gemm_bf16.cu), every role on bf16
    # operands: within two bf16 units of the float64 product rounded to
    # bf16, two calls equal bits; the last shape splits the contraction
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    _card()
    rng = np.random.default_rng(g + m + k + n + 1)
    a, b, dc = (torch.tensor(rng.normal(size=s).astype(np.float32), device="cuda").bfloat16()
                for s in ((g, m, k), (g, k, n), (g, m, n)))
    cases = ((gg.grouped_matmul_fwd, (a, b), a.double() @ b.double()),
             (gg.grouped_matmul_dlhs, (dc, b), dc.double() @ b.double().transpose(1, 2)),
             (gg.grouped_matmul_drhs, (a, dc), a.double().transpose(1, 2) @ dc.double()))
    for fn, args, ref in cases:
        first, second = fn(*args), fn(*args)
        assert first.dtype == torch.bfloat16 and torch.equal(first.view(torch.int16), second.view(torch.int16))
        assert first.shape == ref.shape and _bf16_units(first, ref) <= 2.0


@pytest.mark.cuda
def test_grouped_matmul_bf16_autograd_takes_strided_and_transposed_operands():
    # as the f32 test below: the backward gets a transposed dC beside the
    # transposed Bᵀ and Aᵀ (one operand copied), all bf16
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    _card()
    rng = np.random.default_rng(8)
    a_full, b, w = (torch.tensor(rng.normal(size=s).astype(np.float32), device="cuda").bfloat16()
                    for s in ((3, 96, 2 * 80), (3, 80, 72), (3, 72, 96)))
    a = a_full[:, :, ::2].requires_grad_(True)
    b.requires_grad_(True)
    dout = w.transpose(1, 2)
    gg.grouped_matmul(a, b).transpose(1, 2).backward(w)
    a64, b64 = a.detach().double(), b.detach().double()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert _bf16_units(a.grad, dout.double() @ b64.transpose(1, 2)) <= 2.0
    assert _bf16_units(b.grad, a64.transpose(1, 2) @ dout.double()) <= 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_001, 70_003])
def test_gram_repeats_bitwise_and_matches_plain(n):
    # the one-launch gram at an N that is a multiple of neither 4 nor the
    # 256-column tile (scalar loads; a ragged last tile; at 70,003 several
    # tiles a block): two calls equal bits, and within 1e-5 of the plain
    # version, with an empty, a partial (NaN-filled invalid row) and a full
    # history
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    _card()
    rng = np.random.default_rng(n)
    s, y = (torch.tensor(rng.normal(size=(3, 10, n)).astype(np.float32), device="cuda") for _ in range(2))
    g = torch.tensor(rng.normal(size=(3, n)).astype(np.float32), device="cuda")
    s[1, 5] = float("nan")
    y[1, 5] = float("nan")
    count = torch.tensor([0, 3, 10], dtype=torch.int32, device="cuda")
    first, second = cc.fused_gram_projections(s, y, g, count), cc.fused_gram_projections(s, y, g, count)
    for a, b, ref in zip(first, second, cc.fused_gram_projections_plain(s, y, g, count)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert bool(torch.isfinite(a).all()) and _rel(a, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [850, 1_001, 5_130, 890_410, 890_408])
def test_assembly_repeats_bitwise_and_matches_plain(n):
    # the assembly at Net's fc group (850), an odd N, the ResNet fc group
    # (5,130) and Net1's whole vector (890,410), none a multiple of 4, so
    # no row is 16-byte aligned (the one-column-a-lane path), and at 890,408
    # (the 16-byte path): two calls equal bits, and within 1e-5 of the plain
    # version in float64, with an empty, a partial (NaN-filled invalid row)
    # and a full history
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    _card()
    rng = np.random.default_rng(n)
    s, y = (torch.tensor(rng.normal(size=(3, 10, n)).astype(np.float32), device="cuda") for _ in range(2))
    g = torch.tensor(rng.normal(size=(3, n)).astype(np.float32), device="cuda")
    w, u = (torch.tensor(rng.normal(size=(3, 10)).astype(np.float32), device="cuda") for _ in range(2))
    h_diag = torch.tensor([1.0, 0.7, 1.3], device="cuda")
    s[1, 5] = float("nan")
    y[1, 5] = float("nan")
    count = torch.tensor([0, 3, 10], dtype=torch.int32, device="cuda")
    first = cc.fused_direction_assembly(s, y, g, w, u, h_diag, count)
    second = cc.fused_direction_assembly(s, y, g, w, u, h_diag, count)
    ref = cc.fused_direction_assembly_plain(s.double(), y.double(), g.double(), w.double(), u.double(),
                                            h_diag.double(), count)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert bool(torch.isfinite(first).all()) and _rel(first.double(), ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("aligned,s_q,s_kv,d,causal,q_off,k_off", [
    (True, 1024, 1024, 16, True, 0, 0), (True, 256, 256, 64, True, 0, 0), (False, 256, 256, 16, False, 0, 0),
    (False, 256, 256, 32, True, 0, 64), (False, 128, 384, 64, True, 256, 64), (True, 512, 512, 128, True, 0, 0),
    (False, 256, 256, 128, False, 0, 0), (False, 128, 384, 128, True, 256, 64), (False, 256, 256, 128, True, 0, 32)])
def test_one_pass_kernels_match_plain(aligned, s_q, s_kv, d, causal, q_off, k_off):
    # 'default': one TF32 product a product. The plain versions round as the
    # kernels do but sum in another order, so a probability at a TF32
    # rounding boundary may round one unit apart: every output within 2^-10
    # of its largest entry (chip_smoke.py's ONE_PASS_RTOL), and the kernel
    # at least 4x closer in RMS to its plain version than to 'highest'
    _card()
    rng = np.random.default_rng(s_q + s_kv + d)
    q, do = (torch.tensor(rng.normal(size=(4, s_q, d)).astype(np.float32), device="cuda") for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(4, s_kv, d)).astype(np.float32), device="cuda") for _ in range(2))
    scale = 1.0 / d ** 0.5
    fc = flash_cuda
    if aligned:
        kern, high, mode = (fc.flash_fwd, fc.flash_bwd_dq, fc.flash_bwd_dkv), (
            fc.flash_fwd_plain, fc.flash_bwd_dq_plain, fc.flash_bwd_dkv_plain), ()
    else:
        kern, high, mode = (fc.flash_fwd_rect, fc.flash_bwd_dq_rect, fc.flash_bwd_dkv_rect), (
            fc.flash_fwd_rect_plain, fc.flash_bwd_dq_rect_plain, fc.flash_bwd_dkv_rect_plain), (causal, q_off, k_off)
    one_mode = (causal, q_off, k_off)
    o1, lse1 = fc.flash_fwd_1pass_plain(q, k, v, scale, *one_mode)
    delta = (do * o1).sum(-1)
    got = (*kern[0](q, k, v, scale, *mode, precision="default"),
           kern[1](q, k, v, do, lse1, delta, scale, *mode, precision="default"),
           *kern[2](q, k, v, do, lse1, delta, scale, *mode, precision="default"))
    one = (o1, lse1, fc.flash_bwd_dq_1pass_plain(q, k, v, do, lse1, delta, scale, *one_mode),
           *fc.flash_bwd_dkv_1pass_plain(q, k, v, do, lse1, delta, scale, *one_mode))
    hi = (*high[0](q, k, v, scale, *mode), high[1](q, k, v, do, lse1, delta, scale, *mode),
          *high[2](q, k, v, do, lse1, delta, scale, *mode))
    live = lse1 > -1e29
    for n, a, b, h in zip(("o", "lse", "dq", "dk", "dv"), got, one, hi):
        if n == "lse":
            a, b, h = a[live], b[live], h[live]
        assert bool(torch.isfinite(a).all()) and _rel(a, b) <= 2.0 ** -10, n
        if n != "lse":
            rms = [float((a - r).double().pow(2).mean().sqrt()) for r in (b, h)]
            assert rms[1] >= 4 * rms[0], (n, rms)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(256, 16), (1024, 32), (512, 64), (128, 16), (128, 64), (512, 128), (128, 128)])
def test_bf16_trio_matches_plain_and_repeats_bitwise(s, d):
    # the cast16 trio: o, lse and the bf16 cotangents within two bf16 units
    # (2^-8) of their largest entry (chip_smoke.py's BF16_UNITS); S = 128 is
    # the smallest grid, one block a head. Every S the kernels take (a
    # multiple of 128) is a multiple of each forward key tile (64 or 128).
    _card()
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.tensor(rng.normal(size=(4, s, d)), dtype=torch.bfloat16, device="cuda") for _ in range(3))
    do = torch.tensor(rng.normal(size=(4, s, d)).astype(np.float32), device="cuda")
    fc = flash_cuda
    qs = fc.prescale_q(q, 1.0 / d ** 0.5)
    o, lse = fc.flash_fwd_bf16(qs, k, v)
    o_ref, lse_ref = fc.flash_fwd_bf16_plain(qs, k, v)
    o2, lse2 = fc.flash_fwd_bf16(qs, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    delta, do16 = (do * o_ref).sum(-1), do.to(torch.bfloat16)
    runs = [(fc.flash_bwd_dq_bf16(qs, k, v, do16, lse_ref, delta, 1.0 / d ** 0.5),
             *fc.flash_bwd_dkv_bf16(qs, k, v, do16, lse_ref, delta)) for _ in range(2)]
    ref = (fc.flash_bwd_dq_bf16_plain(qs, k, v, do16, lse_ref, delta, 1.0 / d ** 0.5),
           *fc.flash_bwd_dkv_bf16_plain(qs, k, v, do16, lse_ref, delta))
    for a, b in ((o, o_ref), (lse, lse_ref), *zip(runs[0], ref)):
        assert bool(torch.isfinite(a.float()).all())
        assert float((a.float() - b.float()).abs().max()) <= 2 * 2.0 ** -8 * float(b.float().abs().max())
    assert all(t.dtype == torch.bfloat16 for t in runs[0])
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,dtype,kernels", [
    (80, True, torch.float32, flash_cuda.CAUSAL_KERNELS), (80, False, torch.float32, flash_cuda.RECT_KERNELS),
    (80, True, torch.bfloat16, flash_cuda.BF16_KERNELS), (24, True, torch.float32, flash_cuda.CAUSAL_KERNELS)])
def test_padded_head_dim_launches_the_next_instance(d, causal, dtype, kernels):
    # the public op zero-pads D up to the next instance (80 -> 128, 24 -> 32)
    # and slices the padding off: each kernel of its family launches once,
    # and the result is the same op on CPU tensors (the plain versions, fed
    # the same padding), within the family's tolerance
    _card()
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.tensor(rng.normal(size=(2, 256, 2, d)).astype(np.float32)) for _ in range(4))
    precision = "default" if dtype == torch.bfloat16 else "highest"
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev, dtype).requires_grad_(True) for t in (q, k, v)]
        flash_cuda.reset_launch_counts()
        o = flash_cuda.flash_attention(*leaves, causal=causal, precision=precision)
        grads = torch.autograd.grad(o, leaves, do.to(dev, o.dtype))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert {n: c for n, c in flash_cuda.LAUNCHES.items() if c} == {n: 1 for n in kernels}
        assert o.shape == q.shape and all(g.shape == q.shape for g in grads)
        outs.append([t.detach().float().cpu() for t in (o, *grads)])
    tol = (2 * 2.0 ** -8, 2 * 2.0 ** -8) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    for i, (a, b) in enumerate(zip(*outs)):
        assert _rel(a, b) <= tol[min(i, 1)], i
