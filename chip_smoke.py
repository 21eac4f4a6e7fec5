#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`federated_pytorch_test_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--metrics-out PATH] [--lm-metrics-out PATH] [--vit-metrics-out PATH] [--profile]

Phases, each reported on its own lines; any failure exits non-zero:

1. card     — `nvidia-smi` name and power limit;
2. build    — nvcc builds the port's two CUDA sources, both at once;
3. kernels  — each compact-direction kernel against its plain PyTorch version
              on the card (K=3, m=10, N at every Net group size, one
              ResNet18-block-sized N, counts {0, 3, 10}, a zero-curvature
              slot and a NaN-filled invalid row), relative 1e-5 of the
              largest reference entry; times of the kernel, the plain
              version, one PyTorch library call computing the same function
              (a yardstick the port never calls) and the bound. Each
              time is taken twice: per call as the caller sees it, host
              launch path included (`ms`), and on the device alone with
              the calls queued behind a sleep kernel (`device_ms`);
4. flash    — the three causal flash-attention kernels against their plain
              versions (D in {16, 32, 64} x S in {128, 256, 1024, 2048} at
              BH=8, and the LM path's BH=128, S=2048, D=16): o and lse within
              relative 1e-5 of the largest reference entry, dq, dk, dv within
              1e-4; times at the path's shape beside the bound and
              `scaled_dot_product_attention` (forward; backward) as the
              yardstick;
5. flash rect — the three rectangular flash kernels against their plain
              versions: non-causal at D in {16, 32, 64} x S in {128, 256,
              1024} (BH=8) and the ViT path's BH=6144, S=256, D=16; causal
              with global offsets (q_off, k_off) in {(0,0), (128,0),
              (0,128) fully future, (0,64) unaligned} and one s_q != s_kv
              case; same tolerances, and rows that see no key exactly o = 0,
              lse = -1e30; `flash_block`'s autograd with non-zero o and lse
              cotangents against autograd through the plain forward; times at
              the ViT shape beside the bound and `scaled_dot_product_attention`;
6. parity   — a tiny drive with the plain ('compact') and the fused-kernel
              ('pallas') direction on the card: the first averaging round's
              losses and dual residual agree within relative 1e-3;
7. train    — the fedavg path: the fedavg preset (Net, K=3, batch 512) on the
              full-size synthetic CIFAR-10 stand-in (50,000/10,000, seed 0)
              with the fused-kernel direction, one outer loop over all five
              groups, nadmm=3. Launch counts are zeroed just before and read
              just after; every compact kernel must have launched, losses
              must be finite and every client's accuracy above chance;
8. lm parity — the LM's first round (K=4, S=256) step by step with
              'dense' attention (plain) and 'flash' (the kernels), both fed
              the same parameters and optimizer state before each step:
              losses, parameters and the round's dual residual agree within
              relative 1e-3 (over the whole round, L-BFGS amplifies 1e-6
              step differences past that in a fast-learning client);
9. lm train — the LM path (`federated_lm`, full width): K=4 TransformerLM
              clients (vocab 256, dim 64, 4 heads, 2048 positions) on
              sequences of 2048 tokens, batch 8, 4 minibatches, one outer
              loop over all six groups with flash attention. Flash launch
              counts are zeroed just before and read just after; every flash
              kernel must have launched, losses must be finite and every
              client's next-token accuracy above 5/vocab;
10. vit parity — the ViT's first round (patch 2: 256 tokens, batch 64)
              step by step with 'dense' attention (plain) and 'flash' (the
              rectangular kernels), fed the same parameters and optimizer
              state before each step: losses, parameters and the dual
              residual agree within relative 1e-3;
11. vit train — the ViT path: the fedavg preset with `model="vit"`,
              `model_kwargs={"patch": 2, "attn_impl": "flash"}` (dim 64, 4
              heads, 217,930 parameters per client, K=3, batch 512) and the
              fused-kernel direction, on a synthetic stand-in of 12,288 train
              images (8 minibatches of 512 per client) and 10,000 test
              images, one outer loop over all six groups, nadmm=1. Launch
              counts are zeroed just before and read just after; every
              rectangular flash kernel must have launched, losses must be
              finite and every client's accuracy above chance.

The second-to-last line is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`. Without CUDA, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
M, K = 10, 3
NET_GROUP_SIZES = (456, 2416, 48120, 10164, 850)
LARGE_N = 4_720_644  # ~ResNet18's largest block group; not a multiple of any tile
REPORT_N = 48120  # the main path's largest group (fc1): the shape the JSON line reports
RTOL = 1e-5
SOURCES = ("compact_direction", "flash_attention")  # csrc/<name>.cu
FLASH_DIMS = (16, 32, 64)
FLASH_SEQS = (128, 256, 1024, 2048)
FLASH_SWEEP_BH = 8
FLASH_PATH = (128, 2048, 16)  # (BH, S, D) of the LM path: K·batch·heads, sequence, head dim
FLASH_GRAD_RTOL = 1e-4
FLASH_REPLACES = {
    "flash_fwd": "federated_pytorch_test_tpu/ops/flash_attention.py:559",
    "flash_bwd_dq": "federated_pytorch_test_tpu/ops/flash_attention.py:655",
    "flash_bwd_dkv": "federated_pytorch_test_tpu/ops/flash_attention.py:673",
}
RECT_SEQS = (128, 256, 1024)
RECT_PATH = (6144, 256, 16)  # (BH, S, D) of the ViT path: K·batch·heads, tokens, head dim
# (s_q, s_kv, q_off, k_off) of the causal/offset checks, at BH=8
RECT_OFFSETS = ((256, 256, 0, 0), (256, 256, 128, 0), (128, 128, 0, 128), (256, 256, 0, 64), (128, 384, 256, 64))
RECT_REPLACES = {
    "flash_fwd_rect": "federated_pytorch_test_tpu/ops/flash_attention.py:601",
    "flash_bwd_dq_rect": "federated_pytorch_test_tpu/ops/flash_attention.py:721",
    "flash_bwd_dkv_rect": "federated_pytorch_test_tpu/ops/flash_attention.py:744",
}
VIT_KWARGS = {"patch": 2, "attn_impl": "flash"}
VIT_TRAIN, VIT_TEST = 12_288, 10_000  # 8 minibatches of 512 per client; the full test set
QUEUED_CALLS = 50  # calls queued per device-only timing (a plain version launches ~8 kernels)


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters: int) -> tuple:
    """Mean milliseconds per call over `iters` back-to-back calls, after
    warm-up, as (per call with the host's launch path, device alone).

    The first reading times the calls as issued: where the host issues
    slower than the card runs, it measures the host. For the second, a
    sleep kernel holds the stream while the host queues every call, so
    the events bracket the kernels alone; the sleep grows until it
    outlasts the queueing. At most `QUEUED_CALLS` calls are queued: the
    driver's launch queue holds about a thousand launches, and the host
    blocks once it is full."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    host_ms = start.elapsed_time(stop) / iters
    n_queued = min(iters, QUEUED_CALLS)
    cycles = 10_000_000
    while True:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n_queued):
            fn()
        stop.record()
        queued = not start.query()  # the card had not left the sleep yet
        torch.cuda.synchronize()
        if queued:
            return host_ms, start.elapsed_time(stop) / n_queued
        if cycles > 1 << 34:
            fail("time_ms: could not queue the calls ahead of the card")
        cycles *= 4


def rel_err(out, ref) -> float:
    scale = float(ref.abs().max())
    return float((out - ref).abs().max()) / (scale if scale > 0 else 1.0)


def history(n: int, seed: int):
    """Seeded [K, m, N] history like the optimizer's: y ≈ B s with B SPD,
    client 1 has a NaN-filled invalid row (5 >= count 3), client 2 a
    zero-curvature slot (4)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = 0.1 * torch.randn(K, M, n, device="cuda", generator=gen)
    d = 0.5 + 1.5 * torch.rand(K, 1, n, device="cuda", generator=gen)
    y = s * d + 0.01 * torch.randn(K, M, n, device="cuda", generator=gen)
    g = torch.randn(K, n, device="cuda", generator=gen)
    s[1, 5] = float("nan")
    y[1, 5] = float("nan")
    y[2, 4] = 0.0
    count = torch.tensor([0, 3, 10], dtype=torch.int32, device="cuda")
    h_diag = torch.tensor([1.0, 0.7, 1.3], device="cuda")
    return s, y, g, count, h_diag


def phase_kernels():
    """Each kernel against its plain version at every shape; timings."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.optim.compact import compact_direction, compact_solves, history_valid

    report = {}
    for n in (*NET_GROUP_SIZES, LARGE_N):
        s, y, g, count, h_diag = history(n, seed=n)
        gram = cc.fused_gram_projections(s, y, g, count)
        gram_ref = cc.fused_gram_projections_plain(s, y, g, count)
        errs = {f"gram.{nm}": rel_err(a, b) for nm, a, b in zip(("sy", "yy", "p", "q"), gram, gram_ref)}
        sy, yy, p, q = gram_ref
        u, w, _, _ = compact_solves(sy, p, q, history_valid(count, M), h_diag,
                                    lambda uu: (torch.matmul(yy, uu[..., None])[..., 0], None))
        asm = cc.fused_direction_assembly(s, y, g, w, u, h_diag, count)
        asm_ref = cc.fused_direction_assembly_plain(s, y, g, w, u, h_diag, count)
        errs["assembly"] = rel_err(asm, asm_ref)
        direction = cc.compact_direction_cuda(g, s, y, count, h_diag)
        errs["direction"] = rel_err(direction, compact_direction(g, s, y, count, h_diag))
        # for information: both sides against a float64 reference of the projections
        valid = history_valid(count, M)[..., None]
        s64 = torch.where(valid, s, 0.0).double()
        pq64 = (s64 * g.double()[:, None]).sum(-1)
        info = f"p_vs_f64 kernel={rel_err(gram[2].double(), pq64):.3e} plain={rel_err(gram_ref[2].double(), pq64):.3e}"
        del s64
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all()) for t in (*gram, asm, direction))
        worst = max(errs.values())
        print(f"kernels N={n} " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" finite={finite} {info}", flush=True)
        if not finite or not worst <= RTOL:
            fail(f"kernel disagrees with its plain version at N={n}: {errs} (finite={finite})")

        # timings with a full history (count = m for every client): the
        # steady state of the optimizer, and every row is read
        full = torch.full((K,), M, dtype=torch.int32, device="cuda")
        s.nan_to_num_(0.0)
        y.nan_to_num_(0.0)
        iters = 20 if n > 1_000_000 else 200
        x = torch.cat([s, y, g[:, None]], dim=1)  # [K, 2m+1, N] for the library calls
        coef = torch.cat([w, -h_diag[:, None] * u, h_diag[:, None]], dim=1)[:, None, :]  # [K, 1, 2m+1]
        gram_full = cc.fused_gram_projections(s, y, g, full)
        gram_full_ref = cc.fused_gram_projections_plain(s, y, g, full)
        asm_full = cc.fused_direction_assembly(s, y, g, w, u, h_diag, full)
        asm_full_ref = cc.fused_direction_assembly_plain(s, y, g, w, u, h_diag, full)
        calls = {
            "fused_gram_projections": (
                lambda: cc.fused_gram_projections(s, y, g, full),
                lambda: cc.fused_gram_projections_plain(s, y, g, full),
                lambda: torch.matmul(x, x.transpose(1, 2)),
            ),
            "fused_direction_assembly": (
                lambda: cc.fused_direction_assembly(s, y, g, w, u, h_diag, full),
                lambda: cc.fused_direction_assembly_plain(s, y, g, w, u, h_diag, full),
                lambda: torch.matmul(coef, x),
            ),
        }
        rows = {
            "fused_gram_projections": dict(
                bytes=(2 * M * n + n) * 4 * K,
                flops=2 * (2 * M * M + 2 * M) * n * K,
                max_abs_err=max(float((a - b).abs().max()) for a, b in zip(gram_full, gram_full_ref)),
            ),
            "fused_direction_assembly": dict(
                bytes=(2 * M * n + 2 * n) * 4 * K,
                flops=(4 * M + 3) * n * K,
                max_abs_err=float((asm_full - asm_full_ref).abs().max()),
            ),
        }
        for name, r in rows.items():
            for key, fn in zip(("ms", "plain_ms", "library_ms"), calls[name]):
                r[key], r[key.replace("ms", "device_ms")] = time_ms(fn, iters)
            t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = r["flops"] / F32_FLOPS * 1e3
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            print(
                f"timing {name} N={n} K={K} m={M} ms={r['ms']:.6f} device_ms={r['device_ms']:.6f} "
                f"plain_ms={r['plain_ms']:.6f} plain_device_ms={r['plain_device_ms']:.6f} "
                f"library_ms={r['library_ms']:.6f} library_device_ms={r['library_device_ms']:.6f} "
                f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']})",
                flush=True,
            )
            if n == REPORT_N:
                report[name] = r
    return report


def flash_inputs(bh: int, s: int, d: int, seed: int):
    """Seeded q, k, v, dO `[BH, S, D]` f32 on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, device="cuda", generator=gen) for _ in range(4)]


def flash_check(bh: int, s: int, d: int, seed: int) -> dict:
    """Each flash kernel against its plain version at one shape; the errors."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    q, k, v, do = flash_inputs(bh, s, d, seed)
    scale = 1.0 / d ** 0.5
    o, lse = fc.flash_fwd(q, k, v, scale)
    o_ref, lse_ref = fc.flash_fwd_plain(q, k, v, scale)
    delta = (do * o_ref).sum(-1)
    dq = fc.flash_bwd_dq(q, k, v, do, lse_ref, delta, scale)
    dk, dv = fc.flash_bwd_dkv(q, k, v, do, lse_ref, delta, scale)
    dq_ref = fc.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, scale)
    dk_ref, dv_ref = fc.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, scale)
    torch.cuda.synchronize()
    pairs = {"o": (o, o_ref), "lse": (lse, lse_ref), "dq": (dq, dq_ref), "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    errs = {name: rel_err(a, b) for name, (a, b) in pairs.items()}
    abs_errs = {name: float((a - b).abs().max()) for name, (a, b) in pairs.items()}
    finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs.values())
    print(f"flash BH={bh} S={s} D={d} " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" finite={finite}",
          flush=True)
    worst_fwd = max(errs["o"], errs["lse"])
    worst_bwd = max(errs["dq"], errs["dk"], errs["dv"])
    if not finite or not worst_fwd <= RTOL or not worst_bwd <= FLASH_GRAD_RTOL:
        fail(f"flash kernel disagrees with its plain version at BH={bh} S={s} D={d}: {errs} (finite={finite})")
    return abs_errs


def phase_flash():
    """The flash kernels against their plain versions at every shape; timings
    at the LM path's shape."""
    import torch
    import torch.nn.functional as F

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    for d in FLASH_DIMS:
        for s in FLASH_SEQS:
            flash_check(FLASH_SWEEP_BH, s, d, seed=s + d)
    bh, s, d = FLASH_PATH
    abs_errs = flash_check(bh, s, d, seed=1)

    q, k, v, do = flash_inputs(bh, s, d, seed=1)
    scale = 1.0 / d ** 0.5
    o, lse = fc.flash_fwd_plain(q, k, v, scale)
    delta = (do * o).sum(-1)
    # the yardstick: one PyTorch call computing the same function, [1, BH, S, D]
    q4, k4, v4 = (t.detach().view(1, bh, s, d).requires_grad_(True) for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(1, bh, s, d)

    def sdpa_bwd():
        torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    calls = {
        "flash_fwd": (
            lambda: fc.flash_fwd(q, k, v, scale),
            lambda: fc.flash_fwd_plain(q, k, v, scale),
            lambda: F.scaled_dot_product_attention(q4.detach(), k4.detach(), v4.detach(), is_causal=True),
        ),
        "flash_bwd_dq": (
            lambda: fc.flash_bwd_dq(q, k, v, do, lse, delta, scale),
            lambda: fc.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale),
            sdpa_bwd,
        ),
        "flash_bwd_dkv": (
            lambda: fc.flash_bwd_dkv(q, k, v, do, lse, delta, scale),
            lambda: fc.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale),
            sdpa_bwd,
        ),
    }
    pairs = bh * s * (s + 1) // 2  # (query, key) pairs under the causal mask
    operand = bh * s * d * 4  # bytes of one [BH, S, D] f32 tensor
    row = bh * s * 4  # bytes of one [BH, S] f32 tensor
    work = {  # (bytes: each input read once, each output written once; flops: 2·D per pair per product)
        "flash_fwd": (3 * operand + operand + row, 2 * 2 * d * pairs),
        "flash_bwd_dq": (4 * operand + 2 * row + operand, 3 * 2 * d * pairs),
        "flash_bwd_dkv": (4 * operand + 2 * row + 2 * operand, 4 * 2 * d * pairs),
    }
    abs_of = {"flash_fwd": max(abs_errs["o"], abs_errs["lse"]), "flash_bwd_dq": abs_errs["dq"],
              "flash_bwd_dkv": max(abs_errs["dk"], abs_errs["dv"])}
    # the whole causal attention, forward then backward, through autograd
    q3, k3, v3 = (t.detach().requires_grad_(True) for t in (q, k, v))

    def flash_fwd_bwd():
        torch.autograd.grad(fc._FlashCausal.apply(q3, k3, v3, scale), (q3, k3, v3), do)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), (q4, k4, v4), do4)

    return time_flash(f"BH={bh} S={s} D={d}", calls, work, abs_of, flash_fwd_bwd, sdpa_fwd_bwd)


def time_flash(label: str, calls: dict, work: dict, abs_of: dict, fwd_bwd, sdpa_fwd_bwd) -> dict:
    """Times of each flash kernel, its plain version and the library call,
    beside the bound from (bytes, flops); then the whole attention forward
    and backward through autograd against the library's."""
    both = [time_ms(fn, 20) for fn in (fwd_bwd, sdpa_fwd_bwd)]
    print(f"timing fwd+bwd {label} flash_ms={both[0][0]:.6f} flash_device_ms={both[0][1]:.6f} "
          f"library_ms={both[1][0]:.6f} library_device_ms={both[1][1]:.6f}", flush=True)

    report = {}
    for name, fns in calls.items():
        n_bytes, flops = work[name]
        r = {"bytes": n_bytes, "flops": flops, "max_abs_err": abs_of[name]}
        for key, fn in zip(("ms", "plain_ms", "library_ms"), fns):
            r[key], r[key.replace("ms", "device_ms")] = time_ms(fn, 20)
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(
            f"timing {name} {label} ms={r['ms']:.6f} device_ms={r['device_ms']:.6f} "
            f"plain_ms={r['plain_ms']:.6f} plain_device_ms={r['plain_device_ms']:.6f} "
            f"library_ms={r['library_ms']:.6f} library_device_ms={r['library_device_ms']:.6f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) gflop={flops / 1e9:.3f} "
            f"achieved_tflops={flops / r['device_ms'] / 1e9:.3f}",
            flush=True,
        )
        report[name] = r
    return report


def rect_inputs(bh: int, s_q: int, s_kv: int, d: int, seed: int):
    """Seeded q, k, v, dO f32 on the card: q and dO `[BH, Sq, D]`, k and v `[BH, Skv, D]`."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, n, d, device="cuda", generator=gen) for n in (s_q, s_kv, s_kv, s_q)]


def rect_check(bh: int, s_q: int, s_kv: int, d: int, causal: bool, q_off: int, k_off: int, seed: int) -> dict:
    """Each rectangular kernel against its plain version at one shape and
    offset; rows that see no key must be exact. Returns the absolute errors."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    q, k, v, do = rect_inputs(bh, s_q, s_kv, d, seed)
    scale = 1.0 / d ** 0.5
    args = (scale, causal, q_off, k_off)
    o, lse = fc.flash_fwd_rect(q, k, v, *args)
    o_ref, lse_ref = fc.flash_fwd_rect_plain(q, k, v, *args)
    delta = (do * o_ref).sum(-1)
    dq = fc.flash_bwd_dq_rect(q, k, v, do, lse_ref, delta, *args)
    dk, dv = fc.flash_bwd_dkv_rect(q, k, v, do, lse_ref, delta, *args)
    dq_ref = fc.flash_bwd_dq_rect_plain(q, k, v, do, lse_ref, delta, *args)
    dk_ref, dv_ref = fc.flash_bwd_dkv_rect_plain(q, k, v, do, lse_ref, delta, *args)
    torch.cuda.synchronize()
    live = fc._rect_keep(s_q, s_kv, q_off, k_off, q.device).any(-1) if causal else torch.ones(
        s_q, dtype=torch.bool, device=q.device)
    pairs = {"o": (o, o_ref), "lse": (lse[:, live], lse_ref[:, live]), "dq": (dq, dq_ref), "dk": (dk, dk_ref),
             "dv": (dv, dv_ref)}
    errs = {name: rel_err(a, b) if a.numel() else 0.0 for name, (a, b) in pairs.items()}
    abs_errs = {name: float((a - b).abs().max()) if a.numel() else 0.0 for name, (a, b) in pairs.items()}
    finite = all(bool(torch.isfinite(a).all()) for a in (o, lse, dq, dk, dv))
    dead = ~live
    exact = bool((o[:, dead] == 0).all() and (lse[:, dead] == -1e30).all() and (dq[:, dead] == 0).all())
    mode = f"causal q_off={q_off} k_off={k_off}" if causal else "non-causal"
    print(f"flash rect BH={bh} Sq={s_q} Skv={s_kv} D={d} {mode} dead_rows={int(dead.sum())} "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" finite={finite} dead_rows_exact={exact}",
          flush=True)
    worst_fwd = max(errs["o"], errs["lse"])
    worst_bwd = max(errs["dq"], errs["dk"], errs["dv"])
    if not finite or not exact or not worst_fwd <= RTOL or not worst_bwd <= FLASH_GRAD_RTOL:
        fail(f"rect flash kernel disagrees with its plain version at BH={bh} Sq={s_q} Skv={s_kv} D={d} {mode}: "
             f"{errs} (finite={finite}, dead rows exact={exact})")
    return abs_errs


def block_autograd_check(s_q: int, s_kv: int, causal: bool, q_off: int, k_off: int) -> None:
    """`flash_block`'s autograd (the kernels, dlse folded into delta) against
    autograd through the plain forward, with non-zero o and lse cotangents."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    b, h, d = 2, 4, 16
    gen = torch.Generator(device="cuda").manual_seed(s_q + s_kv + q_off + k_off)
    q = torch.randn(b, s_q, h, d, device="cuda", generator=gen)
    k, v = (torch.randn(b, s_kv, h, d, device="cuda", generator=gen) for _ in range(2))
    do = torch.randn(b, h, s_q, d, device="cuda", generator=gen)
    dlse = torch.randn(b, h, s_q, device="cuda", generator=gen)

    def plain_block(q, k, v):
        o, lse = fc.flash_fwd_rect_plain(fc._to3(q), fc._to3(k), fc._to3(v), 1.0 / d ** 0.5, causal, q_off, k_off)
        return o.reshape(b, h, s_q, d), lse.reshape(b, h, s_q)

    grads = []
    for fn in (lambda q, k, v: fc.flash_block(q, k, v, q_off, k_off, causal=causal), plain_block):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o, lse = fn(*leaves)
        grads.append(torch.autograd.grad((o * do).sum() + (lse * dlse).sum(), leaves))
    errs = {f"d{n}": rel_err(a, b) for n, a, b in zip("qkv", *grads)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads[0])
    mode = f"causal q_off={q_off} k_off={k_off}" if causal else "non-causal"
    print(f"flash_block autograd Sq={s_q} Skv={s_kv} {mode} " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" finite={finite}", flush=True)
    if not finite or not max(errs.values()) <= FLASH_GRAD_RTOL:
        fail(f"flash_block gradients disagree with plain autograd ({mode}): {errs}")


def phase_flash_rect():
    """The rectangular flash kernels against their plain versions, both modes;
    `flash_block`'s autograd; timings at the ViT path's shape."""
    import torch
    import torch.nn.functional as F

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    for d in FLASH_DIMS:
        for s in RECT_SEQS:
            rect_check(FLASH_SWEEP_BH, s, s, d, False, 0, 0, seed=3 * s + d)
        for s_q, s_kv, q_off, k_off in RECT_OFFSETS:
            rect_check(FLASH_SWEEP_BH, s_q, s_kv, d, True, q_off, k_off, seed=s_q + s_kv + q_off + k_off + d)
    for s_q, s_kv, causal, q_off, k_off in ((256, 256, False, 0, 0), (256, 256, True, 0, 64), (128, 384, True, 256, 64)):
        block_autograd_check(s_q, s_kv, causal, q_off, k_off)
    bh, s, d = RECT_PATH
    abs_errs = rect_check(bh, s, s, d, False, 0, 0, seed=2)

    q, k, v, do = rect_inputs(bh, s, s, d, seed=2)
    scale = 1.0 / d ** 0.5
    o, lse = fc.flash_fwd_rect_plain(q, k, v, scale)
    delta = (do * o).sum(-1)
    q4, k4, v4 = (t.detach().view(1, bh, s, d).requires_grad_(True) for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4)
    do4 = do.view(1, bh, s, d)

    def sdpa_bwd():
        torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    calls = {
        "flash_fwd_rect": (
            lambda: fc.flash_fwd_rect(q, k, v, scale),
            lambda: fc.flash_fwd_rect_plain(q, k, v, scale),
            lambda: F.scaled_dot_product_attention(q4.detach(), k4.detach(), v4.detach()),
        ),
        "flash_bwd_dq_rect": (
            lambda: fc.flash_bwd_dq_rect(q, k, v, do, lse, delta, scale),
            lambda: fc.flash_bwd_dq_rect_plain(q, k, v, do, lse, delta, scale),
            sdpa_bwd,
        ),
        "flash_bwd_dkv_rect": (
            lambda: fc.flash_bwd_dkv_rect(q, k, v, do, lse, delta, scale),
            lambda: fc.flash_bwd_dkv_rect_plain(q, k, v, do, lse, delta, scale),
            sdpa_bwd,
        ),
    }
    pairs = bh * s * s  # non-causal: every (query, key) pair
    operand = bh * s * d * 4
    row = bh * s * 4
    work = {
        "flash_fwd_rect": (3 * operand + operand + row, 2 * 2 * d * pairs),
        "flash_bwd_dq_rect": (4 * operand + 2 * row + operand, 3 * 2 * d * pairs),
        "flash_bwd_dkv_rect": (4 * operand + 2 * row + 2 * operand, 4 * 2 * d * pairs),
    }
    abs_of = {"flash_fwd_rect": max(abs_errs["o"], abs_errs["lse"]), "flash_bwd_dq_rect": abs_errs["dq"],
              "flash_bwd_dkv_rect": max(abs_errs["dk"], abs_errs["dv"])}
    q3, k3, v3 = (t.detach().requires_grad_(True) for t in (q, k, v))

    def flash_fwd_bwd():
        torch.autograd.grad(fc._FlashRect.apply(q3, k3, v3, scale, False, 0, 0)[0], (q3, k3, v3), do)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), do4)

    return time_flash(f"BH={bh} S={s} D={d} non-causal", calls, work, abs_of, flash_fwd_bwd, sdpa_fwd_bwd)


def phase_parity():
    """The tiny verify drive on the card with both direction backends."""
    import numpy as np

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset

    recs = {}
    for direction in ("compact", "pallas"):
        cfg = get_preset("fedavg", batch=40, nloop=1, nadmm=1, max_groups=1, lbfgs_direction=direction)
        recs[direction] = Trainer(cfg, verbose=False, source=synthetic_cifar(240, 60)).run()
    def values(rec, name):
        return [float(v) for r in rec.series[name] for v in np.atleast_1d(r["value"])]

    for name in ("train_loss", "dual_residual"):
        a, b = values(recs["pallas"], name), values(recs["compact"], name)
        worst = max(abs(x - z) / max(abs(z), 1e-30) for x, z in zip(a, b))
        print(f"parity {name} pallas-vs-compact max_rel={worst:.3e}", flush=True)
        if len(a) != len(b) or not worst <= 1e-3:
            fail(f"parity: {name} differs between direction backends ({worst:.3e})")


def phase_train(metrics_out, profile: bool):
    """The main path, through the entry points a user calls."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    cfg = get_preset("fedavg", nloop=1, lbfgs_direction="pallas")
    t0 = time.perf_counter()
    source = synthetic_cifar(50_000, 10_000, seed=0)
    tr = Trainer(cfg, verbose=False, source=source)
    print(f"train setup: {cfg.model} K={cfg.n_clients} batch={cfg.batch} nadmm={cfg.nadmm} "
          f"groups={tr.group_order} params={tr.n_params} steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} "
          f"setup_s={time.perf_counter() - t0:.3f}", flush=True)

    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cc.LAUNCHES)

    times = {}
    for r in rec.series["step_time"]:
        if "nadmm" in r:
            key = (r["group"], r["nadmm"])
            times[key] = times.get(key, 0.0) + r["value"]["seconds"]
    losses = {}
    for r in rec.series["train_loss"]:
        losses.setdefault((r["group"], r["nadmm"]), []).append(r["value"])
    duals = {(r["group"], r["nadmm"]): r["value"] for r in rec.series["dual_residual"]}
    accs = {(r["group"], r["nadmm"]): r["value"] for r in rec.series["test_accuracy"]}
    for key in duals:
        last = np.asarray(losses[key][-1])
        print(f"round group={key[0]} nadmm={key[1]} train_loss_last={','.join(f'{v:.6e}' for v in last)} "
              f"dual={duals[key]:.6e} acc={','.join(f'{a:.4f}' for a in accs[key])} wall_s={times[key]:.3f}",
              flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"non-finite training loss: {rec.first_nonfinite}")
    final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
    chance = 1.0 / tr.fed.num_classes
    if not np.all(final_acc > chance):
        fail(f"final accuracy {final_acc} not above chance {chance}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if profile:
        profile_epoch(tr)
    return launches, wall


def profile_epoch(tr):
    """Kernel time by name and the device's busy share over one Net epoch."""
    import torch

    from federated_pytorch_test_tpu_torch.engine.steps import round_init, run_epoch

    ctx = tr.ctx(tr.group_order[0])
    idx = tr.epoch_indices(99, ctx.gid, 0, 0)

    def epoch():
        lstate, _ = round_init(ctx, tr.flat)
        run_epoch(ctx, tr.flat.clone(), lstate, tr.shard_imgs, tr.shard_labels, idx, tr.mean, tr.std)
        torch.cuda.synchronize()

    profile_fn(f"group={ctx.gid}", epoch)


def profile_fn(label: str, epoch) -> None:
    """Kernel time by name and the device's busy share over one call of `epoch`."""
    import torch
    import warnings

    from torch.profiler import ProfilerActivity, profile as tprofile

    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")

    t0 = time.perf_counter()
    epoch()  # the same epoch without the profiler: the wall the busy time is read against
    wall_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch()
    prof_wall_us = (time.perf_counter() - t0) * 1e6
    def self_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device kernels only: an operator's event repeats its kernels' time
    events = [
        e for e in prof.key_averages()
        if self_us(e) > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(self_us(e) for e in events)
    print(f"profile {label} epoch wall_ms={wall_us / 1e3:.3f} profiled_wall_ms={prof_wall_us / 1e3:.3f} "
          f"device_busy_ms={busy_us / 1e3:.3f} idle_share={max(0.0, 1 - busy_us / wall_us):.4f}", flush=True)
    for e in sorted(events, key=lambda e: -self_us(e))[:12]:
        print(f"profile kernel={e.key[:70]!r} calls={e.count} self_device_ms={self_us(e) / 1e3:.3f}",
              flush=True)


def phase_lm_parity():
    """The LM's first round (K=4, S=256, group 0) step by step: before each
    L-BFGS step the 'dense' (plain) and the 'flash' (kernel) model get the
    same parameters and optimizer state, taken from the dense trajectory."""
    import torch

    from federated_pytorch_test_tpu_torch.consensus import FedAvgState, fedavg_round
    from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig, lm_train_step
    from federated_pytorch_test_tpu_torch.optim import lbfgs_init

    lms = {impl: FederatedLM(LMConfig(seq=256, max_groups=1, attn_impl=impl), verbose=False)
           for impl in ("dense", "flash")}
    dense = lms["dense"]
    gid = dense.group_order[0]
    ctxs = {impl: lm.ctx(gid) for impl, lm in lms.items()}
    flat = dense.flat.clone()
    state = lbfgs_init(dense.partition.extract(flat, gid).contiguous(), ctxs["dense"].lbfgs)
    worst = {"train_loss": 0.0, "params": 0.0, "dual_residual": 0.0}
    for s in range(dense.train.shape[1]):
        out = {impl: lm_train_step(ctx, flat.clone(), state, dense.train[:, s]) for impl, ctx in ctxs.items()}
        (fd, sd, ld), (ff, _, lf) = out["dense"], out["flash"]
        xd, xf = dense.partition.extract(fd, gid), dense.partition.extract(ff, gid)
        worst["train_loss"] = max(worst["train_loss"], float(((lf - ld).abs() / ld.abs()).max()))
        worst["params"] = max(worst["params"], float((xf - xd).abs().max() / xd.abs().max()))
        if s == dense.train.shape[1] - 1:  # the averaging round of each last step
            duals = [float(fedavg_round(x, FedAvgState(z=torch.zeros_like(x[0])))[1]["dual_residual"])
                     for x in (xd, xf)]
            worst["dual_residual"] = abs(duals[1] - duals[0]) / duals[0]
        flat, state = fd, sd
    print("lm parity flash-vs-dense per step " + " ".join(f"{k}_max_rel={v:.3e}" for k, v in worst.items()),
          flush=True)
    if not max(worst.values()) <= 1e-3:
        fail(f"lm parity: a step differs between dense and flash attention: {worst}")


def phase_lm_train(metrics_out, profile: bool):
    """The LM path at full width, through the entry point a user calls."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    cfg = LMConfig()
    t0 = time.perf_counter()
    lm = FederatedLM(cfg, verbose=True)
    print(f"lm setup: K={cfg.k} vocab={cfg.vocab} dim={cfg.dim} heads={cfg.num_heads} seq={cfg.seq} "
          f"batch={cfg.batch} minibatches/epoch={cfg.n_batch} attn={cfg.attn_impl} params={lm.partition.total} "
          f"groups={lm.group_order} setup_s={time.perf_counter() - t0:.3f}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = lm.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)

    for r in rec.series["step_time"]:
        if r["value"]["phase"] == "round":
            print(f"lm round group={r['group']} wall_s={r['value']['seconds']:.3f}", flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"lm train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"lm: non-finite training loss: {rec.first_nonfinite}")
    final_acc = np.asarray(rec.series["test_accuracy"][-1]["value"])
    floor = 5.0 / cfg.vocab
    print(f"lm final next-token accuracy {final_acc.round(4).tolist()} (floor {floor:.4f})", flush=True)
    if not np.all(final_acc > floor):
        fail(f"lm final accuracy {final_acc} not above {floor}")
    for name in fc.CAUSAL_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the LM path")
    if profile:
        profile_lm_epoch(lm)
    return launches, wall


def profile_lm_epoch(lm):
    """Kernel time by name and the device's busy share over one group-0 LM epoch."""
    import torch

    from federated_pytorch_test_tpu_torch.federated_lm import run_epoch
    from federated_pytorch_test_tpu_torch.optim import lbfgs_init

    ctx = lm.ctx(lm.group_order[0])

    def epoch():
        flat = lm.flat.clone()
        run_epoch(ctx, flat, lbfgs_init(lm.partition.extract(flat, ctx.gid).contiguous(), ctx.lbfgs), lm.train)
        torch.cuda.synchronize()

    profile_fn(f"lm group={ctx.gid}", epoch)


def phase_vit_parity():
    """The ViT's first round (group 0, batch 64) step by step: before each
    L-BFGS step the 'dense' (plain) and the 'flash' (kernel) model get the
    same parameters and optimizer state, taken from the dense trajectory."""
    import torch

    from federated_pytorch_test_tpu_torch.consensus import FedAvgState, fedavg_round
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step, epoch_batches, round_init

    source = synthetic_cifar(3 * 256, 100, seed=1)
    trs = {impl: Trainer(get_preset("fedavg", model="vit", model_kwargs={**VIT_KWARGS, "attn_impl": impl}, batch=64,
                                    nloop=1, nadmm=1, max_groups=1, lbfgs_direction="pallas"),
                         verbose=False, source=source)
           for impl in ("dense", "flash")}
    dense = trs["dense"]
    gid = dense.group_order[0]
    ctxs = {impl: tr.ctx(gid) for impl, tr in trs.items()}
    flat = dense.flat.clone()
    state, _ = round_init(ctxs["dense"], flat)
    idx = dense.epoch_indices(0, gid, 0, 0)
    worst = {"train_loss": 0.0, "params": 0.0, "dual_residual": 0.0}
    for s, (imgs, labels) in enumerate(epoch_batches(dense.shard_imgs, dense.shard_labels, idx)):
        out = {impl: client_train_step(ctx, flat.clone(), state, imgs, labels, dense.mean, dense.std)
               for impl, ctx in ctxs.items()}
        (fd, sd, ld), (ff, _, lf) = out["dense"], out["flash"]
        xd, xf = dense.partition.extract(fd, gid), dense.partition.extract(ff, gid)
        worst["train_loss"] = max(worst["train_loss"], float(((lf - ld).abs() / ld.abs()).max()))
        worst["params"] = max(worst["params"], float((xf - xd).abs().max() / xd.abs().max()))
        if s == idx.shape[0] - 1:  # the averaging round after each last step
            duals = [float(fedavg_round(x, FedAvgState(z=torch.zeros_like(x[0])))[1]["dual_residual"])
                     for x in (xd, xf)]
            worst["dual_residual"] = abs(duals[1] - duals[0]) / duals[0]
        flat, state = fd, sd
    print(f"vit parity flash-vs-dense per step ({idx.shape[0]} steps) "
          + " ".join(f"{k}_max_rel={v:.3e}" for k, v in worst.items()), flush=True)
    if not max(worst.values()) <= 1e-3:
        fail(f"vit parity: a step differs between dense and flash attention: {worst}")


def phase_vit_train(metrics_out, profile: bool):
    """The ViT path at full width, through the entry points a user calls."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_KWARGS, nloop=1, nadmm=1, lbfgs_direction="pallas")
    t0 = time.perf_counter()
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(VIT_TRAIN, VIT_TEST, seed=0))
    print(f"vit setup: K={cfg.n_clients} batch={cfg.batch} nadmm={cfg.nadmm} {cfg.model_kwargs} "
          f"tokens={tr.model.tokens} params={tr.n_params} groups={tr.group_order} "
          f"steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} setup_s={time.perf_counter() - t0:.3f}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    cc.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**dict(fc.LAUNCHES), **dict(cc.LAUNCHES)}

    for r in rec.series["step_time"]:
        if r["value"]["phase"] == "round":
            print(f"vit round group={r['group']} wall_s={r['value']['seconds']:.3f}", flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"vit train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"vit: non-finite training loss: {rec.first_nonfinite}")
    accs = [(r["group"], np.asarray(r["value"])) for r in rec.series["test_accuracy"]]
    print("vit accuracy per group " + " ".join(f"{g}:{','.join(f'{a:.4f}' for a in v)}" for g, v in accs), flush=True)
    chance = 1.0 / tr.fed.num_classes
    if not np.all(accs[-1][1] > chance):
        fail(f"vit final accuracy {accs[-1][1]} not above chance {chance}")
    for name in fc.RECT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the ViT path")
    if profile:
        profile_epoch(tr)
    return launches, wall


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--metrics-out", help="write the main path's metric series as JSON here")
    ap.add_argument("--lm-metrics-out", help="write the LM path's metric series as JSON here")
    ap.add_argument("--vit-metrics-out", help="write the ViT path's metric series as JSON here")
    ap.add_argument("--profile", action="store_true", help="also profile one epoch of each path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        import federated_pytorch_test_tpu_torch  # noqa: F401
        from federated_pytorch_test_tpu_torch.ops import build
        from federated_pytorch_test_tpu_torch.utils import configure_precision
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    configure_precision()
    t_all = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    def timed_build(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, all at once
        built = list(pool.map(timed_build, SOURCES))
    for lib, seconds in built:
        print(f"build {lib.name} seconds={seconds:.3f}", flush=True)

    report = phase_kernels()
    flash_report = phase_flash()
    rect_report = phase_flash_rect()
    phase_parity()
    launches, wall = phase_train(args.metrics_out, args.profile)
    phase_lm_parity()
    lm_launches, lm_wall = phase_lm_train(args.lm_metrics_out, args.profile)
    phase_vit_parity()
    vit_launches, vit_wall = phase_vit_train(args.vit_metrics_out, args.profile)

    kernels = []
    replaces = {
        "fused_gram_projections": "federated_pytorch_test_tpu/ops/compact_pallas.py:115",
        "fused_direction_assembly": "federated_pytorch_test_tpu/ops/compact_pallas.py:171",
    }
    for name in ("fused_gram_projections", "fused_direction_assembly"):
        r = report[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/compact_direction.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            # `ms`, `plain_ms` and `library_ms` are per call with the host's
            # launch path; the `device_*` times are the card's alone
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": f"K={K} m={M} N={REPORT_N}",
        })
    bh, s, d = FLASH_PATH
    for name, r in flash_report.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": lm_launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # scaled_dot_product_attention: its forward for flash_fwd; its
            # backward (dq, dk and dv in one call) for the two backward kernels
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": f"BH={bh} S={s} D={d} causal",
        })
    bh, s, d = RECT_PATH
    for name, r in rect_report.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/flash_attention.cu",
            "replaces": RECT_REPLACES[name],
            "launches": vit_launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # scaled_dot_product_attention without a mask: its forward for
            # flash_fwd_rect; its backward for the two backward kernels
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": f"BH={bh} S={s} D={d} non-causal",
        })
    print(f"total seconds={time.perf_counter() - t_all:.3f} train_wall_s={wall:.3f} lm_train_wall_s={lm_wall:.3f} "
          f"vit_train_wall_s={vit_wall:.3f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
