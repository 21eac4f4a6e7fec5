#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`federated_pytorch_test_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--metrics-out PATH] [--lm-metrics-out PATH] [--vit-metrics-out PATH]
                          [--vit-moe-metrics-out PATH] [--profile]
    python3 chip_smoke.py --ab-parent DIR

The second form runs none of the phases below: it times the grouped GEMM
at every MoE ViT path shape, the gram at every Net group size and the
train paths, of the checkout in DIR (e.g. the parent commit, `git
archive`d) and of this one in turns, in fresh processes (`run_ab`).

Phases, each reported on its own lines; any failure exits non-zero:

1. card     — `nvidia-smi` name and power limit;
2. build    — nvcc builds the port's three CUDA sources, all at once; ptxas's
              registers and spills and the SASS tensor-core instruction
              counts of every tensor-core instance (the flash forward and
              backward, causal and not; the grouped GEMM's split-TF32
              instances), each of which must hold HGMMA and spill nothing;
3. kernels  — each compact-direction kernel against its plain PyTorch version
              on the card (K=3, m=10, N at every Net group size, one
              ResNet18-block-sized N, counts {0, 3, 10}, a zero-curvature
              slot and a NaN-filled invalid row), relative 1e-5 of the
              largest reference entry; times of the kernel, the plain
              version, one PyTorch library call computing the same function
              (a yardstick the port never calls) and the bound. Each
              time is taken twice: per call as the caller sees it, host
              launch path included (`ms`), and on the device alone with
              the calls queued behind a sleep kernel (`device_ms`). At the
              Net path's largest group the gram's kernels in one call are
              counted by the profiler (exactly one launch) and printed with
              its registers and its time beside its bound;
4. flash    — the three causal flash-attention kernels (the tensor-core
              kernels at Sq = Skv, shift 0) against their plain versions (D
              in {16, 32, 64} x S in {128, 256, 1024, 2048} at BH=8, the
              headroom S=4096 at BH=8 and every D, and the LM path's BH=128,
              S=2048, D=16): o and lse within relative 1e-5 of the largest
              reference entry, dq, dk, dv within 1e-4 (from S=2048 on, also
              printed against the plain version in float64); at the path's
              shape the forward and the dq, dk/dv pair twice on the same
              inputs (equal bits) and with q, k x 8 against the plain
              version in float64 (`fwd_extra_checks`, `bwd_extra_checks`);
              times at the path's shape beside two bounds (split TF32 on the
              tensor cores, exps, bytes; and the ceiling of an f32 FFMA
              design) and `scaled_dot_product_attention` (forward; backward)
              as the yardstick;
5. flash rect — the three rectangular flash kernels against their plain
              versions: non-causal at D in {16, 32, 64} x S in {128, 256,
              1024} (BH=8) and the ViT path's BH=6144, S=256, D=16; causal
              with global offsets (q_off, k_off) in {(0,0), (128,0),
              (0,128) fully future, (0,64) unaligned} and two s_q != s_kv
              cases (one at q_off 37, off the 64-key tile grid); same tolerances, and rows that see no key exactly o = 0,
              lse = -1e30; `flash_block`'s autograd with non-zero o and lse
              cotangents against autograd through the plain forward; the
              repeat and x8 checks of the forward, and of dq and dk/dv
              (`bwd_extra_checks`, within 1e-4 of float64 or twice the f32
              plain version's error), at the ViT shape, non-causal and
              causal; times at the ViT shape beside the bounds and
              `scaled_dot_product_attention`;
6. parity   — a tiny drive with the plain ('compact') and the fused-kernel
              ('pallas') direction on the card: the first averaging round's
              losses and dual residual agree within relative 1e-3;
7. train    — the fedavg path: the fedavg preset (Net, K=3, batch 512) on the
              full-size synthetic CIFAR-10 stand-in (50,000/10,000, seed 0)
              with the fused-kernel direction, one outer loop over all five
              groups, nadmm=3. Launch counts are zeroed just before and read
              just after; every compact kernel must have launched, exactly
              once per direction the optimizer's records count
              (`expected_launches`), losses must be finite and every
              client's accuracy above chance;
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
              kernel must have launched exactly as often as the run's
              records imply (`expected_launches`: the backward once per
              gradient pass in each layer behind the active group, the
              forward once per model pass in every layer), losses must be
              finite and every client's next-token accuracy above 5/vocab;
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
              rectangular flash kernel and compact kernel must have
              launched, exactly as often as the run's records imply, losses
              must be finite and every client's accuracy above chance;
12. grouped — the grouped GEMM (`ops/grouped_gemm.py`) at every shape of
              the MoE ViT path (K=3 clients x E=8 experts = 24 groups,
              20,480 slots an expert, D=64, H=256): both forwards, the
              evaluation forward (20,000 slots), both input gradients (B
              a transposed view) and both weight gradients (A a transposed
              view, the contraction over the slots split in 20): the kernel
              against its plain version in float64 within relative 1e-5 of
              the largest reference entry, two launches equal bits, the
              split sum equal to its plain version; every role likewise at
              the ragged shapes (G, M, K, N) = (3, 13, 257, 9) and (3, 300,
              40, 270); times of the kernel,
              the plain version and `torch.bmm` (TF32 off) beside the bound
              (the bytes, or three TF32 products) and the FFMA ceiling; the
              split sum's with the L2 cache flushed before every call, so
              that its bytes bound holds (each reading must not beat it);
13. vit_moe parity — the MoE ViT's block-0 round (its experts train; the
              gradient crosses every block) step by step at batch 128: the
              plain side ('dense' attention, the grouped GEMM's plain
              version) and the kernel side ('flash', the grouped kernel) fed
              the same parameters and optimizer state before each step:
              losses, parameters and the dual residual within relative 1e-3;
14. vit_moe train — the switch-MoE ViT path: phase 11's configuration with
              `moe_experts=8` (1,146,474 parameters per client,
              `moe_aux_coef` 0.01), one outer loop over all six groups,
              nadmm=1. Launch counts are zeroed just before and read just
              after; every grouped, rectangular flash and compact kernel
              must have launched exactly as often as the run's records imply
              (`expected_grouped`), losses must be finite and every
              client's accuracy above chance.

The second-to-last line is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`. Without CUDA, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate; split TF32 takes three products
EXPS_PER_S = 16 * 132 * 1.83e9  # exp2 on the SFUs: 16 a clock per SM, 132 SMs, 1.83 GHz boost
M, K = 10, 3
NET_GROUP_SIZES = (456, 2416, 48120, 10164, 850)
LARGE_N = 4_720_644  # ~ResNet18's largest block group; not a multiple of any tile
REPORT_N = 48120  # the main path's largest group (fc1): the shape the JSON line reports
RTOL = 1e-5
SOURCES = ("compact_direction", "flash_attention", "grouped_gemm")  # csrc/<name>.cu
FLASH_DIMS = (16, 32, 64)
FLASH_SEQS = (128, 256, 1024, 2048)
FLASH_SWEEP_BH = 8
FLASH_PATH = (128, 2048, 16)  # (BH, S, D) of the LM path: K·batch·heads, sequence, head dim
FLASH_HEADROOM_S = 4096  # a sequence beyond the LM's, at BH=8 and every D
FLASH_GRAD_RTOL = 1e-4
FLASH_REPLACES = {
    "flash_fwd": "federated_pytorch_test_tpu/ops/flash_attention.py:559",
    "flash_bwd_dq": "federated_pytorch_test_tpu/ops/flash_attention.py:655",
    "flash_bwd_dkv": "federated_pytorch_test_tpu/ops/flash_attention.py:673",
}
RECT_SEQS = (128, 256, 1024)
RECT_PATH = (6144, 256, 16)  # (BH, S, D) of the ViT path: K·batch·heads, tokens, head dim
# (s_q, s_kv, q_off, k_off) of the causal/offset checks, at BH=8
RECT_OFFSETS = ((256, 256, 0, 0), (256, 256, 128, 0), (128, 128, 0, 128), (256, 256, 0, 64), (128, 384, 256, 64),
                (128, 256, 37, 0))
RECT_REPLACES = {
    "flash_fwd_rect": "federated_pytorch_test_tpu/ops/flash_attention.py:601",
    "flash_bwd_dq_rect": "federated_pytorch_test_tpu/ops/flash_attention.py:721",
    "flash_bwd_dkv_rect": "federated_pytorch_test_tpu/ops/flash_attention.py:744",
}
VIT_KWARGS = {"patch": 2, "attn_impl": "flash"}
VIT_TRAIN, VIT_TEST = 12_288, 10_000  # 8 minibatches of 512 per client; the full test set
VIT_MOE_KWARGS = {**VIT_KWARGS, "moe_experts": 8}  # the JAX config's own example of E
GROUPED_REPLACES = "federated_pytorch_test_tpu/ops/grouped_gemm.py:74"
GROUPED_TAILS = ((3, 13, 257, 9), (3, 300, 40, 270))  # (G, M, K, N) from the card test's list
LARGE_SLACK = 2.0  # q, k x 8: the kernel's error from float64 may reach this multiple of the f32 plain version's
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


def time_cold_ms(fn, iters: int) -> tuple:
    """As `time_ms`, with the L2 cache flushed before every call, so that
    the call reads its inputs from device memory as a bytes bound assumes.
    The flush writes, then reads, 256 MB (five times the H100's 50 MB L2):
    the write evicts every other line, the read leaves clean lines whose
    eviction costs the call no write-back. The device reading queues each
    call behind a sleep kernel, as `time_ms` does."""
    import torch

    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    host = device = 0.0
    cycles = 10_000_000
    for _ in range(iters):
        flush.zero_()
        flush.sum()
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        host += start.elapsed_time(stop)
        while True:
            flush.zero_()
            flush.sum()
            torch.cuda._sleep(cycles)
            start.record()
            fn()
            stop.record()
            queued = not start.query()  # the card had not left the sleep yet
            torch.cuda.synchronize()
            if queued:
                break
            if cycles > 1 << 34:
                fail("time_cold_ms: could not queue the call ahead of the card")
            cycles *= 4
        device += start.elapsed_time(stop)
    return host / iters, device / iters


def rel_err(out, ref) -> float:
    scale = float(ref.abs().max())
    return float((out - ref).abs().max()) / (scale if scale > 0 else 1.0)


def ptxas_lines(lib):
    """(mangled entry function, line) of every ptxas register, spill or
    warning line in the build log beside `lib`."""
    fn = None
    for line in lib.with_suffix(".log").read_text(errors="replace").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif fn and ("Used" in line or "spill" in line or "warning" in line.lower()):
            yield fn, line.strip()


def spill_bytes(line: str) -> int:
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    return int(m.group(1)) + int(m.group(2)) if m else 0


def sass_functions(lib):
    """(mangled name, SASS) of every kernel in `lib`, from cuobjdump; None
    when the toolkit has no cuobjdump."""
    import shutil

    nvcc_dir = os.path.dirname(os.path.realpath(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"))
    tool = shutil.which("cuobjdump") or os.path.join(nvcc_dir, "cuobjdump")
    if not os.path.exists(tool):
        print("sass cuobjdump not found: tensor-core instructions not counted", flush=True)
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    return [(chunk.split("\n", 1)[0].strip(), chunk) for chunk in sass.split("Function : ")[1:]]


def report_tensor_core_build(lib, label, tc) -> None:
    """What the compiler made of the tensor-core instances in `lib` (those
    whose mangled name `tc` labels, else None): ptxas's registers, shared
    memory and spills, any warning, and the count of tensor-core
    instructions in each instance's SASS. Every instance must hold HGMMA
    and spill nothing."""
    seen = set()
    for fn, line in ptxas_lines(lib):
        name = tc(fn)
        if name is None and "warning" not in line.lower():
            continue
        print(f"ptxas {name or ''} {line}", flush=True)
        seen.add(name)
        if name and spill_bytes(line):
            fail(f"{name} spills: {line}")
    if not seen - {None}:
        fail(f"{label}: the build log has no ptxas report of its tensor-core instances")
    for fn, chunk in sass_functions(lib) or ():
        name = tc(fn)
        if name:
            print(f"sass {name} HGMMA={chunk.count('HGMMA')} HMMA={chunk.count('HMMA')} "
                  f"MUFU.EX2={chunk.count('MUFU.EX2')}", flush=True)
            if "HGMMA" not in chunk:
                fail(f"{name}: no HGMMA in its SASS")


TC_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")  # the tensor-core flash kernels


def flash_label(mangled: str):
    """`flash_bwd_dq_tc<16, true>` from a tensor-core flash instance's mangled name."""
    name = next((k for k in TC_KERNELS if k in mangled), None)
    if name is None:
        return None
    m = re.search(r"ILi(\d+)ELb([01])E", mangled)
    return f"{name}<{m.group(1)}, {'true' if m.group(2) == '1' else 'false'}>" if m else name


def grouped_label(mangled: str):
    """`grouped_gemm_tc<128, A, BT>` from a grouped GEMM instance's mangled
    name (A, B: the operand's contraction axis contiguous; AT, BT: not)."""
    m = re.search(r"grouped_gemm_tcILi(\d+)ELb([01])ELb([01])E", mangled)
    if not m:
        return None
    return f"grouped_gemm_tc<{m.group(1)}, {'A' if m.group(2) == '1' else 'AT'}, {'BT' if m.group(3) == '1' else 'B'}>"


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
        if n == REPORT_N:
            gram_one_launch(lambda: cc.fused_gram_projections(s, y, g, full), report["fused_gram_projections"])
    return report


def gram_one_launch(call, r: dict) -> None:
    """The gram's device kernels in one call, from the profiler: exactly one
    launch; beside it the kernel's registers (build log) and its device
    time against its bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from federated_pytorch_test_tpu_torch.ops import build

    call()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = Counter(e.name for e in prof.events() if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    regs = [line for fn, line in ptxas_lines(build.build("compact_direction")) if "gram_kernel" in fn and "Used" in line]
    print(f"gram launches_per_call={sum(kernels.values())} kernels={dict(kernels)} ptxas={regs} "
          f"device_ms={r['device_ms']:.6f} bound_ms={r['bound_ms']:.6f} share_of_bound={r['bound_ms'] / r['device_ms']:.3f}",
          flush=True)
    if sum(kernels.values()) != 1 or "gram_kernel" not in next(iter(kernels)):
        fail(f"fused_gram_projections: expected one gram_kernel launch a call, the profiler saw {dict(kernels)}")


def flash_inputs(bh: int, s: int, d: int, seed: int):
    """Seeded q, k, v, dO `[BH, S, D]` f32 on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, device="cuda", generator=gen) for _ in range(4)]


def flash_check(bh: int, s: int, d: int, seed: int, f64: bool = False, label: str = "flash") -> dict:
    """Each flash kernel against its plain version at one shape; the errors.
    With `f64`, the kernels' gradients and the f32 plain version's are also
    read against the plain version in float64 (printed, not gated)."""
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
    vs_f64 = ""
    if f64:
        args64 = [t.double() for t in (q, k, v, do, lse_ref, delta)]
        ref64 = (fc.flash_bwd_dq_plain(*args64, scale), *fc.flash_bwd_dkv_plain(*args64, scale))
        for side, i in (("kernel", 0), ("plain_f32", 1)):
            vs_f64 += f" {side}_vs_f64 " + " ".join(f"{n}={rel_err(pairs[n][i].double(), r):.3e}"
                                                     for n, r in zip(("dq", "dk", "dv"), ref64))
        del args64, ref64
    print(f"{label} BH={bh} S={s} D={d} " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + f" finite={finite}"
          + vs_f64, flush=True)
    worst_fwd = max(errs["o"], errs["lse"])
    worst_bwd = max(errs["dq"], errs["dk"], errs["dv"])
    if not finite or not worst_fwd <= RTOL or not worst_bwd <= FLASH_GRAD_RTOL:
        fail(f"flash kernel disagrees with its plain version at BH={bh} S={s} D={d}: {errs} (finite={finite})")
    return abs_errs


def fwd_extra_checks(label: str, kernel, plain, qkv, scale: float, *mode) -> None:
    """Two more checks of a forward kernel at a path shape: two launches give
    the same bits; and q, k x 8 (scores x 64), where f32 rounding of the
    scores alone moves o by ~1e-5 of its largest entry. There the kernel and
    the plain version in f32 are both held against the plain version in
    float64: the kernel within RTOL of it, or no further from it than
    LARGE_SLACK times the f32 plain version is."""
    import torch

    q, k, v = qkv
    runs = [kernel(q, k, v, scale, *mode) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(*runs))
    print(f"flash repeat {label} bitwise_equal={same}", flush=True)
    if not same:
        fail(f"{label}: two launches on the same inputs differ")

    q8, k8 = 8 * q, 8 * k
    o, lse = kernel(q8, k8, v, scale, *mode)
    o32, lse32 = plain(q8, k8, v, scale, *mode)
    o64, lse64 = plain(q8.double(), k8.double(), v.double(), scale, *mode)
    torch.cuda.synchronize()
    errs = {"o": rel_err(o.double(), o64), "lse": rel_err(lse.double(), lse64)}
    plain_errs = {"o": rel_err(o32.double(), o64), "lse": rel_err(lse32.double(), lse64)}
    vs_plain = {"o": rel_err(o, o32), "lse": rel_err(lse, lse32)}
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    print(f"flash large {label} x8 kernel_vs_f64 o={errs['o']:.3e} lse={errs['lse']:.3e} "
          f"plain_f32_vs_f64 o={plain_errs['o']:.3e} lse={plain_errs['lse']:.3e} "
          f"kernel_vs_plain_f32 o={vs_plain['o']:.3e} lse={vs_plain['lse']:.3e} finite={finite}", flush=True)
    for name in errs:
        if not finite or not errs[name] <= max(RTOL, LARGE_SLACK * plain_errs[name]):
            fail(f"{label} x8: {name} is {errs[name]:.3e} from float64 (the f32 plain version: "
                 f"{plain_errs[name]:.3e}; finite={finite})")


def bwd_extra_checks(label: str, inputs, scale: float, mode=(), aligned: bool = False) -> None:
    """`fwd_extra_checks`' two checks for a pair of backward kernels at a path
    shape, from the plain forward's lse and delta: the rectangular pair in
    `mode` (causal, q_off, k_off), or the aligned causal pair. Two launches
    give the same bits; and with q, k x 8, dq, dk and dv within
    FLASH_GRAD_RTOL of the plain version in float64, or no further from it
    than LARGE_SLACK times the f32 plain version is."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    q, k, v, do = inputs
    if aligned:
        kernels = (fc.flash_bwd_dq, fc.flash_bwd_dkv)
        plains = (fc.flash_bwd_dq_plain, fc.flash_bwd_dkv_plain)
        fwd_plain = fc.flash_fwd_plain
    else:
        kernels = (fc.flash_bwd_dq_rect, fc.flash_bwd_dkv_rect)
        plains = (fc.flash_bwd_dq_rect_plain, fc.flash_bwd_dkv_rect_plain)
        fwd_plain = fc.flash_fwd_rect_plain

    def grads(fns, q, k, v, do, lse, delta):
        return (fns[0](q, k, v, do, lse, delta, scale, *mode), *fns[1](q, k, v, do, lse, delta, scale, *mode))

    def stats(q, k):
        o, lse = fwd_plain(q, k, v, scale, *mode)
        return lse, (do * o).sum(-1)

    lse, delta = stats(q, k)
    runs = [grads(kernels, q, k, v, do, lse, delta) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(*runs))
    print(f"flash repeat {label} bitwise_equal={same}", flush=True)
    if not same:
        fail(f"{label}: two launches on the same inputs differ")
    del runs

    q8, k8 = 8 * q, 8 * k
    lse, delta = stats(q8, k8)
    got = grads(kernels, q8, k8, v, do, lse, delta)
    f32 = grads(plains, q8, k8, v, do, lse, delta)
    f64 = grads(plains, *(t.double() for t in (q8, k8, v, do, lse, delta)))
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    errs = {n: rel_err(a.double(), ref) for n, a, ref in zip(names, got, f64)}
    plain_errs = {n: rel_err(b.double(), ref) for n, b, ref in zip(names, f32, f64)}
    vs_plain = {n: rel_err(a, b) for n, a, b in zip(names, got, f32)}
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    print(f"flash large {label} x8 kernel_vs_f64 " + " ".join(f"{n}={errs[n]:.3e}" for n in names)
          + " plain_f32_vs_f64 " + " ".join(f"{n}={plain_errs[n]:.3e}" for n in names)
          + " kernel_vs_plain_f32 " + " ".join(f"{n}={vs_plain[n]:.3e}" for n in names) + f" finite={finite}",
          flush=True)
    for n in names:
        if not finite or not errs[n] <= max(FLASH_GRAD_RTOL, LARGE_SLACK * plain_errs[n]):
            fail(f"{label} x8: {n} is {errs[n]:.3e} from float64 (the f32 plain version: "
                 f"{plain_errs[n]:.3e}; finite={finite})")


def phase_flash():
    """The flash kernels against their plain versions at every shape; timings
    at the LM path's shape."""
    import torch
    import torch.nn.functional as F

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    for d in FLASH_DIMS:
        for s in FLASH_SEQS:
            flash_check(FLASH_SWEEP_BH, s, d, seed=s + d, f64=s >= FLASH_PATH[1])
    for d in FLASH_DIMS:  # twice the LM's sequence: the gradients sum over twice the tiles
        flash_check(FLASH_SWEEP_BH, FLASH_HEADROOM_S, d, seed=FLASH_HEADROOM_S + d, f64=True, label="flash headroom")
    bh, s, d = FLASH_PATH
    abs_errs = flash_check(bh, s, d, seed=1, f64=True)
    fwd_extra_checks("flash_fwd", fc.flash_fwd, fc.flash_fwd_plain, flash_inputs(bh, s, d, seed=5)[:3], 1.0 / d ** 0.5)
    bwd_extra_checks("flash_bwd", flash_inputs(bh, s, d, seed=7), 1.0 / d ** 0.5, aligned=True)

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
    work = {  # (bytes: each input read once, each output written once; flops: 2·D per pair per product; exps)
        "flash_fwd": (3 * operand + operand + row, 2 * 2 * d * pairs, pairs),
        "flash_bwd_dq": (4 * operand + 2 * row + operand, 3 * 2 * d * pairs, pairs),
        "flash_bwd_dkv": (4 * operand + 2 * row + 2 * operand, 4 * 2 * d * pairs, pairs),
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
        n_bytes, flops, exps = work[name]
        r = {"bytes": n_bytes, "flops": flops, "exps": exps, "max_abs_err": abs_of[name]}
        for key, fn in zip(("ms", "plain_ms", "library_ms"), fns):
            r[key], r[key.replace("ms", "device_ms")] = time_ms(fn, 20)
        r.update(flash_bounds(n_bytes, flops, exps))
        print(
            f"timing {name} {label} ms={r['ms']:.6f} device_ms={r['device_ms']:.6f} "
            f"plain_ms={r['plain_ms']:.6f} plain_device_ms={r['plain_device_ms']:.6f} "
            f"library_ms={r['library_ms']:.6f} library_device_ms={r['library_device_ms']:.6f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}: {r['bound_term']}) "
            f"ffma_bound_ms={r['ffma_bound_ms']:.6f} gflop={flops / 1e9:.3f} "
            f"achieved_tflops={flops / r['device_ms'] / 1e9:.3f} share_of_bound={r['bound_ms'] / r['device_ms']:.3f}",
            flush=True,
        )
        report[name] = r
    return report


def flash_bounds(n_bytes: int, flops: int, exps: int) -> dict:
    """The least time of a flash kernel on the card: the largest of its
    bytes at the memory rate, its products in split TF32 (three passes) at
    the tensor-core rate, and its exps at the SFU rate; and, beside it, the
    ceiling of an f32 FFMA design (flops at 67 TFLOP/s or the bytes)."""
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, "tf32x3": 3 * flops / TF32_FLOPS * 1e3,
             "exp": exps / EXPS_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "ffma_bound_ms": max(terms["bytes"], flops / F32_FLOPS * 1e3)}


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
    inputs = rect_inputs(bh, s, s, d, seed=6)
    qkv = inputs[:3]
    fwd_extra_checks("flash_fwd_rect", fc.flash_fwd_rect, fc.flash_fwd_rect_plain, qkv, 1.0 / d ** 0.5)
    fwd_extra_checks("flash_fwd_rect causal q_off=64 k_off=0", fc.flash_fwd_rect, fc.flash_fwd_rect_plain, qkv,
                     1.0 / d ** 0.5, True, 64, 0)
    bwd_extra_checks("flash_bwd_rect", inputs, 1.0 / d ** 0.5)
    bwd_extra_checks("flash_bwd_rect causal q_off=64 k_off=0", inputs, 1.0 / d ** 0.5, (True, 64, 0))
    del inputs, qkv

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
        "flash_fwd_rect": (3 * operand + operand + row, 2 * 2 * d * pairs, pairs),
        "flash_bwd_dq_rect": (4 * operand + 2 * row + operand, 3 * 2 * d * pairs, pairs),
        "flash_bwd_dkv_rect": (4 * operand + 2 * row + 2 * operand, 4 * 2 * d * pairs, pairs),
    }
    abs_of = {"flash_fwd_rect": max(abs_errs["o"], abs_errs["lse"]), "flash_bwd_dq_rect": abs_errs["dq"],
              "flash_bwd_dkv_rect": max(abs_errs["dk"], abs_errs["dv"])}
    q3, k3, v3 = (t.detach().requires_grad_(True) for t in (q, k, v))

    def flash_fwd_bwd():
        torch.autograd.grad(fc._FlashRect.apply(q3, k3, v3, scale, False, 0, 0)[0], (q3, k3, v3), do)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), do4)

    return time_flash(f"BH={bh} S={s} D={d} non-causal", calls, work, abs_of, flash_fwd_bwd, sdpa_fwd_bwd)


def moe_shapes(cfg):
    """(G, C at the train batch, C at the eval batch, D, H) of the MoE ViT path's grouped GEMMs."""
    from federated_pytorch_test_tpu_torch.models import ViT

    model = ViT(**cfg.model_kwargs)
    moe = model.block0.moe
    g = cfg.n_clients * moe.n_experts
    return g, moe.capacity(cfg.batch * model.tokens), moe.capacity(cfg.eval_batch * model.tokens), model.dim, moe.hidden


def grouped_cases(cfg):
    """(label, role, operand shapes, operand transposed?) of every grouped GEMM
    call on the MoE ViT path: the forward of fc1 and fc2 (training and
    evaluation batches), their input gradients dA = dC·Bᵀ and their weight
    gradients dB = Aᵀ·dC, each operand as the autograd function passes it."""
    g, c, c_eval, d, h = moe_shapes(cfg)
    return (
        ("fwd fc1", "grouped_matmul", ((g, c, d), (g, d, h))),
        ("fwd fc2", "grouped_matmul", ((g, c, h), (g, h, d))),
        ("eval fc1", "grouped_matmul", ((g, c_eval, d), (g, d, h))),
        ("dlhs fc2", "grouped_matmul_dlhs", ((g, c, d), (g, h, d))),
        ("dlhs fc1", "grouped_matmul_dlhs", ((g, c, h), (g, d, h))),
        ("drhs fc1", "grouped_matmul_drhs", ((g, c, d), (g, c, h))),
        ("drhs fc2", "grouped_matmul_drhs", ((g, c, h), (g, c, d))),
    )


def grouped_role(role):
    """(kernel wrapper, plain version, one library call) of a grouped role, each
    taking the role's two operands; the contraction's (lhs, rhs) views."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    views = {
        "grouped_matmul": lambda a, b: (a, b),
        "grouped_matmul_dlhs": lambda dc, w: (dc, w.transpose(1, 2)),
        "grouped_matmul_drhs": lambda x, dc: (x.transpose(1, 2), dc),
    }[role]
    kernel = {"grouped_matmul": gg.grouped_matmul_fwd, "grouped_matmul_dlhs": gg.grouped_matmul_dlhs,
              "grouped_matmul_drhs": gg.grouped_matmul_drhs}[role]
    return kernel, (lambda a, b: gg.grouped_matmul_plain(*views(a, b))), (lambda a, b: torch.bmm(*views(a, b))), views


def phase_grouped():
    """The grouped GEMM at every shape of the MoE ViT path: the kernel against
    its plain version in float64 (relative 1e-5 of the largest reference
    entry), two launches equal bits, the split contraction's sum kernel
    against its plain version; times of the kernel, the plain version and
    `torch.bmm` (TF32 off) beside the bound."""
    import torch

    from federated_pytorch_test_tpu_torch.engine import get_preset
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_MOE_KWARGS)
    assert not torch.backends.cuda.matmul.allow_tf32
    report = {}
    for i, (label, role, shapes) in enumerate(grouped_cases(cfg)):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        a, b = (torch.randn(*sh, device="cuda", generator=gen) for sh in shapes)
        kernel, plain, library, views = grouped_role(role)
        lhs, rhs = views(a, b)
        (g, m, k), n = lhs.shape, rhs.shape[2]
        runs = [kernel(a, b) for _ in range(2)]
        ref64 = plain(a.double(), b.double())
        ref32 = plain(a, b)
        torch.cuda.synchronize()
        same = torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))
        err, err32 = rel_err(runs[0].double(), ref64), rel_err(ref32.double(), ref64)
        splits, chunk = gg.split_k(g, m, n, k)
        finite = bool(torch.isfinite(runs[0]).all())
        print(f"grouped {label} [{g},{m},{k}]x[{g},{k},{n}] lhs_t={int(lhs.stride(1) == 1)} "
              f"rhs_t={int(rhs.stride(1) == 1)} splits={splits} kernel_vs_f64={err:.3e} plain_f32_vs_f64={err32:.3e} "
              f"bitwise_equal={same} finite={finite}", flush=True)
        if not finite or not same or not err <= RTOL:
            fail(f"grouped {label}: kernel vs float64 {err:.3e} (bitwise equal {same}, finite {finite})")
        r = {"max_abs_err": float((runs[0] - ref32).abs().max()), "shape": f"[{g},{m},{k}]x[{g},{k},{n}]",
             "splits": splits}
        del runs, ref64, ref32
        for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
            r[key], r[key.replace("ms", "device_ms")] = time_ms(lambda: fn(a, b), 20)
        flops = 2 * g * m * k * n
        r.update(flash_bounds((g * m * k + g * k * n + g * m * n) * 4, flops, 0))
        print(f"timing {role} {label} ms={r['ms']:.6f} device_ms={r['device_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"plain_device_ms={r['plain_device_ms']:.6f} library_ms={r['library_ms']:.6f} "
              f"library_device_ms={r['library_device_ms']:.6f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}: "
              f"{r['bound_term']}) ffma_bound_ms={r['ffma_bound_ms']:.6f} gflop={flops / 1e9:.3f} "
              f"achieved_tflops={flops / r['device_ms'] / 1e9:.3f} share_of_bound={r['bound_ms'] / r['device_ms']:.3f}",
              flush=True)
        report.setdefault(role, r)  # the JSON line reports each role at its first (fc1 or fc2 training) shape
        if role == "grouped_matmul_drhs" and "grouped_matmul_sum" not in report and splits > 1:
            report["grouped_matmul_sum"] = sum_check(g, m, n, splits, seed=200 + i)
        del a, b
    for shape in GROUPED_TAILS:
        grouped_tail_check(*shape)
    return report


def grouped_tail_check(g: int, m: int, k: int, n: int) -> None:
    """Every role of the grouped GEMM at a ragged shape (M, K, N off the
    tiles, rows off 16 bytes: the kernel's 4-byte copies), its operand views
    as autograd passes them: within RTOL of float64, two launches equal bits."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(g + m + k + n)
    a, b, dc = (torch.randn(*sh, device="cuda", generator=gen) for sh in ((g, m, k), (g, k, n), (g, m, n)))
    for role, args in (("grouped_matmul", (a, b)), ("grouped_matmul_dlhs", (dc, b)), ("grouped_matmul_drhs", (a, dc))):
        kernel, plain, _, _ = grouped_role(role)
        runs = [kernel(*args) for _ in range(2)]
        ref64 = plain(*(t.double() for t in args))
        torch.cuda.synchronize()
        same = torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))
        err = rel_err(runs[0].double(), ref64)
        finite = bool(torch.isfinite(runs[0]).all())
        print(f"grouped tail {role} G={g} M={m} K={k} N={n} kernel_vs_f64={err:.3e} bitwise_equal={same} "
              f"finite={finite}", flush=True)
        if not finite or not same or not err <= RTOL or runs[0].shape != ref64.shape:
            fail(f"grouped tail {role} ({g}, {m}, {k}, {n}): kernel vs float64 {err:.3e} (bitwise equal {same})")


def sum_check(g: int, m: int, n: int, splits: int, seed: int) -> dict:
    """The split sum kernel against its plain version (the same order: equal
    bits) at a weight gradient's partials `[S, G, M, N]`; its times with the
    L2 flushed (on the path the partials, 31 MB, are still in L2 from the
    launch that wrote them, and a warm reading beats the bytes bound)."""
    import torch

    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    gen = torch.Generator(device="cuda").manual_seed(seed)
    part = torch.randn(splits, g, m, n, device="cuda", generator=gen)
    got, want = gg.grouped_sum(part), gg.grouped_sum_plain(part)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    print(f"grouped sum [{splits},{g},{m},{n}] bitwise_equal_to_plain={same}", flush=True)
    if not same:
        fail("grouped_sum differs from its plain version (the same order of additions)")
    r = {"max_abs_err": float((got - want).abs().max()), "shape": f"[{splits},{g},{m},{n}]", "splits": splits,
         "l2": "flushed before every call"}
    for key, fn in (("ms", gg.grouped_sum), ("plain_ms", gg.grouped_sum_plain), ("library_ms", lambda p: p.sum(0))):
        r[key], r[key.replace("ms", "device_ms")] = time_cold_ms(lambda: fn(part), 20)
    r.update(flash_bounds((splits + 1) * g * m * n * 4, (splits - 1) * g * m * n, 0))
    r["ffma_bound_ms"] = r["bound_ms"]
    print(f"timing grouped_matmul_sum [{splits},{g},{m},{n}] l2=flushed ms={r['ms']:.6f} "
          f"device_ms={r['device_ms']:.6f} plain_ms={r['plain_ms']:.6f} plain_device_ms={r['plain_device_ms']:.6f} "
          f"library_ms={r['library_ms']:.6f} library_device_ms={r['library_device_ms']:.6f} "
          f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) share_of_bound={r['bound_ms'] / r['device_ms']:.3f}",
          flush=True)
    beaten = [key for key in ("device_ms", "plain_device_ms", "library_device_ms") if r[key] < r["bound_ms"]]
    if beaten:
        fail(f"grouped_matmul_sum: {beaten} below the bytes bound {r['bound_ms']:.6f} ms (the L2 flush failed)")
    return r


def attention_grad_layers(model, gid: int) -> int:
    """Attention layers whose backward runs in a gradient pass of group `gid`:
    every block from the group's first block on, all of them for a group
    before the first block (the embedding) and none for a group after the
    last (the head). Groups name their blocks `block<i>`
    (models/transformer.py); blocks before the group's are frozen, so no
    gradient flows back through them."""
    names = [path[0] for path in model.GROUP_PATHS[gid]]
    blocks = [int(n[len("block"):]) for n in names if n.startswith("block")]
    if blocks:
        return model.DEPTH - min(blocks)
    return model.DEPTH if any(n in ("embed", "pos_embed") for n in names) else 0


def active_blocks(model, gid: int) -> int:
    """Blocks whose own weights group `gid` trains (`block<i>` in its paths)."""
    return sum(path[0].startswith("block") for path in model.GROUP_PATHS[gid])


def expected_launches(rec, model=None, sweep_passes: int = 0) -> dict:
    """The launches a training run's own records imply. Each round records
    the optimizer's batched passes (`objective_passes`: with a gradient,
    without one, and directions, one per inner iteration). The direction
    kernels launch once per direction. In a transformer, a layer's backward
    (`backward`) runs once per gradient pass in each block behind the active
    group, and its forward (`forward`) once per pass of any kind in every
    block: the optimizer's passes and `sweep_passes` per evaluation recorded
    in `test_accuracy`; a weight gradient (`weight_backward`) once per
    gradient pass in each block the group trains."""
    sweeps = Counter((r["nloop"], r["group"]) for r in rec.series["test_accuracy"])
    out = Counter()
    for r in rec.series["objective_passes"]:
        passes = r["value"]
        out["direction"] += passes["direction"]
        if model is not None:
            out["backward"] += attention_grad_layers(model, r["group"]) * passes["grad"]
            out["weight_backward"] += active_blocks(model, r["group"]) * passes["grad"]
            out["forward"] += model.DEPTH * (passes["grad"] + passes["value"]
                                             + sweep_passes * sweeps[(r["nloop"], r["group"])])
    return dict(out)


def expected_grouped(exp: dict, cfg) -> dict:
    """The grouped GEMM's launches on the MoE ViT path from `expected_launches`:
    two a block (fc1, fc2) in every forward, two input gradients in every
    block the gradient crosses, two weight gradients in the trained block,
    and one split sum per weight gradient where `split_k` splits it."""
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    g, c, _, d, h = moe_shapes(cfg)
    split = sum(gg.split_k(g, m, n, c)[0] > 1 for m, n in ((d, h), (h, d)))  # dW1 [D, H], dW2 [H, D]
    return {"grouped_matmul": 2 * exp["forward"], "grouped_matmul_dlhs": 2 * exp["backward"],
            "grouped_matmul_drhs": 2 * exp["weight_backward"], "grouped_matmul_sum": split * exp["weight_backward"]}


def gate_launches(path: str, launches: dict, expected: dict) -> None:
    """Each kernel's launches against the count the run implies, printed side
    by side; any difference fails."""
    for name, want in expected.items():
        print(f"{path} launches {name} expected={want} counted={launches[name]}", flush=True)
    wrong = {name: (want, launches[name]) for name, want in expected.items() if launches[name] != want}
    if wrong:
        fail(f"{path}: launches differ from the count the run implies (expected, counted): {wrong}")


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
    n_dir = expected_launches(rec)["direction"]
    gate_launches("train", launches, {name: n_dir for name in cc.LAUNCHES})
    if profile:
        profile_epoch(tr)
    return launches, wall


def profile_epoch(tr, gid=None):
    """Kernel time by name and the device's busy share over one epoch of
    group `gid` (the first of the order by default)."""
    import torch

    from federated_pytorch_test_tpu_torch.engine.steps import round_init, run_epoch

    ctx = tr.ctx(tr.group_order[0] if gid is None else gid)
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
    from federated_pytorch_test_tpu_torch.engine.steps import _group_params
    from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig, lm_loss, lm_train_step
    from federated_pytorch_test_tpu_torch.optim import lbfgs_init

    def grad(ctx, flat, toks):
        x = ctx.partition.extract(flat, ctx.gid).contiguous().requires_grad_(True)
        with torch.enable_grad():
            loss = lm_loss(ctx.model, _group_params(ctx, flat, x), toks).sum()
        return torch.autograd.grad(loss, x)[0]

    lms = {impl: FederatedLM(LMConfig(seq=256, max_groups=1, attn_impl=impl), verbose=False)
           for impl in ("dense", "flash")}
    dense = lms["dense"]
    gid = dense.group_order[0]
    ctxs = {impl: lm.ctx(gid) for impl, lm in lms.items()}
    flat = dense.flat.clone()
    state = lbfgs_init(dense.partition.extract(flat, gid).contiguous(), ctxs["dense"].lbfgs)
    worst = {"train_loss": 0.0, "params": 0.0, "dual_residual": 0.0}
    for s in range(dense.train.shape[1]):
        toks = dense.train[:, s]
        gd, gf = (grad(ctx, flat, toks) for ctx in ctxs.values())  # at the step's entry
        out = {impl: lm_train_step(ctx, flat.clone(), state, toks) for impl, ctx in ctxs.items()}
        (fd, sd, ld), (ff, sf, lf) = out["dense"], out["flash"]
        xd, xf = dense.partition.extract(fd, gid), dense.partition.extract(ff, gid)
        step = {"train_loss": float(((lf - ld).abs() / ld.abs()).max()),
                "params": float((xf - xd).abs().max() / xd.abs().max())}
        print(f"lm parity step {s} grad_rel={rel_err(gf, gd):.3e} "
              + " ".join(f"{k}_rel={v:.3e}" for k, v in step.items())
              + f" evals dense={sd.func_evals.tolist()} flash={sf.func_evals.tolist()}"
              + f" probes dense={sd.ls_evals.tolist()} flash={sf.ls_evals.tolist()}", flush=True)
        worst = {k: max(v, step.get(k, 0.0)) for k, v in worst.items()}
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
    exp = expected_launches(rec, lm.model, sweep_passes=1)  # an evaluation is one pass over the test sequences
    gate_launches("lm", launches, {"flash_fwd": exp["forward"], "flash_bwd_dq": exp["backward"],
                                   "flash_bwd_dkv": exp["backward"]})
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
    exp = expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))  # an evaluation: one pass a test batch
    gate_launches("vit", launches, {"flash_fwd_rect": exp["forward"], "flash_bwd_dq_rect": exp["backward"],
                                    "flash_bwd_dkv_rect": exp["backward"],
                                    **{name: exp["direction"] for name in cc.LAUNCHES}})
    if profile:
        profile_epoch(tr)
    return launches, wall


class plain_grouped:
    """Within the block, the grouped GEMM's three roles take their plain
    versions on the card too (`torch.bmm`): the plain side of
    `phase_vit_moe_parity`. The port itself has no such switch."""

    def __enter__(self):
        from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

        self.saved = {role: getattr(gg, role) for role in ("grouped_matmul_fwd", "grouped_matmul_dlhs",
                                                          "grouped_matmul_drhs")}
        gg.grouped_matmul_fwd = gg.grouped_matmul_plain
        gg.grouped_matmul_dlhs = lambda dc, w: gg.grouped_matmul_plain(dc, w.transpose(1, 2))
        gg.grouped_matmul_drhs = lambda x, dc: gg.grouped_matmul_plain(x.transpose(1, 2), dc)
        return self

    def __exit__(self, *exc):
        from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

        for role, fn in self.saved.items():
            setattr(gg, role, fn)


def phase_vit_moe_parity():
    """The MoE ViT's block-0 round (group 1: its experts train, the gradient
    crosses every block) step by step at batch 128 (32,768 tokens a client,
    5,120 slots an expert: the weight gradients split), plain against the
    kernels: before each L-BFGS step the plain side ('dense' attention, the
    grouped GEMM's plain version) and the kernel side ('flash', the grouped
    kernel) get the same parameters and optimizer state, taken from the
    plain trajectory. Losses, parameters and the dual residual agree within
    relative 1e-3."""
    import torch

    from federated_pytorch_test_tpu_torch.consensus import FedAvgState, fedavg_round
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step, epoch_batches, round_init
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    source = synthetic_cifar(3 * 512, 100, seed=2)
    trs = {impl: Trainer(get_preset("fedavg", model="vit", model_kwargs={**VIT_MOE_KWARGS, "attn_impl": impl},
                                    batch=128, nloop=1, nadmm=1, max_groups=2, lbfgs_direction="pallas"),
                         verbose=False, source=source)
           for impl in ("dense", "flash")}
    plain = trs["dense"]
    gid = plain.group_order[1]
    ctxs = {impl: tr.ctx(gid) for impl, tr in trs.items()}
    flat = plain.flat.clone()
    state, _ = round_init(ctxs["dense"], flat)
    idx = plain.epoch_indices(0, gid, 0, 0)
    worst = {"train_loss": 0.0, "params": 0.0, "dual_residual": 0.0}
    gg.reset_launch_counts()
    for s, (imgs, labels) in enumerate(epoch_batches(plain.shard_imgs, plain.shard_labels, idx)):
        with plain_grouped():
            fd, sd, ld = client_train_step(ctxs["dense"], flat.clone(), state, imgs, labels, plain.mean, plain.std)
        ff, _, lf = client_train_step(ctxs["flash"], flat.clone(), state, imgs, labels, plain.mean, plain.std)
        xd, xf = plain.partition.extract(fd, gid), plain.partition.extract(ff, gid)
        step = {"train_loss": float(((lf - ld).abs() / ld.abs()).max()),
                "params": float((xf - xd).abs().max() / xd.abs().max())}
        print(f"vit_moe parity step {s} " + " ".join(f"{k}_rel={v:.3e}" for k, v in step.items()), flush=True)
        worst = {k: max(v, step.get(k, 0.0)) for k, v in worst.items()}
        if s == idx.shape[0] - 1:  # the averaging round after each last step
            duals = [float(fedavg_round(x, FedAvgState(z=torch.zeros_like(x[0])))[1]["dual_residual"])
                     for x in (xd, xf)]
            worst["dual_residual"] = abs(duals[1] - duals[0]) / duals[0]
        flat, state = fd, sd
    launches = dict(gg.LAUNCHES)
    print(f"vit_moe parity kernel-vs-plain per step ({idx.shape[0]} steps, group {gid}) "
          + " ".join(f"{k}_max_rel={v:.3e}" for k, v in worst.items()) + f" launches={json.dumps(launches)}",
          flush=True)
    if not max(worst.values()) <= 1e-3:
        fail(f"vit_moe parity: a step differs between the plain path and the kernels: {worst}")
    if not all(launches[k] > 0 for k in launches):
        fail(f"vit_moe parity: the kernel side did not run every grouped kernel: {launches}")


def phase_vit_moe_train(metrics_out, profile: bool):
    """The switch-MoE ViT path at full width, through the entry points a user calls."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    cfg = get_preset("fedavg", model="vit", model_kwargs=VIT_MOE_KWARGS, nloop=1, nadmm=1, lbfgs_direction="pallas")
    t0 = time.perf_counter()
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(VIT_TRAIN, VIT_TEST, seed=0))
    g, c, c_eval, d, h = moe_shapes(cfg)
    print(f"vit_moe setup: K={cfg.n_clients} batch={cfg.batch} nadmm={cfg.nadmm} {cfg.model_kwargs} "
          f"moe_aux_coef={cfg.moe_aux_coef} tokens={tr.model.tokens} params={tr.n_params} groups={tr.group_order} "
          f"group_sizes={[tr.partition.group_size(i) for i in tr.group_order]} experts_x_clients={g} "
          f"capacity={c} eval_capacity={c_eval} steps/epoch={tr.fed.steps_per_epoch(cfg.batch)} "
          f"setup_s={time.perf_counter() - t0:.3f}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    for mod in (fc, cc, gg):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    rec = tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**dict(fc.LAUNCHES), **dict(cc.LAUNCHES), **dict(gg.LAUNCHES)}

    for r in rec.series["step_time"]:
        if r["value"]["phase"] == "round":
            print(f"vit_moe round group={r['group']} wall_s={r['value']['seconds']:.3f}", flush=True)
    n_steps = len(rec.series["train_loss"])
    print(f"vit_moe train wall_s={wall:.3f} minibatches={n_steps} ms_per_minibatch={1e3 * wall / n_steps:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={json.dumps(launches)}", flush=True)
    if metrics_out:
        rec.save(metrics_out)

    all_losses = np.asarray([r["value"] for r in rec.series["train_loss"]])
    if not np.all(np.isfinite(all_losses)) or rec.first_nonfinite is not None:
        fail(f"vit_moe: non-finite training loss: {rec.first_nonfinite}")
    accs = [(r["group"], np.asarray(r["value"])) for r in rec.series["test_accuracy"]]
    print("vit_moe accuracy per group " + " ".join(f"{g}:{','.join(f'{a:.4f}' for a in v)}" for g, v in accs),
          flush=True)
    chance = 1.0 / tr.fed.num_classes
    if not np.all(accs[-1][1] > chance):
        fail(f"vit_moe final accuracy {accs[-1][1]} not above chance {chance}")
    for name in (*fc.RECT_KERNELS, *gg.LAUNCHES):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the MoE ViT path")
    exp = expected_launches(rec, tr.model, sweep_passes=len(tr.test_imgs))  # an evaluation: one pass a test batch
    gate_launches("vit_moe", launches, {"flash_fwd_rect": exp["forward"], "flash_bwd_dq_rect": exp["backward"],
                                        "flash_bwd_dkv_rect": exp["backward"],
                                        **{name: exp["direction"] for name in cc.LAUNCHES},
                                        **expected_grouped(exp, cfg)})
    if profile:
        profile_epoch(tr, tr.group_order[1])
    return launches, wall


# One turn of `--ab-parent`, run in a fresh process from the root of a
# checkout: the device ms of the grouped GEMM at every MoE ViT path shape
# and of the gram at every Net group size, as one JSON line; then
# that checkout's train phases, the LM's group-0 epoch profiled, and their
# walls as one JSON line.
AB_TURN = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
from federated_pytorch_test_tpu_torch.utils import configure_precision
configure_precision()
import torch
from federated_pytorch_test_tpu_torch.engine import get_preset
from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
times = {}
for i, (label, role, shapes) in enumerate(cs.grouped_cases(get_preset("fedavg", model="vit",
                                                                      model_kwargs=cs.VIT_MOE_KWARGS))):
    gen = torch.Generator(device="cuda").manual_seed(100 + i)
    a, b = (torch.randn(*sh, device="cuda", generator=gen) for sh in shapes)
    kernel = cs.grouped_role(role)[0]
    times[label] = cs.time_ms(lambda: kernel(a, b), 20)[1]
    del a, b
full = torch.full((cs.K,), cs.M, dtype=torch.int32, device="cuda")
for n in cs.NET_GROUP_SIZES:
    s, y, g, count, _ = cs.history(n, seed=n)
    s.nan_to_num_(0.0)
    y.nan_to_num_(0.0)
    times[f"gram N={n}"] = cs.time_ms(lambda: cc.fused_gram_projections(s, y, g, full), 200)[1]
    del s, y, g
print("ab kernels " + json.dumps(times), flush=True)
walls = {p: getattr(cs, p)(None, p == "phase_lm_train")[1]
         for p in ("phase_train", "phase_lm_train", "phase_vit_train", "phase_vit_moe_train") if hasattr(cs, p)}
print("ab walls " + json.dumps(walls), flush=True)
"""
AB_RUNS = 3  # turns of each checkout
AB_BUILD = ("import sys; sys.path.insert(0, '.'); import chip_smoke as cs; "
            "from federated_pytorch_test_tpu_torch.ops import build; [build.build(n) for n in cs.SOURCES]")


def run_ab(parent: str, runs: int) -> None:
    """The kernel times and train walls of another checkout (`parent`, e.g.
    `git archive` of the parent commit unpacked) and of this one, `runs`
    turns each, in fresh processes taking turns parent, change, change,
    parent, ... after both have built their kernels. Every line of a turn
    is printed with its checkout's tag; then each kernel's device ms per
    turn and the median ratio (change over parent), and each wall's pair
    differences (change minus parent) and their median."""
    import statistics

    trees = {"parent": os.path.abspath(parent), "change": HERE}
    with ThreadPoolExecutor(2) as pool:  # both builds at once, outside the timed turns
        for tag, proc in zip(trees, pool.map(lambda t: subprocess.run(
                [sys.executable, "-c", AB_BUILD], cwd=t, capture_output=True, text=True), trees.values())):
            if proc.returncode != 0:
                fail(f"ab: the {tag} checkout did not build:\n{proc.stdout}{proc.stderr}")
    order = [("parent", "change"), ("change", "parent")]
    walls = {"parent": [], "change": []}
    kernel_ms = {"parent": [], "change": []}
    for turn in range(runs):
        for tag in order[turn % 2]:
            proc = subprocess.run([sys.executable, "-c", AB_TURN], cwd=trees[tag], capture_output=True, text=True)
            for line in (proc.stdout + proc.stderr).splitlines():
                print(f"[{tag} {turn}] {line}", flush=True)
            if proc.returncode != 0:
                fail(f"ab: the {tag} checkout's turn {turn} failed (exit {proc.returncode})")
            walls[tag].append(json.loads(proc.stdout.split("ab walls ")[-1].splitlines()[0]))
            kernel_ms[tag].append(json.loads(proc.stdout.split("ab kernels ")[-1].splitlines()[0]))
    for name in kernel_ms["change"][0]:
        par, chg = ([t[name] for t in kernel_ms[tag]] for tag in ("parent", "change"))
        print(f"ab device_ms {name} parent={[round(x, 6) for x in par]} change={[round(x, 6) for x in chg]} "
              f"median_ratio={statistics.median(c / p for c, p in zip(chg, par)):.4f}", flush=True)
    for phase in walls["change"][0].keys() & walls["parent"][0].keys():
        diffs = [c[phase] - p[phase] for c, p in zip(walls["change"], walls["parent"])]
        print(f"ab {phase} parent={[round(p[phase], 3) for p in walls['parent']]} "
              f"change={[round(c[phase], 3) for c in walls['change']]} "
              f"diffs={[round(x, 3) for x in diffs]} median_diff={statistics.median(diffs):.3f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--metrics-out", help="write the main path's metric series as JSON here")
    ap.add_argument("--lm-metrics-out", help="write the LM path's metric series as JSON here")
    ap.add_argument("--vit-metrics-out", help="write the ViT path's metric series as JSON here")
    ap.add_argument("--vit-moe-metrics-out", help="write the MoE ViT path's metric series as JSON here")
    ap.add_argument("--profile", action="store_true", help="also profile one epoch of each path")
    ap.add_argument("--ab-parent", metavar="DIR",
                    help="instead of the phases, time the train paths of the checkout in DIR and of this "
                         "one in turns (see run_ab)")
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
    if args.ab_parent:
        run_ab(args.ab_parent, AB_RUNS)
        return 0

    def timed_build(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, all at once
        built = list(pool.map(timed_build, SOURCES))
    for lib, seconds in built:
        print(f"build {lib.name} seconds={seconds:.3f}", flush=True)
    report_tensor_core_build(built[SOURCES.index("flash_attention")][0], "flash_attention", flash_label)
    report_tensor_core_build(built[SOURCES.index("grouped_gemm")][0], "grouped_gemm", grouped_label)

    report = phase_kernels()
    flash_report = phase_flash()
    rect_report = phase_flash_rect()
    phase_parity()
    launches, wall = phase_train(args.metrics_out, args.profile)
    phase_lm_parity()
    lm_launches, lm_wall = phase_lm_train(args.lm_metrics_out, args.profile)
    phase_vit_parity()
    vit_launches, vit_wall = phase_vit_train(args.vit_metrics_out, args.profile)
    grouped_report = phase_grouped()
    phase_vit_moe_parity()
    moe_launches, moe_wall = phase_vit_moe_train(args.vit_moe_metrics_out, args.profile)

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
            # bound_ms: split TF32 on the tensor cores, the exps or the bytes,
            # whichever is largest (bound_term); the f32 FFMA design's ceiling beside it
            "bound_term": r["bound_term"],
            "ffma_bound_ms": r["ffma_bound_ms"],
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
            # bound_ms: split TF32 on the tensor cores, the exps or the bytes,
            # whichever is largest (bound_term); the f32 FFMA design's ceiling beside it
            "bound_term": r["bound_term"],
            "ffma_bound_ms": r["ffma_bound_ms"],
            # scaled_dot_product_attention without a mask: its forward for
            # flash_fwd_rect; its backward for the two backward kernels
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": f"BH={bh} S={s} D={d} non-causal",
        })
    for name, r in grouped_report.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "federated_pytorch_test_tpu_torch/csrc/grouped_gemm.cu",
            "replaces": GROUPED_REPLACES,
            "launches": moe_launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # bound_ms: split TF32 on the tensor cores or the bytes, whichever is
            # larger (bound_term); an f32 FFMA design's ceiling beside it
            "bound_term": r["bound_term"],
            "ffma_bound_ms": r["ffma_bound_ms"],
            # torch.bmm on the same operand views, TF32 off (for the sum: torch.sum over the splits)
            "library_ms": r["library_ms"],
            "ms_includes_host": True,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "shape": r["shape"],
            "splits": r["splits"],
            "l2": r.get("l2", "as left by the previous call"),
        })
    print(f"total seconds={time.perf_counter() - t_all:.3f} train_wall_s={wall:.3f} lm_train_wall_s={lm_wall:.3f} "
          f"vit_train_wall_s={vit_wall:.3f} vit_moe_train_wall_s={moe_wall:.3f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
