#!/usr/bin/env python3
"""Sweeps of the port's kernel tunables on the card (one NVIDIA GPU).

Run from the root of a checkout:

    python3 chip_sweep.py [grouped] [grouped_bf16] [gram] [assembly] [bf16] [flash_1p] [flash_f32] [--parent DIR]
                          [scale64] [determinism] [cudnn]

Ten sweeps (all of them without arguments), the first eight printed one
line per setting with its device ms (calls queued behind a sleep kernel,
`chip_smoke.time_ms`) and its error:

1. grouped — the grouped GEMM (`ops/grouped_gemm.py`) at every MoE ViT path
   shape (`chip_smoke.grouped_cases`) with each output tile the kernel has
   (128 x 64, 64 x 128) and, for the weight gradients, split chunks of
   512 … 4,096 slots (the split sum included), against `torch.bmm` in
   float64;
1b. grouped_bf16 — the bf16 grouped GEMM (`csrc/grouped_gemm_bf16.cu`,
   built with `-DGROUPED_BF16_SWEEP`: `grouped_gemm_bf16_sweep_launch`) at
   every MoE ViT path shape on bf16 operands (phase 12″'s inputs): each
   output tile the kernel has (128 x 256, 128 x 64, 64 x 256, 256 x 64)
   and, for the weight gradients, split chunks of 1,920 … 5,120 slots (the
   split sum included); at the shipped tile and chunk, the ring cut to 2 or
   4 stages and the attribution cuts (no stores, no loads, no products);
   then two CTAs an SM at 128 x 64 (a plan of half the shared memory):
   device ms beside `torch.bmm` on the same bf16 operands and the bound,
   the distance from the float64 product rounded to bf16 in bf16 units,
   and whether the output equals the shipped plan's in bits;
2. gram — the one-launch gram (`ops/compact_cuda.py`) at every Net group
   size and a ResNet18-block N, with at most 16 … 128 blocks a client,
   against the shipped setting's result;
3. assembly — the direction assembly (`ops/compact_cuda.py`) at every size
   of `chip_smoke.AB_ASSEMBLY_SIZES` (Net's groups, Net1's 890,410 and the
   aligned 890,408, the ResNet18 groups), full history, on its
   one-column-a-lane path at every N and on its 16-byte path where the
   rows allow it: equal bits to the shipped path's result, and
   `torch.matmul(coef, X)` timed beside them as the yardstick;
4. bf16 — the bf16 causal trio (`csrc/flash_bf16.cu`: forward, dq, dk/dv)
   at every `chip_smoke.BF16_PATHS` shape, from the library built with
   `-DFLASH_BF16_CUTS` (`flash_*_bf16_cut_launch`,
   `flash_*_bf16_d128_cut_launch`): up to D = 64 the forward and dq at
   every key tile they have, at D = 128 the forward at each of its plans
   (K, V and qs stages) and dk/dv at each ring depth, each kernel whole and
   with its attribution cuts (no exps, no products, loads only — the
   producer alone —, products only, and at D = 128 no loads — the consumers
   alone, with a `binds` line of both shares), each beside its bound
   (`chip_smoke.flash_bounds`); a whole kernel's outputs within two bf16
   units of its plain version (the forward's at that tile;
   `chip_smoke.bf16_units`);
4b. flash_1p — the one-pass f32 forward (`onepass::flash_fwd_1p_tc` in
   `csrc/flash_attention.cu` at D 16, `flash_fwd_tc` above) and dk/dv up to
   D 64 (`onepass::flash_bwd_dkv_1p_tc`) through their entry points at
   every `ONEPASS_SHAPES` shape (the ViT's and the LM's path shapes at D
   16, the same bytes at D 32 and 64) beside the bound; with `--parent
   DIR`, the one-pass forward and dk/dv of the checkout in DIR, timed first
   in a process of its own at the same shapes (`parent_device_ms`), whether
   their outputs equal these in bits, and whether the forward's do at every
   `ONEPASS_CASES` case (chip_smoke.py's `onepass_check` cases); from the
   library built with `-DFLASH_F32_CUTS` (`flash_bwd_dkv_1p_cut_launch`,
   `flash_fwd_1p_cut_launch`, `flash_fwd_tc_cut_launch`), at D 16 the
   dk/dv and the one-pass forward, and at every shape `flash_fwd_tc` at
   each instance the entry points run (split, rows 4 and 5 at D 16; at D 32
   and 64 one pass too), whole and with their attribution cuts (no exps; no
   products, scores that differ by element; loads only — the consumers
   only wait for and free each tile, the producer alone; for
   `flash_fwd_tc` K and V landed and split, nothing computed —; no split —
   nothing landed or formed: the consumers alone), each whole kernel's
   outputs against the entry point's in bits, and a `binds` line of the
   loads-only and consumers-alone shares of the whole;
4c. flash_f32 — the head-dim-128 f32 forward (`fwd128::flash_fwd_d128_tc`
   in `csrc/flash_attention.cu`), dk/dv (`bwd128::flash_bwd_dkv_d128_tc`)
   and dq (`dq128::flash_bwd_dq_d128_tc`) at `chip_smoke.LM128_PATH`
   (causal) and `VIT128_PATH` (non-causal), at 'highest' and 'default',
   from the library built with `-DFLASH_F32_CUTS`
   (`flash_fwd_d128_cut_launch`, `flash_bwd_dkv_d128_cut_launch`,
   `flash_bwd_dq_d128_cut_launch`): the shipped plan (two operand, score or
   transposes stages) whole and with its attribution cuts (no exps; no
   products; loads only — the consumers only wait for and free each stage,
   the producer alone; no split — the producer forms no operands, the
   consumers alone), the other plan (one operand or score stage; dq three
   transposes stages) whole, each beside the shipped entry point's time and
   the bound; a whole plan's outputs equal the shipped ones in bits. SDPA's
   f32 backward is timed beside the D-128 dq and dk/dv (`pair_over_sdpa`).
   With `--parent DIR`, the shipped forward, dq and dk/dv of the checkout in
   DIR are timed first in a process of their own at the same shapes
   (`parent_device_ms`);
5. scale64 — the direction backends (`lbfgs_direction`) at the largest
   scale64 shape: one optimizer step of fedavg_scale64's block7 round (K=64
   ResNet18 clients, N = 4,720,640) with 'pallas', then 'compact', each
   from a fresh Trainer: its wall and peak allocated memory, or that it
   ran out of the card's memory (no device time; a step, not a kernel);
6. determinism — a diagnostic, not a setting of the port: one round of
   each train path (Net fedavg, admm, no_consensus, an admm_resnet round,
   the LM, the ViT, the MoE ViT at f32 and at bf16) on a small synthetic
   set under `torch.use_deterministic_algorithms(True, warn_only=True)`,
   with `CUBLAS_WORKSPACE_CONFIG=:4096:8` (set by this script before the
   first cuBLAS call when the sweep is named): every op PyTorch reports
   as having no deterministic implementation, with its count, a line
   each, and the path's wall. It cannot see the ops that PyTorch swaps
   for a deterministic version in this mode (the backward of
   `index_select` and `gather`, `scatter`): those run without a word, so
   a silent path shows only that no op without a deterministic version
   ran, not that the default path is free of atomics;
7. cudnn — what the port's deterministic cuDNN costs: the Net fedavg loop
   (`chip_smoke.py` phase 7), admm_resnet's block7 round (1,536 train and
   2,000 test images, as phase 17) and fedavg_scale64's block7 round (as
   phase 21), each from a fresh Trainer in turns deterministic, cuDNN's
   default algorithms, default, deterministic (the setting switched after
   the Trainer is built, since every entry point sets the deterministic
   default): wall and peak allocated memory of each turn.

The port's own settings (`grouped_gemm.tiles`, `split_k`,
`compact_cuda.gram_chunks`, `compact_cuda._vec_ok`) are not changed: each setting is launched
through the kernels' C entry points directly. Without CUDA the script exits
non-zero.
"""

from __future__ import annotations

import math
import sys
import time

import chip_smoke as cs


def sweep_grouped() -> None:
    import torch

    from federated_pytorch_test_tpu_torch.engine import get_preset
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    lib = gg._kernels()
    cfg = get_preset("fedavg", model="vit", model_kwargs=cs.VIT_MOE_KWARGS)
    for i, (label, role, shapes) in enumerate(cs.grouped_cases(cfg)):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        a0, b0 = (torch.randn(*sh, device="cuda", generator=gen) for sh in shapes)
        lhs, rhs = cs.grouped_role(role)[3](a0, b0)
        g, m, k = lhs.shape
        n = rhs.shape[2]
        a, a_t, a_g, lda = gg._layout(lhs)
        b, b_t, b_g, ldb = gg._layout(rhs if not a_t else rhs.contiguous())
        ref = torch.bmm(lhs.double(), rhs.double())
        chunks = (512, 1024, 2048, 4096) if role == "grouped_matmul_drhs" else (k,)
        for bm, bn in ((128, 64), (64, 128)):
            for chunk in chunks:
                splits = math.ceil(k / chunk)
                out = torch.empty((g, m, n), device="cuda")
                dst = out if splits == 1 else torch.empty((splits, g, m, n), device="cuda")
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    rc = lib.grouped_gemm_launch(a.data_ptr(), b.data_ptr(), dst.data_ptr(), g, m, n, k, a_t, a_g,
                                                 lda, b_t, b_g, ldb, bm, bn, chunk, stream)
                    if rc != 0:
                        cs.fail(f"grouped_gemm_launch: cudaError {rc}")
                    if splits > 1:
                        gg.grouped_sum(dst, out)

                _, device_ms = cs.time_ms(call, 20)
                print(f"sweep grouped {label} [{g},{m},{k}]x[{g},{k},{n}] tile={bm}x{bn} chunk={chunk} "
                      f"splits={splits} device_ms={device_ms:.6f} err_vs_f64={cs.rel_err(out.double(), ref):.2e}",
                      flush=True)
        del a0, b0, a, b, ref


GROUPED_BF16_CUTS = ("whole", "no_stores", "no_loads", "no_products")  # kFull … kNoProducts


def sweep_grouped_bf16() -> None:
    import ctypes

    import torch

    from federated_pytorch_test_tpu_torch.engine import get_preset
    from federated_pytorch_test_tpu_torch.ops import build
    from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

    lib = build.load("grouped_gemm_bf16", ("GROUPED_BF16_SWEEP",))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = lib.grouped_gemm_bf16_sweep_launch
    launch.argtypes = [ptr] * 3 + [i32] * 5 + [i64, i64, i32, i64, i64] + [i32] * 6 + [ptr]
    launch.restype = i32
    cfg = get_preset("fedavg", model="vit", model_kwargs=cs.VIT_MOE_KWARGS)
    for two_ctas in (False, True):  # the two-CTA plan (a setmaxnreg plan of its own) after every other
        for i, (label, role, shapes) in enumerate(cs.grouped_cases(cfg)):
            gen = torch.Generator(device="cuda").manual_seed(300 + i)  # phase 12″'s inputs
            a0, b0 = (torch.randn(*sh, device="cuda", generator=gen).to(torch.bfloat16) for sh in shapes)
            kernel, _, library, views = cs.grouped_role(role)
            lhs, rhs = views(a0, b0)
            g, m, k = lhs.shape
            n = rhs.shape[2]
            a, a_t, a_g, lda = gg._layout(lhs)
            b, b_t, b_g, ldb = gg._layout(rhs if not a_t else rhs.contiguous())
            shipped = kernel(a0, b0)
            ref = torch.bmm(lhs.double(), rhs.double()).to(torch.bfloat16)
            _, bmm_ms = cs.time_ms(lambda: library(a0, b0), 20)
            _, ship_ms = cs.time_ms(lambda: kernel(a0, b0), 20)
            bound = cs.flash_bounds((g * m * k + g * k * n + g * m * n) * 2, 2 * g * m * k * n, 0, "bf16")["bound_ms"]
            if not two_ctas:
                print(f"sweep grouped_bf16 {label} [{g},{m},{k}]x[{g},{k},{n}] "
                      f"shipped tile={gg.tiles(m, n, torch.bfloat16)} split={gg.split_k(g, m, n, k, torch.bfloat16)} "
                      f"device_ms={ship_ms:.6f} bmm_device_ms={bmm_ms:.6f} bound_ms={bound:.6f}", flush=True)
            chunks = (1920, 2560, 4096, 5120) if role == "grouped_matmul_drhs" else (k,)
            ship_chunk = gg.split_k(g, m, n, k, torch.bfloat16)[1]
            out = torch.empty((g, m, n), dtype=torch.bfloat16, device="cuda")
            # (tile, CTAs an SM, ring, chunk, cut): every tile and chunk; at the
            # shipped tile and chunk, the ring cut and the attribution cuts
            ship = gg.tiles(m, n, torch.bfloat16)
            settings = [(tile, 1, 0, chunk, 0) for tile in ((128, 256), (128, 64), (64, 256), (256, 64))
                        for chunk in chunks]
            settings += [(ship, 1, ring, ship_chunk, 0) for ring in (2, 4)]
            settings += [(ship, 1, 0, ship_chunk, cut) for cut in (1, 2, 3)]
            if two_ctas:
                settings = [((128, 64), 2, 0, chunk, 0) for chunk in chunks]
            for (bm, bn), ctas, ring, chunk, cut in settings:
                splits = math.ceil(k / chunk)
                dst = out if splits == 1 else torch.empty((splits, g, m, n), device="cuda")
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    rc = launch(a.data_ptr(), b.data_ptr(), dst.data_ptr(), g, m, n, k, a_t, a_g, lda, b_t, b_g, ldb,
                                bm, bn, chunk, ring, ctas, cut, stream)
                    if rc != 0:
                        cs.fail(f"grouped_gemm_bf16_sweep_launch: cudaError {rc}")
                    if splits > 1:
                        gg.grouped_sum(dst, out)

                _, device_ms = cs.time_ms(call, 20)
                check = "" if cut else (f" bf16_units_vs_f64={cs.bf16_units(out, ref):.3f} "
                                        f"equals_shipped={cs.bitwise_equal(out, shipped)}")
                print(f"sweep grouped_bf16 {label} tile={bm}x{bn} ctas={ctas} ring={ring} chunk={chunk} "
                      f"splits={splits} cut={GROUPED_BF16_CUTS[cut]} device_ms={device_ms:.6f} "
                      f"vs_bmm={device_ms / bmm_ms:.3f} "
                      f"share_of_bound={bound / device_ms:.3f}{check}", flush=True)
                del dst
            del a0, b0, a, b, lhs, rhs, shipped, ref, out


def sweep_gram() -> None:
    import torch

    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc

    lib = cc._kernels()
    k, m = cs.K, cs.M
    n_out = 2 * m * m + 2 * m
    full = torch.full((k,), m, dtype=torch.int32, device="cuda")
    for n in (*cs.NET_GROUP_SIZES, cs.LARGE_N):
        s, y, g, _, _ = cs.history(n, seed=n)
        s.nan_to_num_(0.0)
        y.nan_to_num_(0.0)
        want = cc.fused_gram_projections(s, y, g, full)
        tiles = math.ceil(n / 256)
        for cap in (16, 24, 32, 44, 64, 96, 128):
            per_block = math.ceil(tiles / cap)
            chunks = math.ceil(tiles / per_block)
            partial, ticket = cc._gram_scratch(s.device, k * chunks * n_out, k)
            out = torch.empty((k, n_out), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                rc = lib.compact_gram_launch(s.data_ptr(), y.data_ptr(), g.data_ptr(), full.data_ptr(),
                                             partial.data_ptr(), ticket.data_ptr(), out.data_ptr(), k, m, n, chunks,
                                             per_block, cc._vec_ok(n, s, y, g), stream)
                if rc != 0:
                    cs.fail(f"compact_gram_launch: cudaError {rc}")

            _, device_ms = cs.time_ms(call, 20 if n > 1_000_000 else 200)
            err = cs.rel_err(out[:, :m * m].reshape(k, m, m), want[0])
            print(f"sweep gram N={n} max_chunks={cap} chunks={chunks} tiles_per_block={per_block} "
                  f"device_ms={device_ms:.6f} sy_vs_shipped={err:.2e}", flush=True)


def sweep_assembly() -> None:
    import torch

    from federated_pytorch_test_tpu_torch.ops import compact_cuda as cc
    from federated_pytorch_test_tpu_torch.optim.compact import compact_solves, history_valid

    lib = cc._kernels()
    k, m = cs.K, cs.M
    full = torch.full((k,), m, dtype=torch.int32, device="cuda")
    for n in cs.AB_ASSEMBLY_SIZES:
        s, y, g, _, h_diag = cs.history(n, seed=n)
        s.nan_to_num_(0.0)
        y.nan_to_num_(0.0)
        sy, yy, p, q = cc.fused_gram_projections_plain(s, y, g, full)
        u, w, _, _ = compact_solves(sy, p, q, history_valid(full, m), h_diag,
                                    lambda uu: (torch.matmul(yy, uu[..., None])[..., 0], None))
        w, u = w.contiguous(), u.contiguous()
        want = cc.fused_direction_assembly(s, y, g, w, u, h_diag, full)
        iters = 20 if n > 200_000 else 200
        x = torch.cat([s, y, g[:, None]], dim=1)
        coef = torch.cat([w, -h_diag[:, None] * u, h_diag[:, None]], dim=1)[:, None, :]
        _, matmul_ms = cs.time_ms(lambda: torch.matmul(coef, x), iters)
        del x
        bound_ms = (2 * m * n + 2 * n) * 4 * k / cs.HBM_BYTES_PER_S * 1e3
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((k, n), device="cuda")
        for vec in sorted({0, cc._vec_ok(n, s, y, g, out)}):

            def call():
                rc = lib.compact_assembly_launch(s.data_ptr(), y.data_ptr(), g.data_ptr(), w.data_ptr(),
                                                 u.data_ptr(), h_diag.data_ptr(), full.data_ptr(), out.data_ptr(),
                                                 k, m, n, vec, stream)
                if rc != 0:
                    cs.fail(f"compact_assembly_launch: cudaError {rc}")

            _, device_ms = cs.time_ms(call, iters)
            print(f"sweep assembly N={n} path={'vec' if vec else 'lane'} shipped={vec == cc._vec_ok(n, s, y, g, out)} "
                  f"device_ms={device_ms:.6f} share_of_bound={bound_ms / device_ms:.3f} "
                  f"matmul_device_ms={matmul_ms:.6f} bitwise_vs_shipped={cs.bitwise_equal(out, want)}", flush=True)
        del s, y, g, out


BF16_CUTS = ("full", "no_exp", "no_mma", "loads_only", "mma_only", "no_loads")  # kFull … kNoLoads in csrc/flash_bf16.cu
BF16_KEYS = (64, 128)  # the forward's and dq's candidate key tiles up to D = 64 (dq's at D = 128)
FWD128_PLANS = ("k3v2q2", "k3v3q1", "k2v2q2")  # `plan` of flash_fwd_bf16_d128_cut_launch: FwdDepth's K, V, qs stages
DKV128_RINGS = (4, 3)  # `ring` of flash_bwd_dkv_bf16_d128_cut_launch: qs/dO stages; the first of each is shipped


def sweep_bf16() -> None:
    """The bf16 trio at every `chip_smoke.BF16_PATHS` shape, from the
    library built with `-DFLASH_BF16_CUTS`: up to D = 64 the forward and dq
    at each key tile and dk/dv, each whole and with the cuts kFull …
    kMmaOnly; at D = 128 the forward of each plan and dk/dv of each ring
    depth, each with every cut (no_loads: the consumers alone), and dq at 64
    keys. A whole kernel's outputs are held to its plain version in bf16
    units; at D = 128 a `binds` line gives the producer alone (loads_only)
    and the consumers alone (no_loads) as shares of the whole."""
    import ctypes

    import torch

    from federated_pytorch_test_tpu_torch.ops import build
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    lib = build.load("flash_bf16", ("FLASH_BF16_CUTS",))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd_bf16_cut_launch.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.flash_fwd_bf16_d128_cut_launch.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.flash_bwd_dq_bf16_cut_launch.argtypes = [ptr] * 7 + [i32] * 3 + [ctypes.c_float] + [i32] * 2 + [ptr]
    lib.flash_bwd_dkv_bf16_cut_launch.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.flash_bwd_dkv_bf16_d128_cut_launch.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    for bh, s, d in cs.BF16_PATHS:
        (_, _, _, do), (q16, k16, v16) = cs.bf16_inputs(bh, s, d, seed=41)
        scale = 1.0 / d ** 0.5
        qs = fc.prescale_q(q16, scale)
        o_ref, lse_ref = fc.flash_fwd_bf16_plain(qs, k16, v16)
        delta, do16 = (do * o_ref).sum(-1), do.to(torch.bfloat16)
        dq_ref = fc.flash_bwd_dq_bf16_plain(qs, k16, v16, do16, lse_ref, delta, scale)
        dk_ref, dv_ref = fc.flash_bwd_dkv_bf16_plain(qs, k16, v16, do16, lse_ref, delta)
        pairs = bh * s * (s + 1) // 2
        op16, op32, row = bh * s * d * 2, bh * s * d * 4, bh * s * 4
        bound_fwd = cs.flash_bounds(3 * op16 + op32 + row, 2 * 2 * d * pairs, pairs, "bf16")["bound_ms"]
        bound_dq = cs.flash_bounds(4 * op16 + 2 * row + op16, 3 * 2 * d * pairs, pairs, "bf16")["bound_ms"]
        bound_dkv = cs.flash_bounds(4 * op16 + 2 * row + 2 * op16, 4 * 2 * d * pairs, pairs, "bf16")["bound_ms"]
        stream = torch.cuda.current_stream().cuda_stream
        label = f"BH={bh} S={s} D={d}"
        o, lse = torch.empty_like(o_ref), torch.empty_like(lse_ref)
        dq, dk, dv = torch.empty_like(q16), torch.empty_like(k16), torch.empty_like(v16)

        def time_cuts(kind: str, variant: str, call, bound: float, check, cuts) -> None:
            """Each cut of one variant: device ms beside the bound, the whole
            one's check; at D = 128 the shares of the producer and consumers alone."""
            ms = {}
            for cut, cut_name in enumerate(cuts):
                if call(cut) != 0:
                    print(f"sweep bf16 {kind} {label} {variant} cut={cut_name} no instance", flush=True)
                    continue
                _, ms[cut_name] = cs.time_ms(lambda: call(cut), 20)
                print(f"sweep bf16 {kind} {label} {variant} cut={cut_name} device_ms={ms[cut_name]:.6f} "
                      f"bound_ms={bound:.6f} share_of_bound={bound / ms[cut_name]:.3f}"
                      f"{check() if cut == 0 else ''}", flush=True)
            if "no_loads" in ms and "full" in ms:
                print(f"sweep bf16 {kind} {label} {variant} binds producer_alone={ms['loads_only'] / ms['full']:.3f} "
                      f"consumers_alone={ms['no_loads'] / ms['full']:.3f} (of the whole)", flush=True)

        def fwd_check(want=(o_ref, lse_ref)):
            return f" o_units={cs.bf16_units(o, want[0]):.3f} lse_units={cs.bf16_units(lse, want[1]):.3f}"

        def dkv_check():
            return f" dk_units={cs.bf16_units(dk, dk_ref):.3f} dv_units={cs.bf16_units(dv, dv_ref):.3f}"

        if d == 128:
            for plan, name in enumerate(FWD128_PLANS):
                time_cuts("fwd", f"plan={name}", lambda cut, plan=plan: lib.flash_fwd_bf16_d128_cut_launch(
                    qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, s, plan, cut,
                    stream), bound_fwd, fwd_check, BF16_CUTS)
        else:
            for keys in BF16_KEYS:
                want = fc.flash_fwd_bf16_plain(qs, k16, v16, keys=keys)
                time_cuts("fwd", f"keys={keys}", lambda cut, keys=keys: lib.flash_fwd_bf16_cut_launch(
                    qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, s, d, keys, cut,
                    stream), bound_fwd, lambda want=want: fwd_check(want), BF16_CUTS[:5])
        for keys in BF16_KEYS:
            time_cuts("dq", f"keys={keys}", lambda cut, keys=keys: lib.flash_bwd_dq_bf16_cut_launch(
                qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), do16.data_ptr(), lse_ref.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), bh, s, d, scale, keys, cut, stream), bound_dq,
                lambda: f" dq_units={cs.bf16_units(dq, dq_ref):.3f}", BF16_CUTS[:5])
        if d == 128:
            for ring in DKV128_RINGS:
                time_cuts("dkv", f"ring={ring}", lambda cut, ring=ring: lib.flash_bwd_dkv_bf16_d128_cut_launch(
                    qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), do16.data_ptr(), lse_ref.data_ptr(),
                    delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s, ring, cut, stream), bound_dkv, dkv_check,
                    BF16_CUTS)
        else:
            time_cuts("dkv", "tile=64", lambda cut: lib.flash_bwd_dkv_bf16_cut_launch(
                qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), do16.data_ptr(), lse_ref.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), bh, s, d, cut, stream), bound_dkv, dkv_check, BF16_CUTS[:5])
        del q16, k16, v16, qs, do, do16, o_ref, lse_ref, delta, dq_ref, dk_ref, dv_ref, o, lse, dq, dk, dv


# (causal, (BH, S, D)) of flash_1p: the ViT's and the LM's path shapes, then
# the same bytes at D 32 and 64, where the one-pass dk/dv runs one CTA an SM
ONEPASS_SHAPES = ((False, cs.RECT_PATH), (True, cs.FLASH_PATH), (False, (3072, 256, 32)), (False, (1536, 256, 64)),
                  (True, (64, 2048, 32)), (True, (32, 2048, 64)))
F32_PLANS = ("ring2", "ring1")  # `plan` of flash_fwd_d128_cut_launch: operand stages; the first is shipped
DKV_PLANS = ("ring2", "ring1")  # `plan` of flash_bwd_dkv_d128_cut_launch: score stages; the first is shipped
DQ_PLANS = ("tr2", "tr3")  # `plan` of flash_bwd_dq_d128_cut_launch: transposes stages; the first is shipped
F32_CUTS = ("full", "no_exp", "no_mma", "loads_only", "no_split")  # `cut`, kFull … kNoSplit
# the shipped D-128 forward, dq and dk/dv of a checkout, timed in its own
# process from that checkout's root: device ms of each at both precisions at
# LM128_PATH and VIT128_PATH (the backward from the plain forward's lse and
# delta), one JSON line
F32_PARENT = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
from federated_pytorch_test_tpu_torch.utils import configure_precision
configure_precision()
out = {}
for aligned, (bh, s, d) in ((True, cs.LM128_PATH), (False, cs.VIT128_PATH)):
    q, k, v, do = cs.flash_inputs(bh, s, d, seed=43)
    scale = 1.0 / d ** 0.5
    o, lse = fc.flash_fwd_plain(q, k, v, scale) if aligned else fc.flash_fwd_rect_plain(q, k, v, scale)
    delta = (do * o).sum(-1)
    del o
    for precision in fc.PRECISIONS:
        if aligned:
            calls = {"fwd": lambda: fc.flash_fwd(q, k, v, scale, precision),
                     "dq": lambda: fc.flash_bwd_dq(q, k, v, do, lse, delta, scale, precision),
                     "dkv": lambda: fc.flash_bwd_dkv(q, k, v, do, lse, delta, scale, precision)}
        else:
            calls = {"fwd": lambda: fc.flash_fwd_rect(q, k, v, scale, precision=precision),
                     "dq": lambda: fc.flash_bwd_dq_rect(q, k, v, do, lse, delta, scale, precision=precision),
                     "dkv": lambda: fc.flash_bwd_dkv_rect(q, k, v, do, lse, delta, scale, precision=precision)}
        for name, fn in calls.items():
            out[f"{name} {aligned} {precision}"] = cs.time_ms(fn, 20)[1]
    del q, k, v, do, lse, delta
print("parent " + json.dumps(out))
"""


# the onepass_check cases of chip_smoke.py (phase_flash_default): (BH, Sq,
# Skv, D, causal, q_off, k_off), the aligned causal one as rectangular
# offsets 0, 0 at Sq = Skv; the forward's outputs at each are held to the
# parent checkout's in bits
ONEPASS_CASES = tuple(c for d in cs.FLASH_DIMS[:3] for c in (
    (cs.FLASH_SWEEP_BH, 1024, 1024, d, True, 0, 0), (cs.FLASH_SWEEP_BH, 256, 256, d, False, 0, 0),
    (cs.FLASH_SWEEP_BH, 256, 256, d, True, 0, 64), (cs.FLASH_SWEEP_BH, 128, 384, d, True, 256, 64)))

# the one-pass forward and dk/dv of a checkout, timed in its own process
# from that checkout's root: device ms and the digests of o and lse, of dk
# and dv at each shape of the JSON list in argv[1] (ONEPASS_SHAPES; the
# backward from the checkout's one-pass forward), and the digest of o and
# lse at each case of the JSON list in argv[2] (ONEPASS_CASES), one JSON line
ONEPASS_PARENT = """
import hashlib, json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
import torch
from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc
from federated_pytorch_test_tpu_torch.utils import configure_precision
configure_precision()
def digest(*ts):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]
out = {}
for causal, (bh, s, d) in json.loads(sys.argv[1]):
    q, k, v, do = cs.flash_inputs(bh, s, d, seed=43)
    scale = 1.0 / d ** 0.5
    if causal:
        fwd = lambda: fc.flash_fwd(q, k, v, scale, "default")
        dkv = lambda: fc.flash_bwd_dkv(q, k, v, do, lse, delta, scale, "default")
    else:
        fwd = lambda: fc.flash_fwd_rect(q, k, v, scale, precision="default")
        dkv = lambda: fc.flash_bwd_dkv_rect(q, k, v, do, lse, delta, scale, precision="default")
    o, lse = fwd()
    delta = (do * o).sum(-1)
    out[f"fwd {causal} {bh} {s} {d}"] = [cs.time_ms(fwd, 20)[1], digest(o, lse)]
    dk, dv = dkv()
    out[f"{causal} {bh} {s} {d}"] = [cs.time_ms(dkv, 20)[1], digest(dk, dv)]
    del q, k, v, do, o, lse, delta, dk, dv
for bh, s_q, s_kv, d, causal, q_off, k_off in json.loads(sys.argv[2]):
    q, k, v, _ = cs.rect_inputs(bh, s_q, s_kv, d, seed=47)
    out[f"case {bh} {s_q} {s_kv} {d} {causal} {q_off} {k_off}"] = digest(
        *fc.flash_fwd_rect(q, k, v, 1.0 / d ** 0.5, causal, q_off, k_off, precision="default"))
    del q, k, v
print("parent " + json.dumps(out))
"""


def digest(*ts) -> str:
    import hashlib

    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]


def sweep_flash_1p(parent: str = "") -> None:
    """The one-pass f32 forward (`onepass::flash_fwd_1p_tc` at D 16,
    `flash_fwd_tc` at D 32 and 64) and dk/dv (`onepass::flash_bwd_dkv_1p_tc`) through their entry
    points at every `ONEPASS_SHAPES` shape, beside the bound
    (`chip_smoke.flash_bounds`, one TF32 product) and, with `parent` (a
    checkout's root), that checkout's one-pass forward and dk/dv timed first
    in a process of its own (`ONEPASS_PARENT`), the outputs against these in
    bits, and the forward's at every `ONEPASS_CASES` case; at D 16, from the
    library built with `-DFLASH_F32_CUTS`, the dk/dv whole and with each
    attribution cut, the whole kernel's outputs against the entry point's in
    bits, and a `binds` line: the loads-only cut (the producer's side alone)
    and the no-split cut (the consumers alone) over the whole; then the
    forward's cuts (`sweep_fwd_1p_cuts`)."""
    import ctypes
    import json
    import os

    import torch

    from federated_pytorch_test_tpu_torch.ops import build
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    parent_ms = {}
    if parent:
        proc = cs.subprocess.run([sys.executable, "-c", ONEPASS_PARENT, json.dumps(ONEPASS_SHAPES),
                                  json.dumps(ONEPASS_CASES)],
                                 cwd=os.path.abspath(parent), capture_output=True, text=True)
        if proc.returncode != 0:
            cs.fail(f"sweep flash_1p: the parent checkout failed:\n{proc.stdout}{proc.stderr}")
        parent_ms = json.loads(proc.stdout.split("parent ")[-1].splitlines()[0])
    lib = build.load("flash_attention", ("FLASH_F32_CUTS",))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_bwd_dkv_1p_cut_launch.argtypes = [ptr] * 8 + [i32] * 7 + [ctypes.c_float] + [i32] + [ptr]
    stream = torch.cuda.current_stream().cuda_stream
    for causal, (bh, s, d) in ONEPASS_SHAPES:
        q, k, v, do = cs.flash_inputs(bh, s, d, seed=43)
        scale = 1.0 / d ** 0.5
        pairs = bh * s * (s + 1) // 2 if causal else bh * s * s
        operand, row = bh * s * d * 4, bh * s * 4
        label = f"BH={bh} S={s} D={d} {'causal' if causal else 'non-causal'} default"
        if causal:
            fwd = lambda: fc.flash_fwd(q, k, v, scale, "default")
            dkv = lambda: fc.flash_bwd_dkv(q, k, v, do, lse, delta, scale, "default")
        else:
            fwd = lambda: fc.flash_fwd_rect(q, k, v, scale, precision="default")
            dkv = lambda: fc.flash_bwd_dkv_rect(q, k, v, do, lse, delta, scale, precision="default")
        o, lse = fwd()
        delta = (do * o).sum(-1)
        dk_ref, dv_ref = dkv()
        bounds = {"fwd": cs.flash_bounds(4 * operand + row, 2 * 2 * d * pairs, pairs, "tf32x1")["bound_ms"],
                  "dkv": cs.flash_bounds(6 * operand + 2 * row, 4 * 2 * d * pairs, pairs, "tf32x1")["bound_ms"]}
        for kernel, outs, call in (("fwd", (o, lse), fwd), ("dkv", (dk_ref, dv_ref), dkv)):
            bound = bounds[kernel]
            shipped_ms = cs.time_ms(call, 20)[1]
            par = parent_ms.get(f"{causal} {bh} {s} {d}" if kernel == "dkv" else f"fwd {causal} {bh} {s} {d}")
            print(f"sweep flash_1p {kernel} {label} shipped device_ms={shipped_ms:.6f} bound_ms={bound:.6f} "
                  f"share_of_bound={bound / shipped_ms:.3f}"
                  + (f" parent_device_ms={par[0]:.6f} parent_over_shipped={par[0] / shipped_ms:.3f} "
                     f"bitwise_parent={par[1] == digest(*outs)}" if par else ""), flush=True)
        if d == 16:
            dk, dv = torch.empty_like(k), torch.empty_like(v)

            def cut_launch(cut):
                return lib.flash_bwd_dkv_1p_cut_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), bh, s, s, d, int(causal), 0, 0, scale, cut, stream)

            ms = {}
            for cut, cut_name in enumerate(F32_CUTS):
                if cut_launch(cut) != 0:
                    cs.fail(f"sweep flash_1p: cut {cut_name} did not launch")
                torch.cuda.synchronize()
                check = "" if cut else f" bitwise_shipped={torch.equal(dk, dk_ref) and torch.equal(dv, dv_ref)}"
                ms[cut_name] = cs.time_ms(lambda: cut_launch(cut), 20)[1]
                print(f"sweep flash_1p dkv {label} cut={cut_name} device_ms={ms[cut_name]:.6f} "
                      f"bound_ms={bounds['dkv']:.6f} share_of_bound={bounds['dkv'] / ms[cut_name]:.3f}{check}",
                      flush=True)
            print(f"sweep flash_1p dkv {label} binds loads_only_share={ms['loads_only'] / ms['full']:.3f} "
                  f"consumers_alone_share={ms['no_split'] / ms['full']:.3f}", flush=True)
            del dk, dv
        del q, k, v, do, o, lse, delta, dk_ref, dv_ref
    for case in ONEPASS_CASES:
        bh, s_q, s_kv, d, causal, q_off, k_off = case
        q, k, v, _ = cs.rect_inputs(bh, s_q, s_kv, d, seed=47)
        got = digest(*fc.flash_fwd_rect(q, k, v, 1.0 / d ** 0.5, causal, q_off, k_off, precision="default"))
        par = parent_ms.get(f"case {bh} {s_q} {s_kv} {d} {causal} {q_off} {k_off}")
        print(f"sweep flash_1p fwd case BH={bh} Sq={s_q} Skv={s_kv} D={d} causal={causal} q_off={q_off} "
              f"k_off={k_off} digest={got}" + (f" bitwise_parent={par == got}" if par else ""), flush=True)
        del q, k, v
    sweep_fwd_1p_cuts(lib)


def sweep_fwd_1p_cuts(lib) -> None:
    """`sweep_flash_1p`'s forward cuts: at the two D-16 path shapes the
    one-pass forward (`onepass::flash_fwd_1p_tc<16, ·, Cut>`,
    `flash_fwd_1p_cut_launch`); at every `ONEPASS_SHAPES` shape `flash_fwd_tc`
    at each instance the entry points run it as (`flash_fwd_tc_cut_launch`:
    split, rows 4 and 5 at D 16, and at D 32 and 64 one pass too), each
    whole and with each attribution cut, beside the bound; each whole
    kernel's o and lse against the entry point's in bits; a `binds` line of
    the loads-only and no-split shares of the whole."""
    import ctypes

    import torch

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd_1p_cut_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ctypes.c_float] + [i32] + [ptr]
    lib.flash_fwd_tc_cut_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ctypes.c_float] + [i32] * 2 + [ptr]
    stream = torch.cuda.current_stream().cuda_stream
    for causal, (bh, s, d) in ONEPASS_SHAPES:
        q, k, v, _ = cs.flash_inputs(bh, s, d, seed=43)
        scale = 1.0 / d ** 0.5
        pairs = bh * s * (s + 1) // 2 if causal else bh * s * s
        operand, row = bh * s * d * 4, bh * s * 4
        kernels = [("fwd_tc", "highest")] + ([("fwd_1p", "default")] if d == 16 else [("fwd_tc", "default")])
        for kernel, precision in kernels:
            bound = cs.flash_bounds(4 * operand + row, 2 * 2 * d * pairs, pairs,
                                    "tf32x3" if precision == "highest" else "tf32x1")["bound_ms"]
            label = f"BH={bh} S={s} D={d} {'causal' if causal else 'non-causal'} {precision}"
            if causal:
                o_ref, lse_ref = fc.flash_fwd(q, k, v, scale, precision)
            else:
                o_ref, lse_ref = fc.flash_fwd_rect(q, k, v, scale, precision=precision)
            o, lse = torch.empty_like(q), torch.empty_like(lse_ref)

            def cut_launch(cut):
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, s, s, d,
                        int(causal), 0, 0, scale)
                if kernel == "fwd_1p":
                    return lib.flash_fwd_1p_cut_launch(*args, cut, stream)
                return lib.flash_fwd_tc_cut_launch(*args, 3 if precision == "highest" else 1, cut, stream)

            ms = {}
            for cut, cut_name in enumerate(F32_CUTS):
                if cut_launch(cut) != 0:
                    cs.fail(f"sweep flash_1p: {kernel} {label} cut {cut_name} did not launch")
                torch.cuda.synchronize()
                check = "" if cut else f" bitwise_shipped={torch.equal(o, o_ref) and torch.equal(lse, lse_ref)}"
                ms[cut_name] = cs.time_ms(lambda: cut_launch(cut), 20)[1]
                print(f"sweep flash_1p fwd {label} kernel={kernel} cut={cut_name} device_ms={ms[cut_name]:.6f} "
                      f"bound_ms={bound:.6f} share_of_bound={bound / ms[cut_name]:.3f}{check}", flush=True)
            print(f"sweep flash_1p fwd {label} kernel={kernel} binds loads_only_share="
                  f"{ms['loads_only'] / ms['full']:.3f} consumers_alone_share={ms['no_split'] / ms['full']:.3f}",
                  flush=True)
            del o, lse, o_ref, lse_ref
        del q, k, v


def sweep_flash_f32(parent: str = "") -> None:
    """The head-dim-128 f32 forward (`csrc/flash_attention.cu`,
    `fwd128::flash_fwd_d128_tc`), dk/dv (`bwd128::flash_bwd_dkv_d128_tc`)
    and dq (`dq128::flash_bwd_dq_d128_tc`) at both path shapes and both
    precisions, from the library built with `-DFLASH_F32_CUTS`
    (`flash_fwd_d128_cut_launch`, `flash_bwd_dkv_d128_cut_launch`,
    `flash_bwd_dq_d128_cut_launch`): the shipped plan whole and with each
    attribution cut (no exps, no products, the consumers only waiting for
    and freeing the stages, the producer forming no operands), the other
    plan whole, each beside the shipped entry point's time and the bound (`chip_smoke.flash_bounds`); a whole plan's outputs against the
    shipped ones in bits; SDPA's f32 backward beside the dq and dk/dv. With
    `parent` (a checkout's root, e.g. the parent commit unpacked), that
    checkout's shipped forward, dq and dk/dv are timed in a process of their
    own first, at the same shapes."""
    import ctypes
    import json
    import os

    import torch

    from federated_pytorch_test_tpu_torch.ops import build
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    parent_ms = {}
    if parent:
        proc = cs.subprocess.run([sys.executable, "-c", F32_PARENT], cwd=os.path.abspath(parent),
                                 capture_output=True, text=True)
        if proc.returncode != 0:
            cs.fail(f"sweep flash_f32: the parent checkout failed:\n{proc.stdout}{proc.stderr}")
        parent_ms = json.loads(proc.stdout.split("parent ")[-1].splitlines()[0])
    lib = build.load("flash_attention", ("FLASH_F32_CUTS",))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd_d128_cut_launch.argtypes = [ptr] * 5 + [i32] * 6 + [ctypes.c_float] + [i32] * 3 + [ptr]
    lib.flash_bwd_dkv_d128_cut_launch.argtypes = [ptr] * 8 + [i32] * 6 + [ctypes.c_float] + [i32] * 3 + [ptr]
    lib.flash_bwd_dq_d128_cut_launch.argtypes = [ptr] * 7 + [i32] * 6 + [ctypes.c_float] + [i32] * 3 + [ptr]
    for aligned, (bh, s, d) in ((True, cs.LM128_PATH), (False, cs.VIT128_PATH)):
        q, k, v, _ = cs.flash_inputs(bh, s, d, seed=43)
        scale = 1.0 / d ** 0.5
        pairs = bh * s * (s + 1) // 2 if aligned else bh * s * s
        operand, row = bh * s * d * 4, bh * s * 4
        stream = torch.cuda.current_stream().cuda_stream
        label = f"BH={bh} S={s} D={d} {'causal' if aligned else 'non-causal'}"
        o, lse = torch.empty_like(q), torch.empty((bh, s), device="cuda")
        for precision in fc.PRECISIONS:
            passes = fc.passes_of(precision)
            bound = cs.flash_bounds(4 * operand + row, 2 * 2 * d * pairs, pairs,
                                    "tf32x3" if passes == 3 else "tf32x1")["bound_ms"]
            if aligned:
                shipped = lambda: fc.flash_fwd(q, k, v, scale, precision)
            else:
                shipped = lambda: fc.flash_fwd_rect(q, k, v, scale, precision=precision)
            o_ref, lse_ref = shipped()
            shipped_ms = cs.time_ms(shipped, 20)[1]
            par = parent_ms.get(f"fwd {aligned} {precision}")
            print(f"sweep flash_f32 {label} {precision} shipped device_ms={shipped_ms:.6f} bound_ms={bound:.6f} "
                  f"share_of_bound={bound / shipped_ms:.3f}"
                  + (f" parent_device_ms={par:.6f} parent_over_shipped={par / shipped_ms:.3f}" if par else ""),
                  flush=True)
            for plan, plan_name in enumerate(F32_PLANS):
                for cut, cut_name in enumerate(F32_CUTS):
                    def fwd():
                        return lib.flash_fwd_d128_cut_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                                             lse.data_ptr(), bh, s, s, int(aligned), 0, 0, scale,
                                                             passes, plan, cut, stream)

                    if fwd() != 0:
                        continue  # no instance of this plan and cut
                    torch.cuda.synchronize()
                    check = "" if cut else f" bitwise_shipped={torch.equal(o, o_ref) and torch.equal(lse, lse_ref)}"
                    _, device_ms = cs.time_ms(fwd, 20)
                    print(f"sweep flash_f32 {label} {precision} plan={plan_name} cut={cut_name} "
                          f"device_ms={device_ms:.6f} bound_ms={bound:.6f} share_of_bound={bound / device_ms:.3f}"
                          f"{check}", flush=True)
            del o_ref, lse_ref
        del o, lse
        sweep_bwd_d128(lib, aligned, (bh, s, d), (q, k, v), parent_ms)
        del q, k, v


def sweep_bwd_d128(lib, aligned: bool, shape, qkv, parent_ms: dict) -> None:
    """`sweep_flash_f32`'s backward part at one path shape: SDPA's f32
    backward, then for the dk/dv and the dq the shipped kernel beside its
    bound, the parent's time and the D-128 pair (dq + dk/dv) over SDPA, then
    each plan and cut of its `flash_bwd_*_d128_cut_launch`."""
    import torch
    import torch.nn.functional as F

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    bh, s, d = shape
    q, k, v = qkv
    do = cs.flash_inputs(bh, s, d, seed=43)[3]
    scale = 1.0 / d ** 0.5
    o, lse = fc.flash_fwd_plain(q, k, v, scale) if aligned else fc.flash_fwd_rect_plain(q, k, v, scale)
    delta = (do * o).sum(-1)
    del o
    pairs = bh * s * (s + 1) // 2 if aligned else bh * s * s
    operand, row = bh * s * d * 4, bh * s * 4
    label = f"BH={bh} S={s} D={d} {'causal' if aligned else 'non-causal'}"
    q4, k4, v4 = (t.detach().view(1, bh, s, d).requires_grad_(True) for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=aligned)
    sdpa_ms = cs.time_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), do.view(1, bh, s, d), retain_graph=True),
                         20)[1]
    del q4, k4, v4, o4
    print(f"sweep flash_f32 {label} sdpa_bwd device_ms={sdpa_ms:.6f}", flush=True)
    # per kernel: its outputs, plans, cut entry point, output bytes and products
    kernels = {"dkv": ((torch.empty_like(k), torch.empty_like(v)), DKV_PLANS, lib.flash_bwd_dkv_d128_cut_launch,
                       2 * operand, 4),
               "dq": ((torch.empty_like(q),), DQ_PLANS, lib.flash_bwd_dq_d128_cut_launch, operand, 3)}
    stream = torch.cuda.current_stream().cuda_stream
    for precision in fc.PRECISIONS:
        passes = fc.passes_of(precision)
        if aligned:
            shipped = {"dkv": lambda: fc.flash_bwd_dkv(q, k, v, do, lse, delta, scale, precision),
                       "dq": lambda: (fc.flash_bwd_dq(q, k, v, do, lse, delta, scale, precision),)}
        else:
            shipped = {"dkv": lambda: fc.flash_bwd_dkv_rect(q, k, v, do, lse, delta, scale, precision=precision),
                       "dq": lambda: (fc.flash_bwd_dq_rect(q, k, v, do, lse, delta, scale, precision=precision),)}
        refs = {name: fn() for name, fn in shipped.items()}
        shipped_ms = {name: cs.time_ms(fn, 20)[1] for name, fn in shipped.items()}
        pair = (shipped_ms["dkv"] + shipped_ms["dq"]) / sdpa_ms
        for name, (outs, plans, cut_launch, out_bytes, n_products) in kernels.items():
            bound = cs.flash_bounds(4 * operand + 2 * row + out_bytes, n_products * 2 * d * pairs, pairs,
                                    "tf32x3" if passes == 3 else "tf32x1")["bound_ms"]
            ms, par = shipped_ms[name], parent_ms.get(f"{name} {aligned} {precision}")
            print(f"sweep flash_f32 {name} {label} {precision} shipped device_ms={ms:.6f} bound_ms={bound:.6f} "
                  f"share_of_bound={bound / ms:.3f} pair_over_sdpa={pair:.3f}"
                  + (f" parent_device_ms={par:.6f} parent_over_shipped={par / ms:.3f}" if par else ""), flush=True)
            for plan, plan_name in enumerate(plans):
                for cut, cut_name in enumerate(F32_CUTS):
                    def call():
                        return cut_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                          delta.data_ptr(), *(t.data_ptr() for t in outs), bh, s, s, int(aligned), 0,
                                          0, scale, passes, plan, cut, stream)

                    if call() != 0:
                        continue  # no instance of this plan and cut
                    torch.cuda.synchronize()
                    check = "" if cut else \
                        f" bitwise_shipped={all(torch.equal(a, b) for a, b in zip(outs, refs[name]))}"
                    _, device_ms = cs.time_ms(call, 20)
                    print(f"sweep flash_f32 {name} {label} {precision} plan={plan_name} cut={cut_name} "
                          f"device_ms={device_ms:.6f} bound_ms={bound:.6f} share_of_bound={bound / device_ms:.3f}"
                          f"{check}", flush=True)
        del refs
    del do, lse, delta, kernels


def scale64_step(direction: str, source, gid: int) -> None:
    """One optimizer step of fedavg_scale64's round of group `gid` with the
    `direction` backend, from a fresh Trainer; every tensor it made is
    freed when it returns."""
    import torch

    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step, epoch_batches, round_init

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(get_preset("fedavg_scale64", lbfgs_direction=direction), verbose=False, source=source)
    ctx = tr.ctx(gid)
    state, _ = round_init(ctx, tr.flat)
    imgs, labels = next(epoch_batches(tr.shard_imgs, tr.shard_labels, tr.epoch_indices(0, gid, 0, 0)))
    t0 = time.perf_counter()
    client_train_step(ctx, tr.flat, state, tr.stats, imgs, labels, tr.mean, tr.std)
    torch.cuda.synchronize()
    print(f"sweep scale64 direction={direction} K={tr.cfg.n_clients} N={tr.partition.group_size(gid)} "
          f"step_s={time.perf_counter() - t0:.3f} peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} "
          f"fits=True", flush=True)


def sweep_scale64() -> None:
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar

    source = synthetic_cifar(cs.SCALE64_TRAIN, cs.SCALE64_TEST, num_classes=100, seed=0)
    for direction in ("pallas", "compact"):
        try:
            scale64_step(direction, source, gid=8)  # block7
        except torch.cuda.OutOfMemoryError as e:
            print(f"sweep scale64 direction={direction} fits=False "
                  f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} ({str(e).splitlines()[0]})", flush=True)


DETERMINISM_TRAIN, DETERMINISM_TEST = 3_072, 500  # images of the determinism sweep's runs


def deterministic_path(label: str, run) -> None:
    """`run()` under `torch.use_deterministic_algorithms(True, warn_only=True)`:
    each op PyTorch warns about, printed with its count."""
    import warnings
    from collections import Counter

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    ops = Counter(str(w.message).splitlines()[0] for w in caught if "determinis" in str(w.message))
    print(f"sweep determinism {label} s={wall:.3f} ops_warned={len(ops)}", flush=True)
    for msg, n in sorted(ops.items()):
        print(f"sweep determinism {label} x{n}: {msg}", flush=True)


def sweep_determinism() -> None:
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig

    def trainer(cfg, source, order=None):
        def run():
            tr = Trainer(cfg, verbose=False, source=source)
            if order is not None:
                tr.group_order = order
            tr.run()
        return run

    small = synthetic_cifar(DETERMINISM_TRAIN, DETERMINISM_TEST, seed=0)
    one = dict(nloop=1, nadmm=1, lbfgs_direction="pallas")
    deterministic_path("fedavg conv1", trainer(get_preset("fedavg", **one), small, [0]))
    deterministic_path("admm conv1", trainer(get_preset("admm", **{**one, "nadmm": 2}), small, [0]))
    deterministic_path("no_consensus", trainer(get_preset("no_consensus", nepoch=1, lbfgs_direction="pallas"), small))
    deterministic_path("admm_resnet conv1", trainer(get_preset("admm_resnet", **one), small, [0]))
    deterministic_path("lm embedding", lambda: FederatedLM(LMConfig(max_groups=1), verbose=False).run())
    for label, kwargs, dtype in (("vit", cs.VIT_KWARGS, "float32"), ("vit_moe", cs.VIT_MOE_KWARGS, "float32"),
                                 ("vit_moe_bf16", cs.VIT_MOE_BF16_KWARGS, "bfloat16")):
        deterministic_path(f"{label} block0", trainer(
            get_preset("fedavg", model="vit", model_kwargs=kwargs, compute_dtype=dtype, **one), small, [1]))


CUDNN_TURNS = ("deterministic", "default", "default", "deterministic")


def cudnn_turns(label: str, build, run) -> None:
    """`run(build())` in CUDNN_TURNS, each turn a fresh object from `build`
    with `cudnn.deterministic` set after it; the wall and peak of each."""
    import gc

    import torch

    for mode in CUDNN_TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        obj = build()
        torch.backends.cudnn.deterministic = mode == "deterministic"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(obj)
        torch.cuda.synchronize()
        print(f"sweep cudnn {label} mode={mode} wall_s={time.perf_counter() - t0:.3f} "
              f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f}", flush=True)
        del obj
    torch.backends.cudnn.deterministic = True


def sweep_cudnn() -> None:
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset

    def trainer(cfg, source, order=None):
        def build():
            tr = Trainer(cfg, verbose=False, source=source)
            if order is not None:
                tr.group_order = order
            return tr
        return build

    cudnn_turns("fedavg loop", trainer(get_preset("fedavg", nloop=1, lbfgs_direction="pallas"),
                                       synthetic_cifar(50_000, 10_000, seed=0)), lambda tr: tr.run())
    cudnn_turns("admm_resnet block7 round", trainer(get_preset("admm_resnet", nloop=1, lbfgs_direction="pallas"),
                                                    synthetic_cifar(cs.RESNET_TRAIN, cs.RESNET_TEST, seed=0), [8]),
                lambda tr: tr.run())
    cudnn_turns("fedavg_scale64 block7 round",
                trainer(get_preset("fedavg_scale64", nloop=1, nadmm=1, lbfgs_direction="pallas"),
                        synthetic_cifar(cs.SCALE64_TRAIN, cs.SCALE64_TEST, num_classes=100, seed=0), [8]),
                lambda tr: tr.run())


def main() -> int:
    import os

    import torch

    if "determinism" in sys.argv[1:] or not sys.argv[1:]:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before the first cuBLAS handle
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: the sweeps need an NVIDIA GPU")
    from federated_pytorch_test_tpu_torch.utils import configure_precision

    configure_precision()
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    args = sys.argv[1:]
    parent = ""
    if "--parent" in args:  # flash_1p's and flash_f32's parent checkout
        i = args.index("--parent")
        parent = args[i + 1]
        del args[i:i + 2]
    sweeps = {"grouped": sweep_grouped, "grouped_bf16": sweep_grouped_bf16, "gram": sweep_gram, "assembly": sweep_assembly, "bf16": sweep_bf16,
              "flash_1p": lambda: sweep_flash_1p(parent), "flash_f32": lambda: sweep_flash_f32(parent),
              "scale64": sweep_scale64, "determinism": sweep_determinism, "cudnn": sweep_cudnn}
    for name in args or sweeps:
        if name not in sweeps:
            cs.fail(f"unknown sweep {name!r}; have {sorted(sweeps)}")
        sweeps[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
