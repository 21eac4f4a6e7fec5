#!/usr/bin/env python3
"""Sweeps of the port's kernel tunables on the card (one NVIDIA GPU).

Run from the root of a checkout:

    python3 chip_sweep.py [grouped] [gram] [assembly] [bf16] [scale64]

Five sweeps (all of them without arguments), each printed one line per
setting with its device ms (calls queued behind a sleep kernel,
`chip_smoke.time_ms`) and its error:

1. grouped — the grouped GEMM (`ops/grouped_gemm.py`) at every MoE ViT path
   shape (`chip_smoke.grouped_cases`) with each output tile the kernel has
   (128 x 64, 64 x 128) and, for the weight gradients, split chunks of
   512 … 4,096 slots (the split sum included), against `torch.bmm` in
   float64;
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
   at both `chip_smoke.BF16_PATHS`, from the library built with
   `-DFLASH_BF16_CUTS` (`flash_*_bf16_cut_launch`): the forward and dq at
   every key tile they have, each kernel whole and with its attribution
   cuts (no exps, no products, loads only, products only), each beside its
   bound (`chip_smoke.flash_bounds`); a whole kernel's outputs within two
   bf16 units of its plain version (the forward's at that tile;
   `chip_smoke.bf16_units`);
5. scale64 — the direction backends (`lbfgs_direction`) at the largest
   scale64 shape: one optimizer step of fedavg_scale64's block7 round (K=64
   ResNet18 clients, N = 4,720,640) with 'pallas', then 'compact', each
   from a fresh Trainer: its wall and peak allocated memory, or that it
   ran out of the card's memory (no device time; a step, not a kernel).

The port's own settings (`grouped_gemm.tiles`, `SPLIT_CHUNK`,
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


BF16_CUTS = ("full", "no_exp", "no_mma", "loads_only", "mma_only")  # kFull … kMmaOnly in csrc/flash_bf16.cu
BF16_KEYS = (64, 128)  # the forward's and dq's candidate key tiles


def sweep_bf16() -> None:
    import ctypes

    import torch

    from federated_pytorch_test_tpu_torch.ops import build
    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    lib = build.load("flash_bf16", ("FLASH_BF16_CUTS",))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd_bf16_cut_launch.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.flash_bwd_dq_bf16_cut_launch.argtypes = [ptr] * 7 + [i32] * 3 + [ctypes.c_float] + [i32] * 2 + [ptr]
    lib.flash_bwd_dkv_bf16_cut_launch.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
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
        for keys in BF16_KEYS:
            want = fc.flash_fwd_bf16_plain(qs, k16, v16, keys=keys)
            for cut, cut_name in enumerate(BF16_CUTS):
                def fwd():
                    return lib.flash_fwd_bf16_cut_launch(qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), o.data_ptr(),
                                                         lse.data_ptr(), bh, s, d, keys, cut, stream)

                if fwd() != 0:
                    print(f"sweep bf16 fwd {label} keys={keys} cut={cut_name} no instance", flush=True)
                    continue
                _, device_ms = cs.time_ms(fwd, 20)
                check = "" if cut else (f" o_units={cs.bf16_units(o, want[0]):.3f} "
                                        f"lse_units={cs.bf16_units(lse, want[1]):.3f}")
                print(f"sweep bf16 fwd {label} keys={keys} cut={cut_name} device_ms={device_ms:.6f} "
                      f"bound_ms={bound_fwd:.6f} share_of_bound={bound_fwd / device_ms:.3f}{check}", flush=True)
        for keys in BF16_KEYS:
            for cut, cut_name in enumerate(BF16_CUTS):
                def dq_call():
                    return lib.flash_bwd_dq_bf16_cut_launch(qs.data_ptr(), k16.data_ptr(), v16.data_ptr(),
                                                            do16.data_ptr(), lse_ref.data_ptr(), delta.data_ptr(),
                                                            dq.data_ptr(), bh, s, d, scale, keys, cut, stream)

                if dq_call() != 0:
                    print(f"sweep bf16 dq {label} keys={keys} cut={cut_name} no instance", flush=True)
                    continue
                _, device_ms = cs.time_ms(dq_call, 20)
                check = "" if cut else f" dq_units={cs.bf16_units(dq, dq_ref):.3f}"
                print(f"sweep bf16 dq {label} keys={keys} cut={cut_name} device_ms={device_ms:.6f} "
                      f"bound_ms={bound_dq:.6f} share_of_bound={bound_dq / device_ms:.3f}{check}", flush=True)
        for cut, cut_name in enumerate(BF16_CUTS):
            def dkv():
                return lib.flash_bwd_dkv_bf16_cut_launch(qs.data_ptr(), k16.data_ptr(), v16.data_ptr(), do16.data_ptr(),
                                                         lse_ref.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                                         dv.data_ptr(), bh, s, d, cut, stream)

            if dkv() != 0:
                print(f"sweep bf16 dkv {label} cut={cut_name} no instance", flush=True)
                continue
            _, device_ms = cs.time_ms(dkv, 20)
            check = "" if cut else (f" dk_units={cs.bf16_units(dk, dk_ref):.3f} "
                                    f"dv_units={cs.bf16_units(dv, dv_ref):.3f}")
            print(f"sweep bf16 dkv {label} cut={cut_name} device_ms={device_ms:.6f} bound_ms={bound_dkv:.6f} "
                  f"share_of_bound={bound_dkv / device_ms:.3f}{check}", flush=True)
        del q16, k16, v16, qs, do, do16, o_ref, lse_ref, delta, dq_ref, dk_ref, dv_ref, o, lse, dq, dk, dv


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: the sweeps need an NVIDIA GPU")
    from federated_pytorch_test_tpu_torch.utils import configure_precision

    configure_precision()
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sweeps = {"grouped": sweep_grouped, "gram": sweep_gram, "assembly": sweep_assembly, "bf16": sweep_bf16,
              "scale64": sweep_scale64}
    for name in sys.argv[1:] or sweeps:
        if name not in sweeps:
            cs.fail(f"unknown sweep {name!r}; have {sorted(sweeps)}")
        sweeps[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
