#!/usr/bin/env python3
"""Sweeps of the port's kernel tunables on the card (one NVIDIA GPU).

Run from the root of a checkout:

    python3 chip_sweep.py

Two sweeps, each printed one line per setting with its device ms (calls
queued behind a sleep kernel, `chip_smoke.time_ms`) and its error:

1. grouped — the grouped GEMM (`ops/grouped_gemm.py`) at every MoE ViT path
   shape (`chip_smoke.grouped_cases`) with each output tile the kernel has
   (128 x 64, 64 x 128) and, for the weight gradients, split chunks of
   512 … 4,096 slots (the split sum included), against `torch.bmm` in
   float64;
2. gram — the one-launch gram (`ops/compact_cuda.py`) at every Net group
   size and a ResNet18-block N, with at most 16 … 128 blocks a client,
   against the shipped setting's result.

The port's own settings (`grouped_gemm.tiles`, `SPLIT_CHUNK`,
`compact_cuda.gram_chunks`) are not changed: each setting is launched
through the kernels' C entry points directly. Without CUDA the script exits
non-zero.
"""

from __future__ import annotations

import math
import sys

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: the sweeps need an NVIDIA GPU")
    from federated_pytorch_test_tpu_torch.utils import configure_precision

    configure_precision()
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sweep_grouped()
    sweep_gram()
    return 0


if __name__ == "__main__":
    sys.exit(main())
