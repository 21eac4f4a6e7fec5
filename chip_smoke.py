#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`federated_pytorch_test_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--metrics-out PATH] [--profile]

Phases, each reported on its own lines; any failure exits non-zero:

1. card     — `nvidia-smi` name and power limit;
2. build    — nvcc builds the port's CUDA source;
3. kernels  — each hand-written kernel against its plain PyTorch version
              on the card (K=3, m=10, N at every Net group size, one
              ResNet18-block-sized N, counts {0, 3, 10}, a zero-curvature
              slot and a NaN-filled invalid row), relative 1e-5 of the
              largest reference entry; times of the kernel, the plain
              version, one PyTorch library call computing the same function
              (a yardstick the port never calls) and the bytes bound. Each
              time is taken twice: per call as the caller sees it, host
              launch path included (`ms`), and on the device alone with
              the calls queued behind a sleep kernel (`device_ms`);
4. parity   — a tiny drive with the plain ('compact') and the fused-kernel
              ('pallas') direction on the card: the first averaging round's
              losses and dual residual agree within relative 1e-3;
5. train    — the main path: the fedavg preset (Net, K=3, batch 512) on the
              full-size synthetic CIFAR-10 stand-in (50,000/10,000, seed 0)
              with the fused-kernel direction, one outer loop over all five
              groups, nadmm=3. Launch counts are zeroed just before and read
              just after; every kernel must have launched, losses must be
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

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
M, K = 10, 3
NET_GROUP_SIZES = (456, 2416, 48120, 10164, 850)
LARGE_N = 4_720_644  # ~ResNet18's largest block group; not a multiple of any tile
REPORT_N = 48120  # the main path's largest group (fc1): the shape the JSON line reports
RTOL = 1e-5
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
    """Kernel time by name and the device's busy share over one epoch."""
    import torch
    import warnings

    from torch.profiler import ProfilerActivity, profile as tprofile

    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")

    from federated_pytorch_test_tpu_torch.engine.steps import round_init, run_epoch

    ctx = tr.ctx(tr.group_order[0])
    idx = tr.epoch_indices(99, ctx.gid, 0, 0)

    def epoch():
        lstate, _ = round_init(ctx, tr.flat)
        run_epoch(ctx, tr.flat.clone(), lstate, tr.shard_imgs, tr.shard_labels, idx, tr.mean, tr.std)
        torch.cuda.synchronize()

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
    print(f"profile group={ctx.gid} epoch wall_ms={wall_us / 1e3:.3f} profiled_wall_ms={prof_wall_us / 1e3:.3f} "
          f"device_busy_ms={busy_us / 1e3:.3f} idle_share={max(0.0, 1 - busy_us / wall_us):.4f}", flush=True)
    for e in sorted(events, key=lambda e: -self_us(e))[:12]:
        print(f"profile kernel={e.key[:70]!r} calls={e.count} self_device_ms={self_us(e) / 1e3:.3f}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--metrics-out", help="write the main path's metric series as JSON here")
    ap.add_argument("--profile", action="store_true", help="also profile one epoch of the main path")
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

    t0 = time.perf_counter()
    lib = build.build("compact_direction")
    print(f"build {lib.name} seconds={time.perf_counter() - t0:.3f}", flush=True)

    report = phase_kernels()
    phase_parity()
    launches, wall = phase_train(args.metrics_out, args.profile)

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
    print(f"total seconds={time.perf_counter() - t_all:.3f} train_wall_s={wall:.3f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
