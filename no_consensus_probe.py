#!/usr/bin/env python3
"""Where a no_consensus client turns non-finite, on the card (one NVIDIA GPU).

Run from the root of a checkout:

    python3 no_consensus_probe.py [--runs 6] [--epochs 2] [--deterministic] [--poison]

Each run trains the `no_consensus` preset (Net1, K=3, batch 32, the whole
vector of 890,410 one group, the fc1 elastic net) with the kernel
direction (`pallas`), as `chip_smoke.py` phase 18 does, on the full-size
synthetic stand-in, step by step through `client_train_step`, for the
first `--epochs` epochs of its first round, in a fresh Trainer. After every
step it checks each client's loss and parameters. A run that stays finite
prints its final losses and a checksum of the parameters (two runs with
equal checksums took the same trajectory). At the first non-finite step
the run prints the preceding steps of that client (data loss, largest
parameter, h_diag, step size, history count) and replays the step from the
saved state with every direction and every objective evaluation of that
client printed: the direction's norm against the compact direction
computed in float64, g·d, and the history's y·s, s·s and y·y a slot.

`--deterministic` runs cuDNN in its deterministic mode. `--poison` first
fills the caching allocator with NaN, so that a read of memory nobody
wrote shows as NaN. Without CUDA the script exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
import time

DIRECTION = "pallas"  # the kernel direction, as chip_smoke.py phase 18 runs it


def clone_state(st):
    return type(st)(*[v.clone() if hasattr(v, "clone") else v for v in st])


def run(args) -> bool:
    """One run; True if every step stayed finite."""
    import numpy as np
    import torch

    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
    from federated_pytorch_test_tpu_torch.engine import steps as st

    cfg = get_preset("no_consensus", lbfgs_direction=DIRECTION, nepoch=args.epochs)
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(50_000, 10_000, seed=0))
    ctx = tr.ctx(0)
    lstate, _ = st.round_init(ctx, tr.flat)
    idx = np.concatenate([tr.epoch_indices(0, 0, 0, e) for e in range(args.epochs)])
    batches = list(st.epoch_batches(tr.shard_imgs, tr.shard_labels, idx))
    flat, stats, ring = tr.flat, tr.stats, []
    t0 = time.perf_counter()
    for s, (images, labels) in enumerate(batches):
        prev = (flat.clone(), clone_state(lstate))
        flat, lstate, stats, loss = st.client_train_step(ctx, flat, lstate, stats, images, labels, tr.mean, tr.std)
        ring = (ring + [dict(step=s, data_loss=loss.tolist(), x_max=flat.abs().amax(1).tolist(),
                             h_diag=lstate.h_diag.tolist(), t=lstate.t.tolist(),
                             count=lstate.hist_count.tolist())])[-12:]
        bad = ~torch.isfinite(loss) | ~torch.isfinite(flat).all(1)
        if bool(bad.any()):
            break
    else:
        torch.cuda.synchronize()
        print(f"run finite steps={len(batches)} s={time.perf_counter() - t0:.1f} final_data_loss={loss.tolist()} "
              f"checksum={[float(v) for v in flat.double().sum(1)]}", flush=True)
        return True
    c = int(torch.nonzero(bad)[0])
    print(f"run NONFINITE step={s} client={c} of {len(batches)}", flush=True)
    for r in ring:
        print("  before " + " ".join(f"{k}={v[c] if isinstance(v, list) else v}" for k, v in r.items()), flush=True)
    replay(ctx, tr, prev, batches[s], stats, c)
    return False


def replay(ctx, tr, prev, batch, stats, c) -> None:
    """The step again from its saved state, client `c`'s directions and
    objective evaluations printed."""
    from federated_pytorch_test_tpu_torch.engine import steps as st
    from federated_pytorch_test_tpu_torch.optim import lbfgs
    from federated_pytorch_test_tpu_torch.optim.compact import compact_direction

    evals, dirs = [], []
    objective, direction_fn = st.objective, lbfgs.DIRECTIONS[DIRECTION]

    def traced_objective(*a, **kw):
        out = objective(*a, **kw)
        evals.append(f"  eval objective={out[0][c].item():.6e} data_loss={out[1][c].item():.6e} "
                     f"x_max={a[2][c].abs().max().item():.4e}")
        return out

    def traced_direction(g, s_hist, y_hist, count, h_diag):
        d = direction_fn(g, s_hist, y_hist, count, h_diag)
        d64 = compact_direction(g.double(), s_hist.double(), y_hist.double(), count, h_diag.double())
        s64, y64 = s_hist[c].double(), y_hist[c].double()
        err = (d[c].double() - d64[c]).abs().max() / d64[c].abs().max().clamp_min(1e-300)

        def row(v):
            return ",".join(f"{x:.3e}" for x in v.tolist())

        dirs.append(f"  direction after eval {len(evals)}: count={int(count[c])} h_diag={float(h_diag[c]):.6e} "
                    f"|g|={float(g[c].norm()):.6e} |d|={float(d[c].norm()):.6e} |d_f64|={float(d64[c].norm()):.6e} "
                    f"rel_vs_f64={float(err):.3e} g.d={float((g[c] * d[c]).sum()):.6e}\n"
                    f"    y.s={row((s64 * y64).sum(-1))}\n    s.s={row((s64 * s64).sum(-1))}\n"
                    f"    y.y={row((y64 * y64).sum(-1))}")
        return d

    st.objective, lbfgs.DIRECTIONS[DIRECTION] = traced_objective, traced_direction
    try:
        flat0, lstate0 = prev
        out = st.client_train_step(ctx, flat0.clone(), clone_state(lstate0), stats, *batch, tr.mean, tr.std)
    finally:
        st.objective, lbfgs.DIRECTIONS[DIRECTION] = objective, direction_fn
    print(f"replay data_loss={out[3].tolist()}", flush=True)
    print("\n".join(dirs), flush=True)
    print("\n".join(evals), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--deterministic", action="store_true", help="cuDNN's deterministic mode")
    ap.add_argument("--poison", action="store_true", help="fill the caching allocator with NaN first")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL no CUDA device", flush=True)
        return 1
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = args.deterministic, False
    if args.poison:
        junk = torch.full((30 * 2**30 // 4,), float("nan"), device="cuda")  # 30 GiB, back to the cache
        del junk
    print(f"probe direction={DIRECTION} epochs={args.epochs} deterministic={args.deterministic} "
          f"poison={args.poison}", flush=True)
    finite = [run(args) for _ in range(args.runs)]
    print(f"probe runs={len(finite)} finite={sum(finite)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
