"""Command line: `python -m federated_pytorch_test_tpu_torch --preset NAME [...]`.

Presets: fedavg, admm (Net), fedavg_resnet, admm_resnet (ResNet18).
Runs on the card unless `--device cpu` is given; `--lbfgs-direction
pallas` opts into the fused compact-direction kernels. Examples:

    python -m federated_pytorch_test_tpu_torch --preset admm --lbfgs-direction pallas
    python -m federated_pytorch_test_tpu_torch --preset admm_resnet --lbfgs-direction pallas
    python -m federated_pytorch_test_tpu_torch --preset fedavg --device cpu \\
        --synthetic-n-train 240 --synthetic-n-test 60 --batch 40 --nloop 1 --nadmm 2 --max-groups 2
"""

from __future__ import annotations

import argparse
import sys

from .engine import PRESETS, Trainer, get_preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m federated_pytorch_test_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="fedavg", choices=sorted(PRESETS))
    p.add_argument("--lbfgs-direction", choices=["compact", "pallas"])
    for name in ("nloop", "nadmm", "batch", "max-groups", "synthetic-n-train", "synthetic-n-test"):
        p.add_argument(f"--{name}", type=int)
    p.add_argument("--device", help="'cuda' (default), 'cuda:N' or 'cpu'")
    p.add_argument("--metrics-out", help="write the metric series as JSON here")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    overrides = {}
    for field in ("lbfgs_direction", "nloop", "nadmm", "batch", "max_groups",
                  "synthetic_n_train", "synthetic_n_test", "device"):
        if getattr(args, field) is not None:
            overrides[field] = getattr(args, field)
    cfg = get_preset(args.preset, **overrides)
    rec = Trainer(cfg, verbose=not args.quiet).run()
    if args.metrics_out:
        rec.save(args.metrics_out)
    return 0 if rec.first_nonfinite is None else 1


if __name__ == "__main__":
    sys.exit(main())
