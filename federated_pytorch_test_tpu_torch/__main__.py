"""Command line: `python -m federated_pytorch_test_tpu_torch --preset NAME [...]`.

Presets: no_consensus (Net1, independent training), fedavg, admm (Net),
fedavg_resnet, admm_resnet (ResNet18). Runs on the card unless `--device
cpu` is given; `--lbfgs-direction pallas` opts into the fused
compact-direction kernels, `two_loop` into the sequential recursion.
`--save-model` checkpoints the full state under `--checkpoint-dir` after
every outer loop; `--load-model` continues from the newest checkpoint there
(and requires one), `--resume auto` does so when there is one. Examples:

    python -m federated_pytorch_test_tpu_torch --preset no_consensus --lbfgs-direction pallas
    python -m federated_pytorch_test_tpu_torch --preset admm --lbfgs-direction pallas
    python -m federated_pytorch_test_tpu_torch --preset admm_resnet --lbfgs-direction pallas
    python -m federated_pytorch_test_tpu_torch --preset fedavg --device cpu \\
        --synthetic-n-train 240 --synthetic-n-test 60 --batch 40 --nloop 1 --nadmm 2 --max-groups 2
    python -m federated_pytorch_test_tpu_torch --preset no_consensus --device cpu \\
        --synthetic-n-train 240 --synthetic-n-test 60 --batch 40 --nepoch 2 --eval-every-batch

A save/resume pair (the second run continues with loop 1 of 2):

    python -m federated_pytorch_test_tpu_torch --preset fedavg --device cpu --synthetic-n-train 240 \\
        --synthetic-n-test 60 --batch 40 --nloop 1 --max-groups 2 --save-model --checkpoint-dir ckpt
    python -m federated_pytorch_test_tpu_torch --preset fedavg --device cpu --synthetic-n-train 240 \\
        --synthetic-n-test 60 --batch 40 --nloop 2 --max-groups 2 --load-model --checkpoint-dir ckpt
"""

from __future__ import annotations

import argparse
import sys

from .engine import PRESETS, Trainer, get_preset
from .optim.lbfgs import DIRECTIONS

INT_FLAGS = ("nloop", "nepoch", "nadmm", "batch", "max_groups", "synthetic_n_train", "synthetic_n_test")
BOOL_FLAGS = ("save_model", "load_model", "eval_every_batch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m federated_pytorch_test_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="fedavg", choices=sorted(PRESETS))
    p.add_argument("--lbfgs-direction", choices=sorted(DIRECTIONS))
    for name in INT_FLAGS:
        p.add_argument("--" + name.replace("_", "-"), type=int)
    for name in BOOL_FLAGS:
        p.add_argument("--" + name.replace("_", "-"), action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--checkpoint-dir")
    p.add_argument("--resume", choices=["off", "auto"])
    p.add_argument("--device", help="'cuda' (default), 'cuda:N' or 'cpu'")
    p.add_argument("--metrics-out", help="write the metric series as JSON here")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    fields = ("lbfgs_direction", *INT_FLAGS, *BOOL_FLAGS, "checkpoint_dir", "resume", "device")
    overrides = {f: getattr(args, f) for f in fields if getattr(args, f) is not None}
    cfg = get_preset(args.preset, **overrides)
    rec = Trainer(cfg, verbose=not args.quiet).run()
    if args.metrics_out:
        rec.save(args.metrics_out)
    return 0 if rec.first_nonfinite is None else 1


if __name__ == "__main__":
    sys.exit(main())
