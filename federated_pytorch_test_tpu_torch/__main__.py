"""Command line: `python -m federated_pytorch_test_tpu_torch --preset NAME [...]`.

Presets: no_consensus (Net1, independent training), fedavg, admm (Net),
fedavg_resnet, admm_resnet (ResNet18), fedavg_scale64, admm_scale64 (64
ResNet18 clients on CIFAR-100); `--list-presets` prints them. Every
field of `ExperimentConfig` is a flag, `--` + the field with `_` as `-`,
booleans as `--x/--no-x`; a flag left out keeps the preset's value. Runs on
the card unless `--device cpu` is given; `--lbfgs-direction pallas` opts into the fused
compact-direction kernels, `two_loop` into the sequential recursion;
`--linesearch-probes P` evaluates the Armijo ladder in fans of P step sizes
a batched pass (`--client-fold gemm|vmap`); `--average-model` starts every
client from the clients' mean; `--no-synthetic-ok` refuses the synthetic
stand-in when no CIFAR archive is found.
`--save-model` checkpoints the full state under `--checkpoint-dir` after
every outer loop; `--load-model` continues from the newest checkpoint there
(and requires one), `--resume auto` does so when there is one.

Exit code: 0 when the run ends, also when a series turned non-finite; that
run prints `# FIRST NON-FINITE at {...}` (the JAX package's CLI does the
same). Examples:

    python -m federated_pytorch_test_tpu_torch --preset admm --nloop 2 --no-bb-update
    python -m federated_pytorch_test_tpu_torch --list-presets
    python -m federated_pytorch_test_tpu_torch --preset no_consensus --lbfgs-direction pallas
    python -m federated_pytorch_test_tpu_torch --preset admm --lbfgs-direction pallas
    python -m federated_pytorch_test_tpu_torch --preset admm_resnet --lbfgs-direction pallas
    python -m federated_pytorch_test_tpu_torch --preset fedavg_scale64 --lbfgs-direction pallas
    python -m federated_pytorch_test_tpu_torch --preset fedavg --linesearch-probes 4 --lbfgs-direction pallas
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
import dataclasses
import sys

from .engine import PRESETS, ExperimentConfig, Trainer, get_preset


def _add_config_flags(parser: argparse.ArgumentParser) -> None:
    """One flag per `ExperimentConfig` field (booleans get --x/--no-x), all
    defaulting to None: an absent flag leaves the preset's value."""
    for f in dataclasses.fields(ExperimentConfig):
        flag = "--" + f.name.replace("_", "-")
        ts = str(f.type)
        if ts == "bool":
            parser.add_argument(flag, dest=f.name, action=argparse.BooleanOptionalAction, default=None)
            continue
        typ = {"int": int, "float": float, "int | None": int, "float | None": float}.get(ts, str)
        parser.add_argument(flag, dest=f.name, type=typ, default=None)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m federated_pytorch_test_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="fedavg", choices=sorted(PRESETS))
    p.add_argument("--list-presets", action="store_true")
    p.add_argument("--metrics-out", help="write the metric series as JSON here")
    p.add_argument("--quiet", action="store_true")
    _add_config_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_presets:
        for name, cfg in sorted(PRESETS.items()):
            print(f"{name:16s} model={cfg.model:9s} strategy={cfg.strategy:7s} "
                  f"batch={cfg.batch} nloop={cfg.nloop} nadmm={cfg.nadmm}")
        return 0
    overrides = {f.name: getattr(args, f.name) for f in dataclasses.fields(ExperimentConfig)
                 if getattr(args, f.name) is not None}
    cfg = get_preset(args.preset, **overrides)
    rec = Trainer(cfg, verbose=not args.quiet).run()
    if args.metrics_out:
        rec.save(args.metrics_out)
    if rec.first_nonfinite is not None:
        print(f"# FIRST NON-FINITE at {rec.first_nonfinite}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
