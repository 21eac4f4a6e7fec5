"""The port's command line against the JAX package's: the same flags parse
to the same config overrides, `--list-presets` prints the same lines, and
a run whose series turned non-finite reports it and exits 0."""

import argparse
import dataclasses
import re

import pytest

from federated_pytorch_test_tpu import __main__ as jax_cli
from federated_pytorch_test_tpu.engine import ExperimentConfig as JaxConfig
from federated_pytorch_test_tpu_torch import __main__ as cli
from federated_pytorch_test_tpu_torch.engine import ExperimentConfig, Trainer, get_preset
from federated_pytorch_test_tpu_torch.utils.metrics import MetricsRecorder

TINY = ["--device", "cpu", "--synthetic-n-train", "120", "--synthetic-n-test", "30", "--batch", "40",
        "--nloop", "1", "--nadmm", "1", "--max-groups", "1", "--quiet"]
PORT_ONLY = {"--device", "--preset", "--metrics-out", "--quiet", "--list-presets"}


def _jax_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--preset")
    jax_cli._add_config_flags(p)
    return p


def _overrides(args, config) -> dict:
    return {f.name: getattr(args, f.name) for f in dataclasses.fields(config) if getattr(args, f.name) is not None}


def _long_flags(parser: argparse.ArgumentParser) -> set:
    return {s for s in parser._option_string_actions if s.startswith("--") and s != "--help"}


@pytest.mark.parametrize("argv", [
    "--preset admm --nloop 2 --no-bb-update",
    "--n-clients 2 --model net1 --seed 3",
    "--lbfgs-history 5 --lbfgs-lr 0.5 --no-check-results",
    "--max-groups 1 --data-root /x",
    "--compute-dtype bfloat16 --remat",
    "--compute-dtype float32 --no-remat",
    "--linesearch-probes 4 --client-fold vmap",
    "--client-fold gemm --linesearch-probes 1",
    "--average-model --no-synthetic-ok",
    "--no-average-model --synthetic-ok",
    "--preset fedavg_scale64 --lbfgs-direction pallas",
], ids=lambda a: a.split()[0].lstrip("-") + "_" + a.split()[-1].lstrip("-/"))
def test_flags_parse_as_the_jax_cli_parses_them(argv):
    port = _overrides(cli.build_parser().parse_args(argv.split()), ExperimentConfig)
    ref = _overrides(_jax_parser().parse_args(argv.split()), JaxConfig)
    assert port == ref and port
    assert {type(v) for v in port.values()} == {type(v) for v in ref.values()}


def test_every_field_has_a_flag_and_every_flag_is_the_jax_clis_or_the_ports_own():
    port, ref = _long_flags(cli.build_parser()), _long_flags(_jax_parser())
    for f in dataclasses.fields(ExperimentConfig):
        flag = "--" + f.name.replace("_", "-")
        assert flag in port, flag
        if str(f.type) == "bool":
            assert "--no-" + flag[2:] in port, flag
    assert port - ref <= PORT_ONLY, sorted(port - ref - PORT_ONLY)


def test_list_presets_prints_the_jax_clis_lines(capsys):
    assert cli.main(["--list-presets"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(cli.PRESETS) == 7  # the scale64 pair included
    assert jax_cli.main(["--list-presets"]) == 0
    ref = set(capsys.readouterr().out.splitlines())
    for name, line in zip(sorted(cli.PRESETS), lines):
        assert re.fullmatch(rf"{name} +model=\S+ +strategy=\S+ +batch=\d+ nloop=\d+ nadmm=\d+", line), line
        assert line in ref, line
    assert set(lines) == ref


def test_a_run_reaches_the_trainer_with_the_flags(monkeypatch):
    seen = {}

    def run(self):
        seen["cfg"] = self.cfg
        return MetricsRecorder(verbose=False)

    monkeypatch.setattr(Trainer, "run", run)
    argv = ["--preset", "admm", "--no-bb-update", "--n-clients", "2", "--seed", "3", "--lbfgs-history", "5"]
    assert cli.main(argv + TINY) == 0
    assert seen["cfg"] == get_preset("admm", bb_update=False, n_clients=2, seed=3, lbfgs_history=5, device="cpu",
                                     synthetic_n_train=120, synthetic_n_test=30, batch=40, nloop=1, nadmm=1,
                                     max_groups=1)


def test_a_nonfinite_run_reports_it_and_exits_0(monkeypatch, capsys):
    def run(self):
        rec = MetricsRecorder(verbose=False)
        rec.first_nonfinite = {"series": "train_loss", "nloop": 0, "group": 0, "nadmm": 0, "epoch": 0,
                               "minibatch": 1}
        return rec

    monkeypatch.setattr(Trainer, "run", run)
    assert cli.main(TINY) == 0
    out = capsys.readouterr().out
    assert "# FIRST NON-FINITE at {'series': 'train_loss', 'nloop': 0" in out
