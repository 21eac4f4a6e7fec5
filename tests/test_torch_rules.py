"""Rules of the PyTorch port: no JAX, no import of the JAX package, the
card unless the CPU is asked for, and no kernel launch on CPU tensors."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

import federated_pytorch_test_tpu_torch as port
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.ops import compact_cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(port.__file__).resolve().parent


def test_import_loads_no_jax():
    code = (
        "import sys, federated_pytorch_test_tpu_torch, federated_pytorch_test_tpu_torch.__main__\n"
        "import federated_pytorch_test_tpu_torch.convert, federated_pytorch_test_tpu_torch.federated_lm\n"
        "import federated_pytorch_test_tpu_torch.ops.flash_cuda\n"
        "import federated_pytorch_test_tpu_torch.utils.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'federated_pytorch_test_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize(
    "path",
    [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py", ROOT / "chip_sweep.py", ROOT / "no_consensus_probe.py"],
    ids=lambda p: p.name,
)
def test_no_module_names_the_jax_package(path):
    text = path.read_text()
    assert not re.search(r"federated_pytorch_test_tpu\.", text), path
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", text, re.M), path


def test_resolve_device_runs_cudnn_deterministically():
    # every entry point goes through `resolve_device`, which sets the
    # port's numeric defaults: cuDNN deterministic, no autotuning
    from federated_pytorch_test_tpu_torch.utils import resolve_device

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_no_module_turns_cudnn_autotuning_on():
    for path in sorted(PKG.rglob("*.py")):
        text = path.read_text()
        assert not re.search(r"cudnn\.benchmark\s*=\s*True", text), path
        assert not re.search(r"cudnn\.deterministic\s*=\s*False", text), path


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    cfg = get_preset("fedavg", synthetic_n_train=240, synthetic_n_test=60, batch=40)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, verbose=False)


def test_public_helpers_default_to_the_card():
    from federated_pytorch_test_tpu_torch.consensus import fedavg_init
    from federated_pytorch_test_tpu_torch.federated_lm import main as lm_main
    from federated_pytorch_test_tpu_torch.models import Net, init_client_params

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_client_params(Net(), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fedavg_init(10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_main(["--k", "2", "--seq", "128"])
    assert init_client_params(Net(), 2, device="cpu").device.type == "cpu"
    assert fedavg_init(10, device="cpu").z.device.type == "cpu"


def test_cpu_run_launches_no_kernel():
    compact_cuda.reset_launch_counts()
    cfg = get_preset(
        "fedavg", synthetic_n_train=120, synthetic_n_test=30, batch=40, nloop=1, nadmm=1,
        max_groups=1, lbfgs_direction="pallas",
    )
    rec = Trainer(cfg, verbose=False, device="cpu").run()
    assert rec.first_nonfinite is None
    assert all(v == 0 for v in compact_cuda.LAUNCHES.values())


def test_cli_runs_on_cpu(tmp_path):
    from federated_pytorch_test_tpu_torch.__main__ import main

    out = tmp_path / "m.json"
    rc = main([
        "--device", "cpu", "--synthetic-n-train", "120", "--synthetic-n-test", "30",
        "--batch", "40", "--nloop", "1", "--nadmm", "1", "--max-groups", "1", "--quiet",
        "--metrics-out", str(out),
    ])
    assert rc == 0 and out.exists()

