"""Port parity for the ViT slice: the fedavg engine with ViT clients end to end.

A small drive — `synthetic_cifar(48, 16)`, ViT at dim 32, 2 heads, patch 2
(256 tokens), K=3, batch 8 (2 lockstep minibatches per epoch), nloop 1,
nadmm 1, the first 2 groups of the train order (group 0, the patch
embedding and positions, backpropagates through every attention layer;
group 1 is the first block), the fused-kernel L-BFGS direction — runs
through the JAX package's Trainer and the port's Trainer from the same
initial parameters (the JAX init, converted). Both draw the same
minibatches (same numpy shuffle recipe). The JAX Trainer runs 'dense'
attention: its 'flash' path stops inside the engine's shard_map
(`vma=None` on the flash kernels' outputs, ROADMAP §C). The port runs
'flash', which on CPU tensors is the rectangular kernels' plain PyTorch
versions, so no kernel is launched.

Tolerance: each round's per-minibatch losses and its dual residual within
relative 1e-3. No round of this drive amplifies past that, so rounds are
compared whole (readings, printed by `PYTHONPATH=. python
tests/test_torch_vit_slice.py`, beside `LIMITS`). Per-client accuracy:
within one test sample.
"""

import numpy as np
import pytest

from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
from federated_pytorch_test_tpu.engine import Trainer as JTrainer
from federated_pytorch_test_tpu.engine import get_preset as j_preset
from federated_pytorch_test_tpu_torch.convert import flat_from_jax
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.models import ViT
from federated_pytorch_test_tpu_torch.ops import compact_cuda, flash_cuda

WIDTH = dict(dim=32, num_heads=2, patch=2)
DRIVE = dict(model="vit", batch=8, nloop=1, nadmm=1, max_groups=2, lbfgs_direction="pallas")
N_TRAIN, N_TEST = 48, 16
# (group, nadmm) -> (train-loss limit, dual-residual limit), relative;
# readings are the port-vs-JAX maxima on this drive
LIMITS = {
    (0, 0): (1e-3, 1e-3),  # readings: loss 1.1e-5, dual 1.9e-5
    (1, 0): (1e-3, 1e-3),  # loss 1.3e-5, dual 3.8e-7
}


@pytest.fixture(scope="module")
def runs():
    jcfg = j_preset("fedavg", model_kwargs={**WIDTH, "attn_impl": "dense"}, **DRIVE)
    jtr = JTrainer(jcfg, verbose=False, source=j_synthetic(N_TRAIN, N_TEST))
    flat0 = np.array(jtr.flat)  # a copy: the JAX run donates its buffers
    jrec = jtr.run()
    compact_cuda.reset_launch_counts()
    flash_cuda.reset_launch_counts()
    tr = Trainer(
        get_preset("fedavg", model_kwargs={**WIDTH, "attn_impl": "flash"}, **DRIVE), verbose=False,
        source=synthetic_cifar(N_TRAIN, N_TEST), device="cpu", init_flat=flat_from_jax(flat0, ViT(**WIDTH)),
    )
    rec = tr.run()
    return jrec, rec, tr, {**compact_cuda.LAUNCHES, **flash_cuda.LAUNCHES}


def _by_round(rec, name):
    out = {}
    for r in rec.series[name]:
        out.setdefault((r["group"], r["nadmm"]), []).append(r["value"])
    return {key: np.asarray(v, np.float64) for key, v in out.items()}


def test_slice_visits_the_same_rounds(runs):
    jrec, rec, tr, _ = runs
    assert tr.group_order == [0, 1] and tr.n_params == 59818
    for name in ("train_loss", "dual_residual", "test_accuracy"):
        assert sorted(_by_round(rec, name)) == sorted(_by_round(jrec, name)) == sorted(LIMITS)
    assert len(rec.series["train_loss"]) == 2 * 1 * 2  # groups x nadmm x steps


def test_slice_train_losses_match(runs):
    jrec, rec, _, _ = runs
    got, want = _by_round(rec, "train_loss"), _by_round(jrec, "train_loss")
    for key, (tol, _) in LIMITS.items():
        assert got[key].shape == want[key].shape == (2, 3)
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=0, err_msg=f"round {key}")


def test_slice_dual_residuals_match(runs):
    jrec, rec, _, _ = runs
    got, want = _by_round(rec, "dual_residual"), _by_round(jrec, "dual_residual")
    for key, (_, tol) in LIMITS.items():
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=0, err_msg=f"round {key}")


def test_slice_accuracies_match(runs):
    jrec, rec, _, _ = runs
    got, want = _by_round(rec, "test_accuracy"), _by_round(jrec, "test_accuracy")
    for key in LIMITS:
        assert np.all(np.abs(got[key] - want[key]) * N_TEST <= 1.0 + 1e-9), key


def test_cpu_vit_path_launches_no_kernel(runs):
    *_, launches = runs
    assert set(flash_cuda.RECT_KERNELS) <= set(launches)
    assert all(n == 0 for n in launches.values()), launches


if __name__ == "__main__":
    # the port-vs-JAX readings behind LIMITS, round by round
    jrec, rec, _, _ = runs.__wrapped__()
    for name in ("train_loss", "dual_residual"):
        got, want = _by_round(rec, name), _by_round(jrec, name)
        for key in LIMITS:
            print(f"{name} round={key} max_rel={np.max(np.abs(got[key] - want[key]) / np.abs(want[key])):.3e}")
