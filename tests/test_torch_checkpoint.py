"""Checkpoint and resume of the port (`utils/checkpoint.py`,
`Trainer.save`/`_restore`), on the CPU.

* The writer is atomic and the loader falls back past a torn checkpoint;
  a checkpoint of the same step is overwritten; an explicit step
  propagates its error (the JAX package's `tests/test_fault.py`
  checkpoint tests, on the port's `torch.save` files).
* A fedavg and an admm run round-trip: parameters, loop cursor and the
  per-group rho store (`tests/test_engine.py::test_checkpoint_roundtrip`).
* A resumed run equals the uninterrupted run bit for bit, in its final
  parameters and in every record of the continued loop
  (`tests/test_engine.py::test_resume_replays_exact_trajectory`): fedavg,
  and admm with BB, whose accepted rho is carried into the second loop
  (BB's thresholds are opened, `bb_epsilon=1e-12, bb_rhomax=1e6`, so that
  it accepts a proposal on this small drive: the second loop starts from
  the restored rho, not rho0).
* `resume="auto"` without a checkpoint starts fresh; `load_model` without
  one raises.
* A BatchNorm model's statistics round-trip bit for bit (fedavg_resnet at
  a narrow width, `STAGES` 8/16/32/64, cut to the linear head group, as
  the JAX package's tests cut it).
* Content parity with the JAX package: after one loop of the same admm
  drive (Net's fc1 group, one ADMM round of two steps) from the same
  initial parameters, the JAX package's `load_checkpoint` tree and the
  port's hold the same keys, cursor and rho-store groups; rho within
  relative 1e-6 (both keep rho0) and the parameters within relative 1e-4
  of the largest, the per-step limit of the slice tests (reading 5.3e-6;
  over three ADMM rounds the float32 drift the slice tests describe
  reaches 2e-2 on a few coordinates, so the drive stops at one).
"""

import os

import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
from federated_pytorch_test_tpu.engine import Trainer as JTrainer
from federated_pytorch_test_tpu.engine import get_preset as j_preset
from federated_pytorch_test_tpu.utils import load_checkpoint as j_load_checkpoint
from federated_pytorch_test_tpu_torch.convert import flat_from_jax
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.models import Net, ResNet18
from federated_pytorch_test_tpu_torch.utils import checkpoint_path, load_checkpoint, save_checkpoint

SRC = synthetic_cifar(240, 60)
# BB thresholds opened so that the small drive accepts a proposal (rho ~1.1)
OPEN_BB = dict(bb_epsilon=1e-12, bb_rhomax=1e6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs files
    in parallel processes, and a thread per core in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(preset, **over):
    base = dict(batch=40, nloop=1, eval_batch=30, max_groups=1, device="cpu")
    base.update(over)
    return get_preset(preset, **base)


def test_atomic_write_and_torn_fallback(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, {"v": torch.arange(4.0), "step": 1}, step=1)
    save_checkpoint(d, {"v": torch.arange(4.0) * 2, "step": 2}, step=2)
    assert not [p for p in os.listdir(d) if p.startswith(".tmp_step")]  # no staging survives a save

    # torn writes: step_3 holds garbage, step_4 is a directory
    (tmp_path / "step_3").write_bytes(b"\x00garbage")
    (tmp_path / "step_4").mkdir()
    with pytest.warns(UserWarning, match="skipping unreadable checkpoint"):
        state = load_checkpoint(d)
    assert state["step"] == 2 and torch.equal(state["v"], torch.arange(4.0) * 2)

    # an abandoned staging file is never a checkpoint
    (tmp_path / ".tmp_step_9").write_bytes(b"\x00")
    with pytest.warns(UserWarning):
        assert load_checkpoint(d)["step"] == 2

    # an explicit step propagates its error; absence is loud
    with pytest.raises(Exception):
        load_checkpoint(d, step=3)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d, step=7)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"))
    for s in (1, 2):
        os.remove(checkpoint_path(d, s))
    with pytest.raises(FileNotFoundError, match="no readable checkpoint"), pytest.warns(UserWarning):
        load_checkpoint(d)


def test_overwrite_same_step(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, {"v": torch.zeros(3)}, step=1)
    save_checkpoint(d, {"v": torch.ones(3)}, step=1)
    assert torch.equal(load_checkpoint(d)["v"], torch.ones(3))
    assert torch.equal(load_checkpoint(d, step=1)["v"], torch.ones(3))
    assert os.listdir(d) == ["step_1"]


@pytest.mark.parametrize("preset", ["fedavg", "admm"])
def test_checkpoint_roundtrip(tmp_path, preset):
    cfg = tiny(preset, nadmm=3, save_model=True, checkpoint_dir=str(tmp_path), **OPEN_BB)
    tr = Trainer(cfg, verbose=False, source=SRC)
    tr.run()
    assert sorted(os.listdir(tmp_path)) == ["step_1"]  # written after the loop

    tr2 = Trainer(cfg.replace(load_model=True), verbose=False, source=SRC)
    assert torch.equal(tr2.flat, tr.flat)
    assert tr2._completed_nloops == 1
    assert sorted(tr2._rho_store) == sorted(tr._rho_store)
    for g in tr._rho_store:
        assert torch.equal(tr2._rho_store[g], tr._rho_store[g])
    if preset == "admm":
        assert tr._rho_store and not torch.allclose(tr._rho_store[2], torch.tensor(1e-3))  # BB accepted
    assert len(tr2.run().series) == 0  # nothing left to run: the cursor is at nloop


@pytest.mark.parametrize("preset, extra", [("fedavg", {}), ("admm", dict(bb_update=True, **OPEN_BB))])
def test_resume_replays_the_uninterrupted_run_bitwise(tmp_path, preset, extra):
    common = dict(nadmm=3, save_model=True, **extra)
    tr_a = Trainer(tiny(preset, nloop=2, checkpoint_dir=str(tmp_path / "a"), **common), verbose=False, source=SRC)
    rec_a = tr_a.run()

    cfg_b = tiny(preset, nloop=1, checkpoint_dir=str(tmp_path / "b"), **common)
    Trainer(cfg_b, verbose=False, source=SRC).run()
    tr_b2 = Trainer(cfg_b.replace(nloop=2, load_model=True), verbose=False, source=SRC)
    assert tr_b2._completed_nloops == 1
    rec_b2 = tr_b2.run()

    assert torch.equal(tr_b2.flat, tr_a.flat)
    names = ["train_loss", "dual_residual", "test_accuracy"]
    if preset == "admm":
        names += ["primal_residual", "mean_rho"]
        # the second loop starts from the rho BB accepted in the first
        first = [r["value"] for r in rec_a.series["mean_rho"] if r["nloop"] == 1][0]
        assert first != pytest.approx(1e-3)
        for g in tr_a._rho_store:
            assert torch.equal(tr_b2._rho_store[g], tr_a._rho_store[g])
    for name in names:
        a_vals = [r["value"] for r in rec_a.series[name] if r["nloop"] == 1]
        b_vals = [r["value"] for r in rec_b2.series[name]]
        assert a_vals and a_vals == b_vals, name


def test_resume_auto_without_checkpoint_starts_fresh(tmp_path):
    cfg = tiny("fedavg", resume="auto", checkpoint_dir=str(tmp_path / "none"))
    assert Trainer(cfg, verbose=False, source=SRC)._completed_nloops == 0
    with pytest.raises(FileNotFoundError):
        Trainer(cfg.replace(resume="off", load_model=True), verbose=False, source=SRC)


def test_resume_auto_takes_the_newest_readable_checkpoint(tmp_path):
    cfg = tiny("fedavg", nloop=2, nadmm=1, save_model=True, checkpoint_dir=str(tmp_path))
    tr = Trainer(cfg, verbose=False, source=SRC)
    tr.run_loop(0)
    tr._completed_nloops = 1
    tr.save(step=1)
    flat1 = tr.flat.clone()
    (tmp_path / "step_2").write_bytes(b"torn")
    with pytest.warns(UserWarning, match="skipping unreadable checkpoint"):
        tr2 = Trainer(cfg.replace(resume="auto"), verbose=False, source=SRC)
    assert tr2._completed_nloops == 1 and torch.equal(tr2.flat, flat1)


def test_batchnorm_statistics_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr(ResNet18, "STAGES", ((8, 1), (8, 1), (16, 2), (16, 1), (32, 2), (32, 1), (64, 2), (64, 1)))
    cfg = get_preset("fedavg_resnet", batch=30, nloop=1, nadmm=1, eval_batch=30, device="cpu", save_model=True,
                     checkpoint_dir=str(tmp_path))
    src = synthetic_cifar(90, 30)
    tr = Trainer(cfg, verbose=False, source=src)
    init = {n: t.clone() for n, t in tr.stats.items()}
    tr.group_order = [9]  # the linear head: the cheapest group
    tr.run()
    assert tr.stats and all(not torch.equal(t, init[n]) for n, t in tr.stats.items())
    tr2 = Trainer(cfg.replace(load_model=True), verbose=False, source=src)
    assert sorted(tr2.stats) == sorted(tr.stats)
    assert all(torch.equal(tr2.stats[n], t) for n, t in tr.stats.items())
    assert torch.equal(tr2.flat, tr.flat)


def test_checkpoint_content_matches_jax(tmp_path):
    drive = dict(batch=40, nloop=1, nadmm=1, max_groups=1, eval_batch=30, save_model=True)
    jtr = JTrainer(j_preset("admm", checkpoint_dir=str(tmp_path / "jax"), **drive), verbose=False,
                   source=j_synthetic(240, 60))
    flat0 = np.array(jtr.flat)
    jtr.run()
    tr = Trainer(get_preset("admm", checkpoint_dir=str(tmp_path / "port"), device="cpu", **drive), verbose=False,
                 source=SRC, init_flat=flat_from_jax(flat0, Net()))
    tr.run()

    want = j_load_checkpoint(str(tmp_path / "jax"))
    got = load_checkpoint(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) == ["batch_stats", "completed_nloops", "flat", "rho_store"]
    assert got["completed_nloops"] == int(want["completed_nloops"]) == 1
    assert sorted(got["rho_store"]) == sorted(want["rho_store"]) == ["2"]
    np.testing.assert_allclose(got["rho_store"]["2"].numpy(), np.asarray(want["rho_store"]["2"]), rtol=1e-6)
    assert got["batch_stats"] == {} and len(want["batch_stats"]) == 0
    want_flat = flat_from_jax(np.asarray(want["flat"]), Net())
    err = np.abs(got["flat"].numpy() - want_flat).max() / np.abs(want_flat).max()
    assert err <= 1e-4, err


def test_cli_save_then_load_and_resume(tmp_path):
    from federated_pytorch_test_tpu_torch.__main__ import main

    ckpt, out = str(tmp_path / "ckpt"), tmp_path / "m.json"
    common = ["--preset", "admm", "--device", "cpu", "--synthetic-n-train", "240", "--synthetic-n-test", "60",
              "--batch", "40", "--nadmm", "1", "--max-groups", "1", "--quiet", "--checkpoint-dir", ckpt]
    assert main(common + ["--nloop", "1", "--save-model"]) == 0
    assert sorted(os.listdir(ckpt)) == ["step_1"]
    assert main(common + ["--nloop", "2", "--load-model", "--metrics-out", str(out)]) == 0
    series = __import__("json").loads(out.read_text())["series"]
    assert {r["nloop"] for r in series["train_loss"]} == {1}  # continued from the restored loop
    assert main(common + ["--nloop", "2", "--resume", "auto", "--save-model"]) == 0
    assert sorted(os.listdir(ckpt)) == ["step_1", "step_2"]
    with pytest.raises(FileNotFoundError):
        main(common + ["--nloop", "1", "--load-model", "--checkpoint-dir", str(tmp_path / "none")])
