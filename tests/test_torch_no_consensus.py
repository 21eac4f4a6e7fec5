"""Port parity for the `no_consensus` preset's parts: the configuration,
the fc1-only elastic net (`reg_mode="first_linear"`), the per-client
initial draws (`init_model=False`) and the evaluation cadence.

* Every field the two packages' `ExperimentConfig`s share has the same
  value in all five presets (the port adds only `device`).
* `reg_segments` for Net1 equals the JAX Trainer's `_ctx(0).reg_segments`:
  fc1, 819,712 of the 890,410 coordinates.
* The objective (data loss + elastic net on fc1 of the full vector) at the
  JAX Trainer's per-client init, converted, on one minibatch: within
  relative 1e-6 of the JAX package's data loss plus its `_regularizer`
  (readings ~1e-7); its gradient reaches every coordinate and differs from
  the data loss's by exactly the elastic net's on fc1 and nowhere else.
* `init_model=False`: each client its own draw, the same for the same seed.
* The record layout — the cursor keys of every `train_loss` and
  `test_accuracy` record, in order — equals the JAX Trainer's on the same
  drive (Net, the cadence is model-independent, K=3, batch 40, `nepoch=2`),
  per epoch and with `eval_every_batch`, and for fedavg with
  `eval_every_batch` (per-minibatch records and the round-end one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from federated_pytorch_test_tpu.data import normalize as j_normalize
from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
from federated_pytorch_test_tpu.engine import ExperimentConfig as JConfig
from federated_pytorch_test_tpu.engine import Trainer as JTrainer
from federated_pytorch_test_tpu.engine import get_preset as j_preset
from federated_pytorch_test_tpu.engine.steps import _regularizer as j_regularizer
from federated_pytorch_test_tpu.models import Net1 as JNet1
from federated_pytorch_test_tpu_torch.convert import flat_from_jax
from federated_pytorch_test_tpu_torch.data import normalize, synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import ExperimentConfig, Trainer, get_preset
from federated_pytorch_test_tpu_torch.engine.steps import objective
from federated_pytorch_test_tpu_torch.models import Net1
from federated_pytorch_test_tpu_torch.partition import Segment

PRESETS = ("no_consensus", "fedavg", "admm", "fedavg_resnet", "admm_resnet")
N_TRAIN, N_TEST = 240, 60


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs files
    in parallel processes, and a thread per core in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields_match_jax(name):
    shared = {f.name for f in dataclasses.fields(JConfig)} & {f.name for f in dataclasses.fields(ExperimentConfig)}
    assert {f.name for f in dataclasses.fields(ExperimentConfig)} - shared == {"device"}
    got, want = get_preset(name), j_preset(name)
    assert {f: getattr(got, f) for f in shared} == {f: getattr(want, f) for f in shared}


def test_config_accepts_and_validates_the_new_fields():
    cfg = ExperimentConfig(strategy="none", reg_mode="first_linear", lbfgs_direction="two_loop", resume="auto")
    assert (cfg.init_model, cfg.check_results, cfg.eval_every_batch) == (True, True, False)
    assert (cfg.save_model, cfg.load_model, cfg.checkpoint_dir) == (False, False, "./checkpoints")
    for field, bad, msg in (("strategy", "gossip", "strategy must be"), ("reg_mode", "all", "reg_mode must be"),
                            ("resume", "always", "resume must be"), ("lbfgs_direction", "cubic", "must be one of")):
        with pytest.raises(ValueError, match=msg):
            ExperimentConfig(**{field: bad})


@pytest.fixture(scope="module")
def net1():
    """The JAX Trainer and the port's Trainer of the no_consensus preset on
    the same data, the port starting from the JAX per-client init."""
    jtr = JTrainer(j_preset("no_consensus", batch=40, nepoch=2), verbose=False, source=j_synthetic(N_TRAIN, N_TEST))
    flat0 = np.array(jtr.flat)
    tr = Trainer(get_preset("no_consensus", batch=40, nepoch=2), verbose=False, source=synthetic_cifar(N_TRAIN, N_TEST),
                 device="cpu", init_flat=flat_from_jax(flat0, Net1()))
    return jtr, flat0, tr


def test_reg_segments_are_fc1_as_in_jax(net1):
    jtr, _, tr = net1
    want = tuple((s.start, s.size) for s in jtr._ctx(0).reg_segments)
    assert tuple((s.start, s.size) for s in tr.ctx(0).reg_segments) == want == ((65_568, 819_712),)
    assert tr.n_params == 890_410 and tr.partition.groups == ((Segment(0, 890_410),),) and tr.group_order == [0]
    assert not tr.ctx(0).reg_on_active


def test_objective_with_fc1_elastic_net_matches_jax(net1):
    jtr, flat0, tr = net1
    idx = tr.epoch_indices(0, 0, 0, 0)[0]  # [K, B]
    rows = np.arange(tr.cfg.n_clients)[:, None]
    imgs, labels = tr.fed.train_images[rows, idx], tr.fed.train_labels[rows, idx]
    jctx = jtr._ctx(0)

    def j_obj(flat_c, im, lab, mu, sd):
        logits = JNet1().apply({"params": jtr.unravel(flat_c)}, j_normalize(im, mu, sd))
        return optax.softmax_cross_entropy_with_integer_labels(logits, lab).mean() + j_regularizer(jctx, flat_c, flat_c)

    want = np.asarray(jax.vmap(j_obj)(jnp.asarray(flat0), imgs, labels, tr.fed.mean, tr.fed.std))

    ctx = tr.ctx(0)
    images = normalize(torch.from_numpy(imgs), tr.mean, tr.std)
    x = tr.flat.clone().requires_grad_(True)
    loss, dl, _ = objective(ctx, tr.flat, x, {}, images, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=1e-6)

    # the elastic net's gradient lands on fc1 only, on every fc1 coordinate
    (g,) = torch.autograd.grad(loss.sum(), x, retain_graph=True)
    (g_data,) = torch.autograd.grad(dl.sum(), x)
    (seg,) = ctx.reg_segments
    fc1 = slice(seg.start, seg.start + seg.size)
    v = tr.flat[:, fc1]
    want_reg = ctx.lambda1 * torch.where(v >= 0, 1.0, -1.0) + 2 * ctx.lambda2 * v
    torch.testing.assert_close(g[:, fc1] - g_data[:, fc1], want_reg, rtol=1e-4, atol=1e-8)
    assert torch.equal(g[:, : seg.start], g_data[:, : seg.start])
    assert torch.equal(g[:, seg.start + seg.size :], g_data[:, seg.start + seg.size :])


def test_init_model_false_draws_each_client_apart():
    src = synthetic_cifar(N_TRAIN, N_TEST)
    own = Trainer(get_preset("no_consensus", batch=40), verbose=False, source=src, device="cpu").flat
    again = Trainer(get_preset("no_consensus", batch=40), verbose=False, source=src, device="cpu").flat
    common = Trainer(get_preset("no_consensus", batch=40, init_model=True), verbose=False, source=src, device="cpu").flat
    assert torch.equal(own, again)
    for a in range(3):
        assert torch.equal(common[a], common[0])
        for b in range(a):
            assert not torch.equal(own[a], own[b])
    assert not torch.equal(own[0], common[0])


def _layout(rec):
    return {name: [{k: v for k, v in r.items() if k not in ("t", "value")} for r in rec.series.get(name, [])]
            for name in ("train_loss", "test_accuracy")}


@pytest.mark.parametrize("preset, eval_every_batch", [("no_consensus", False), ("no_consensus", True),
                                                      ("fedavg", True)])
def test_record_layout_matches_jax(preset, eval_every_batch):
    drive = dict(model="net", batch=40, nloop=1, nadmm=1, nepoch=2, eval_batch=30, max_groups=1,
                 eval_every_batch=eval_every_batch)
    jrec = JTrainer(j_preset(preset, **drive), verbose=False, source=j_synthetic(N_TRAIN, N_TEST)).run()
    rec = Trainer(get_preset(preset, **drive), verbose=False, source=synthetic_cifar(N_TRAIN, N_TEST),
                  device="cpu").run()
    got, want = _layout(rec), _layout(jrec)
    assert got == want
    n_evals = len(want["test_accuracy"])
    assert n_evals == {("no_consensus", False): 3, ("no_consensus", True): 4, ("fedavg", True): 5}[preset,
                                                                                                   eval_every_batch]


def test_check_results_false_evaluates_nothing():
    rec = Trainer(get_preset("no_consensus", model="net", batch=40, nepoch=2, check_results=False), verbose=False,
                  source=synthetic_cifar(N_TRAIN, N_TEST), device="cpu").run()
    assert "test_accuracy" not in rec.series and len(rec.series["train_loss"]) == 4


@pytest.mark.parametrize("direction", ["two_loop", "compact", "pallas"])
def test_cli_runs_no_consensus_on_cpu(tmp_path, direction):
    from federated_pytorch_test_tpu_torch.__main__ import main

    out = tmp_path / "m.json"
    assert main(["--preset", "no_consensus", "--device", "cpu", "--synthetic-n-train", "120",
                 "--synthetic-n-test", "60", "--batch", "40", "--nepoch", "1", "--eval-every-batch",
                 "--lbfgs-direction", direction, "--quiet", "--metrics-out", str(out)]) == 0
    series = __import__("json").loads(out.read_text())["series"]
    # one minibatch (a Net1 step costs seconds here); the per-minibatch
    # cadence over several is test_record_layout_matches_jax's
    assert [r["minibatch"] for r in series["test_accuracy"]] == [0]
