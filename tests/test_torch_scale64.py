"""The scale64 slice: K=64 clients, `average_model`, `synthetic_ok` and the
in-place history push, against the JAX package.

* `fedavg_scale64` and `admm_scale64` (BASELINE.json config 5: 64 ResNet18
  clients on CIFAR-100) equal the JAX package's presets on every field the
  two configs share, as do the other five presets; the four new fields
  have its defaults and raise its errors.
* CIFAR-100's 50,000 images shard as the JAX package shards them at K=64:
  781 a client, the last 16 left over.
* `synthetic_ok=False` without an archive raises as the JAX Trainer does;
  `average_model` replaces every client by the clients' mean before
  training, as the JAX Trainer does (relative 1e-6: the two means sum in
  another order), and the averaged run's first round then follows JAX's
  (relative 1e-3, the slice tests' first-round limit).
* Net at K=64 over one group (fc1) and two minibatches of 8, through both
  Trainers from the same init: the train losses within relative 1e-3 and
  the dual residuals within 1e-3.
* ResNet18 at full width, 100 classes, K=64 clients with distinct weights
  (the JAX init scaled by 1 + k/100) and 2 images a client: the train-mode
  forward against `ResNet18.apply` client by client, logits within
  relative 1e-5 of the largest entry and the new statistics within 1e-5
  (the narrow model's limits, `tests/test_torch_resnet.py`).
* The in-place history update against the functional push it replaced
  (roll, slot write, the pushed history selected where the pair was
  accepted, zeroed on a round's first iteration, the old one kept where
  the client no longer iterates), bitwise, over random masks: full,
  partial and empty histories, rejected pairs, inactive and first-ever
  clients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
from federated_pytorch_test_tpu.data.pipeline import make_federated as j_make_federated
from federated_pytorch_test_tpu.engine import ExperimentConfig as JConfig
from federated_pytorch_test_tpu.engine import Trainer as JTrainer
from federated_pytorch_test_tpu.engine import get_preset as j_preset
from federated_pytorch_test_tpu.models import ResNet18 as JResNet18
from federated_pytorch_test_tpu_torch.convert import flat_from_jax, params_from_jax, stats_from_jax
from federated_pytorch_test_tpu_torch.data import DataSource, make_federated, synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import PRESETS, ExperimentConfig, Trainer, get_preset
from federated_pytorch_test_tpu_torch.models import Net, ResNet18
from federated_pytorch_test_tpu_torch.optim import lbfgs

PORT_ONLY = {"device"}
NEW_FIELDS = {"synthetic_ok": True, "average_model": False, "linesearch_probes": 1, "client_fold": "gemm"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work, as the other slice
    tests (the suite runs files in parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_match_jax_on_every_shared_field(name):
    port, ref = get_preset(name), j_preset(name)
    names = {f.name for f in dataclasses.fields(ExperimentConfig)} - PORT_ONLY
    assert names <= {f.name for f in dataclasses.fields(JConfig)}
    for field in sorted(names):
        assert getattr(port, field) == getattr(ref, field), field
    if name.endswith("scale64"):
        assert (port.n_clients, port.model, port.dataset, port.check_results) == (64, "resnet18", "cifar100", False)


@pytest.mark.parametrize("field,bad", [("linesearch_probes", 0), ("linesearch_probes", True),
                                       ("linesearch_probes", 2.0), ("client_fold", "loop")])
def test_new_fields_have_the_jax_defaults_and_errors(field, bad):
    for f, default in NEW_FIELDS.items():
        assert getattr(ExperimentConfig(), f) == getattr(JConfig(), f) == default
    with pytest.raises(ValueError) as port_err:
        ExperimentConfig(**{field: bad})
    with pytest.raises(ValueError) as jax_err:
        JConfig(**{field: bad})
    assert str(port_err.value) == str(jax_err.value)


def test_cifar100_shards_as_the_jax_package_at_k64():
    n = 50_000
    images = np.broadcast_to(np.zeros((1, 32, 32, 3), np.uint8), (n, 32, 32, 3))
    labels = np.arange(n, dtype=np.int32) % 100
    src = DataSource(images, labels, images[:10], labels[:10], 100, "synthetic")
    fed = make_federated(src, 64, biased=False)
    jfed = j_make_federated(src, 64, biased=False)
    assert fed.train_labels.shape == jfed.train_labels.shape == (64, 781)  # 16 images left over
    np.testing.assert_array_equal(fed.train_labels, jfed.train_labels)
    np.testing.assert_array_equal(fed.mean, jfed.mean)


def test_synthetic_ok_false_raises_without_an_archive(tmp_path):
    cfg = dict(data_root=str(tmp_path), synthetic_ok=False, nloop=1)
    with pytest.raises(FileNotFoundError) as port_err:
        Trainer(get_preset("fedavg", device="cpu", **cfg), verbose=False)
    with pytest.raises(FileNotFoundError) as jax_err:
        JTrainer(j_preset("fedavg", **cfg), verbose=False)
    assert type(port_err.value).__name__ == type(jax_err.value).__name__ == "ArchiveNotFound"
    with pytest.warns(UserWarning, match="synthetic stand-in"):  # the default falls back
        Trainer(get_preset("fedavg", device="cpu", data_root=str(tmp_path), synthetic_n_train=120,
                           synthetic_n_test=30, batch=40), verbose=False)


AVG_DRIVE = dict(batch=40, nloop=1, nadmm=1, max_groups=1, init_model=False, eval_batch=60)


def test_average_model_matches_the_jax_trainer():
    jtr = JTrainer(j_preset("fedavg", average_model=True, **AVG_DRIVE), verbose=False, source=j_synthetic(240, 60))
    drawn = np.array(JTrainer(j_preset("fedavg", **AVG_DRIVE), verbose=False, source=j_synthetic(240, 60)).flat)
    assert np.abs(drawn - drawn[:1]).max() > 0  # init_model=False: the clients start apart
    javg = np.array(jtr.flat)
    tr = Trainer(get_preset("fedavg", average_model=True, **AVG_DRIVE), verbose=False,
                 source=synthetic_cifar(240, 60), device="cpu", init_flat=flat_from_jax(drawn, Net()))
    want = flat_from_jax(javg, Net())
    assert torch.equal(tr.flat, tr.flat[:1].expand_as(tr.flat))  # one model for every client
    np.testing.assert_allclose(tr.flat.numpy(), want, rtol=1e-6, atol=1e-7)
    rec, jrec = tr.run(), jtr.run()
    for name in ("train_loss", "dual_residual"):
        got = np.asarray([r["value"] for r in rec.series[name]], np.float64)
        ref = np.asarray([r["value"] for r in jrec.series[name]], np.float64)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=0, err_msg=name)


K64_DRIVE = dict(n_clients=64, batch=8, nloop=1, nadmm=1, max_groups=1, eval_batch=50, dataset="cifar100",
                 lbfgs_direction="pallas")


def test_net_at_k64_matches_the_jax_trainer():
    n_train = 64 * 16  # two minibatches of 8 a client
    jtr = JTrainer(j_preset("fedavg", **K64_DRIVE), verbose=False, source=j_synthetic(n_train, 50, num_classes=100))
    flat0 = np.array(jtr.flat)
    jrec = jtr.run()
    tr = Trainer(get_preset("fedavg", **K64_DRIVE), verbose=False, device="cpu",
                 source=synthetic_cifar(n_train, 50, num_classes=100), init_flat=flat_from_jax(flat0, Net(100)))
    assert tr.fed.shard_size == 16 and tr.group_order == [2]
    rec = tr.run()
    got = np.asarray([r["value"] for r in rec.series["train_loss"]], np.float64)
    ref = np.asarray([r["value"] for r in jrec.series["train_loss"]], np.float64)
    assert got.shape == ref.shape == (2, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=0)
    dual = [r["value"] for r in rec.series["dual_residual"]]
    np.testing.assert_allclose(dual, [r["value"] for r in jrec.series["dual_residual"]], rtol=1e-3)


def test_resnet18_forward_at_k64_and_100_classes_matches_flax():
    k, b = 64, 2
    variables = jax.jit(lambda: JResNet18(num_classes=100).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                                                train=False))()
    params0 = jax.tree.map(np.asarray, variables["params"])
    stats0 = jax.tree.map(np.asarray, variables["batch_stats"])
    model = ResNet18(num_classes=100)
    scale = torch.linspace(1.0, 1.0 + (k - 1) / 100, k, dtype=torch.float64).float()
    base = params_from_jax(params0, model)
    tparams = {n: base[n][None] * scale.reshape((k,) + (1,) * base[n].ndim) for n in model.shapes()}
    tstats = {n: t.reshape(1, -1).expand(k, -1).contiguous() for n, t in stats_from_jax(stats0, model).items()}
    x = np.random.default_rng(0).normal(size=(k, b, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        logits, new_stats = model.forward_batched(tparams, torch.from_numpy(x), stats=tstats)

    @jax.jit
    def one(c, xx):
        p = jax.tree.map(lambda a: a * (1.0 + c / 100.0), params0)
        out, mut = JResNet18(num_classes=100).apply({"params": p, "batch_stats": stats0}, xx, train=True,
                                                    mutable=["batch_stats"])
        return out, mut["batch_stats"]

    for c in range(k):
        want, want_stats = one(jnp.float32(c), x[c])
        want = np.asarray(want)
        assert np.abs(logits[c].numpy() - want).max() <= 1e-5 * np.abs(want).max(), c
        for name, t in stats_from_jax(jax.tree.map(np.asarray, want_stats), model).items():
            ref = t.reshape(-1).numpy()
            assert np.abs(new_stats[name][c].numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), (c, name)


def _functional_history(s_hist, y_hist, count, s, y, accept, fresh, active):
    """The update the in-place one replaced: every client's history rolled
    and written as the JAX package's `_push_history` does, selected where
    the pair was accepted, zeroed where `fresh`, and the old history kept
    where the client no longer iterates (the loop's `select`)."""
    m = s_hist.shape[1]
    full = (count == m)[:, None, None]
    ps = torch.where(full, torch.roll(s_hist, -1, dims=1), s_hist)
    py = torch.where(full, torch.roll(y_hist, -1, dims=1), y_hist)
    idx = torch.where(count == m, m - 1, count)
    slot = (torch.arange(m)[None, :] == idx[:, None])[:, :, None]
    ps = torch.where(slot, s[:, None, :], ps)
    py = torch.where(slot, y[:, None, :], py)
    acc, fe, act = (v[:, None, None] for v in (accept, fresh, active))
    out = []
    for old, pushed in ((s_hist, ps), (y_hist, py)):
        new = torch.where(acc, pushed, old)
        new = torch.where(fe, torch.zeros(()), new)
        out.append(torch.where(act, new, old))
    counts = torch.where(accept, torch.clamp(count + 1, max=m), count)
    counts = torch.where(fresh, 0, counts)
    return out[0], out[1], torch.where(active, counts, count)


@pytest.mark.parametrize("seed", range(6))
def test_in_place_history_update_is_bitwise_the_functional_push(seed):
    rng = np.random.default_rng(seed)
    k, m, n = 24, 5, 37
    s_hist = torch.from_numpy(rng.normal(size=(k, m, n)).astype(np.float32))
    s_hist[rng.integers(k), rng.integers(m), rng.integers(n)] = float("nan")  # a poisoned slot stays local
    y_hist = torch.from_numpy(rng.normal(size=(k, m, n)).astype(np.float32))
    count = torch.from_numpy(rng.integers(0, m + 1, size=k).astype(np.int32))
    count[:3] = torch.tensor([0, m, m - 1], dtype=torch.int32)
    s, y = (torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)) for _ in range(2))
    accept, fresh, active = (torch.from_numpy(rng.random(k) < p) for p in (0.6, 0.25, 0.75))
    want = _functional_history(s_hist, y_hist, count, s, y, accept, fresh, active)

    got_s, got_y = s_hist.clone(), y_hist.clone()
    pushed = lbfgs._update_history_(got_s, got_y, count, s, y, accept & active & ~fresh, fresh & active)
    counts = torch.where(active, torch.where(fresh, 0, torch.where(accept, pushed, count)), count)
    for got, ref in ((got_s, want[0]), (got_y, want[1])):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))  # every bit, NaN payloads too
    assert torch.equal(counts, want[2])
    # with no client to reset, the update is the push alone
    got_s, got_y = s_hist.clone(), y_hist.clone()
    lbfgs._update_history_(got_s, got_y, count, s, y, accept & active)
    ref = _functional_history(s_hist, y_hist, count, s, y, accept, torch.zeros_like(fresh), active)
    assert torch.equal(got_s.view(torch.int32), ref[0].view(torch.int32))
