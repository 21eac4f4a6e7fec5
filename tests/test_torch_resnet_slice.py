"""Port parity for the ResNet slices: `admm_resnet` and `fedavg_resnet` on the engine.

Both packages run ResNet18 at a narrow width (`STAGES` planes 8/16/32/64
on both classes, as `tests/test_torch_resnet.py` sets them; nothing in the
JAX package is edited), K=3, batch 8, on `synthetic_cifar(96, 40)` (4
minibatches a client), with the fused-kernel direction, from one state:
the JAX package's init and BatchNorm statistics, converted.

* `admm_resnet` through both Trainers: nadmm 2, the first two groups of
  the preset's shuffled order (block1, then block7). Per round the train
  loss, primal and dual residuals and mean rho, then the accuracies and
  the clients' running statistics at the end. Relative 1e-3 where the port
  reaches it; past that, about twice the largest reading with 1, 3 or 8
  torch threads (`ROUND_LIMITS`, `STATS_LIMITS`). block7's second round
  is where the stochastic L-BFGS trajectory has amplified float32
  rounding to percent level (train loss 1.9e-2, its BatchNorm variances
  4.9e-2): every single step agrees within 1e-6 from the same state (the
  step test below runs block7's), and on this drive the port's own
  `compact` and `pallas` directions, which differ only in rounding, drift
  apart by 1.9e-3 in that round's loss and 4e-3 in those statistics.
  The fixed rho stays 1e-3 in both; accuracies within one test sample.
* `fedavg_resnet` step by step on block7's round (the largest group): the
  JAX package's L-BFGS steps, with the engine's folded objective (the
  accepted evaluation's new statistics, the previous ones where the
  NaN-step fallback leaves the final point unevaluated), make the
  trajectory; before each step the port gets the same parameters,
  statistics and optimizer state. Parameters within relative 1e-4 of the
  largest entry with equal iteration counters (reading 1.0e-6), the new
  statistics within 1e-5 (reading 3.9e-6).
"""

import jax
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
from federated_pytorch_test_tpu.engine import Trainer as JTrainer
from federated_pytorch_test_tpu.engine import get_preset as j_preset
from federated_pytorch_test_tpu.models import ResNet18 as JResNet18
from federated_pytorch_test_tpu_torch.convert import flat_from_jax, stats_from_jax
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.models import ResNet18

NARROW = ((8, 1), (8, 1), (16, 2), (16, 1), (32, 2), (32, 1), (64, 2), (64, 1))
N_TRAIN, N_TEST = 96, 40
DRIVE = dict(batch=8, nloop=1, nadmm=2, max_groups=2, eval_batch=N_TEST, lbfgs_direction="pallas")
SERIES = ("train_loss", "primal_residual", "dual_residual")
# (group, nadmm) -> relative limits of (train loss, primal, dual); the
# largest port-vs-JAX readings with 1, 3 and 8 torch threads beside them
ROUND_LIMITS = {
    (2, 0): (1e-3, 1e-3, 1e-3),  # readings 3.4e-5, 8.1e-7, 2.0e-6
    (2, 1): (1e-3, 1e-3, 1e-3),  # 1.5e-4, 1.5e-5, 4.7e-5
    (8, 0): (3e-3, 1e-3, 1e-3),  # 1.4e-3, 3.2e-4, 2.4e-6
    (8, 1): (4e-2, 2e-2, 2e-2),  # 1.9e-2, 8.8e-3, 1.1e-2
}
# the clients' running statistics after the run, relative to each tensor's
# largest entry: block7's layers (trained last; readings up to 4.9e-2, its
# bn2 variance) and every other layer (4.0e-4)
STATS_LIMITS = {"block7": 1e-1, "other": 1e-3}



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs files
    in parallel processes, and a thread per core in each of them
    oversubscribes the cores. The readings behind the limits hold with
    1, 3 and 8 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _jax_trainer(preset, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JResNet18, "STAGES", NARROW)
        return JTrainer(j_preset(preset, **kw), verbose=False, source=j_synthetic(N_TRAIN, N_TEST))


def _port_trainer(preset, flat0, stats0, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ResNet18, "STAGES", NARROW)
        model = ResNet18()
        return Trainer(get_preset(preset, **kw), verbose=False, source=synthetic_cifar(N_TRAIN, N_TEST),
                       device="cpu", init_flat=flat_from_jax(flat0, model), init_stats=stats_from_jax(stats0, model))


@pytest.fixture(scope="module")
def admm_runs():
    jtr = _jax_trainer("admm_resnet", **DRIVE)
    flat0 = np.array(jtr.flat)  # copies: the JAX run donates its buffers
    stats0 = jax.tree.map(np.array, jtr.stats)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JResNet18, "STAGES", NARROW)
        jrec = jtr.run()
    tr = _port_trainer("admm_resnet", flat0, stats0, **DRIVE)
    return jtr, jrec, tr, tr.run()


def _by_round(rec, name):
    out = {}
    for r in rec.series[name]:
        out.setdefault((r["group"], r["nadmm"]), []).append(r["value"])
    return {key: np.asarray(v, np.float64) for key, v in out.items()}


def test_admm_resnet_visits_the_same_rounds(admm_runs):
    jtr, jrec, tr, rec = admm_runs
    assert tr.group_order == jtr.group_order == [2, 8]
    for name in (*SERIES, "mean_rho", "test_accuracy"):
        assert sorted(_by_round(rec, name)) == sorted(_by_round(jrec, name)) == sorted(ROUND_LIMITS), name
    assert len(rec.series["train_loss"]) == 2 * 2 * 4  # groups x nadmm x steps


@pytest.mark.parametrize("name", SERIES)
def test_admm_resnet_series_match(admm_runs, name):
    _, jrec, _, rec = admm_runs
    got, want = _by_round(rec, name), _by_round(jrec, name)
    for key, limits in ROUND_LIMITS.items():
        tol = limits[SERIES.index(name)]
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=0, err_msg=f"{name} round {key}")


def test_admm_resnet_keeps_its_fixed_rho(admm_runs):
    _, jrec, _, rec = admm_runs
    got, want = _by_round(rec, "mean_rho"), _by_round(jrec, "mean_rho")
    for key in ROUND_LIMITS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
        np.testing.assert_allclose(got[key], 1e-3, rtol=1e-6)


def test_admm_resnet_accuracies_and_statistics_match(admm_runs):
    jtr, jrec, tr, rec = admm_runs
    got = np.asarray([r["value"] for r in rec.series["test_accuracy"]]) * N_TEST
    want = np.asarray([r["value"] for r in jrec.series["test_accuracy"]]) * N_TEST
    assert np.all(np.abs(got - want) <= 1.0 + 1e-9)
    jstats = stats_from_jax(jax.tree.map(np.asarray, jtr.stats), tr.model)
    assert sorted(jstats) == sorted(tr.stats)
    init = tr.model.init_stats(3, "cpu")
    for name, t in tr.stats.items():
        want_t = jstats[name].numpy().astype(np.float64)
        err = np.abs(t.numpy() - want_t).max() / np.abs(want_t).max()
        limit = STATS_LIMITS["block7" if name.startswith("block7.") else "other"]
        assert err <= limit, f"{name}: relative {err:.3e}"
        assert torch.isfinite(t).all() and not torch.equal(t, init[name])  # every layer's averages moved


def _fedavg_steps(gid):
    """`fedavg_resnet`'s round of group `gid` (nadmm 1) step by step. Yields
    (minibatch, port (x, stats, state), JAX (x, stats, state))."""
    import jax.numpy as jnp
    import optax

    from federated_pytorch_test_tpu.data import normalize as j_normalize
    from federated_pytorch_test_tpu.optim import LBFGSConfig as JConfig
    from federated_pytorch_test_tpu.optim import lbfgs_init as j_lbfgs_init
    from federated_pytorch_test_tpu.optim import lbfgs_step as j_lbfgs_step
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step
    from federated_pytorch_test_tpu_torch.optim import LBFGSState

    kw = dict(DRIVE, nadmm=1)
    jtr = _jax_trainer("fedavg_resnet", **kw)
    jflat, jstats = np.array(jtr.flat), jax.tree.map(np.array, jtr.stats)
    tr = _port_trainer("fedavg_resnet", jflat, jstats, **kw)
    cfg = tr.cfg
    jpart, unravel = jtr.partition, jtr.unravel
    jcfg = JConfig(max_iter=cfg.lbfgs_max_iter, history_size=cfg.lbfgs_history, line_search=True,
                   batch_mode=True, direction=cfg.lbfgs_direction)
    imgs, labels = tr.shard_imgs.numpy(), tr.shard_labels.numpy()
    mean, std = tr.mean.numpy(), tr.std.numpy()
    rows = np.arange(cfg.n_clients)[:, None]

    def one_client(flat_c, x, st, stats_c, im, lab, mu, sd):
        images = j_normalize(im, mu, sd)

        def loss_fn(v):
            logits, mut = JResNet18().apply({"params": unravel(jpart.insert(flat_c, gid, v)), "batch_stats": stats_c},
                                            images, train=True, mutable=["batch_stats"])
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, lab).mean()
            return ce, (ce, mut["batch_stats"])

        x, st, aux = j_lbfgs_step(loss_fn, x, st, jcfg, has_aux=True)
        stats_c = jax.tree.map(lambda new, old: jnp.where(aux.aux_ok, new, old), aux.aux[1], stats_c)
        return x, st, stats_c

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JResNet18, "STAGES", NARROW)
        jstep = jax.jit(jax.vmap(one_client))
        x = jax.vmap(lambda f: jpart.extract(f, gid))(jnp.asarray(jflat))
        st = jax.vmap(lambda v: j_lbfgs_init(v, jcfg))(x)
        ctx = tr.ctx(gid)
        idx = tr.epoch_indices(0, gid, 0, 0)

        def group_to_port(vec):
            full = np.zeros(vec.shape[:-1] + (jpart.total,), np.float32)
            full = np.asarray(jax.vmap(lambda f, v: jpart.insert(f, gid, v))(full.reshape(-1, jpart.total),
                                                                             vec.reshape(-1, vec.shape[-1])))
            out = tr.partition.extract(torch.from_numpy(flat_from_jax(full, tr.model)), gid)
            return out.reshape(*vec.shape[:-1], -1).contiguous()

        vecs = ("s_hist", "y_hist", "d", "prev_grad", "running_avg", "running_avg_sq")
        for s in range(idx.shape[0]):
            im, lab = imgs[rows, idx[s]], labels[rows, idx[s]]
            x_new, st_new, jstats_new = jstep(jnp.asarray(jflat), x, st, jstats, jnp.asarray(im), jnp.asarray(lab),
                                              mean, std)
            full = np.asarray(jax.vmap(lambda f, v: jpart.insert(f, gid, v))(jnp.asarray(jflat), x))
            st_p = LBFGSState(**{f: group_to_port(np.asarray(v)) if f in vecs else torch.from_numpy(np.array(v))
                                 for f, v in st._asdict().items()})
            flat_p, st_p, stats_p, _ = client_train_step(
                ctx, torch.from_numpy(flat_from_jax(full, tr.model)), st_p, stats_from_jax(jstats, tr.model),
                torch.from_numpy(im), torch.from_numpy(lab), tr.mean, tr.std,
            )
            yield s, (tr.partition.extract(flat_p, gid), stats_p, st_p), (
                group_to_port(np.asarray(x_new)), stats_from_jax(jax.tree.map(np.asarray, jstats_new), tr.model),
                st_new)
            x, st, jstats = x_new, st_new, jstats_new


def test_each_fedavg_resnet_step_matches_jax():
    n = 0
    for s, (x_p, stats_p, st_p), (x_j, stats_j, st_j) in _fedavg_steps(8):
        err = float((x_p - x_j).abs().max()) / float(x_j.abs().max())
        assert err <= 1e-4, f"step {s}: parameters relative {err:.3e}"
        for f in ("n_iter", "func_evals", "ls_evals", "hist_count"):
            assert torch.equal(getattr(st_p, f), torch.from_numpy(np.asarray(getattr(st_j, f)))), f"step {s}: {f}"
        assert sorted(stats_p) == sorted(stats_j)
        for name, t in stats_p.items():
            e = float((t - stats_j[name]).abs().max()) / float(stats_j[name].abs().max())
            assert e <= 1e-5, f"step {s} {name}: relative {e:.3e}"
        n += 1
    assert n == 4  # minibatches of the round


if __name__ == "__main__":
    # the port-vs-JAX readings behind the limits
    jtr, jrec, tr, rec = admm_runs.__wrapped__()
    for name in (*SERIES, "mean_rho"):
        got, want = _by_round(rec, name), _by_round(jrec, name)
        for key in ROUND_LIMITS:
            diff = np.abs(got[key] - want[key])
            print(f"{name} round={key} max_rel={np.max(diff / np.abs(want[key])):.3e}")
    jstats = stats_from_jax(jax.tree.map(np.asarray, jtr.stats), tr.model)
    for part in STATS_LIMITS:
        print(f"final stats {part} max_rel", max(float((t - jstats[n]).abs().max() / jstats[n].abs().max())
                                                for n, t in tr.stats.items() if n.startswith("block7.") == (part == "block7")))
    for s, (x_p, stats_p, _), (x_j, stats_j, _) in _fedavg_steps(8):
        print(f"step {s} params max_rel={float((x_p - x_j).abs().max()) / float(x_j.abs().max()):.3e} stats max_rel="
              f"{max(float((t - stats_j[n]).abs().max()) / float(stats_j[n].abs().max()) for n, t in stats_p.items()):.3e}")
