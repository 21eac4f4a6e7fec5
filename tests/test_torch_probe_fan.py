"""The line search's probe fan against the JAX package.

* `backtracking_armijo_probes_aux` against the JAX package's on a
  deterministic φ in float64, K clients at once (a quadratic a client, one
  client whose ladder never satisfies the condition, one whose probes go
  NaN, which the reference's rule accepts): the accepted step sizes and
  the evaluation counts equal JAX's, exactly, for P in {2, 4, 7}; and the
  step sizes equal the sequential search's.
* An engine step at `linesearch_probes=4` (`client_train_step`) from the
  same parameters, statistics and optimizer state as the JAX package's
  `lbfgs_step` with its engine's widened fan (`fold_params` over
  `active_leaf_mask`, the `--client-fold gemm` construction): two steps of
  Net's fc2 round (the convolutions and fc1 below it run once a fan, fc3
  above it on a 4-times-wider batch) and of a narrowed ResNet18's block1
  round (the stem and block0 once a fan, BatchNorm statistics per
  (client, probe) above), under both of the port's folds. Parameters within relative 1e-4 of the largest entry with
  equal iteration and evaluation counters, the new statistics within
  1e-5 — the per-step limits of the port's other slice tests
  (`tests/test_torch_resnet_slice.py`).
* 'gemm' against 'vmap' on the port alone, whole runs: relative 1e-6 (the
  two folds give the same values; on this CPU they agree in every bit).
* `linesearch_probes=1` never builds a fan and is bitwise the sequential
  search: a run equals the same run with the history pushed by the JAX
  package's functional recipe (roll, then write the slot) kept here as
  the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.optim.linesearch import backtracking_armijo_probes_aux as j_probes
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.optim import lbfgs
from federated_pytorch_test_tpu_torch.optim.linesearch import backtracking_armijo_aux, backtracking_armijo_probes_aux

NARROW = ((8, 1), (8, 1), (16, 2), (16, 1), (32, 2), (32, 1), (64, 2), (64, 1))
# per client: phi(a) = A·(a − B)² + F0 − A·B², so phi(0) = F0; client 3's
# minimum lies below 0 (no rung satisfies the condition), client 5's loss
# is NaN past a = 0.3
A = np.array([1.0, 40.0, 0.3, 5.0, 2.0, 1.0])
B = np.array([0.4, 0.01, 3.0, -1.0, 0.2, 0.5])
F0 = np.array([1.0, 2.0, 0.5, 1.0, 3.0, 1.0])
GTD = -2.0 * A * B  # phi'(0); client 3's is positive
ALPHABAR = np.array([1.0, 1.0, 8.0, 1.0, 0.05, 1.0])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work, as the other slice
    tests (the suite runs files in parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_fan(probes):
    """JAX's fan on the same φ, in float64, vmapped over the clients."""
    jax.config.update("jax_enable_x64", True)
    try:
        a_j, b_j, f_j = jnp.asarray(A), jnp.asarray(B), jnp.asarray(F0)

        def one(kk, f, g, ab):
            def phi_aux(a):
                loss = a_j[kk] * (a - b_j[kk]) ** 2 + f_j[kk] - a_j[kk] * b_j[kk] ** 2
                return jnp.where((kk == 5) & (a > 0.3), jnp.nan, loss), a

            return j_probes(phi_aux, f, g, ab, probes=probes)

        out = jax.vmap(one)(jnp.arange(len(A)), jnp.asarray(F0), jnp.asarray(GTD), jnp.asarray(ALPHABAR))
        return tuple(np.asarray(o) for o in out)
    finally:
        jax.config.update("jax_enable_x64", False)


def _losses(alphas):
    """The port's φ on `alphas [K, P]` (float64)."""
    a, b, f = (torch.from_numpy(v)[:, None] for v in (A, B, F0))
    out = a * (alphas - b) ** 2 + f - a * b**2
    nan = (torch.arange(len(A))[:, None] == 5) & (alphas > 0.3)
    return torch.where(nan, torch.nan, out)


@pytest.mark.parametrize("probes", [2, 4, 7])
def test_fan_picks_the_jax_step_and_counts_its_evaluations(probes):
    ja, jn, jaux = _jax_fan(probes)
    t = lambda v: torch.from_numpy(np.asarray(v, np.float64))
    alpha, n_evals, aux = backtracking_armijo_probes_aux(lambda al: (_losses(al), al), t(F0), t(GTD), t(ALPHABAR),
                                                        probes=probes)
    np.testing.assert_array_equal(alpha.numpy(), ja)
    np.testing.assert_array_equal(n_evals.numpy(), jn)
    np.testing.assert_array_equal(aux.numpy(), jaux)  # the aux of the accepted rung
    assert n_evals[3] == 36 and alpha[3] == 2.0**-35  # never satisfied: the whole ladder, rung max_iters
    assert alpha[5] == 1.0  # a NaN probe is accepted (the reference's rule)
    # client 1 accepts rung 6: every fan up to the one holding it is charged whole
    assert alpha[1] == 2.0**-6 and n_evals[1] == probes * -(-7 // probes)

    seq, _, _ = backtracking_armijo_aux(lambda al: (_losses(al[:, None])[:, 0], al), t(F0), t(GTD), t(ALPHABAR))
    np.testing.assert_array_equal(alpha.numpy(), seq.numpy())


def test_fan_freezes_inactive_clients_after_the_first_fan():
    calls = []

    def fan(al):
        calls.append(al.clone())
        return torch.full_like(al, 10.0), ()  # never satisfied

    z = torch.zeros(3, dtype=torch.float64)
    active = torch.tensor([True, False, True])
    alpha, n, _ = backtracking_armijo_probes_aux(fan, z, -torch.ones(3, dtype=torch.float64),
                                                 torch.ones(3, dtype=torch.float64), probes=4, active=active)
    assert len(calls) == 9  # 36 rungs in fans of 4
    # the inactive client keeps its first fan: its last rung, none satisfying
    assert n.tolist() == [36, 4, 36] and alpha[1] == 2.0**-3 and alpha[0] == 2.0**-35
    with pytest.raises(ValueError, match="probes must be >= 1"):
        backtracking_armijo_probes_aux(fan, z, z, z, probes=0)


def test_lbfgs_step_without_an_engine_fan_takes_the_sequential_steps():
    # `lbfgs_step` at ls_probes > 1 with no `fan_fn` evaluates each rung of
    # a fan as one call of `loss_fn`: the losses are the sequential search's,
    # so are the steps; only the charged evaluations and the passes differ
    from federated_pytorch_test_tpu_torch.optim import LBFGSConfig, lbfgs_init, lbfgs_step

    rng = np.random.default_rng(5)
    mats = torch.from_numpy(np.stack([m @ m.T / 6 + 0.1 * np.eye(6) for m in rng.normal(size=(4, 6, 6))]))
    rhs = torch.from_numpy(rng.normal(size=(4, 6)))

    def loss(x):
        return 0.5 * (x * (mats @ x[..., None])[..., 0]).sum(-1) - (rhs * x).sum(-1) + (x**4).sum(-1)

    out = {}
    for probes in (1, 4):
        cfg = LBFGSConfig(max_iter=5, history_size=4, line_search=True, batch_mode=True, ls_probes=probes)
        x = torch.full((4, 6), 2.0, dtype=torch.float64)
        st = lbfgs_init(x, cfg)
        for _ in range(3):
            x, st, _ = lbfgs_step(loss, x, st, cfg)
        out[probes] = (x, st)
    (x1, s1), (x4, s4) = out[1], out[4]
    assert torch.equal(x1, x4) and torch.equal(s1.n_iter, s4.n_iter)
    assert bool((s4.ls_evals >= s1.ls_evals).all()) and bool((s4.ls_evals % 4 == 0).all())
    assert s4.host_reads < s1.host_reads  # one read a fan, not one a halving


def _jax_steps(kind, gid, fold_params_on, probes=4):
    """Two L-BFGS steps of the JAX package on group `gid` from its init,
    with the engine's fan of `probes` (`fold_params` over
    `active_leaf_mask` when `fold_params_on`), and the port's step from
    each of the same states under both folds. Yields (step, {fold: port
    result}, JAX result)."""
    import optax

    from federated_pytorch_test_tpu.consensus import elastic_net as j_elastic
    from federated_pytorch_test_tpu.data import normalize as j_normalize
    from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
    from federated_pytorch_test_tpu.engine import Trainer as JTrainer
    from federated_pytorch_test_tpu.engine import get_preset as j_preset
    from federated_pytorch_test_tpu.models import Net as JNet
    from federated_pytorch_test_tpu.models import ResNet18 as JResNet18
    from federated_pytorch_test_tpu.models.base import active_leaf_mask, fold_params
    from federated_pytorch_test_tpu.optim import LBFGSConfig as JConfig
    from federated_pytorch_test_tpu.optim import lbfgs_init as j_lbfgs_init
    from federated_pytorch_test_tpu.optim import lbfgs_step as j_lbfgs_step
    from federated_pytorch_test_tpu_torch.convert import flat_from_jax, stats_from_jax
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step
    from federated_pytorch_test_tpu_torch.optim import LBFGSState
    from federated_pytorch_test_tpu_torch.models import ResNet18

    preset, jmodel, drive = {
        "net": ("fedavg", JNet, dict(batch=40, nadmm=1)),
        "resnet": ("fedavg_resnet", JResNet18, dict(batch=8, nadmm=1)),
    }[kind]
    n_train = 240 if kind == "net" else 96
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JResNet18, "STAGES", NARROW)
        mp.setattr(ResNet18, "STAGES", NARROW)
        jtr = JTrainer(j_preset(preset, linesearch_probes=probes, **drive), verbose=False,
                       source=j_synthetic(n_train, 20))
        jflat = np.array(jtr.flat)
        jstats = jax.tree.map(np.array, jtr.stats) if kind == "resnet" else None
        trs = {fold: Trainer(get_preset(preset, linesearch_probes=probes, client_fold=fold, **drive), verbose=False,
                             source=synthetic_cifar(n_train, 20), device="cpu")
               for fold in ("gemm", "vmap")}
        tr = trs["gemm"]
        jpart, unravel = jtr.partition, jtr.unravel
        cfg = tr.cfg
        jcfg = JConfig(max_iter=cfg.lbfgs_max_iter, history_size=cfg.lbfgs_history, line_search=True,
                       batch_mode=True, direction=cfg.lbfgs_direction, ls_probes=probes)
        mask = active_leaf_mask(unravel, jpart, gid)
        assert any(mask) and not all(mask)

        def one_client(flat_c, x, st, stats_c, im, lab, mu, sd):
            images = j_normalize(im, mu, sd)

            def objective_with(params_of, v):
                full = jpart.insert(flat_c, gid, v)
                reg = j_elastic(v, cfg.lambda1, cfg.lambda2) if gid in jpart.linear_group_ids else 0.0
                if stats_c is None:
                    logits = jmodel().apply({"params": params_of(full)}, images)
                    new = ()
                else:
                    logits, mut = jmodel().apply({"params": params_of(full), "batch_stats": stats_c}, images,
                                                 train=True, mutable=["batch_stats"])
                    new = mut["batch_stats"]
                ce = optax.softmax_cross_entropy_with_integer_labels(logits, lab).mean()
                return ce + reg, (ce, new)

            fan_fn = None
            if fold_params_on:
                frozen = unravel(flat_c)

                def fan_fn(x_cur, d, alphas):
                    return jax.vmap(lambda a: objective_with(lambda f: fold_params(unravel(f), frozen, mask),
                                                             x_cur + a * d))(alphas)

            x, st, aux = j_lbfgs_step(lambda v: objective_with(unravel, v), x, st, jcfg, has_aux=True, fan_fn=fan_fn)
            if stats_c is not None:
                stats_c = jax.tree.map(lambda new, old: jnp.where(aux.aux_ok, new, old), aux.aux[1], stats_c)
            return x, st, stats_c

        jstep = jax.jit(jax.vmap(one_client))
        x = jax.vmap(lambda f: jpart.extract(f, gid))(jnp.asarray(jflat))
        st = jax.vmap(lambda v: j_lbfgs_init(v, jcfg))(x)
        imgs, labels = tr.shard_imgs.numpy(), tr.shard_labels.numpy()
        mean, std = tr.mean.numpy(), tr.std.numpy()
        rows = np.arange(cfg.n_clients)[:, None]
        idx = tr.epoch_indices(0, gid, 0, 0)

        def group_to_port(vec):
            full = np.zeros(vec.shape[:-1] + (jpart.total,), np.float32)
            full = np.asarray(jax.vmap(lambda f, v: jpart.insert(f, gid, v))(full.reshape(-1, jpart.total),
                                                                             vec.reshape(-1, vec.shape[-1])))
            out = tr.partition.extract(torch.from_numpy(flat_from_jax(full, tr.model)), gid)
            return out.reshape(*vec.shape[:-1], -1).contiguous()

        vecs = ("s_hist", "y_hist", "d", "prev_grad", "running_avg", "running_avg_sq")
        port_stats = (lambda s: stats_from_jax(s, tr.model)) if kind == "resnet" else (lambda s: {})
        for s in range(2):
            im, lab = imgs[rows, idx[s]], labels[rows, idx[s]]
            x_new, st_new, jstats_new = jstep(jnp.asarray(jflat), x, st, jstats, jnp.asarray(im), jnp.asarray(lab),
                                              mean, std)
            full = np.asarray(jax.vmap(lambda f, v: jpart.insert(f, gid, v))(jnp.asarray(jflat), x))
            out = {}
            for fold, t in trs.items():
                st_p = LBFGSState(**{f: group_to_port(np.asarray(v)) if f in vecs else torch.from_numpy(np.array(v))
                                     for f, v in st._asdict().items()})
                flat_p, st_p, stats_p, _ = client_train_step(
                    t.ctx(gid), torch.from_numpy(flat_from_jax(full, t.model)), st_p, port_stats(jstats),
                    torch.from_numpy(im), torch.from_numpy(lab), t.mean, t.std,
                )
                out[fold] = (t.partition.extract(flat_p, gid), stats_p, st_p)
            yield s, out, (group_to_port(np.asarray(x_new)), port_stats(jax.tree.map(np.asarray, jstats_new))
                           if jstats_new is not None else {}, st_new)
            x, st, jstats = x_new, st_new, jstats_new


@pytest.mark.parametrize("kind,gid", [("net", 3), ("resnet", 2)])
def test_a_fanned_engine_step_matches_jax_under_both_folds(kind, gid):
    n = 0
    for s, out, (x_j, stats_j, st_j) in _jax_steps(kind, gid, fold_params_on=True):
        for fold, (x_p, stats_p, st_p) in out.items():
            err = float((x_p - x_j).abs().max()) / float(x_j.abs().max())
            assert err <= 1e-4, f"{fold} step {s}: parameters relative {err:.3e}"
            for f in ("n_iter", "func_evals", "ls_evals", "hist_count"):
                assert torch.equal(getattr(st_p, f), torch.from_numpy(np.asarray(getattr(st_j, f)))), \
                    f"{fold} step {s}: {f}"
            assert sorted(stats_p) == sorted(stats_j)
            for name, t in stats_p.items():
                e = float((t - stats_j[name]).abs().max()) / float(stats_j[name].abs().max())
                assert e <= 1e-5, f"{fold} step {s} {name}: relative {e:.3e}"
        assert int(st_j.ls_evals.max()) >= 4  # the fan ran: a fan charges its width
        n += 1
    assert n == 2


def _run(preset, probes, fold, **kw):
    cfg = get_preset(preset, linesearch_probes=probes, client_fold=fold, device="cpu", **kw)
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(96 if "resnet" in preset else 240, 20))
    rec = tr.run()
    return tr, rec


def _series(rec, name="train_loss"):
    return np.asarray([r["value"] for r in rec.series[name]], np.float64)


@pytest.mark.parametrize("preset", ["fedavg", "admm_resnet"])
def test_gemm_and_vmap_folds_agree(preset, monkeypatch):
    from federated_pytorch_test_tpu_torch.models import ResNet18

    monkeypatch.setattr(ResNet18, "STAGES", NARROW)
    kw = dict(batch=40, nloop=1, nadmm=1, max_groups=3) if preset == "fedavg" else \
        dict(batch=8, nloop=1, nadmm=1, max_groups=2, eval_batch=20)
    (tg, rg), (tv, rv) = _run(preset, 4, "gemm", **kw), _run(preset, 4, "vmap", **kw)
    for name in ("train_loss", "dual_residual", "test_accuracy"):
        a, b = _series(rg, name), _series(rv, name)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_allclose(tg.flat.numpy(), tv.flat.numpy(), rtol=0, atol=1e-6 * float(tv.flat.abs().max()))
    for n, t in tg.stats.items():
        np.testing.assert_allclose(t.numpy(), tv.stats[n].numpy(), rtol=1e-6, atol=1e-7, err_msg=n)


def _functional_push(s_hist, y_hist, count, s, y):
    """The history push before it was done in place (the JAX package's roll
    and slot write, batched): the reference for the in-place push."""
    m = s_hist.shape[1]
    full = (count == m)[:, None, None]
    s_hist = torch.where(full, torch.roll(s_hist, -1, dims=1), s_hist)
    y_hist = torch.where(full, torch.roll(y_hist, -1, dims=1), y_hist)
    idx = torch.where(count == m, m - 1, count)
    slot = (torch.arange(m)[None, :] == idx[:, None])[:, :, None]
    s_hist = torch.where(slot, s[:, None, :], s_hist)
    y_hist = torch.where(slot, y[:, None, :], y_hist)
    return s_hist, y_hist, torch.clamp(count + 1, max=m)


def _push_by_the_functional_recipe(s_hist, y_hist, count, s, y, push):
    ps, py, pc = _functional_push(s_hist, y_hist, count, s, y)
    mask = push[:, None, None]
    s_hist.copy_(torch.where(mask, ps, s_hist))
    y_hist.copy_(torch.where(mask, py, y_hist))
    return torch.where(push, pc, count)


@pytest.mark.parametrize("direction", ["compact", "pallas"])
def test_one_probe_is_the_sequential_search_bitwise(direction, monkeypatch):
    def no_fan(*a, **k):
        raise AssertionError("a fan was built at linesearch_probes=1")

    kw = dict(batch=40, nloop=1, nadmm=2, max_groups=2, lbfgs_direction=direction)
    monkeypatch.setattr(lbfgs, "backtracking_armijo_probes_aux", no_fan)
    tr, rec = _run("fedavg", 1, "gemm", **kw)
    monkeypatch.setattr(lbfgs, "_push_history_", _push_by_the_functional_recipe)
    tr_ref, rec_ref = _run("fedavg", 1, "gemm", **kw)
    for name in ("train_loss", "dual_residual", "test_accuracy"):
        np.testing.assert_array_equal(_series(rec, name), _series(rec_ref, name), err_msg=name)
    assert torch.equal(tr.flat, tr_ref.flat)
