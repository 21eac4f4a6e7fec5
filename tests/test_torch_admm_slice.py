"""Port parity for the admm slice: the admm preset end to end.

The drive — `synthetic_cifar(240, 60)`, Net, K=3, batch 40, nloop 1,
nadmm 3 (BB is due at nadmm 2), the first 2 groups of the train order,
the fused-kernel L-BFGS direction — runs through the JAX package's
Trainer and the port's Trainer from the same initial parameters (the JAX
init, converted). Both draw the same minibatches.

As in `tests/test_torch_slice.py`, what separates the two packages is
float32 rounding that the stochastic L-BFGS trajectory amplifies. Each
round is held to relative 1e-3 where the port reaches it, and otherwise
to a limit about 1.5 times the largest port-vs-JAX reading on this drive
with 1, 3 or 8 torch threads (conv1's rounds, at losses of 3e-4 to 4e-5).
`ROUND_LIMITS` lists them with the readings beside them (`PYTHONPATH=.
python tests/test_torch_admm_slice.py` prints them). The
mean rho is held within relative 1e-6: both packages keep rho0 on this
drive (BB rejects every proposal at nadmm 2), which the test also checks.
Accuracy: within one test sample.

Per step (`test_each_step_matches_jax_from_the_same_state`): the JAX
package's L-BFGS steps with its ADMM term make the trajectory, and its
`admm_round` the consensus; before each step the port gets the same
parameters, optimizer state and y, z, rho, converted, and must land
within relative 1e-4 of the JAX step on every coordinate with equal
iteration counters, except the steps listed in `STEP_LIMITS`.
"""

import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
from federated_pytorch_test_tpu.engine import Trainer as JTrainer
from federated_pytorch_test_tpu.engine import get_preset as j_preset
from federated_pytorch_test_tpu_torch.convert import flat_from_jax
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.models import Net

DRIVE = dict(batch=40, nloop=1, nadmm=3, max_groups=2, lbfgs_direction="pallas")
N_TEST = 60
SERIES = ("train_loss", "primal_residual", "dual_residual")
# (group, nadmm) -> relative limits of (train loss, primal, dual); the
# largest port-vs-JAX readings with 1, 3 and 8 torch threads beside them
ROUND_LIMITS = {
    (2, 0): (1e-3, 1e-3, 1e-3),  # readings: 2.3e-5, 2.6e-7, 3.0e-7
    (2, 1): (1e-3, 1e-3, 1e-3),  # 9.0e-5, 7.6e-7, 7.2e-6
    (2, 2): (3e-3, 1e-3, 1e-3),  # 1.8e-3, 2.9e-4, 4.1e-4
    # conv1: losses of 3e-4 down to 4e-5, where L-BFGS takes many halvings
    (0, 0): (6e-3, 1e-3, 1e-3),  # 3.9e-3, 2.7e-4, 1.1e-4
    (0, 1): (6e-3, 4e-3, 2e-3),  # 3.9e-3, 2.3e-3, 9.8e-4
    (0, 2): (9e-3, 4e-3, 2e-3),  # 6.0e-3, 2.8e-3, 1.2e-3
}



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

@pytest.fixture(scope="module")
def runs():
    jtr = JTrainer(j_preset("admm", **DRIVE), verbose=False, source=j_synthetic(240, N_TEST))
    flat0 = np.array(jtr.flat)  # a copy: the JAX run donates its buffers
    jrec = jtr.run()
    tr = Trainer(
        get_preset("admm", **DRIVE), verbose=False, source=synthetic_cifar(240, N_TEST),
        device="cpu", init_flat=flat_from_jax(flat0, Net()),
    )
    return jrec, tr.run(), tr


def _values(rec, name):
    return [(r["nloop"], r["group"], r["nadmm"], r["value"]) for r in rec.series[name]]


def _by_round(rec, name):
    out = {}
    for _, gid, a, value in _values(rec, name):
        out.setdefault((gid, a), []).append(value)
    return {key: np.asarray(v, np.float64) for key, v in out.items()}


def test_admm_slice_visits_the_same_rounds(runs):
    jrec, rec, tr = runs
    assert tr.group_order == [2, 0]
    for name in (*SERIES, "mean_rho", "test_accuracy"):
        assert [v[:3] for v in _values(rec, name)] == [v[:3] for v in _values(jrec, name)], name
    assert len(rec.series["train_loss"]) == 2 * 3 * 2  # groups x nadmm x steps
    assert sorted(_by_round(rec, "dual_residual")) == sorted(ROUND_LIMITS)


@pytest.mark.parametrize("name", SERIES)
def test_admm_slice_series_match(runs, name):
    jrec, rec, _ = runs
    got, want = _by_round(rec, name), _by_round(jrec, name)
    for key, limits in ROUND_LIMITS.items():
        tol = limits[SERIES.index(name)]
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=0, err_msg=f"{name} round {key}")


def test_admm_slice_mean_rho_matches(runs):
    jrec, rec, _ = runs
    got, want = _by_round(rec, "mean_rho"), _by_round(jrec, "mean_rho")
    for key in ROUND_LIMITS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=f"round {key}")
        np.testing.assert_allclose(got[key], 1e-3, rtol=1e-6)  # no proposal accepted on this drive


def test_admm_slice_accuracies_match(runs):
    jrec, rec, _ = runs
    got = np.asarray([v[3] for v in _values(rec, "test_accuracy")]) * N_TEST
    want = np.asarray([v[3] for v in _values(jrec, "test_accuracy")]) * N_TEST
    assert np.all(np.abs(got - want) <= 1.0 + 1e-9)


def _step_by_step():
    """The drive step by step: the JAX package's L-BFGS steps (vmapped over
    the clients, its engine's objective with the ADMM term) and its
    `admm_round` make the trajectory; before each step the port is fed the
    same parameters, optimizer state and y, z, rho, converted. Yields
    (group, nadmm, minibatch, port step, JAX step)."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch
    from jax.sharding import PartitionSpec as P

    from federated_pytorch_test_tpu.consensus import admm_init as j_admm_init
    from federated_pytorch_test_tpu.consensus import admm_penalty as j_admm_penalty
    from federated_pytorch_test_tpu.consensus import admm_round as j_admm_round
    from federated_pytorch_test_tpu.consensus import elastic_net as j_elastic
    from federated_pytorch_test_tpu.data import normalize as j_normalize
    from federated_pytorch_test_tpu.models import Net as JNet
    from federated_pytorch_test_tpu.models import init_client_params as j_init_params
    from federated_pytorch_test_tpu.optim import LBFGSConfig as JConfig
    from federated_pytorch_test_tpu.optim import lbfgs_init as j_lbfgs_init
    from federated_pytorch_test_tpu.optim import lbfgs_step as j_lbfgs_step
    from federated_pytorch_test_tpu.parallel import CLIENT_AXIS, client_mesh, shard_map
    from federated_pytorch_test_tpu.partition import flatten_params as jflatten
    from federated_pytorch_test_tpu_torch.consensus import ADMMState
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step
    from federated_pytorch_test_tpu_torch.optim import LBFGSState

    cfg = get_preset("admm", **DRIVE)
    jadmm = j_preset("admm", **DRIVE).admm_config()
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(240, N_TEST), device="cpu")
    model, k = Net(), cfg.n_clients
    params0 = jax.tree.map(lambda x: x[0], j_init_params(JNet(), k, seed=0)["params"])
    flat0, unravel = jflatten(params0)
    jpart = JNet.partition(params0)
    jflat = jnp.broadcast_to(flat0[None], (k, flat0.shape[0]))
    jcfg = JConfig(max_iter=cfg.lbfgs_max_iter, history_size=cfg.lbfgs_history, line_search=True,
                   batch_mode=True, direction=cfg.lbfgs_direction)
    imgs, labels = tr.shard_imgs.numpy(), tr.shard_labels.numpy()
    mean, std = tr.mean.numpy(), tr.std.numpy()
    rows = np.arange(k)[:, None]
    c = P(CLIENT_AXIS)
    st_spec = type(j_admm_init(jnp.zeros((k, 1)), jadmm))(y=c, z=P(), rho=c, yhat0=c, x0=c)

    def consensus(x, st, a):
        fn = shard_map(lambda xx, ss: j_admm_round(xx, ss, jnp.int32(a), jadmm)[0], mesh=client_mesh(1),
                       in_specs=(c, st_spec), out_specs=st_spec)
        return jax.jit(fn)(x, st)

    def group_to_port(vec, gid):  # [..., G] in JAX order -> port order
        full = np.zeros(vec.shape[:-1] + (jpart.total,), np.float32)
        off = 0
        for seg in jpart.groups[gid]:
            full[..., seg.start : seg.start + seg.size] = vec[..., off : off + seg.size]
            off += seg.size
        return tr.partition.extract(torch.from_numpy(flat_from_jax(full, model)), gid).contiguous()

    def state_to_port(st, gid):
        vecs = ("s_hist", "y_hist", "d", "prev_grad", "running_avg", "running_avg_sq")
        return LBFGSState(**{
            f: group_to_port(np.asarray(v), gid) if f in vecs else torch.from_numpy(np.array(v))
            for f, v in st._asdict().items()
        })

    def admm_to_port(ast, gid):
        return ADMMState(y=group_to_port(np.asarray(ast.y), gid), z=group_to_port(np.asarray(ast.z), gid),
                         rho=torch.from_numpy(np.array(ast.rho)), yhat0=None, x0=None)

    for gid in tr.group_order:
        reg = gid in jpart.linear_group_ids

        def one_client(flat_c, x, st, im, lab, mu, sd, y, z, rho, gid=gid, reg=reg):
            images = j_normalize(im, mu, sd)

            def loss_fn(v):
                logits = JNet().apply({"params": unravel(jpart.insert(flat_c, gid, v))}, images)
                loss = optax.softmax_cross_entropy_with_integer_labels(logits, lab).mean()
                if reg:
                    loss = loss + j_elastic(v, cfg.lambda1, cfg.lambda2)
                return loss + j_admm_penalty(v, y, z, rho)

            x, st, _ = j_lbfgs_step(loss_fn, x, st, jcfg)
            return x, st

        jstep = jax.jit(jax.vmap(one_client, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None, 0)))
        x = jax.vmap(lambda f: jpart.extract(f, gid))(jflat)
        st = jax.vmap(lambda v: j_lbfgs_init(v, jcfg))(x)
        ast = j_admm_init(x, jadmm)
        ctx = tr.ctx(gid)
        for a in range(cfg.nadmm):
            idx = tr.epoch_indices(0, gid, a, 0)
            for s in range(idx.shape[0]):
                im, lab = imgs[rows, idx[s]], labels[rows, idx[s]]
                x_new, st_new = jstep(jflat, x, st, jnp.asarray(im), jnp.asarray(lab), mean, std,
                                      ast.y, ast.z, ast.rho)
                full = jax.vmap(lambda f, v: jpart.insert(f, gid, v))(jflat, x)
                flat_p = torch.from_numpy(flat_from_jax(np.asarray(full), model))
                flat_p, st_p, _, _ = client_train_step(
                    ctx, flat_p, state_to_port(st, gid), {}, torch.from_numpy(im), torch.from_numpy(lab),
                    tr.mean, tr.std, admm_to_port(ast, gid),
                )
                yield gid, a, s, (tr.partition.extract(flat_p, gid), st_p), (group_to_port(np.asarray(x_new), gid),
                                                                              st_new)
                x, st = x_new, st_new
            ast = consensus(x, ast, a)  # the clients keep their x
        jflat = jax.vmap(lambda f, v: jpart.insert(f, gid, v))(jflat, x)


# (group, nadmm, minibatch) -> {client: (limit, coordinates allowed past
# 1e-4, counters compared)}; every other (step, client) is held to
# relative 1e-4 on every coordinate with equal counters. Readings beside.
STEP_LIMITS = {
    # one fc1 coordinate near the elastic net's kink at 0 (port -0.0023,
    # JAX -0.0052 after the step). Reading 8.2e-3 at 1 of 48,120
    # coordinates, the rest within 1e-6.
    (2, 2, 0): {1: (2e-2, 1, True)},
    # conv1 at losses near 1e-4: the gradients carry rounding at 1e-3 of
    # their size. Readings 1.2e-3 at 117 of 456 coordinates (1 and 3 torch
    # threads; 2.5e-4 at 55 with 8), and 2.5e-4 at 111; equal counters.
    (0, 1, 0): {2: (2e-3, 200, True)},
    (0, 1, 1): {1: (5e-4, 200, True)},
}


def test_each_step_matches_jax_from_the_same_state():
    n = 0
    for gid, a, s, (x_p, st_p), (x_j, st_j) in _step_by_step():
        err = ((x_p - x_j).abs() / float(x_j.abs().max())).numpy()  # [K, G]
        for c in range(err.shape[0]):
            limit, outliers, counters = STEP_LIMITS.get((gid, a, s), {}).get(c, (1e-4, 0, True))
            where = f"step (group {gid}, nadmm {a}, minibatch {s}) client {c}"
            assert err[c].max() <= limit, f"{where}: relative {err[c].max():.3e}"
            if outliers is not None:
                assert int((err[c] > 1e-4).sum()) <= outliers, f"{where}: {int((err[c] > 1e-4).sum())} coordinates"
            if counters:
                for f in ("n_iter", "func_evals", "ls_evals", "hist_count"):
                    assert int(getattr(st_p, f)[c]) == int(np.asarray(getattr(st_j, f))[c]), f"{where}: {f}"
        n += 1
    assert n == 2 * 3 * 2  # groups x nadmm x minibatches


if __name__ == "__main__":
    # the port-vs-JAX readings behind ROUND_LIMITS and STEP_LIMITS
    jrec, rec, _ = runs.__wrapped__()
    for name in (*SERIES, "mean_rho"):
        got, want = _by_round(rec, name), _by_round(jrec, name)
        for key in ROUND_LIMITS:
            diff = np.abs(got[key] - want[key])
            print(f"{name} round={key} max_rel={np.max(diff / np.abs(want[key])):.3e} max_abs={np.max(diff):.3e}")
    for gid, a, s, (x_p, st_p), (x_j, st_j) in _step_by_step():
        err = ((x_p - x_j).abs() / float(x_j.abs().max())).numpy()
        same = [all(int(getattr(st_p, f)[c]) == int(np.asarray(getattr(st_j, f))[c])
                    for f in ("n_iter", "func_evals", "ls_evals", "hist_count")) for c in range(err.shape[0])]
        print(f"step group={gid} nadmm={a} minibatch={s} per-client max_rel="
              f"{','.join(f'{e:.3e}' for e in err.max(1))} past_1e-4={(err > 1e-4).sum(1).tolist()} counters={same}")
