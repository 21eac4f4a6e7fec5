"""Port parity for the whole slice: the fedavg preset end to end.

The verify drive — `synthetic_cifar(240, 60)`, Net, K=3, batch 40,
nloop 1, nadmm 2, the first 2 groups of the train order, the fused-kernel
L-BFGS direction — runs through the JAX package's Trainer and the port's
Trainer from the same initial parameters (the JAX init, converted). Both
draw the same minibatches (same numpy shuffle recipe).

Tolerances and why. What separates the two packages on this drive is
float32 rounding, made larger by the optimizer. From the same parameters the port's entry loss
equals the JAX package's and its gradient agrees within relative 9e-7
(the convolutions sum in another order). The shards hold 80 samples, so
the clients memorize their batches within a few steps, and the stochastic
L-BFGS trajectory amplifies that difference minibatch by minibatch. The
JAX package's own 'compact' and 'pallas' backends, which share every
forward pass and differ only in the direction's rounding, drift apart by
up to 2.3e-4 in train loss and 4.4e-4 in dual residual on this drive.

Each round is held to relative 1e-3 where the port reaches it, and
otherwise to a limit just above the port-vs-JAX reading on this drive
(the same with 1, 3 or 8 torch threads; `PYTHONPATH=. python
tests/test_torch_slice.py` prints the readings). `ROUND_LIMITS` lists each
round's limits, with the largest reading beside them. The last round's
losses lie near 1e-6. That is the float32 resolution of a cross-entropy
whose logits are of order 10 (their spacing is about 1e-6), so those
losses are held in absolute terms.

Per-client accuracy: within one test sample, since a logit that differs
in its last bits can flip one borderline prediction.
"""

import numpy as np
import pytest

from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
from federated_pytorch_test_tpu.engine import Trainer as JTrainer
from federated_pytorch_test_tpu.engine import get_preset as j_preset
from federated_pytorch_test_tpu_torch.convert import flat_from_jax
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.models import Net

DRIVE = dict(batch=40, nloop=1, nadmm=2, max_groups=2, lbfgs_direction="pallas")
N_TEST = 60
# (group, nadmm) -> (train-loss limit, dual-residual limit), relative
# unless marked "abs"; readings are the port-vs-JAX maxima on this drive
ROUND_LIMITS = {
    (2, 0): ((1e-3, "rel"), 1e-3),  # readings: loss 3.0e-5, dual 9.9e-8
    (2, 1): ((4e-3, "rel"), 1e-3),  # loss 3.0e-3, dual 1.6e-4
    (0, 0): ((4e-3, "rel"), 1e-3),  # loss 2.8e-3, dual 7.4e-5
    (0, 1): ((2e-6, "abs"), 3e-2),  # loss 1.5e-6 abs (0.64 rel at 1e-6), dual 2.3e-2
}


@pytest.fixture(scope="module")
def runs():
    jtr = JTrainer(j_preset("fedavg", **DRIVE), verbose=False, source=j_synthetic(240, N_TEST))
    flat0 = np.array(jtr.flat)  # a copy: the JAX run donates its buffers
    jrec = jtr.run()
    tr = Trainer(
        get_preset("fedavg", **DRIVE), verbose=False, source=synthetic_cifar(240, N_TEST),
        device="cpu", init_flat=flat_from_jax(flat0, Net()),
    )
    return jrec, tr.run(), tr


def _values(rec, name):
    return [(r["nloop"], r["group"], r["nadmm"], r["value"]) for r in rec.series[name]]


def _rel(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


def test_slice_visits_the_same_rounds(runs):
    jrec, rec, tr = runs
    assert tr.group_order == [2, 0]
    for name in ("train_loss", "dual_residual", "test_accuracy"):
        assert [v[:3] for v in _values(rec, name)] == [v[:3] for v in _values(jrec, name)]
    assert len(rec.series["train_loss"]) == 2 * 2 * 2  # groups x nadmm x steps


def test_slice_first_round_matches_tightly(runs):
    jrec, rec, tr = runs
    first = (0, tr.group_order[0], 0)
    for name in ("train_loss", "dual_residual"):
        got = [v[3] for v in _values(rec, name) if v[:3] == first]
        want = [v[3] for v in _values(jrec, name) if v[:3] == first]
        assert got and len(got) == len(want)
        _rel(got, want, 1e-3)


def _by_round(rec, name):
    out = {}
    for _, gid, a, value in _values(rec, name):
        out.setdefault((gid, a), []).append(value)
    return {key: np.asarray(v, np.float64) for key, v in out.items()}


def test_slice_train_losses_match(runs):
    jrec, rec, _ = runs
    got, want = _by_round(rec, "train_loss"), _by_round(jrec, "train_loss")
    assert sorted(got) == sorted(want) == sorted(ROUND_LIMITS)
    for key, ((tol, kind), _) in ROUND_LIMITS.items():
        if kind == "rel":
            np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=0, err_msg=f"round {key}")
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol, err_msg=f"round {key}")


def test_slice_dual_residuals_match(runs):
    jrec, rec, _ = runs
    got, want = _by_round(rec, "dual_residual"), _by_round(jrec, "dual_residual")
    assert sorted(got) == sorted(want) == sorted(ROUND_LIMITS)
    for key, (_, tol) in ROUND_LIMITS.items():
        _rel(got[key], want[key], tol)


def test_slice_accuracies_match(runs):
    jrec, rec, _ = runs
    got = np.asarray([v[3] for v in _values(rec, "test_accuracy")]) * N_TEST
    want = np.asarray([v[3] for v in _values(jrec, "test_accuracy")]) * N_TEST
    assert np.all(np.abs(got - want) <= 1.0 + 1e-9)


def _step_by_step():
    """The verify drive step by step: the JAX package's L-BFGS steps (vmapped
    over the clients, its engine's objective) make the trajectory; before
    each step the port is fed the same parameters and optimizer state,
    converted. Yields (group, nadmm, minibatch, port step, JAX step)."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from federated_pytorch_test_tpu.consensus import elastic_net as j_elastic
    from federated_pytorch_test_tpu.data import normalize as j_normalize
    from federated_pytorch_test_tpu.models import Net as JNet
    from federated_pytorch_test_tpu.models import init_client_params as j_init_params
    from federated_pytorch_test_tpu.optim import LBFGSConfig as JConfig
    from federated_pytorch_test_tpu.optim import lbfgs_init as j_lbfgs_init
    from federated_pytorch_test_tpu.optim import lbfgs_step as j_lbfgs_step
    from federated_pytorch_test_tpu.partition import flatten_params as jflatten
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step
    from federated_pytorch_test_tpu_torch.optim import LBFGSState

    cfg = get_preset("fedavg", **DRIVE)
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

    for gid in tr.group_order:
        reg = gid in jpart.linear_group_ids

        def one_client(flat_c, x, st, im, lab, mu, sd, gid=gid, reg=reg):
            images = j_normalize(im, mu, sd)

            def loss_fn(v):
                logits = JNet().apply({"params": unravel(jpart.insert(flat_c, gid, v))}, images)
                ce = optax.softmax_cross_entropy_with_integer_labels(logits, lab).mean()
                return ce + j_elastic(v, cfg.lambda1, cfg.lambda2) if reg else ce

            x, st, _ = j_lbfgs_step(loss_fn, x, st, jcfg)
            return x, st

        jstep = jax.jit(jax.vmap(one_client))
        x = jax.vmap(lambda f: jpart.extract(f, gid))(jflat)
        st = jax.vmap(lambda v: j_lbfgs_init(v, jcfg))(x)
        ctx = tr.ctx(gid)
        for a in range(cfg.nadmm):
            idx = tr.epoch_indices(0, gid, a, 0)
            for s in range(idx.shape[0]):
                im, lab = imgs[rows, idx[s]], labels[rows, idx[s]]
                x_new, st_new = jstep(jflat, x, st, jnp.asarray(im), jnp.asarray(lab), mean, std)
                full = jax.vmap(lambda f, v: jpart.insert(f, gid, v))(jflat, x)
                flat_p = torch.from_numpy(flat_from_jax(np.asarray(full), model))
                flat_p, st_p, _, _ = client_train_step(
                    ctx, flat_p, state_to_port(st, gid), {}, torch.from_numpy(im), torch.from_numpy(lab),
                    tr.mean, tr.std,
                )
                yield gid, a, s, (tr.partition.extract(flat_p, gid), st_p), (group_to_port(np.asarray(x_new), gid),
                                                                              st_new)
                x, st = x_new, st_new
            x = jnp.broadcast_to(jnp.mean(x, axis=0)[None], x.shape)  # the FedAvg round
            jflat = jax.vmap(lambda f, v: jpart.insert(f, gid, v))(jflat, x)


# Single steps from the same state (`test_each_step_matches_jax_from_the_same_state`):
# (group, nadmm, minibatch) -> {client: (limit, coordinates allowed past 1e-4,
# counters compared)}; every other (step, client) is held to relative 1e-4
# on every coordinate with equal counters. Readings beside each entry.
STEP_LIMITS = {
    # one fc1 coordinate lands within 1e-7 of the elastic net's kink at 0
    # on the third inner iteration: -1.7e-8 here, +2.8e-7 in JAX (+5.4e-8
    # when the port runs client 0 alone), so the L1 subgradient takes the
    # other sign and the fourth iteration moves that coordinate by
    # 0.058 instead of 0.034. Reading: 6.3e-2 at 1 of 48,120 coordinates,
    # the rest within 3e-6.
    (2, 1, 0): {0: (8e-2, 1, True)},
    # conv1's second round: losses near 3e-6, where float32 resolves a
    # cross-entropy in steps of ~6e-8 (1 - p rounds), so the gradients carry
    # percent-level rounding and the |loss - prev_loss| < 1e-9 stop test
    # fires an iteration apart (client 1: JAX stops after 3 iterations,
    # the port after 4). Readings: client 1 5.3e-2, clients 0 and 2 3.1e-5.
    (0, 1, 0): {1: (8e-2, None, False)},
    # readings: client 1 3.1e-2 (3 iterations more), clients 0 and 2 5.1e-4
    # and 3.7e-4 with equal counters
    (0, 1, 1): {0: (1e-3, None, True), 1: (6e-2, None, False), 2: (1e-3, None, True)},
}


def test_each_step_matches_jax_from_the_same_state():
    # the drift question: is any single step of the port off, or does the
    # slice's round-by-round gap come from accumulation and from decisions
    # taken at float32's resolution (STEP_LIMITS)?
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
    assert n == 2 * 2 * 2  # groups x nadmm x minibatches


if __name__ == "__main__":
    # the port-vs-JAX readings behind ROUND_LIMITS, round by round
    jrec, rec, _ = runs.__wrapped__()
    for name in ("train_loss", "dual_residual"):
        got, want = _by_round(rec, name), _by_round(jrec, name)
        for key in sorted(got, key=list(ROUND_LIMITS).index):
            diff = np.abs(got[key] - want[key])
            print(f"{name} round={key} max_rel={np.max(diff / np.abs(want[key])):.3e} max_abs={np.max(diff):.3e}")
    # each step from the same state
    for gid, a, s, (x_p, _), (x_j, _) in _step_by_step():
        err = float((x_p - x_j).abs().max()) / float(x_j.abs().max())
        print(f"step group={gid} nadmm={a} minibatch={s} params max_rel={err:.3e}")
