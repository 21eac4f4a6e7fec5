"""The optimizer's full-batch step rules against the JAX package, in float64.

* `cubic_linesearch` batched over K clients against the JAX package's
  (one client at a time, `vmap`ped) on per-client φ that take different
  branches: accepted at once, bracketed and zoomed, run out of
  extrapolations (the `lr` fallback) and flat (step 1). The central
  difference (step 1e-6) of float64 losses that sum in another order
  differs by ~1e-10, so the step sizes are held to relative 1e-9.
* `lbfgs_step` with the cubic search (`line_search=True,
  batch_mode=False`) and with the fixed step (`line_search=False`, the
  JAX default) on K quadratics and on K quartics: three steps against the
  JAX package's `lbfgs_step` per client, parameters within relative 1e-10
  (fixed) and 1e-6 (cubic: `LIMITS` says why) of the largest coordinate,
  the iteration and evaluation counters equal.
* `LBFGSConfig`'s fields and defaults are the JAX package's, and
  `has_aux` without the batch-mode search raises its error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.optim import LBFGSConfig as JConfig
from federated_pytorch_test_tpu.optim import lbfgs_init as j_init
from federated_pytorch_test_tpu.optim import lbfgs_step as j_step
from federated_pytorch_test_tpu.optim.linesearch import cubic_linesearch as j_cubic
from federated_pytorch_test_tpu_torch.optim import LBFGSConfig, cubic_linesearch, lbfgs_init, lbfgs_step

K, D = 4, 20
# per client: phi(a) = F0 + G·a + C·a² + Q·a⁴ (client 3 flat)
F0 = np.array([1.0, 2.0, 0.5, 1.0, 3.0, 0.7])
G = np.array([-1.0, -4.0, -0.01, 0.0, -2.0, -1e-3])
C = np.array([0.5, 30.0, 0.001, 0.0, 0.2, 5.0])
Q = np.array([0.1, 0.0, 0.0, 0.0, 2.0, 40.0])


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("lr", [1.0, 0.05])
def test_cubic_search_matches_jax(x64, lr):
    f0, g, c, q = (jnp.asarray(v) for v in (F0, G, C, Q))

    def one(k):
        return j_cubic(lambda a: f0[k] + g[k] * a + c[k] * a**2 + q[k] * a**4, f0[k], lr)

    want = np.asarray(jax.vmap(one)(jnp.arange(len(F0))))
    tf0, tg, tc, tq = (torch.from_numpy(v) for v in (F0, G, C, Q))
    calls = []

    def phi(a):
        calls.append(a)
        return tf0 + tg * a + tc * a**2 + tq * a**4

    got = cubic_linesearch(phi, tf0.clone(), lr).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert got[3] == 1.0  # a flat direction: step 1
    assert len(set(np.round(got, 12).tolist())) >= 4  # the clients took different branches
    assert all(a.shape == (len(F0),) for a in calls)  # every evaluation one batched pass


def _objectives(kind, seed):
    """K convex problems in D=20 (quadratics, or with a quartic term) that
    three steps do not solve: near a minimum the losses sit at float64's
    resolution and the cubic search's branch tests flip on the last bit."""
    rng = np.random.default_rng(seed)
    mats = np.stack([m @ m.T / D + (0.05 + 0.05 * k) * np.eye(D) for k, m in enumerate(rng.normal(size=(K, D, D)))])
    rhs = rng.normal(size=(K, D))
    quart = 0.1 * (1 + np.arange(K)) if kind == "quartic" else np.zeros(K)

    def jloss(k):
        a, b, w = jnp.asarray(mats[k]), jnp.asarray(rhs[k]), quart[k]
        return lambda v: 0.5 * v @ (a @ v) - b @ v + w * jnp.sum(v**4)

    tm, tb, tw = (torch.from_numpy(v) for v in (mats, rhs, quart))

    def loss(x):
        return 0.5 * (x * (tm @ x[..., None])[..., 0]).sum(-1) - (tb * x).sum(-1) + tw * (x**4).sum(-1)

    return jloss, loss


# relative to the largest coordinate: the fixed step repeats JAX's
# arithmetic up to the losses' summation order (readings ~1e-12); the cubic
# search's central differences turn that order into ~1e-9 of a step size,
# which three steps carry to 7.7e-8 (quartic; 5.1e-9 quadratic)
LIMITS = {"cubic": 1e-6, "fixed": 1e-10}


@pytest.mark.parametrize("kind", ["quadratic", "quartic"])
@pytest.mark.parametrize("rule", ["cubic", "fixed"])
def test_full_batch_lbfgs_steps_match_jax(x64, kind, rule):
    line_search = rule == "cubic"
    lr = 1.0 if line_search else 0.05
    jloss, loss = _objectives(kind, seed=3)
    want, want_counts = [], []
    for k in range(K):
        jcfg = JConfig(lr=lr, max_iter=4, history_size=4, line_search=line_search, batch_mode=False)
        x = jnp.full((D,), 0.3, jnp.float64)
        st = j_init(x, jcfg)
        for _ in range(3):
            x, st, _ = j_step(jloss(k), x, st, jcfg)
        want.append(np.asarray(x))
        want_counts.append((int(st.n_iter), int(st.func_evals), int(st.hist_count)))

    cfg = LBFGSConfig(lr=lr, max_iter=4, history_size=4, line_search=line_search, batch_mode=False)
    x = torch.full((K, D), 0.3, dtype=torch.float64)
    st = lbfgs_init(x, cfg)
    for _ in range(3):
        x, st, aux = lbfgs_step(loss, x, st, cfg)
    want = np.stack(want)
    err = np.abs(x.numpy() - want).max() / np.abs(want).max()
    assert err <= LIMITS[rule], f"relative {err:.3e}"
    got_counts = list(zip(st.n_iter.tolist(), st.func_evals.tolist(), st.hist_count.tolist()))
    assert got_counts == want_counts
    assert st.ls_evals.tolist() == [0] * K  # only the Armijo search counts probes


def test_config_fields_and_defaults_are_the_jax_packages():
    port = {f.name: f.default for f in dataclasses.fields(LBFGSConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert port == ref
    with pytest.raises(ValueError, match="ls_probes must be >= 1, got 0"):
        LBFGSConfig(ls_probes=0)
    x = torch.zeros((2, 3), dtype=torch.float64)
    for cfg in (LBFGSConfig(), LBFGSConfig(line_search=True), LBFGSConfig(batch_mode=True)):
        with pytest.raises(ValueError, match="has_aux requires batch_mode line search"):
            lbfgs_step(lambda v: ((v**2).sum(-1), ()), x, lbfgs_init(x, cfg), cfg, has_aux=True)
