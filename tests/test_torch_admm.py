"""Port parity for ADMM with BB rho (`consensus/admm.py`) and its place in the engine.

The port's ADMM functions are held against the JAX package's on the same
seeded numpy inputs, run as `tests/test_consensus.py` runs them: inside
`shard_map` over the client mesh, with the clients on 1 and on 3 devices.
K = 3 clients and N = 37 coordinates (not a multiple of 8).

Tolerances, beside their largest readings on the CPU (both meshes):
* `admm_penalty`: relative 1e-6 (reading 2.6e-7; the two sum in other orders);
* `admm_round`, six iterations (nadmm 0-5) with a fixed rho and with BB on,
  each field relative to its largest entry: z 1e-5 (reading 2.3e-7: the
  ρ-weighted client sum adds three terms, across 3 devices in another
  order), primal and dual residuals 1e-5 (9.9e-8, 3.4e-7), ŷ⁰ 1e-5
  (1.5e-6), y 2e-5 (4.9e-6: y accumulates ρ(x − z), and x − z cancels
  about a hundredfold on these inputs, whose clients spread by 1% of x, so
  z's 2e-7 grows there); rho and the mean rho 1e-6 (1.9e-7, 6.6e-8); x⁰
  exactly (a copy);
* `_bb_new_rho` against the JAX function and the reference rule:
  relative 1e-5, as `tests/test_consensus.py` holds the JAX function;
* the engine tests are structural (which state persists, which is reset),
  compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from federated_pytorch_test_tpu.consensus import ADMMConfig as JADMMConfig
from federated_pytorch_test_tpu.consensus import admm_init as j_admm_init
from federated_pytorch_test_tpu.consensus import admm_penalty as j_admm_penalty
from federated_pytorch_test_tpu.consensus import admm_round as j_admm_round
from federated_pytorch_test_tpu.consensus.admm import _bb_new_rho as j_bb_new_rho
from federated_pytorch_test_tpu.parallel import CLIENT_AXIS, client_mesh, shard_map
from federated_pytorch_test_tpu_torch.consensus import ADMMConfig, admm_init, admm_penalty, admm_round
from federated_pytorch_test_tpu_torch.consensus.admm import _bb_new_rho
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.engine import trainer as trainer_module

K, N = 3, 37
ROUNDS = 6  # nadmm 0..5: BB is due at 2 and 4
FIELDS = ("y", "z", "rho", "yhat0", "x0")


@pytest.fixture(params=[1, 3], ids=["D1", "D3"])
def mesh(request):
    return client_mesh(request.param)


def _rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


def test_admm_penalty_matches_jax():
    rng = np.random.default_rng(1)
    x, y = (rng.normal(size=(K, N)).astype(np.float32) for _ in range(2))
    z = rng.normal(size=N).astype(np.float32)
    rho = np.asarray([[0.37], [0.001], [0.05]], np.float32)
    want = jax.vmap(j_admm_penalty, in_axes=(0, 0, None, 0))(x, y, z, rho)
    got = admm_penalty(*(torch.from_numpy(a) for a in (x, y, z, rho)))
    assert got.shape == (K,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _inputs(seed):
    """Six iterations' client coordinates `[ROUNDS, K, N]`. The start lies
    near 0 and the later iterates along one direction u, far from it:
    ŷ⁰ starts at the first x (the reference quirk), so at nadmm 2 Δy is
    small beside Δx and well correlated with it, and every client accepts
    its BB proposal; at nadmm 4 the proposals are rejected."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=N)
    xs = [-0.02 * u + 0.001 * rng.normal(size=(K, N))]
    xs += [3.0 * u * (1.0 + 0.5 * a) + 0.3 * rng.normal(size=(K, N)) for a in range(1, ROUNDS)]
    return np.stack(xs).astype(np.float32)


def _jax_trajectory(mesh, xs, cfg):
    def body(xs_l):
        st = j_admm_init(xs_l[0], cfg)
        states, mets = [], []
        for a in range(ROUNDS):
            st, m = j_admm_round(xs_l[a], st, jnp.int32(a), cfg)
            states.append(st)
            mets.append((m.primal_residual, m.dual_residual, m.mean_rho))
        return states, mets

    c = P(CLIENT_AXIS)
    st_spec = type(j_admm_init(jnp.zeros((K, N)), cfg))(y=c, z=P(), rho=c, yhat0=c, x0=c)
    fn = shard_map(body, mesh=mesh, in_specs=(P(None, CLIENT_AXIS),),
                   out_specs=([st_spec] * ROUNDS, [(P(), P(), P())] * ROUNDS))
    return jax.jit(fn)(jnp.asarray(xs))


@pytest.mark.parametrize("bb", [False, True], ids=["fixed_rho", "bb"])
def test_admm_round_matches_jax(mesh, bb):
    kw = dict(rho0=0.001, bb_update=bb, bb_period=2)
    xs = _inputs(seed=4)
    jstates, jmets = _jax_trajectory(mesh, xs, JADMMConfig(**kw))
    cfg = ADMMConfig(**kw)
    st = admm_init(torch.from_numpy(xs[0]), cfg)
    accepted = []
    for a in range(ROUNDS):
        st, met = admm_round(torch.from_numpy(xs[a]), st, a, cfg)
        want = jstates[a]
        for f in FIELDS:
            got, w = getattr(st, f).numpy(), np.asarray(getattr(want, f))
            if f == "x0":
                np.testing.assert_array_equal(got, w, err_msg=f"nadmm {a} {f}")
            else:
                _rel(got, w, {"rho": 1e-6, "y": 2e-5}.get(f, 1e-5))
        for name, w in zip(("primal_residual", "dual_residual", "mean_rho"), jmets[a]):
            assert met[name].ndim == 0
            _rel(met[name].numpy(), w, 1e-6 if name == "mean_rho" else 1e-5)
        accepted.append(int((st.rho != cfg.rho0).sum()))
    # BB: every client accepts at nadmm 2 and keeps that rho through the
    # rejected proposal at 4; a fixed rho never moves
    assert accepted == ([0, 0, K, K, K, K] if bb else [0] * ROUNDS)


def _bb_reference_rho(rho, yhat, yhat0, x, x0, cfg):
    """The reference's BB rule, one client, in numpy (as tests/test_consensus.py)."""
    dy, dx = yhat - yhat0, x - x0
    d11, d12, d22 = dy @ dy, dy @ dx, dx @ dx
    if abs(d12) > cfg.bb_epsilon and d11 > cfg.bb_epsilon and d22 > cfg.bb_epsilon:
        alpha = d12 / np.sqrt(d11 * d22)
        alpha_sd = d11 / d12
        alpha_mg = d12 / d22
        alpha_hat = alpha_mg if 2 * alpha_mg > alpha_sd else alpha_sd - 0.5 * alpha_mg
        if alpha >= cfg.bb_alphacorrmin and alpha_hat < cfg.bb_rhomax:
            return alpha_hat
    return rho


def _bb_cases():
    """(name, yhat, x) of one client each, with ŷ⁰ = x⁰ = 0."""
    rng = np.random.default_rng(3)
    out = []
    for scale in (1.0, 1e-4, -1.0):  # typical; below eps; negative d12 (correlation guard)
        yhat = rng.normal(size=N).astype(np.float32) * abs(scale)
        x = (rng.normal(size=N) * scale).astype(np.float32)
        out.append((f"scale={scale}", yhat, x))
    dx = rng.normal(size=N).astype(np.float32) * 3
    out.append(("crafted", 0.05 * dx, dx))  # alpha 1, alphaMG 0.05 < rhomax: accepted
    out.append(("large", 0.5 * dx, dx))  # accepted by correlation, alpha_hat >= rhomax
    ortho = dx.copy()
    ortho[0], ortho[1] = dx[1], -dx[0]
    ortho[2:] = 0.0
    dx2 = np.zeros(N, np.float32)
    dx2[:2] = dx[:2]
    out.append(("|d12|<=eps", ortho, dx2))  # dy orthogonal to dx: d12 = 0
    out.append(("d11<=eps", np.full(N, 1e-4, np.float32), dx))
    out.append(("d22<=eps", dx, np.full(N, 1e-4, np.float32)))
    return out


def test_bb_new_rho_matches_jax_and_the_reference_rule():
    cfg, jcfg = ADMMConfig(bb_update=True), JADMMConfig(bb_update=True)
    cases = _bb_cases()
    rho = np.float32(0.001)
    yhat = np.stack([c[1] for c in cases])
    x = np.stack([c[2] for c in cases])
    zero = np.zeros_like(x)
    # every case a client of one batched call: each keeps to its own branch
    got = _bb_new_rho(torch.full((len(cases), 1), float(rho)), torch.from_numpy(yhat), torch.from_numpy(zero),
                      torch.from_numpy(x), torch.from_numpy(zero), cfg)
    assert got.shape == (len(cases), 1)
    for i, (name, yh, xx) in enumerate(cases):
        want = _bb_reference_rho(rho, yh, np.zeros(N, np.float32), xx, np.zeros(N, np.float32), cfg)
        jwant = j_bb_new_rho(jnp.asarray([rho]), jnp.asarray(yh), jnp.zeros(N), jnp.asarray(xx), jnp.zeros(N), jcfg)
        np.testing.assert_allclose(float(got[i, 0]), want, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(float(got[i, 0]), float(jwant[0]), rtol=1e-5, err_msg=name)
    accepted = {name for (name, _, _), r in zip(cases, got[:, 0].tolist()) if r != float(rho)}
    # the crafted step is accepted; every guard rejects its own case
    assert "crafted" in accepted
    assert not accepted & {"scale=0.0001", "scale=-1.0", "large", "|d12|<=eps", "d11<=eps", "d22<=eps"}, accepted
    np.testing.assert_allclose(float(got[3, 0]), 0.05, rtol=1e-5)


def test_bb_full_trajectory_matches_numpy_mirror():
    # tests/test_consensus.py's mirror of the reference loop, for the port
    cfg = ADMMConfig(rho0=0.001, bb_update=True, bb_period=2)
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(K, N)).astype(np.float32) * 3 for _ in range(3)]
    st = admm_init(torch.from_numpy(xs[0]), cfg)
    got = []
    for a, x in enumerate(xs):
        st, _ = admm_round(torch.from_numpy(x), st, a, cfg)
        got.append(st.rho[:, 0].numpy().copy())

    rho = np.full(K, cfg.rho0, np.float32)
    z = np.zeros(N, np.float32)
    y = np.zeros((K, N), np.float32)
    yhat0, x0 = xs[0].copy(), np.zeros((K, N), np.float32)
    for a, x in enumerate(xs):
        if a == 0:
            x0 = x.copy()
        elif a % cfg.bb_period == 0:
            yhat = y + rho[:, None] * (x - z)
            for k in range(K):
                rho[k] = _bb_reference_rho(rho[k], yhat[k], yhat0[k], x[k], x0[k], cfg)
            yhat0, x0 = yhat, x.copy()
        z = sum(y[k] + rho[k] * x[k] for k in range(K)) / rho.sum()
        y = np.stack([y[k] + rho[k] * (x[k] - z) for k in range(K)])
        np.testing.assert_allclose(got[a], rho, rtol=1e-5)
    np.testing.assert_allclose(st.z.numpy(), z, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(st.y.numpy(), y, rtol=1e-4, atol=1e-6)


def _tiny(**kw):
    return get_preset("admm", batch=40, nloop=2, nadmm=2, max_groups=1, device="cpu", **kw)


def test_rho_persists_per_group_while_y_and_z_restart(monkeypatch):
    # the reference allocates rho once outside its loops, so a group's rho
    # carries to that group's next visit; y and z restart at 0 every round
    seen = []
    real = trainer_module.admm_consensus

    def spy(ctx, flat, state, nadmm):
        if nadmm == 0:
            seen.append((ctx.gid, float(state.y.abs().max()), float(state.z.abs().max()), state.rho.clone()))
        return real(ctx, flat, state, nadmm)

    monkeypatch.setattr(trainer_module, "admm_consensus", spy)
    tr = Trainer(_tiny(), verbose=False, source=synthetic_cifar(240, 60))
    gid = tr.group_order[0]
    assert not tr._rho_store
    tr.run_round(nloop=0, gid=gid)
    assert gid in tr._rho_store and tuple(tr._rho_store[gid].shape) == (3, 1)

    custom = torch.full((3, 1), 0.0567)
    tr._rho_store[gid] = custom
    tr.run_round(nloop=1, gid=gid)
    assert np.isclose(tr.recorder.series["mean_rho"][-2]["value"], 0.0567, rtol=1e-6)
    assert [s[:3] for s in seen] == [(gid, 0.0, 0.0), (gid, 0.0, 0.0)]
    assert torch.equal(seen[0][3], torch.full((3, 1), 1e-3)) and torch.equal(seen[1][3], custom)


def test_clients_keep_distinct_x_after_an_admm_round():
    tr = Trainer(_tiny(), verbose=False, source=synthetic_cifar(240, 60))
    gid = tr.group_order[0]
    before = tr.flat.clone()
    tr.run_round(nloop=0, gid=gid)
    x = tr.partition.extract(tr.flat, gid)
    assert float((x - x[:1]).abs().max()) > 0.0  # nothing was broadcast back
    # the other groups' coordinates are untouched
    rest = [g for g in range(tr.partition.num_groups) if g != gid]
    for g in rest:
        assert torch.equal(tr.partition.extract(tr.flat, g), tr.partition.extract(before, g))
    names = {"train_loss", "dual_residual", "primal_residual", "mean_rho", "test_accuracy"}
    assert names <= set(tr.recorder.series)


def test_config_accepts_admm_and_still_refuses_the_rest():
    assert get_preset("admm").admm_config() == ADMMConfig(rho0=1e-3, bb_update=True)
    # 'none' and 'first_linear' are ported (the no_consensus preset); values
    # neither package knows, and a zero BB period, are refused
    assert get_preset("admm", strategy="none", reg_mode="first_linear").strategy == "none"
    for bad in (dict(strategy="gossip"), dict(reg_mode="all"), dict(bb_period=0)):
        with pytest.raises(ValueError):
            get_preset("admm", **bad)
