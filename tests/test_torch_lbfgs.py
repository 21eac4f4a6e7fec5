"""Port parity: stochastic L-BFGS steps on Net's fc1 group, and the
vmap freeze semantics of the batched optimizer.

Two consecutive `lbfgs_step`s (two minibatches of 40, so the second step
crosses a batch boundary: Welford alphabar, suppressed history push) on
the fc1 group with the elastic net, from the same converted parameters,
through the JAX package and the port's `client_train_step`. Tolerance:
relative 1e-4 of the largest parameter — float32 forward/backward passes
summed in different orders, compounded over up to 8 inner iterations
and their line searches (the bound the JAX package holds its own two
direction backends to end to end, tests/test_ops.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from federated_pytorch_test_tpu.consensus import elastic_net as j_elastic
from federated_pytorch_test_tpu.data import normalize as j_normalize
from federated_pytorch_test_tpu.models import Net as JNet
from federated_pytorch_test_tpu.optim import LBFGSConfig as JConfig
from federated_pytorch_test_tpu.optim import lbfgs_init as j_init
from federated_pytorch_test_tpu.optim import lbfgs_step as j_step
from federated_pytorch_test_tpu.partition import flatten_params as jflatten
from federated_pytorch_test_tpu_torch.convert import flat_from_jax
from federated_pytorch_test_tpu_torch.engine.steps import GroupContext, client_train_step
from federated_pytorch_test_tpu_torch.models import Net
from federated_pytorch_test_tpu_torch.optim import LBFGSConfig, lbfgs_init, lbfgs_step

GID = 2  # fc1, 48,120 parameters
L1 = L2 = 1e-4


def _close(a, b, rtol):
    scale = np.max(np.abs(b)) + 1e-30
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale, atol=rtol)


def _batches():
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, size=(2, 40, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(2, 40)).astype(np.int32)
    return imgs, labels


@pytest.mark.parametrize("direction", ["compact", "pallas"])
def test_two_lbfgs_steps_on_fc1_match_jax(direction):
    jmodel = JNet()
    jp = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    jflat, unravel = jflatten(jp)
    jpart = JNet.partition(jp)
    imgs, labels = _batches()
    jcfg = JConfig(max_iter=4, history_size=10, line_search=True, batch_mode=True, direction=direction)

    x = jpart.extract(jflat, GID)
    jstate = j_init(x, jcfg)
    jaux = []
    for b in range(2):
        images = j_normalize(jnp.asarray(imgs[b]), 0.5, 0.5)

        def loss_fn(xx, images=images, lab=jnp.asarray(labels[b])):
            logits = jmodel.apply({"params": unravel(jpart.insert(jflat, GID, xx))}, images)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, lab).mean()
            return ce + j_elastic(xx, L1, L2)

        x, jstate, aux = j_step(loss_fn, x, jstate, jcfg)
        jaux.append(aux)
    jfinal = np.asarray(jpart.insert(jflat, GID, x))

    model = Net()
    cfg = LBFGSConfig(max_iter=4, history_size=10, line_search=True, batch_mode=True, direction=direction)
    ctx = GroupContext(
        model=model, shapes=model.shapes(), partition=model.partition(), gid=GID,
        lbfgs=cfg, reg_on_active=True, lambda1=L1, lambda2=L2,
    )
    flat = torch.from_numpy(flat_from_jax(np.asarray(jflat), model))[None].clone()
    state = lbfgs_init(ctx.partition.extract(flat, GID).contiguous(), cfg)
    half = torch.tensor([0.5])
    for b in range(2):
        flat, state, _, _ = client_train_step(
            ctx, flat, state, {}, torch.from_numpy(imgs[b][None]),
            torch.from_numpy(labels[b][None]), half, half,
        )
    _close(flat[0].numpy(), flat_from_jax(jfinal, model), 1e-4)
    # the same number of iterations, evaluations and line-search probes
    assert int(state.n_iter[0]) == int(jstate.n_iter)
    assert int(state.func_evals[0]) == int(jstate.func_evals)
    assert int(state.ls_evals[0]) == int(jstate.ls_evals)
    assert int(state.hist_count[0]) == int(jstate.hist_count)


def test_batched_clients_equal_independent_runs():
    # the vmap freeze rule: K clients in one batched step == K separate
    # steps, including a client that converges early and one that
    # enters with a NaN gradient and must keep its parameters
    rng = np.random.default_rng(0)
    n = 12
    a = [rng.normal(size=(n, n)) for _ in range(3)]
    mats = torch.tensor(np.stack([m @ m.T + (n + 5 * k) * np.eye(n) for k, m in enumerate(a)]),
                        dtype=torch.float32)
    rhs = torch.tensor(rng.normal(size=(3, n)), dtype=torch.float32)
    rhs[1] = 0.0  # client 1 starts at its optimum: done at entry

    def loss(x):
        k = x.shape[0]
        m = mats[:k] if k == 3 else mats[sel[0] : sel[0] + 1]
        r = rhs[:k] if k == 3 else rhs[sel[0] : sel[0] + 1]
        return 0.5 * (x * (m @ x[..., None])[..., 0]).sum(-1) - (r * x).sum(-1)

    cfg = LBFGSConfig(max_iter=6, history_size=4, line_search=True, batch_mode=True)
    x0 = torch.zeros(3, n)
    x0[2, 0] = float("nan")  # client 2 enters with a NaN gradient
    sel = [0]
    x_b, s_b, _ = lbfgs_step(loss, x0, lbfgs_init(x0, cfg), cfg)
    for k in range(3):
        sel[0] = k
        xk, sk, _ = lbfgs_step(loss, x0[k : k + 1], lbfgs_init(x0[k : k + 1], cfg), cfg)
        # float32 batched vs single products may round differently
        torch.testing.assert_close(x_b[k], xk[0], equal_nan=True, rtol=1e-5, atol=1e-6)
        assert int(s_b.n_iter[k]) == int(sk.n_iter[0])
    assert torch.equal(x_b[1], x0[1])
    assert torch.isnan(x_b[2, 0]) and torch.equal(x_b[2, 1:], x0[2, 1:])


def test_elastic_net_value_and_gradient_match_jax():
    # including the subgradient at ±0, where JAX's |v| takes +1
    v = np.array([[0.0, -0.0, 0.3, -1.2, 2e-8]], np.float32)
    from federated_pytorch_test_tpu_torch.consensus import elastic_net

    jval, jgrad = jax.value_and_grad(lambda x: j_elastic(x, L1, L2))(jnp.asarray(v[0]))
    t = torch.tensor(v, requires_grad=True)
    val = elastic_net(t, L1, L2)
    val.sum().backward()
    np.testing.assert_allclose(val.detach().numpy()[0], np.asarray(jval), rtol=1e-6)
    np.testing.assert_array_equal(t.grad.numpy()[0], np.asarray(jgrad))
