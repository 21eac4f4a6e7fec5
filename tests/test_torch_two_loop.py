"""Port parity for the `two_loop` L-BFGS direction (the masked two-loop
recursion, plain PyTorch, batched over the clients).

* against the JAX package's `_two_loop_direction` (vmapped over the
  clients) on the same float32 inputs, at history counts 0, 3 and m, with
  a zero-curvature slot: within relative 1e-5 of the largest entry
  (readings 0, 2.7e-7 and 2.0e-7: the same recursion, summed in another
  order);
* against the port's `compact` direction in float64 at counts 0, 1, 3, m:
  the two are the same H·g, so within rtol 1e-9 / atol 1e-10, the JAX
  package's own limits (`tests/test_lbfgs.py::
  test_compact_direction_matches_two_loop`);
* end to end: three `lbfgs_step`s on K quadratics in float64 with
  `two_loop`, against the JAX package's `lbfgs_step` with `two_loop` on the
  batch-mode path each client alone, and against the port's `compact`
  direction: within rtol 1e-8 (the bound of `tests/test_lbfgs.py::
  test_compact_vs_two_loop_end_to_end`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.optim import LBFGSConfig as JConfig
from federated_pytorch_test_tpu.optim import lbfgs_init as j_init
from federated_pytorch_test_tpu.optim import lbfgs_step as j_step
from federated_pytorch_test_tpu.optim.lbfgs import _two_loop_direction as j_two_loop
from federated_pytorch_test_tpu_torch.optim import LBFGSConfig, compact_direction, lbfgs_init, lbfgs_step
from federated_pytorch_test_tpu_torch.optim.lbfgs import DIRECTIONS, _two_loop_direction

K, M, N = 3, 6, 40


def _history(count, seed, dtype=np.float32):
    """[K, m, N] history with positive curvature in the valid slots (as the
    optimizer's acceptance guard keeps it) and a zero-curvature slot 1 in
    client 2 (y = 0 there)."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(K, M, N))
    y = rng.normal(size=(K, M, N)) + s
    y[2, 1] = 0.0
    g = rng.normal(size=(K, N))
    h = np.array([1.0, 0.37, 1.6])
    cnt = np.full((K,), count, np.int32)
    return [a.astype(dtype) for a in (g, s, y)] + [cnt, h.astype(dtype)]


def test_two_loop_is_a_direction_of_the_port():
    assert DIRECTIONS["two_loop"] is _two_loop_direction
    assert LBFGSConfig(direction="two_loop").direction == "two_loop"
    with pytest.raises(ValueError, match="direction must be one of"):
        LBFGSConfig(direction="cubic")


@pytest.mark.parametrize("count", [0, 3, M])
def test_two_loop_matches_jax(count):
    g, s, y, cnt, h = _history(count, seed=count)
    want = np.asarray(jax.vmap(j_two_loop)(g, s, y, cnt, h))
    got = _two_loop_direction(*(torch.from_numpy(a) for a in (g, s, y, cnt, h))).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    if count == 0:
        np.testing.assert_array_equal(got, -g * h[:, None])  # no valid slot: -h·g


@pytest.mark.parametrize("count", [0, 1, 3, M])
def test_two_loop_matches_compact_in_float64(count):
    args = [torch.from_numpy(a) for a in _history(count, seed=10 + count, dtype=np.float64)]
    args[3] = args[3].to(torch.int32)
    np.testing.assert_allclose(_two_loop_direction(*args).numpy(), compact_direction(*args).numpy(),
                               rtol=1e-9, atol=1e-10)


def _quadratics(seed):
    rng = np.random.default_rng(seed)
    a = [rng.normal(size=(8, 8)) for _ in range(K)]
    mats = np.stack([m @ m.T + (8 + 2 * k) * np.eye(8) for k, m in enumerate(a)])
    rhs = rng.normal(size=(K, 8))
    return mats, rhs


def test_two_loop_lbfgs_steps_match_jax_and_compact():
    mats, rhs = _quadratics(12)
    jax.config.update("jax_enable_x64", True)
    try:
        want = []
        for k in range(K):
            a, b = jnp.asarray(mats[k]), jnp.asarray(rhs[k])
            jcfg = JConfig(max_iter=10, history_size=5, line_search=True, batch_mode=True, direction="two_loop")
            x = jnp.zeros((8,), jnp.float64)
            st = j_init(x, jcfg)
            for _ in range(3):
                x, st, _ = j_step(lambda v, a=a, b=b: 0.5 * v @ (a @ v) - b @ v, x, st, jcfg)
            want.append(np.asarray(x))
    finally:
        jax.config.update("jax_enable_x64", False)

    tm, tb = torch.from_numpy(mats), torch.from_numpy(rhs)

    def loss(x):
        return 0.5 * (x * (tm @ x[..., None])[..., 0]).sum(-1) - (tb * x).sum(-1)

    got = {}
    for direction in ("two_loop", "compact"):
        cfg = LBFGSConfig(max_iter=10, history_size=5, line_search=True, batch_mode=True, direction=direction)
        x = torch.zeros((K, 8), dtype=torch.float64)
        st = lbfgs_init(x, cfg)
        for _ in range(3):
            x, st, _ = lbfgs_step(loss, x, st, cfg)
        got[direction] = x.numpy()
    np.testing.assert_allclose(got["two_loop"], np.stack(want), rtol=1e-8)
    np.testing.assert_allclose(got["two_loop"], got["compact"], rtol=1e-8)
