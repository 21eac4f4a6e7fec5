"""Port parity: Net/Net1/Net2 logits from converted JAX parameters.

Same NHWC inputs (numpy, seeded) through the Flax model and the port's
model with the converted weights. Tolerance: relative 1e-5 of the largest
logit — both sides run float32 convolutions and products, which differ
only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.models import Net as JNet, Net1 as JNet1, Net2 as JNet2
from federated_pytorch_test_tpu.partition import flatten_params as jflatten
from federated_pytorch_test_tpu_torch.convert import flat_from_jax, params_from_jax
from federated_pytorch_test_tpu_torch.models import Net, Net1, Net2, init_client_params
from federated_pytorch_test_tpu_torch.partition import unflatten_params

PAIRS = {"net": (JNet, Net), "net1": (JNet1, Net1), "net2": (JNet2, Net2)}


def _close(a, b, rtol):
    scale = np.max(np.abs(b)) + 1e-30
    np.testing.assert_allclose(a / scale, b / scale, atol=rtol)


@pytest.mark.parametrize("name", ["net", "net1"])
def test_logits_match_jax(name):
    jcls, tcls = PAIRS[name]
    jmodel = jcls()
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32)
    jp = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"]
    ref = np.asarray(jmodel.apply({"params": jp}, jnp.asarray(x)))
    model = tcls()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    _close(out, ref, 1e-5)


def test_batched_forward_matches_per_client():
    # K clients with distinct weights in one batched forward == K forwards
    model = Net()
    jp = JNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    base = flat_from_jax(np.asarray(jflatten(jp)[0]), model.shapes())
    flat = torch.from_numpy(np.stack([base, 0.9 * base, 1.1 * base]))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 5, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        out = model.forward_batched(unflatten_params(flat, model.shapes()), x)
        for k in range(3):
            model.load_state_dict(unflatten_params(flat[k], model.shapes()))
            _close(out[k].numpy(), model(x[k]).numpy(), 1e-6)


def test_common_seed_init():
    # xavier-uniform weights inside the Glorot bound, biases 0.01, all
    # clients identical, the same draw from the same seed
    model = Net()
    flat = init_client_params(model, 3, seed=7)
    assert torch.equal(flat[0], flat[2])
    assert torch.equal(flat, init_client_params(Net(), 3, seed=7))
    params = unflatten_params(flat[0], model.shapes())
    for name, p in params.items():
        if name.endswith(".bias"):
            assert torch.all(p == 0.01)
        else:
            o, i = p.shape[:2]
            rf = int(np.prod(p.shape[2:])) if p.ndim > 2 else 1
            bound = np.sqrt(6.0 / ((i + o) * rf))
            assert float(p.abs().max()) <= bound
            assert float(p.abs().max()) > 0.5 * bound
