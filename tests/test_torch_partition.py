"""Port parity: flat codec, partition groups and parameter conversion.

The PyTorch port (`federated_pytorch_test_tpu_torch`) must cut its flat
parameter vector at the same leaf boundaries as the JAX package, so every
partition group, L-BFGS vector and consensus slice covers the same span
in both. Exact (integer) comparisons: no arithmetic is involved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.models import Net as JNet, Net1 as JNet1, Net2 as JNet2
from federated_pytorch_test_tpu.partition import flatten_params as jflatten
from federated_pytorch_test_tpu_torch.convert import (
    flat_from_jax,
    flat_to_jax,
    params_from_jax,
    params_to_jax,
)
from federated_pytorch_test_tpu_torch.models import Net, Net1, Net2
from federated_pytorch_test_tpu_torch.partition import (
    flatten_params,
    unflatten_params,
)

PAIRS = {"net": (JNet, Net), "net1": (JNet1, Net1), "net2": (JNet2, Net2)}


def _jax_params(jcls):
    return jcls().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_partition_groups_match_jax(name):
    jcls, tcls = PAIRS[name]
    jpart = jcls.partition(_jax_params(jcls))
    tpart = tcls().partition()
    assert tpart.total == jpart.total
    assert [[(s.start, s.size) for s in g] for g in tpart.groups] == [
        [(s.start, s.size) for s in g] for g in jpart.groups
    ]
    assert tpart.linear_group_ids == jpart.linear_group_ids
    assert tpart.train_order == jpart.train_order


def test_net_group_sizes():
    part = Net().partition()
    assert part.total == 62006
    assert [part.group_size(g) for g in range(part.num_groups)] == [456, 2416, 48120, 10164, 850]


def test_flat_codec_round_trip_and_conversion():
    jp = _jax_params(JNet)
    jflat, _ = jflatten(jp)
    jflat = np.asarray(jflat)
    model = Net()
    shapes = model.shapes()
    tparams = params_from_jax(jax.tree.map(np.asarray, jp), model)
    assert {n: tuple(t.shape) for n, t in tparams.items()} == shapes
    tflat = flatten_params(tparams).numpy()
    # converting the JAX flat vector equals flattening the converted tree
    np.testing.assert_array_equal(flat_from_jax(jflat, model), tflat)
    np.testing.assert_array_equal(flat_to_jax(tflat, model), jflat)
    # the codec round-trips, stacked clients included
    stacked = torch.from_numpy(np.stack([tflat, 2 * tflat]))
    views = unflatten_params(stacked, shapes)
    np.testing.assert_array_equal(flatten_params(views, batch_dims=1).numpy(), stacked.numpy())
    back = params_to_jax(tparams, model)
    for layer, leaves in jp.items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], np.asarray(arr))


def test_partition_extract_insert_round_trip():
    part = Net().partition()
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.normal(size=(3, part.total)).astype(np.float32))
    for gid in range(part.num_groups):
        v = part.extract(flat, gid)
        assert v.shape == (3, part.group_size(gid))
        new = torch.zeros_like(v)
        out = part.insert(flat, gid, new)
        assert torch.equal(part.extract(out, gid), new)
        # the other groups are untouched
        for other in range(part.num_groups):
            if other != gid:
                assert torch.equal(part.extract(out, other), part.extract(flat, other))
