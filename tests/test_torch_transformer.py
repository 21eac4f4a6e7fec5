"""Port parity: the TransformerLM's parameter tree, flat order and logits.

A small `TransformerLM` (vocab 32, dim 32, 2 heads, 128 positions) is
initialised in the JAX package (with 'dense' attention: its init runs a
64-token forward, which the flash kernels refuse), converted, and run on
the same seeded tokens in both packages. The flat leaf order and the
partition groups are compared exactly. Logits: relative 2e-4 / absolute
2e-5 — float32 products and LayerNorms summed in other orders through
four blocks (the JAX flash path runs its Pallas kernels in interpret
mode, as the JAX package's own tests do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.models import Net as JNet
from federated_pytorch_test_tpu.models import TransformerLM as JLM
from federated_pytorch_test_tpu.partition import flatten_params as jflatten
from federated_pytorch_test_tpu.partition.flat import leaf_offsets as j_leaf_offsets
from federated_pytorch_test_tpu_torch.convert import (
    flat_from_jax,
    flat_to_jax,
    jax_path,
    params_from_jax,
    params_to_jax,
)
from federated_pytorch_test_tpu_torch.models import Net, TransformerLM
from federated_pytorch_test_tpu_torch.models.base import ARRAY, DENSE, EMBED, NORM_BIAS, SCALE
from federated_pytorch_test_tpu_torch.partition import flatten_params, leaf_offsets

SMALL = dict(vocab=32, dim=32, num_heads=2, max_len=128)


@pytest.fixture(scope="module")
def jax_lm():
    jp = JLM(**SMALL, attn_impl="dense").init(jax.random.PRNGKey(4), jnp.zeros((1, 64), jnp.int32))["params"]
    return jax.tree.map(np.asarray, jp)


def test_leaf_order_matches_jax(jax_lm):
    model = TransformerLM(**SMALL)
    kinds = model.leaf_kinds()
    port = [(jax_path(".".join(p), kinds[".".join(p)]), start, size) for p, start, size in leaf_offsets(model.shapes())]
    assert port == j_leaf_offsets(jax_lm)
    roots = []
    for path, _, _ in port:
        if path[0] not in roots:
            roots.append(path[0])
    assert roots == ["block0", "block1", "block2", "block3", "embed", "head", "ln_out", "pos_embed"]
    assert [p[1:] for p, _, _ in port if p[0] == "block0"] == [
        ("attn", "proj", "bias"), ("attn", "proj", "kernel"), ("attn", "qkv", "bias"), ("attn", "qkv", "kernel"),
        ("fc1", "bias"), ("fc1", "kernel"), ("fc2", "bias"), ("fc2", "kernel"),
        ("ln1", "bias"), ("ln1", "scale"), ("ln2", "bias"), ("ln2", "scale"),
    ]


def test_leaf_kinds():
    kinds = TransformerLM(**SMALL).leaf_kinds()
    assert kinds["embed.weight"] == EMBED and kinds["pos_embed"] == ARRAY
    assert kinds["block2.attn.qkv.weight"] == DENSE and kinds["head.weight"] == DENSE
    assert kinds["ln_out.weight"] == SCALE and kinds["block0.ln1.bias"] == NORM_BIAS


def test_partition_groups_match_jax(jax_lm):
    jpart = JLM.partition(jax_lm)
    tpart = TransformerLM(**SMALL).partition()
    assert tpart.total == jpart.total
    assert [[(s.start, s.size) for s in g] for g in tpart.groups] == [
        [(s.start, s.size) for s in g] for g in jpart.groups
    ]
    assert (tpart.linear_group_ids, tpart.train_order) == (jpart.linear_group_ids, jpart.train_order)


def test_full_size_parameter_count():
    # the class defaults: vocab 256, dim 64, 4 heads, 2048 positions
    part = TransformerLM().partition()
    assert part.total == 364160
    assert [part.group_size(g) for g in range(part.num_groups)] == [147456, 49984, 49984, 49984, 50112, 16640]


def test_converter_round_trip(jax_lm):
    model = TransformerLM(**SMALL)
    tparams = params_from_jax(jax_lm, model)
    assert {n: tuple(t.shape) for n, t in tparams.items()} == model.shapes()
    # embeddings and positions keep their [rows, dim] layout; dense kernels transpose
    np.testing.assert_array_equal(tparams["embed.weight"].numpy(), jax_lm["embed"]["embedding"])
    np.testing.assert_array_equal(tparams["pos_embed"].numpy(), jax_lm["pos_embed"])
    np.testing.assert_array_equal(tparams["head.weight"].numpy(), jax_lm["head"]["kernel"].T)
    back = params_to_jax(tparams, model)
    assert jax.tree.structure(back) == jax.tree.structure(jax_lm)
    jax.tree.map(np.testing.assert_array_equal, back, jax_lm)
    jflat = np.asarray(jflatten(jax_lm)[0])
    tflat = flatten_params(tparams).numpy()
    np.testing.assert_array_equal(flat_from_jax(jflat, model), tflat)
    np.testing.assert_array_equal(flat_to_jax(tflat, model), jflat)
    stacked = np.stack([jflat, -jflat])  # leading client axis
    np.testing.assert_array_equal(flat_to_jax(flat_from_jax(stacked, model), model), stacked)


def test_converter_rejects_a_foreign_tree(jax_lm):
    with pytest.raises((KeyError, ValueError)):
        params_from_jax(jax_lm, Net())


def test_net_converter_cases_still_pass():
    jp = jax.tree.map(np.asarray, JNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    model = Net()
    tparams = params_from_jax(jp, model)
    np.testing.assert_array_equal(tparams["conv1.weight"].numpy(), np.transpose(jp["conv1"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(tparams["fc1.weight"].numpy(), jp["fc1"]["kernel"].T)
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(tparams, model), jp)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match_jax(jax_lm, impl):
    tokens = np.random.default_rng(9).integers(0, SMALL["vocab"], size=(3, 128)).astype(np.int32)
    jlm = JLM(**SMALL, attn_impl=impl)
    ref = np.asarray(jlm.apply({"params": jax_lm}, jnp.asarray(tokens)))
    model = TransformerLM(**SMALL, attn_impl=impl)
    model.load_state_dict(params_from_jax(jax_lm, model))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens)).numpy()
    assert out.shape == (3, 128, SMALL["vocab"])
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_batched_forward_matches_per_client(jax_lm):
    # K clients with distinct weights in one batched forward == K forwards
    model = TransformerLM(**SMALL, attn_impl="flash")
    base = flat_from_jax(np.asarray(jflatten(jax_lm)[0]), model)
    flat = torch.from_numpy(np.stack([base, 0.9 * base, 1.1 * base]))
    from federated_pytorch_test_tpu_torch.partition import unflatten_params

    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 32, size=(3, 2, 128)))
    with torch.no_grad():
        out = model.forward_batched(unflatten_params(flat, model.shapes()), tokens)
        for k in range(3):
            model.load_state_dict(unflatten_params(flat[k], model.shapes()))
            np.testing.assert_allclose(out[k].numpy(), model(tokens[k]).numpy(), rtol=1e-5, atol=1e-6)


def test_attn_options():
    with pytest.raises(NotImplementedError):
        TransformerLM(**SMALL, attn_impl="ring")
    moe = TransformerLM(**SMALL, moe_experts=4)  # a switch-MoE MLP in every block (tests/test_torch_moe.py)
    tokens = torch.zeros(1, 128, dtype=torch.long)
    assert moe.moe_experts == 4 and moe(tokens).shape == (1, 128, SMALL["vocab"])
    with pytest.raises(ValueError, match="moe_experts"):
        TransformerLM(**SMALL, moe_experts=-1)
    with pytest.raises(ValueError):
        TransformerLM(**SMALL, attn_impl="sparse")
    from federated_pytorch_test_tpu_torch.models.transformer import resolve_attn_impl

    assert [resolve_attn_impl("auto", s) for s in (1024, 2048, 2100, 4096)] == ["dense", "flash", "dense", "flash"]


def test_init_kinds():
    # the reference init per kind: LayerNorm scale 1 / bias 0, dense bias
    # 0.01, embeddings and positions normal(0.02), dense weights xavier
    from federated_pytorch_test_tpu_torch.models import init_client_params
    from federated_pytorch_test_tpu_torch.partition import unflatten_params

    model = TransformerLM(**SMALL)
    p = unflatten_params(init_client_params(model, 2, seed=1, device="cpu")[1], model.shapes())
    assert torch.all(p["block1.ln2.weight"] == 1) and torch.all(p["ln_out.bias"] == 0)
    assert torch.all(p["head.bias"] == 0.01)
    assert abs(float(p["pos_embed"].std()) - 0.02) < 0.002
    assert abs(float(p["embed.weight"].std()) - 0.02) < 0.004
    bound = np.sqrt(6.0 / (32 + 96))
    assert 0.9 * bound < float(p["block0.attn.qkv.weight"].abs().max()) <= bound
