"""Port parity: the ViT's parameter tree, flat order, partition, logits and gradients.

A small `ViT` (dim 32, 2 heads, patch 2: 256 tokens, so 'flash' takes the
rectangular kernels' non-causal path) is initialised in the JAX package,
converted, and run on the same seeded images in both packages. The flat
leaf order and the partition groups are compared exactly. Logits:
relative 2e-4 / absolute 2e-5, as the LM's (float32 products and
LayerNorms summed in other orders through four blocks). Parameter
gradients of sum(logits²): relative 2e-3 / absolute 2e-4, the JAX
package's own flash-vs-dense tolerance for a model's gradients (the
backward sums over 256 keys and 2·256 tokens in other orders). The JAX
'flash' path runs its Pallas kernels in interpret mode, as its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.models import ViT as JViT
from federated_pytorch_test_tpu.partition import flatten_params as jflatten
from federated_pytorch_test_tpu.partition.flat import leaf_offsets as j_leaf_offsets
from federated_pytorch_test_tpu_torch.convert import flat_from_jax, flat_to_jax, jax_path, params_from_jax, params_to_jax
from federated_pytorch_test_tpu_torch.engine import ExperimentConfig, Trainer
from federated_pytorch_test_tpu_torch.models import MODELS, ViT
from federated_pytorch_test_tpu_torch.models.base import ARRAY, CONV
from federated_pytorch_test_tpu_torch.partition import flatten_params, leaf_offsets, unflatten_params

SMALL = dict(dim=32, num_heads=2, patch=2)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def jax_vit():
    jp = JViT(**SMALL).init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)


def test_vit_is_a_model_of_the_engine():
    assert MODELS["vit"] is ViT


def test_leaf_order_matches_jax(jax_vit):
    model = ViT(**SMALL)
    kinds = model.leaf_kinds()
    assert kinds["embed.weight"] == CONV and kinds["pos_embed"] == ARRAY
    port = [(jax_path(".".join(p), kinds[".".join(p)]), start, size) for p, start, size in leaf_offsets(model.shapes())]
    assert port == j_leaf_offsets(jax_vit)


def test_partition_groups_match_jax(jax_vit):
    jpart = JViT.partition(jax_vit)
    tpart = ViT(**SMALL).partition()
    assert tpart.total == jpart.total
    assert [[(s.start, s.size) for s in g] for g in tpart.groups] == [
        [(s.start, s.size) for s in g] for g in jpart.groups
    ]
    assert (tpart.linear_group_ids, tpart.train_order) == (jpart.linear_group_ids, jpart.train_order)


def test_full_size_parameter_count():
    # the class widths at patch 2: dim 64, 4 heads, 256 tokens, 10 classes
    part = ViT(patch=2).partition()
    assert part.total == 217930
    assert [part.group_size(g) for g in range(part.num_groups)] == [17216, 49984, 49984, 49984, 50112, 650]


def test_converter_round_trip(jax_vit):
    model = ViT(**SMALL)
    tparams = params_from_jax(jax_vit, model)
    assert {n: tuple(t.shape) for n, t in tparams.items()} == model.shapes()
    # the patch embedding is HWIO -> OIHW; the bare positions keep their leading 1
    np.testing.assert_array_equal(tparams["embed.weight"].numpy(),
                                  np.transpose(jax_vit["embed"]["kernel"], (3, 2, 0, 1)))
    assert tparams["pos_embed"].shape == jax_vit["pos_embed"].shape == (1, 256, 32)
    back = params_to_jax(tparams, model)
    assert jax.tree.structure(back) == jax.tree.structure(jax_vit)
    jax.tree.map(np.testing.assert_array_equal, back, jax_vit)
    jflat = np.asarray(jflatten(jax_vit)[0])
    tflat = flatten_params(tparams).numpy()
    np.testing.assert_array_equal(flat_from_jax(jflat, model), tflat)
    stacked = np.stack([jflat, 2 * jflat])
    np.testing.assert_array_equal(flat_to_jax(flat_from_jax(stacked, model), model), stacked)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match_jax(jax_vit, images, impl):
    ref = np.asarray(JViT(**SMALL, attn_impl=impl).apply({"params": jax_vit}, jnp.asarray(images)))
    model = ViT(**SMALL, attn_impl=impl)
    model.load_state_dict(params_from_jax(jax_vit, model))
    with torch.no_grad():
        out = model(torch.from_numpy(images)).numpy()
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out, ref, **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_gradients_match_jax(jax_vit, images, impl):
    jvit = JViT(**SMALL, attn_impl=impl)
    ref = jax.grad(lambda p: jnp.sum(jvit.apply({"params": p}, jnp.asarray(images)) ** 2))(
        jax.tree.map(jnp.asarray, jax_vit))
    model = ViT(**SMALL, attn_impl=impl)
    params = {n: t.requires_grad_(True) for n, t in params_from_jax(jax_vit, model).items()}
    (model.forward_batched({n: t[None] for n, t in params.items()}, torch.from_numpy(images)[None]) ** 2).sum().backward()
    got = params_to_jax({n: t.grad for n, t in params.items()}, model)
    for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(ref), jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(want), err_msg=jax.tree_util.keystr(path), **GRAD_TOL)


def test_batched_forward_matches_per_client(jax_vit):
    # K clients with distinct weights in one batched forward == K forwards
    model = ViT(**SMALL, attn_impl="flash")
    base = flat_from_jax(np.asarray(jflatten(jax_vit)[0]), model)
    flat = torch.from_numpy(np.stack([base, 0.9 * base, 1.1 * base]))
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(3, 2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        out = model.forward_batched(unflatten_params(flat, model.shapes()), x)
        assert out.shape == (3, 2, 10)
        for k in range(3):
            model.load_state_dict(unflatten_params(flat[k], model.shapes()))
            np.testing.assert_allclose(out[k].numpy(), model(x[k]).numpy(), rtol=1e-5, atol=1e-6)


def test_options():
    with pytest.raises(NotImplementedError):
        ViT(moe_experts=4)
    with pytest.raises(NotImplementedError):
        ViT(attn_impl="ring")
    with pytest.raises(ValueError, match="divisible by 128"):  # patch 4: 64 tokens
        ViT(attn_impl="flash")
    with pytest.raises(ValueError, match="does not divide"):
        ViT(patch=3)
    with pytest.raises(ValueError, match="32x32x3"):
        ViT(**SMALL)(torch.zeros(1, 28, 28, 3))
    from federated_pytorch_test_tpu_torch.models.transformer import resolve_attn_impl

    assert resolve_attn_impl(ViT(patch=2, attn_impl="auto").attn_impl, 256) == "dense"  # auto: flash from 2048


def test_trainer_takes_model_kwargs():
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar

    cfg = ExperimentConfig(model="vit", model_kwargs={"patch": 2, "attn_impl": "flash", "dim": 32, "num_heads": 2},
                           batch=8, device="cpu")
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(48, 16))
    assert isinstance(tr.model, ViT) and tr.model.tokens == 256 and tr.model.attn_impl == "flash"
    with pytest.raises(ValueError, match=r"model_kwargs \['depth'\] are not fields of 'vit'"):
        Trainer(cfg.replace(model_kwargs={"depth": 6}), verbose=False, source=synthetic_cifar(48, 16))
    with pytest.raises(ValueError, match="not fields of 'net'"):
        Trainer(ExperimentConfig(model_kwargs={"patch": 2}, batch=8, device="cpu"), verbose=False,
                source=synthetic_cifar(48, 16))
