"""Port parity: the switch-MoE MLP, the MoE transformers and the MoE loss term.

The JAX package's `MoEMLP` (dim 16, E = 4, MLP x 4) is initialised with
Flax, its parameters converted, and both layers run on the same seeded
tokens: the routing (expert index, keep mask) is equal, the output within
1e-5 of the largest reference entry (two f32 GEMMs in other orders) and the
load-balance term within 1e-6; also with a capacity of one slot an expert,
where most tokens overflow (after the JAX package's
`tests/test_moe.py::test_moe_capacity_overflow_rides_residual`). The
gradients of the gate and of the experts are held to 1e-5 of each leaf's
largest entry. `ViT(moe_experts=4)` and `TransformerLM(moe_experts=4)` are
run for two clients at once against `apply` per client: logits and each
client's load-balance term within 1e-5. The engine's `data_loss` is held
against the JAX package's `_data_loss` with and without `moe_aux_coef`, as
`tests/test_engine.py::test_moe_aux_loss_reaches_engine_loss` does.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
from federated_pytorch_test_tpu.engine import Trainer as JTrainer
from federated_pytorch_test_tpu.engine import get_preset as j_preset
from federated_pytorch_test_tpu.engine.steps import _data_loss as j_data_loss
from federated_pytorch_test_tpu.models import TransformerLM as JLM
from federated_pytorch_test_tpu.models import ViT as JViT
from federated_pytorch_test_tpu.models.moe import MoEMLP as JMoE
from federated_pytorch_test_tpu.partition import flatten_params as jflatten
from federated_pytorch_test_tpu_torch.convert import flat_from_jax, jax_path
from federated_pytorch_test_tpu_torch.engine.steps import GroupContext, data_loss
from federated_pytorch_test_tpu_torch.models import TransformerLM, ViT, init_client_params
from federated_pytorch_test_tpu_torch.models.base import DENSE, expert_xavier_bound, xavier_bound
from federated_pytorch_test_tpu_torch.models.moe import EXPERT_BIAS, EXPERT_WEIGHT, MoEMLP
from federated_pytorch_test_tpu_torch.optim import LBFGSConfig
from federated_pytorch_test_tpu_torch.partition import leaf_offsets, unflatten_params

DIM, E = 16, 4
OUT_RTOL = 1e-5  # of the largest reference entry
AUX_ATOL = 1e-6
GRAD_RTOL = 1e-5  # of each leaf's largest reference entry


def _layer_inputs(capacity_factor, seed, b=2, s=24):
    x = np.random.default_rng(seed).normal(size=(b, s, DIM)).astype(np.float32)
    layer = JMoE(DIM, E, capacity_factor=capacity_factor, return_aux=True)
    params = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    return layer, params, x


def _port_params(jparams):
    """The JAX layer's tree as the port's `{moe.<leaf>: [1, ...]}` (the gate's kernel transposed)."""
    p = {"moe.gate.weight": jparams["gate"]["kernel"].T, "moe.gate.bias": jparams["gate"]["bias"]}
    p.update({f"moe.{n}": jparams[n] for n in ("w1", "b1", "w2", "b2")})
    return {n: torch.from_numpy(np.array(v))[None] for n, v in p.items()}


def _jax_routing(jparams, x, cap):
    """expert and keep per token, as the JAX layer computes them."""
    xt = jnp.asarray(x).reshape(-1, DIM)
    probs = jax.nn.softmax(xt @ jparams["gate"]["kernel"] + jparams["gate"]["bias"], axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, E, dtype=jnp.float32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1.0) * onehot, axis=1)
    return np.asarray(expert), np.asarray(pos < cap)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("capacity_factor,dropped", [(1.25, False), (1.0 / 8, True)], ids=["ample", "overflow"])
def test_layer_matches_jax(capacity_factor, dropped):
    layer, jparams, x = _layer_inputs(capacity_factor, seed=3)
    want, want_aux = layer.apply({"params": jparams}, jnp.asarray(x))
    moe = MoEMLP(DIM, E, capacity_factor=capacity_factor)
    params = _port_params(jparams)
    y = torch.from_numpy(x).reshape(1, -1, DIM)
    cap = moe.capacity(y.shape[1])
    assert cap == max(1, math.ceil(y.shape[1] / E * capacity_factor))
    _, expert, _, _, keep = moe.route(params, "moe", y)
    j_expert, j_keep = _jax_routing(jparams, x, cap)
    np.testing.assert_array_equal(expert[0].numpy(), j_expert)
    np.testing.assert_array_equal(keep[0].numpy(), j_keep)
    assert bool((~keep).any()) == dropped
    with torch.no_grad():
        out, aux = moe.forward_batched(params, "moe", y)
    out = out.reshape(x.shape).numpy()
    assert _rel(out, np.asarray(want)) <= OUT_RTOL
    assert abs(float(aux[0]) - float(want_aux)) <= AUX_ATOL
    # a dropped token's output is exactly 0: it rides the residual
    assert np.all(out.reshape(-1, DIM)[~keep[0].numpy()] == 0)
    if dropped:
        assert int(keep.sum()) <= E * cap


def test_layer_gradients_match_jax():
    layer, jparams, x = _layer_inputs(1.0, seed=4)  # capacity 12 of 48 tokens: some overflow
    cot = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        out, aux = layer.apply({"params": p}, xx)
        return jnp.sum(out * cot) + 3.0 * aux

    jgrads, jgx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))
    params = {n: t.requires_grad_(True) for n, t in _port_params(jparams).items()}
    y = torch.from_numpy(x).reshape(1, -1, DIM).requires_grad_(True)
    out, aux = MoEMLP(DIM, E, capacity_factor=1.0).forward_batched(params, "moe", y)
    ((out.reshape(x.shape) * torch.from_numpy(cot)).sum() + 3.0 * aux.sum()).backward()
    want = _port_params(jax.tree.map(np.asarray, jgrads))
    for name, t in params.items():
        assert _rel(t.grad.numpy(), want[name].numpy()) <= GRAD_RTOL, name
    assert _rel(y.grad.reshape(x.shape).numpy(), np.asarray(jgx)) <= GRAD_RTOL


def test_new_leaf_kinds_convert_and_initialise_as_flax():
    model = ViT(dim=DIM, num_heads=2, moe_experts=E)
    kinds = model.leaf_kinds()
    assert kinds["block0.moe.w1"] == kinds["block0.moe.w2"] == EXPERT_WEIGHT
    assert kinds["block0.moe.b1"] == kinds["block0.moe.b2"] == EXPERT_BIAS
    assert kinds["block0.moe.gate.weight"] == DENSE
    assert jax_path("block0.moe.w1", EXPERT_WEIGHT) == ("block0", "moe", "w1")
    assert jax_path("block0.moe.gate.weight", DENSE) == ("block0", "moe", "gate", "kernel")
    # the JAX package's order inside a block: b1, b2, gate/bias, gate/kernel, w1, w2
    names = [".".join(p[2:]) for p, _, _ in leaf_offsets(model.shapes()) if p[:2] == ("block0", "moe")]
    assert names == ["b1", "b2", "gate.bias", "gate.weight", "w1", "w2"]
    p = unflatten_params(init_client_params(model, 1, seed=2, device="cpu")[0], model.shapes())
    assert torch.all(p["block2.moe.b1"] == 0.01) and torch.all(p["block2.moe.b2"] == 0.01)
    for name, shape in (("block1.moe.w1", (E, DIM, 4 * DIM)), ("block1.moe.w2", (E, 4 * DIM, DIM))):
        bound = expert_xavier_bound(shape)  # fan_in = E·in, fan_out = E·out
        assert tuple(p[name].shape) == shape and math.isclose(bound, math.sqrt(6 / (E * DIM + E * 4 * DIM)))
        assert 0.95 * bound < float(p[name].abs().max()) <= bound
    gate_bound = xavier_bound((E, DIM))
    assert 0.8 * gate_bound < float(p["block0.moe.gate.weight"].abs().max()) <= gate_bound
    # Flax's own draws stay inside the same bounds
    jp = JViT(dim=DIM, num_heads=2, moe_experts=E).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    bound = expert_xavier_bound((E, DIM, 4 * DIM))
    assert 0.95 * bound < float(jnp.abs(jp["block1"]["moe"]["w1"]).max()) <= bound
    assert np.all(np.asarray(jp["block1"]["moe"]["b1"]) == np.float32(0.01))


def test_negative_experts_raise():
    with pytest.raises(ValueError, match="moe_experts"):
        ViT(moe_experts=-1)
    with pytest.raises(ValueError, match="moe_experts"):
        TransformerLM(moe_experts=-2)


def _two_clients(jmodel, model, dummy, seed):
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), dummy)["params"])
    base = flat_from_jax(np.asarray(jflatten(jp)[0]), model)
    return jp, torch.from_numpy(np.stack([base, 0.9 * base]))


@pytest.mark.parametrize("kind", ["vit", "lm"])
def test_moe_models_match_jax_per_client(kind):
    if kind == "vit":
        kw = dict(dim=DIM, num_heads=2, patch=4, moe_experts=E)
        jmodel, model = JViT(**kw), ViT(**kw)
        x = np.random.default_rng(6).normal(size=(2, 3, 32, 32, 3)).astype(np.float32)
        jp, flat = _two_clients(jmodel, model, jnp.zeros((1, 32, 32, 3)), seed=7)
    else:
        kw = dict(vocab=32, dim=DIM, num_heads=2, max_len=64, moe_experts=E)
        jmodel, model = JLM(**kw), TransformerLM(**kw)
        x = np.random.default_rng(8).integers(0, 32, size=(2, 3, 64)).astype(np.int32)
        jp, flat = _two_clients(jmodel, model, jnp.zeros((1, 64), jnp.int32), seed=9)
    with torch.no_grad():
        logits, aux = model.forward_batched(unflatten_params(flat, model.shapes()), torch.from_numpy(x),
                                            return_aux=True)
    assert aux.shape == (2,)
    for k, scale in enumerate((1.0, 0.9)):
        pk = jax.tree.map(lambda a: a * np.float32(scale), jp)
        want, mut = jmodel.apply({"params": pk}, jnp.asarray(x[k]), mutable=["intermediates"])
        want_aux = sum(float(jnp.sum(a)) for a in jax.tree.leaves(mut["intermediates"]))
        assert _rel(logits[k].numpy(), np.asarray(want)) <= 1e-5, k
        assert abs(float(aux[k]) - want_aux) <= 1e-5, k
    with torch.no_grad():  # without experts the term is 0
        plain = type(model)(**{**kw, "moe_experts": 0})
        _, zero = plain.forward_batched(unflatten_params(torch.zeros(2, plain.partition().total), plain.shapes()),
                                        torch.from_numpy(x), return_aux=True)
    assert torch.all(zero == 0)


@pytest.fixture(scope="module")
def jax_moe_ctx():
    cfg = j_preset("fedavg", model="vit", model_kwargs={"moe_experts": 2, "dim": DIM, "num_heads": 2}, batch=40,
                   nloop=1, check_results=False, synthetic_ok=True)
    tr = JTrainer(cfg, verbose=False, source=j_synthetic(n_train=240, n_test=60))
    return tr._ctx(tr.group_order[0]), np.asarray(tr.flat)[0], cfg.moe_aux_coef


def test_data_loss_matches_jax_with_and_without_the_aux_term(jax_moe_ctx):
    jctx, flat0, coef = jax_moe_ctx
    assert jctx.moe_aux_coef == coef == 0.01
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(4,)).astype(np.int32)
    model = ViT(dim=DIM, num_heads=2, moe_experts=2)
    flat = torch.from_numpy(flat_from_jax(flat0, model))[None]
    params = unflatten_params(flat, model.shapes())
    ctx = GroupContext(model=model, shapes=model.shapes(), partition=model.partition(), gid=0,
                       lbfgs=LBFGSConfig(line_search=True, batch_mode=True), reg_on_active=False, moe_aux_coef=coef)
    got = {}
    for c in (coef, 0.0):
        with torch.no_grad():
            got[c] = float(data_loss(dataclasses.replace(ctx, moe_aux_coef=c), params,
                                     torch.from_numpy(imgs)[None], torch.from_numpy(labels)[None])[0])
        want, _ = j_data_loss(jctx._replace(moe_aux_coef=c), jnp.asarray(flat0), {}, jnp.asarray(imgs),
                              jnp.asarray(labels))
        assert abs(got[c] - float(want)) <= 1e-5 * abs(float(want)), (c, got[c], float(want))
    # four blocks' load-balance terms, each >= 1, at coefficient 0.01
    assert got[coef] - got[0.0] > 0.9 * 4 * coef


def test_trainer_context_takes_the_coefficient_only_with_experts():
    from federated_pytorch_test_tpu_torch.data import synthetic_cifar
    from federated_pytorch_test_tpu_torch.engine import ExperimentConfig, Trainer

    cfg = ExperimentConfig(model="vit", model_kwargs={"dim": DIM, "num_heads": 2, "moe_experts": 2}, batch=8,
                           device="cpu")
    assert cfg.moe_aux_coef == 0.01
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(48, 16))
    assert tr.ctx(1).moe_aux_coef == 0.01
    dense = Trainer(cfg.replace(model_kwargs={"dim": DIM, "num_heads": 2}), verbose=False,
                    source=synthetic_cifar(48, 16))
    assert dense.ctx(1).moe_aux_coef == 0.0
