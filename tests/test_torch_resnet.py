"""Port parity for ResNet18 (`models/resnet.py`) and its converter.

Full width is checked by shapes only (`jax.eval_shape`, no compute): the
parameter count, the 10 partition groups, the BatchNorm statistics and
the ResNet presets' shuffled group order. The numerics run at a narrow
width: `STAGES` set to planes 8/16/32/64 on both packages' classes (the
stem keeps its 64 planes in both), K=2 clients with their own parameters
and running statistics, batch 4, seeded numpy inputs.

Tolerances, with their readings on the CPU:
* train-mode logits within relative 1e-5 of the largest Flax logit
  (reading 1.2e-6): both normalize with the batch statistics, but torch's
  `F.batch_norm` computes the batch variance by another formula than
  Flax's E[x²] − E[x]², which moves the normalized values by a few ulps;
  the convolutions also sum in another order;
* the new running statistics within relative 1e-5 of each tensor's
  largest entry (reading 1.4e-6): the port computes them as Flax does,
  from activations that carry the convolutions' rounding;
* eval-mode logits on the same converted statistics, relative 1e-5
  (reading 8.3e-7);
* the single stride-2 block, relative 1e-5 (reading 3e-7); torch's
  symmetric (1, 1) padding misses by far more (checked, > 1e-2);
* the converter's round trips: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.models import ResNet18 as JResNet18
from federated_pytorch_test_tpu.models import init_client_params as j_init_params
from federated_pytorch_test_tpu_torch.convert import (
    _leaves,
    flat_from_jax,
    flat_to_jax,
    params_from_jax,
    params_to_jax,
    stats_from_jax,
    stats_to_jax,
)
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.models import ResNet18
from federated_pytorch_test_tpu_torch.models.resnet import _same_pads

NARROW = ((8, 1), (8, 1), (16, 2), (16, 1), (32, 2), (32, 1), (64, 2), (64, 1))
SHUFFLED = [2, 8, 4, 9, 1, 6, 7, 3, 0, 5]  # np.random.RandomState(0).permutation(10)
K, B = 2, 4


def _rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: relative {err:.3e}"
    return err


def _sizes(tree):
    return [int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree)]


def test_full_width_shapes_match_jax():
    variables = jax.eval_shape(lambda: JResNet18().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    model = ResNet18()
    assert sum(_sizes(variables["params"])) == 11_173_962 == sum(p.numel() for p in model.parameters())
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), variables["params"])
    jpart = JResNet18.partition(template)
    part = model.partition()
    sizes = [part.group_size(g) for g in range(part.num_groups)]
    assert sizes == [jpart.group_size(g) for g in range(jpart.num_groups)]
    assert len(sizes) == 10 and max(sizes) == sizes[8] == 4_720_640  # block7
    def spans(p):
        return [[(seg.start, seg.size) for seg in g] for g in p.groups]

    assert spans(part) == spans(jpart) and part.linear_group_ids == tuple(jpart.linear_group_ids) == ()
    # one leaf order for both flat vectors (the converter checks it) and
    # the same statistics, by name and shape
    assert len(_leaves(model)) == len(jax.tree_util.tree_leaves(variables["params"]))
    stats = model.init_stats(1, "cpu")
    jstats = jax.tree_util.tree_flatten_with_path(variables["batch_stats"])[0]
    assert sorted(stats) == sorted(".".join(k.key for k in path) for path, _ in jstats)
    for path, leaf in jstats:
        assert tuple(stats[".".join(k.key for k in path)].shape[1:]) == leaf.shape


@pytest.mark.parametrize("preset", ["fedavg_resnet", "admm_resnet"])
def test_resnet_presets_visit_the_shuffled_order(preset):
    assert list(np.random.RandomState(0).permutation(10)) == SHUFFLED
    src = synthetic_cifar(96, 20)
    tr = Trainer(get_preset(preset, device="cpu"), verbose=False, source=src)
    assert tr.group_order == SHUFFLED and tr.n_params == 11_173_962
    assert get_preset(preset).batch == 32 and not get_preset(preset).biased_input
    # max_groups cuts the order after the shuffle
    assert Trainer(get_preset(preset, device="cpu", max_groups=2), verbose=False, source=src).group_order == [2, 8]


@pytest.fixture(scope="module")
def narrow():
    """Both packages' ResNet18 at planes 8/16/32/64 for the module's tests:
    K=2 clients with distinct parameters and running statistics (the JAX
    init, perturbed per client from a numpy seed), converted to the port."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JResNet18, "STAGES", NARROW)
        mp.setattr(ResNet18, "STAGES", NARROW)
        variables = jax.tree.map(np.asarray, jax.jit(lambda: j_init_params(JResNet18(), K, seed=0))())
        rng = np.random.default_rng(0)
        params = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), variables["params"])
        stats = jax.tree.map(lambda a: (a + 0.1 * rng.random(size=a.shape)).astype(np.float32),
                             variables["batch_stats"])
        model = ResNet18()
        tparams = {n: torch.stack([params_from_jax(jax.tree.map(lambda a: a[k], params), model)[n]
                                   for k in range(K)]) for n in model.shapes()}
        tstats = stats_from_jax(stats, model)
    x = rng.normal(size=(K, B, 32, 32, 3)).astype(np.float32)
    return dict(model=model, params=params, stats=stats, tparams=tparams, tstats=tstats, x=x)


def _flax(params, stats, x, train, stages=NARROW):
    """Flax apply per client, vmapped over K; train mode also returns the new statistics."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JResNet18, "STAGES", stages)

        def one(p, s, xx):
            if train:
                out, mut = JResNet18().apply({"params": p, "batch_stats": s}, xx, train=True, mutable=["batch_stats"])
                return out, mut["batch_stats"]
            return JResNet18().apply({"params": p, "batch_stats": s}, xx, train=False), s

        out, new = jax.jit(jax.vmap(one))(params, stats, x)
    return np.asarray(out), jax.tree.map(np.asarray, new)


def test_train_mode_logits_and_new_statistics_match_flax(narrow):
    want, want_stats = _flax(narrow["params"], narrow["stats"], narrow["x"], train=True)
    logits, new_stats = narrow["model"].forward_batched(narrow["tparams"], torch.from_numpy(narrow["x"]),
                                                        stats=narrow["tstats"])
    _rel(logits.numpy(), want, 1e-5, "train logits")
    want_stats = stats_from_jax(want_stats, narrow["model"])
    assert sorted(new_stats) == sorted(want_stats)
    for name, t in new_stats.items():
        _rel(t.numpy(), want_stats[name].numpy(), 1e-5, name)
        assert not torch.equal(t, narrow["tstats"][name])  # the running averages moved


def test_eval_mode_logits_match_flax_on_converted_statistics(narrow):
    want, _ = _flax(narrow["params"], narrow["stats"], narrow["x"], train=False)
    got = narrow["model"].forward_batched(narrow["tparams"], torch.from_numpy(narrow["x"]), stats=narrow["tstats"],
                                          train=False)
    _rel(got.numpy(), want, 1e-5, "eval logits")
    with pytest.raises(ValueError):
        narrow["model"].forward_batched(narrow["tparams"], torch.from_numpy(narrow["x"]), train=False)


def test_a_stride2_block_pads_like_flax_same():
    # one stride-2 block alone behind the stem, on 8x8 inputs (the pool
    # then sees 4x4): Flax "SAME" pads (0, 1) there, not (1, 1)
    assert _same_pads(8, 3, 2) == (0, 1) and _same_pads(8, 3, 1) == (1, 1) and _same_pads(8, 1, 2) == (0, 0)
    stages = ((16, 2),)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(K, B, 8, 8, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JResNet18, "STAGES", stages)
        mp.setattr(ResNet18, "STAGES", stages)
        variables = jax.jit(lambda: JResNet18().init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)), train=False))()
        variables = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a), (K, *a.shape)), variables)
        model = ResNet18()
    assert model.block0.shortcut
    params = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), variables["params"])
    tparams = {n: torch.stack([params_from_jax(jax.tree.map(lambda a: a[k], params), model)[n] for k in range(K)])
               for n in model.shapes()}
    tstats = stats_from_jax(variables["batch_stats"], model)
    want, _ = _flax(params, variables["batch_stats"], x, train=True, stages=stages)
    with torch.no_grad():
        got, _ = model.forward_batched(tparams, torch.from_numpy(x), stats=tstats)
    _rel(got.numpy(), want, 1e-5, "stride-2 block")
    # torch's symmetric padding is not Flax's
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("federated_pytorch_test_tpu_torch.models.resnet._same_pads",
                   lambda size, kernel, stride: (kernel // 2, kernel // 2))
        with torch.no_grad():
            sym, _ = model.forward_batched(tparams, torch.from_numpy(x), stats=tstats)
    assert np.abs(sym.numpy() - want).max() > 1e-2 * np.abs(want).max()


def test_converter_round_trips_parameters_and_statistics(narrow):
    model = narrow["model"]
    one = jax.tree.map(lambda a: a[0], narrow["params"])
    back = params_to_jax(params_from_jax(one, model), model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(one)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(one)):
        np.testing.assert_array_equal(a, b)
    flat = np.concatenate([a.reshape(K, -1) for a in jax.tree_util.tree_leaves(narrow["params"])], axis=1)
    np.testing.assert_array_equal(flat_to_jax(flat_from_jax(flat, model), model), flat)
    stats_back = stats_to_jax(narrow["tstats"])
    assert jax.tree_util.tree_structure(stats_back) == jax.tree_util.tree_structure(narrow["stats"])
    for a, b in zip(jax.tree_util.tree_leaves(stats_back), jax.tree_util.tree_leaves(narrow["stats"])):
        np.testing.assert_array_equal(a, b)
