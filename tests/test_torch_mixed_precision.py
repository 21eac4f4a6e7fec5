"""Port parity for mixed precision: `compute_dtype="bfloat16"` and `remat`.

The JAX package's meaning, held here against it on the CPU: parameters,
the loss and all L-BFGS math stay f32; convolutions, matmuls and the norms'
elementwise math run in bf16; the engine casts the frozen coordinates to
bf16 once a minibatch and the active group's inside each evaluation, and
casts the logits to f32 before the cross-entropy.

* The config fields, their defaults and their validation against the JAX
  `ExperimentConfig`.
* Net, a narrowed ResNet18 (planes 8/16/32/64, the JAX package's own
  ResNet test width), a small ViT (dim 32, 2 heads, 256 tokens, 'flash' at
  attn_precision 'default') and a small TransformerLM (dim 32, 2 heads,
  128 tokens, likewise), from one seed with parameters converted from the
  JAX init (`convert.py`): logits, the clients' losses and the active
  group's gradient against the JAX model's `apply` at dtype=bfloat16 on the
  same bf16-cast parameters, within rtol = atol = 3e-2 of the largest
  entry — the JAX package's own bf16-vs-f32 bound (tests/test_engine.py:480):
  the two frameworks round bf16 at other places (a product's output before
  or after its bias, LayerNorm and BatchNorm statistics; the port's
  BatchNorm takes its statistics in f32 where the JAX model takes them in
  bf16, `models/resnet.py`). The ResNet's new running statistics likewise.
  Each test prints its readings.
* One L-BFGS step of Net's fc1 group at bf16 from the same state against the
  JAX step (`lbfgs_step` on the same bf16 objective): the parameters
  within 3e-2 of the largest.
* `remat` on and off: the same trajectory within the JAX package's
  rtol 1e-5, atol 1e-6 (tests/test_engine.py:254-264).
* A switch-MoE model under bf16 raises (no bf16 grouped GEMM yet).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from federated_pytorch_test_tpu.consensus import elastic_net as j_elastic
from federated_pytorch_test_tpu.data import normalize as j_normalize
from federated_pytorch_test_tpu.engine.config import ExperimentConfig as JExperimentConfig
from federated_pytorch_test_tpu.models import Net as JNet
from federated_pytorch_test_tpu.models import ResNet18 as JResNet18
from federated_pytorch_test_tpu.models import TransformerLM as JLM
from federated_pytorch_test_tpu.models import ViT as JViT
from federated_pytorch_test_tpu.optim import LBFGSConfig as JLBFGSConfig
from federated_pytorch_test_tpu.optim import lbfgs_init as j_init
from federated_pytorch_test_tpu.optim import lbfgs_step as j_step
from federated_pytorch_test_tpu.partition import flatten_params as jflatten
from federated_pytorch_test_tpu_torch.convert import flat_from_jax, flat_to_jax, stats_from_jax, stats_to_jax
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import ExperimentConfig, Trainer, get_preset
from federated_pytorch_test_tpu_torch.engine.steps import GroupContext, client_train_step, objective
from federated_pytorch_test_tpu_torch.models import Net, ResNet18, TransformerLM, ViT
from federated_pytorch_test_tpu_torch.optim import LBFGSConfig, lbfgs_init
from federated_pytorch_test_tpu_torch.partition import unflatten_params

BF16_TOL = 3e-2  # the JAX package's bf16-vs-f32 bound (tests/test_engine.py:480)
NARROW = ((8, 1), (8, 1), (16, 2), (16, 1), (32, 2), (32, 1), (64, 2), (64, 1))
K = 2


def _close(what, got, want, tol=BF16_TOL):
    """got within tol (relative and absolute) of want, measured against want's largest entry; prints the reading."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    reading = float(np.abs(got - want).max()) / scale
    print(f"{what}: max |port - jax| / max|jax| = {reading:.3e}")
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol, err_msg=what)
    return reading


def test_config_fields_match_jax():
    for name in ("compute_dtype", "remat"):
        assert getattr(ExperimentConfig(), name) == getattr(JExperimentConfig(), name)
    assert ExperimentConfig(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    for bad in ("float16", "bf16"):
        with pytest.raises(ValueError) as port_err:
            ExperimentConfig(compute_dtype=bad)
        with pytest.raises(ValueError) as jax_err:
            JExperimentConfig(compute_dtype=bad)
        assert str(port_err.value) == str(jax_err.value)
    # presets take them as overrides, as in the JAX package
    assert get_preset("fedavg", compute_dtype="bfloat16", remat=True).remat


def _jax_client_loss(jmodel, unravel, jpart, gid, jflat16, x, inputs, labels, stats=None):
    """The JAX engine's bf16 evaluation for one client: the active group cast
    inside, logits cast to f32 before the cross-entropy."""
    params = unravel(jpart.insert(jflat16, gid, x.astype(jnp.bfloat16)))
    if stats is not None:
        logits, upd = jmodel.apply({"params": params, "batch_stats": stats}, inputs, train=True,
                                   mutable=["batch_stats"])
    else:
        logits, upd = jmodel.apply({"params": params}, inputs), None
    flat_logits = logits.astype(jnp.float32).reshape(-1, logits.shape[-1])
    loss = optax.softmax_cross_entropy_with_integer_labels(flat_logits, labels.reshape(-1)).mean()
    return loss, (logits, upd)


def _case(name):
    """(jax model, port model, jax params, inputs [K, ...], labels [K, ...], group, stats)."""
    rng = np.random.default_rng(7)
    if name == "lm":
        kw = dict(vocab=32, dim=32, num_heads=2, max_len=128)
        jmodel = JLM(**kw, attn_impl="flash", attn_precision="default", dtype=jnp.bfloat16)
        init = JLM(**kw, attn_impl="dense").init(jax.random.PRNGKey(4), jnp.zeros((1, 64), jnp.int32))
        model = TransformerLM(**kw, attn_impl="flash", attn_precision="default", dtype=torch.bfloat16)
        inputs = rng.integers(0, 32, size=(K, 2, 128)).astype(np.int32)
        labels = rng.integers(0, 32, size=(K, 2, 128)).astype(np.int32)
        return jmodel, model, init["params"], inputs, labels, 0, None
    images = rng.normal(size=(K, 4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(K, 4)).astype(np.int32)
    if name == "vit":
        kw = dict(dim=32, num_heads=2, patch=2)
        jmodel = JViT(**kw, attn_impl="flash", attn_precision="default", dtype=jnp.bfloat16)
        init = JViT(**kw).init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
        model = ViT(**kw, attn_impl="flash", attn_precision="default", dtype=torch.bfloat16)
        return jmodel, model, init["params"], images[:, :2], labels[:, :2], 1, None
    if name == "net":
        init = JNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
        return JNet(dtype=jnp.bfloat16), Net(dtype=torch.bfloat16), init["params"], images, labels, 2, None
    init = JResNet18().init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)), train=False)
    return (JResNet18(dtype=jnp.bfloat16), ResNet18(dtype=torch.bfloat16), init["params"], images, labels, 9,
            init["batch_stats"])


@pytest.mark.parametrize("name", ["net", "resnet", "vit", "lm"])
def test_bf16_model_matches_jax(name, monkeypatch):
    if name == "resnet":
        monkeypatch.setattr(JResNet18, "STAGES", NARROW)
        monkeypatch.setattr(ResNet18, "STAGES", NARROW)
    jmodel, model, jparams, inputs, labels, gid, jstats = _case(name)
    jparams = jax.tree.map(np.asarray, jparams)
    jflat, unravel = jflatten(jparams)
    jpart = type(jmodel).partition(jparams)
    jflat16 = jflat.astype(jnp.bfloat16)
    x0 = jpart.extract(jflat, gid)

    want_loss, want_grad, want_logits, want_stats = [], [], [], []
    client = jax.jit(jax.value_and_grad(_jax_client_loss, argnums=5, has_aux=True), static_argnums=(0, 1, 2, 3))
    for c in range(K):
        (loss, (logits, upd)), grad = client(jmodel, unravel, jpart, gid, jflat16, x0, jnp.asarray(inputs[c]),
                                             jnp.asarray(labels[c]), jstats)
        want_loss.append(float(loss))
        want_grad.append(np.asarray(jpart.insert(jnp.zeros_like(jflat), gid, grad)))
        want_logits.append(np.asarray(logits.astype(jnp.float32)))
        if upd is not None:
            want_stats.append(upd["batch_stats"])

    flat = torch.from_numpy(flat_from_jax(np.asarray(jflat), model))[None].repeat(K, 1)
    part = model.partition()
    x = part.extract(flat, gid).contiguous().requires_grad_(True)
    shapes = model.shapes()
    if name == "lm":
        params = unflatten_params(part.insert(flat.to(torch.bfloat16), gid, x.to(torch.bfloat16)), shapes)
        logits = model.forward_batched(params, torch.from_numpy(inputs))
        losses = torch.nn.functional.cross_entropy(
            logits.float().reshape(K, -1, logits.shape[-1]).transpose(1, 2), torch.from_numpy(labels).reshape(K, -1)
            .long(), reduction="none").mean(-1)
        new_stats = {}
    else:
        ctx = GroupContext(model=model, shapes=shapes, partition=part, gid=gid,
                           lbfgs=LBFGSConfig(line_search=True, batch_mode=True), reg_on_active=False)
        stats = {}
        if jstats is not None:
            stats = {n: t[None].repeat(K, *([1] * t.dim())) for n, t in stats_from_jax(jstats, model).items()}
        losses, _, new_stats = objective(ctx, flat, x, stats, torch.from_numpy(inputs), torch.from_numpy(labels))
        params = unflatten_params(part.insert(flat.to(torch.bfloat16), gid, x.detach().to(torch.bfloat16)), shapes)
        with torch.no_grad():
            out = model.forward_batched(params, torch.from_numpy(inputs), stats=stats) if stats else \
                model.forward_batched(params, torch.from_numpy(inputs))
        logits = out[0] if stats else out
    (grad,) = torch.autograd.grad(losses.sum(), x)
    assert logits.dtype == torch.bfloat16 and losses.dtype == torch.float32 and grad.dtype == torch.float32
    full_grad = part.insert(torch.zeros_like(flat), gid, grad)

    _close(f"{name} logits", logits.detach().float().numpy(), np.stack(want_logits))
    _close(f"{name} loss", losses.detach().numpy(), np.array(want_loss))
    _close(f"{name} group {gid} gradient", flat_to_jax(full_grad.numpy(), model), np.stack(want_grad))
    worst = 0.0
    for c, ws in enumerate(want_stats):  # the ResNet's new running averages, tensor by tensor
        got = jax.tree_util.tree_leaves(stats_to_jax({n: t[c] for n, t in new_stats.items()}))
        want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, ws))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            scale = max(float(np.abs(b).max()), 1e-30)
            np.testing.assert_allclose(a / scale, b / scale, rtol=BF16_TOL, atol=BF16_TOL)
            worst = max(worst, float(np.abs(a - b).max()) / scale)
    if want_stats:
        print(f"{name} running statistics: worst max |port - jax| / max|jax| = {worst:.3e}")

def test_bf16_lbfgs_step_on_fc1_matches_jax():
    gid, lam = 2, 1e-4
    jmodel = JNet(dtype=jnp.bfloat16)
    jp = JNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    jflat, unravel = jflatten(jp)
    jpart = JNet.partition(jp)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, size=(40, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(40,)).astype(np.int32)
    images = j_normalize(jnp.asarray(imgs), 0.5, 0.5)
    jcfg = JLBFGSConfig(max_iter=4, history_size=10, line_search=True, batch_mode=True)
    jflat16 = jflat.astype(jnp.bfloat16)

    def loss_fn(xx):
        logits = jmodel.apply({"params": unravel(jpart.insert(jflat16, gid, xx.astype(jnp.bfloat16)))}, images)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), jnp.asarray(labels)).mean()
        return ce + j_elastic(xx, lam, lam)

    x0 = jpart.extract(jflat, gid)
    x, jstate, _ = j_step(loss_fn, x0, j_init(x0, jcfg), jcfg)
    jfinal = np.asarray(jpart.insert(jflat, gid, x))

    model = Net(dtype=torch.bfloat16)
    cfg = LBFGSConfig(max_iter=4, history_size=10, line_search=True, batch_mode=True)
    ctx = GroupContext(model=model, shapes=model.shapes(), partition=model.partition(), gid=gid, lbfgs=cfg,
                       reg_on_active=True, lambda1=lam, lambda2=lam)
    flat = torch.from_numpy(flat_from_jax(np.asarray(jflat), model))[None].clone()
    start = flat.clone()
    state = lbfgs_init(ctx.partition.extract(flat, gid).contiguous(), cfg)
    half = torch.tensor([0.5])
    flat, state, _, loss = client_train_step(ctx, flat, state, {}, torch.from_numpy(imgs[None]),
                                             torch.from_numpy(labels[None]), half, half)
    print(f"iterations port={int(state.n_iter[0])} jax={int(jstate.n_iter)}; "
          f"evaluations port={int(state.func_evals[0])} jax={int(jstate.func_evals)}")
    assert torch.isfinite(flat).all() and not torch.equal(flat, start)
    _close("one bf16 L-BFGS step, fc1", flat[0].numpy(), flat_from_jax(jfinal, model))


def test_remat_keeps_the_trajectory():
    flats, losses = {}, {}
    for remat in (False, True):
        cfg = get_preset("fedavg", batch=40, nloop=1, nadmm=1, max_groups=2, compute_dtype="bfloat16",
                         remat=remat, device="cpu", check_results=False)
        tr = Trainer(cfg, verbose=False, source=synthetic_cifar(240, 60))
        assert tr.ctx(tr.group_order[0]).remat is remat
        rec = tr.run()
        flats[remat] = tr.flat.numpy()
        losses[remat] = np.asarray([r["value"] for r in rec.series["train_loss"]])
    assert np.isfinite(losses[True]).all()
    np.testing.assert_allclose(flats[True], flats[False], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5, atol=1e-6)


def test_bf16_trainer_runs_with_f32_parameters():
    # the engine path end to end at bf16: the flat vector and the optimizer
    # stay f32, the model runs in bf16, evaluation casts per layer
    cfg = get_preset("fedavg", batch=40, nloop=1, nadmm=1, max_groups=1, compute_dtype="bfloat16", device="cpu",
                     eval_batch=30)
    tr = Trainer(cfg, verbose=False, source=synthetic_cifar(240, 60))
    assert tr.model.dtype == torch.bfloat16 and tr.flat.dtype == torch.float32
    rec = tr.run()
    assert tr.flat.dtype == torch.float32 and np.isfinite(tr.flat.numpy()).all()
    assert np.isfinite(np.asarray(rec.series["train_loss"][-1]["value"])).all()
    assert 0.0 <= float(np.min(rec.series["test_accuracy"][-1]["value"])) <= 1.0


def test_moe_under_bf16_raises():
    cfg = ExperimentConfig(model="vit", model_kwargs={"patch": 2, "dim": 32, "num_heads": 2, "moe_experts": 2},
                           compute_dtype="bfloat16", device="cpu", batch=8)
    with pytest.raises(NotImplementedError, match="bf16 grouped GEMM"):
        Trainer(cfg, verbose=False, source=synthetic_cifar(24, 16))
