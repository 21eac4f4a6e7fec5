"""Port parity for the no_consensus slice: the preset end to end.

The drive — `synthetic_cifar(240, 60)`, Net1 (890,410 parameters a
client, all trained at once), K=3, batch 40 (two minibatches an epoch),
`nepoch=1`, each client from its own initial draw (the JAX Trainer's
per-client init, converted through `init_flat`), the elastic net on fc1
only — runs through the JAX package's Trainer and the port's Trainer.
Both draw the same minibatches. The port runs the fused-kernel direction
(`pallas`; on the CPU its kernels' plain versions). The JAX side runs its
`compact` direction: its `pallas` direction runs the Pallas kernels in
interpret mode, 85 s an epoch at N = 890,410 against 35 s on an 8-core
Intel Xeon, and the JAX package holds the two to each other
(`tests/test_ops.py`).

One epoch: the drive's minibatch losses, records and accuracies are those
of the first epoch, and the per-epoch record layout over two epochs is
held against the JAX Trainer's in `tests/test_torch_no_consensus.py`.

Limits. The epoch's per-client losses are held against the JAX Trainer's
to the limit listed in `EPOCH_LIMITS` beside the reading
(`PYTHONPATH=. python tests/test_torch_no_consensus_slice.py` prints
them). It is wide: at N = 890,410 the JAX package's own float32 L-BFGS
step strays up to 1.0e-3 from the same step in float64 (the port's up to
2.4e-4, mostly ~5e-6). Accuracy after the epoch and at the round's end:
within one test sample (the readings are equal).

Per step (`test_each_step_matches_jax_from_the_same_state`): the JAX
package's `lbfgs_step` on its engine's objective (data loss plus its
`_regularizer` on fc1), computed in float64, one client at a time, makes
the trajectory of the first epoch (two steps, the second across a batch
boundary); before each step the port's `client_train_step` gets the same
parameters and optimizer state rounded to float32, and must land within
relative 1e-4 of the JAX step on every coordinate, except the steps listed
in `STEP_LIMITS`, with equal counters. The reference is float64 because
the JAX package's float32 step is further from it than the port's. The
first epoch only: one JAX step of Net1 at N = 890,410 takes ~3 s a client
on an 8-core Intel Xeon.
"""

import numpy as np
import pytest
import torch

from federated_pytorch_test_tpu.data import synthetic_cifar as j_synthetic
from federated_pytorch_test_tpu.engine import Trainer as JTrainer
from federated_pytorch_test_tpu.engine import get_preset as j_preset
from federated_pytorch_test_tpu_torch.convert import flat_from_jax
from federated_pytorch_test_tpu_torch.data import synthetic_cifar
from federated_pytorch_test_tpu_torch.engine import Trainer, get_preset
from federated_pytorch_test_tpu_torch.models import Net1

DRIVE = dict(batch=40, nepoch=1, eval_batch=30)
N_TRAIN, N_TEST = 240, 60
# epoch -> relative limit of the per-client losses against the JAX
# Trainer's; the largest port-vs-JAX reading with 1 and 8 torch threads
# beside it. Whole-run readings carry the JAX package's own float32
# rounding: its step strays up to 1.0e-3 from float64 (see STEP_LIMITS).
EPOCH_LIMITS = {
    0: 3e-2,  # reading 1.8e-2 (client 1, loss 1.23)
}
# (minibatch, client) -> relative limit of the port's step against the JAX
# package's float64 step from the same state; every other step 1e-4.
# Readings with 1 | 8 torch threads beside; the JAX package's own float32
# step from the same state reads 1.2e-5 to 1.0e-3 against its float64 step.
STEP_LIMITS = {
    (0, 0): 4e-4,  # 2.3e-5 | 2.4e-4 (JAX float32: 2.4e-4)
    (1, 0): 2e-4,  # 8.4e-5 | 8.4e-5 (JAX float32: 1.0e-3)
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs files
    in parallel processes, and a thread per core in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainers():
    """Both Trainers, the port's from the JAX per-client init, and that init."""
    jtr = JTrainer(j_preset("no_consensus", lbfgs_direction="compact", **DRIVE), verbose=False,
                   source=j_synthetic(N_TRAIN, N_TEST))
    flat0 = np.array(jtr.flat)  # a copy: the JAX run donates its buffers
    tr = Trainer(get_preset("no_consensus", lbfgs_direction="pallas", **DRIVE), verbose=False,
                 source=synthetic_cifar(N_TRAIN, N_TEST), device="cpu", init_flat=flat_from_jax(flat0, Net1()))
    return jtr, tr, flat0


@pytest.fixture(scope="module")
def runs(trainers):
    jtr, tr, flat0 = trainers
    return jtr.run(), tr.run(), tr, flat0


def _cursor(r):
    return {k: v for k, v in r.items() if k not in ("t", "value")}


def _epoch_losses(rec):
    out = {}
    for r in rec.series["train_loss"]:
        out.setdefault(r["epoch"], []).append(r["value"])
    return {e: np.asarray(v, np.float64) for e, v in out.items()}


def test_slice_writes_the_same_records(runs):
    jrec, rec, tr, flat0 = runs
    for name in ("train_loss", "test_accuracy"):
        assert [_cursor(r) for r in rec.series[name]] == [_cursor(r) for r in jrec.series[name]], name
    # two minibatches; the epoch's record and the round-end record that repeats it
    assert len(rec.series["train_loss"]) == 2 and len(rec.series["test_accuracy"]) == 2
    assert "dual_residual" not in rec.series  # nothing is exchanged
    assert tr.n_params == 890_410 and not np.array_equal(flat0[0], flat0[1])


def test_slice_epoch_losses_match(runs):
    jrec, rec, _, _ = runs
    got, want = _epoch_losses(rec), _epoch_losses(jrec)
    assert sorted(got) == sorted(want) == sorted(EPOCH_LIMITS)
    for e, tol in EPOCH_LIMITS.items():
        np.testing.assert_allclose(got[e], want[e], rtol=tol, atol=0, err_msg=f"epoch {e}")


def test_slice_accuracies_match(runs):
    jrec, rec, _, _ = runs
    got = np.asarray([r["value"] for r in rec.series["test_accuracy"]]) * N_TEST
    want = np.asarray([r["value"] for r in jrec.series["test_accuracy"]]) * N_TEST
    assert np.all(np.abs(got - want) <= 1.0 + 1e-9)


def test_clients_train_apart(runs):
    _, rec, tr, flat0 = runs
    moved = (tr.flat - torch.from_numpy(flat_from_jax(flat0, Net1()))).abs().amax(dim=1)
    assert bool((moved > 0).all())
    for a in range(3):
        for b in range(a):
            assert not torch.equal(tr.flat[a], tr.flat[b])


def _step_by_step(jtr, tr, jflat, with_f32: bool = False):
    """The first epoch step by step from the init `jflat` (JAX order): the
    JAX package's `lbfgs_step` on its engine's objective (data loss plus
    `_regularizer`), in float64, one client at a time, makes the
    trajectory; before each step the port gets the same parameters and
    optimizer state, rounded to float32. Yields
    (minibatch, client, port (x, counters), JAX float64 (x, state), and
    with `with_f32` the JAX package's float32 step from the same rounded
    state, else None)."""
    import jax
    import jax.numpy as jnp
    import optax

    from federated_pytorch_test_tpu.data import normalize as j_normalize
    from federated_pytorch_test_tpu.engine.steps import _regularizer as j_regularizer
    from federated_pytorch_test_tpu.models import Net1 as JNet1
    from federated_pytorch_test_tpu.optim import LBFGSConfig as JConfig
    from federated_pytorch_test_tpu.optim import lbfgs_init as j_lbfgs_init
    from federated_pytorch_test_tpu.optim import lbfgs_step as j_lbfgs_step
    from federated_pytorch_test_tpu.partition import flatten_params as jflatten
    from federated_pytorch_test_tpu_torch.engine.steps import client_train_step
    from federated_pytorch_test_tpu_torch.optim import LBFGSState

    jctx = jtr._ctx(0)
    cfg = tr.cfg
    jcfg = JConfig(max_iter=cfg.lbfgs_max_iter, history_size=cfg.lbfgs_history, line_search=True,
                   batch_mode=True, direction="compact")
    model, k = Net1(), cfg.n_clients
    idx = tr.epoch_indices(0, 0, 0, 0)
    imgs, labels = tr.shard_imgs.numpy(), tr.shard_labels.numpy()
    # the normalized float32 images both sides see
    images = [[np.asarray(j_normalize(imgs[c, idx[s, c]], tr.fed.mean[c], tr.fed.std[c])) for c in range(k)]
              for s in range(idx.shape[0])]

    def make_step(unravel):
        def one_client(x, st, im, lab):
            def loss_fn(v):
                logits = JNet1().apply({"params": unravel(v)}, im)
                return optax.softmax_cross_entropy_with_integer_labels(logits, lab).mean() + j_regularizer(jctx, v, v)

            return j_lbfgs_step(loss_fn, x, st, jcfg)[:2]

        return jax.jit(one_client)

    def to_port(st):
        vecs = ("s_hist", "y_hist", "d", "prev_grad", "running_avg", "running_avg_sq")
        return {f: torch.from_numpy(flat_from_jax(np.asarray(v, np.float32), model)) if f in vecs
                else torch.from_numpy(np.array(v, np.float32 if np.asarray(v).dtype.kind == "f" else np.int32))
                for f, v in st._asdict().items()}

    def rounded(tree):
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a).astype(np.float32 if a.dtype.kind == "f" else a.dtype)),
                            tree)

    jax.config.update("jax_enable_x64", True)
    try:
        params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jtr.unravel(jnp.asarray(jflat[0])))
        step64 = make_step(jflatten(params64)[1])
        xs = [jnp.asarray(jflat[c], jnp.float64) for c in range(k)]
        sts = [j_lbfgs_init(x, jcfg) for x in xs]
        for s in range(idx.shape[0]):
            outs = [step64(xs[c], sts[c], jnp.asarray(images[s][c], jnp.float64), labels[c, idx[s, c]])
                    for c in range(k)]
            if with_f32:
                jax.config.update("jax_enable_x64", False)
                step32 = make_step(jtr.unravel)
                outs32 = [step32(*rounded((xs[c], sts[c])), images[s][c], labels[c, idx[s, c]]) for c in range(k)]
                jax.config.update("jax_enable_x64", True)
            parts = [to_port(st) for st in sts]
            state = LBFGSState(**{f: torch.stack([p[f] for p in parts]) for f in parts[0]})
            flat_p = torch.from_numpy(np.stack([flat_from_jax(np.asarray(x, np.float32), model) for x in xs]))
            rows = np.arange(k)[:, None]
            flat_p, st_p, _, _ = client_train_step(
                tr.ctx(0), flat_p, state, {}, torch.from_numpy(imgs[rows, idx[s]]),
                torch.from_numpy(labels[rows, idx[s]]), tr.mean, tr.std,
            )
            for c in range(k):
                x_j, st_j = outs[c]
                counters = {f: int(getattr(st_p, f)[c]) for f in ("n_iter", "func_evals", "ls_evals", "hist_count")}
                f32 = flat_from_jax(np.asarray(outs32[c][0]), model) if with_f32 else None
                yield s, c, (flat_p[c].numpy(), counters), (flat_from_jax(np.asarray(x_j), model), st_j), f32
            xs = [o[0] for o in outs]
            sts = [o[1] for o in outs]
    finally:
        jax.config.update("jax_enable_x64", False)


def test_each_step_matches_jax_from_the_same_state(trainers):
    n = 0
    for s, c, (x_p, counters), (x_j, st_j), _ in _step_by_step(*trainers):
        err = float(np.abs(x_p - x_j).max() / np.abs(x_j).max())
        where = f"step (minibatch {s}) client {c}"
        assert err <= STEP_LIMITS.get((s, c), 1e-4), f"{where}: relative {err:.3e}"
        for f, v in counters.items():
            assert v == int(np.asarray(getattr(st_j, f))), f"{where}: {f}"
        n += 1
    assert n == 2 * 3


if __name__ == "__main__":
    # the port-vs-JAX readings behind EPOCH_LIMITS and the per-step limit
    for threads in (1, 8):
        torch.set_num_threads(threads)
        both = trainers.__wrapped__()
        jrec, rec, _, _ = runs.__wrapped__(both)
        got, want = _epoch_losses(rec), _epoch_losses(jrec)
        for e in sorted(got):
            rel = np.abs(got[e] - want[e]) / np.maximum(np.abs(want[e]), 1e-30)
            print(f"threads={threads} epoch {e} max_rel={rel.max():.3e} losses port={got[e].tolist()} "
                  f"jax={want[e].tolist()}")
        accs = [(r["value"], q["value"]) for r, q in zip(rec.series["test_accuracy"], jrec.series["test_accuracy"])]
        print(f"threads={threads} accuracies port,jax={accs}")
        for s, c, (x_p, counters), (x_j, st_j), x_32 in _step_by_step(*both, with_f32=True):
            scale = np.abs(x_j).max()
            print(f"threads={threads} step {s} client {c} port_vs_jax_f64={np.abs(x_p - x_j).max() / scale:.3e} "
                  f"jax_f32_vs_jax_f64={np.abs(x_32 - x_j).max() / scale:.3e} port_vs_jax_f32="
                  f"{np.abs(x_p - x_32).max() / scale:.3e} counters={counters}")
