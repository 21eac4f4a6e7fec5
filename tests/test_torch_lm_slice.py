"""Port parity for the LM slice: federated TransformerLM training end to end.

Both packages run the JAX package's `examples/federated_lm.py` recipe at a
small size — K=2 clients, vocab 32, dim 32, 2 heads, sequences of 128
tokens, batch 2, 2 lockstep minibatches, one outer loop over the first two
groups of `TRAIN_ORDER` (group 0, the embeddings, backpropagates through
every attention layer; group 1 is the first block) — from the same
parameters (the JAX init, converted) on the same client-biased Markov
corpus. The JAX side is built from `TransformerLM`, `lbfgs_step` and
`fedavg_round` as the example builds it, with the clients `vmap`ped on one
device and 'dense' attention (its flash kernels in interpret mode cost
~16 s per compiled step here). The port runs 'flash', which on CPU tensors
is the kernels' plain PyTorch versions, so no kernel is launched.

Tolerance: each round's per-minibatch losses and its dual residual within
relative 1e-3 (the readings, printed by
`PYTHONPATH=. python tests/test_torch_lm_slice.py`, are listed in
`LIMITS`); per-client accuracy within one token in 2·2·128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from federated_pytorch_test_tpu.consensus import FedAvgState as JFedAvgState
from federated_pytorch_test_tpu.consensus import fedavg_round as j_fedavg_round
from federated_pytorch_test_tpu.models import TransformerLM as JLM
from federated_pytorch_test_tpu.models import init_client_params as j_init_client_params
from federated_pytorch_test_tpu.optim import LBFGSConfig as JConfig
from federated_pytorch_test_tpu.optim import lbfgs_init as j_lbfgs_init
from federated_pytorch_test_tpu.optim import lbfgs_step as j_lbfgs_step
from federated_pytorch_test_tpu.parallel import CLIENT_AXIS, shard_map
from federated_pytorch_test_tpu.partition import flatten_params as jflatten
from federated_pytorch_test_tpu_torch.convert import flat_from_jax
from federated_pytorch_test_tpu_torch.federated_lm import FederatedLM, LMConfig, make_corpus
from federated_pytorch_test_tpu_torch.ops import compact_cuda, flash_cuda

CFG = LMConfig(k=2, vocab=32, dim=32, num_heads=2, seq=128, batch=2, n_batch=2, nloop=1, max_groups=2,
               attn_impl="flash", device="cpu")
# (group) -> (train-loss limit, dual-residual limit), relative; readings
# are the port-vs-JAX maxima on this drive
LIMITS = {
    0: (1e-3, 1e-3),  # readings: loss 6.3e-7, dual 7.8e-7
    1: (1e-3, 1e-3),  # loss 7.8e-7, dual 9.4e-8
}


def _jax_run(train, test):
    """The example's loop on the JAX package; returns (flat0, losses, duals, accs) per round."""
    k = CFG.k
    jlm = JLM(vocab=CFG.vocab, dim=CFG.dim, num_heads=CFG.num_heads, max_len=CFG.seq, attn_impl="dense")
    params0 = jax.tree.map(lambda x: x[0], j_init_client_params(jlm, k, seed=CFG.seed)["params"])
    flat0, unravel = jflatten(params0)
    part = JLM.partition(params0)
    jcfg = JConfig(max_iter=4, history_size=10, line_search=True, batch_mode=True)
    mesh = Mesh(np.asarray(jax.devices()[:1]), (CLIENT_AXIS,))  # every client on one device

    def ce(full_flat, toks):
        logits = jlm.apply({"params": unravel(full_flat)}, toks[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), toks[:, 1:]).mean()

    def make_round(gid):
        def client_epoch(flat_c, batches):
            seg0 = part.extract(flat_c, gid)

            def one_batch(carry, toks):
                seg, state = carry

                def loss(v):
                    return ce(part.insert(flat_c, gid, v), toks)

                seg, state, _ = j_lbfgs_step(loss, seg, state, jcfg)
                return (seg, state), loss(seg)

            (seg, _), losses = jax.lax.scan(one_batch, (seg0, j_lbfgs_init(seg0, jcfg)), batches)
            return part.insert(flat_c, gid, seg), losses

        def round_fn(flat_loc, batches_loc, z):
            flat_loc, losses = jax.vmap(client_epoch)(flat_loc, batches_loc)
            x = jax.vmap(lambda f: part.extract(f, gid))(flat_loc)
            state, metrics = j_fedavg_round(x, JFedAvgState(z=z))
            flat_loc = jax.vmap(lambda f: part.insert(f, gid, state.z))(flat_loc)
            return flat_loc, losses, metrics["dual_residual"]

        return jax.jit(shard_map(round_fn, mesh=mesh, in_specs=(P(CLIENT_AXIS), P(CLIENT_AXIS), P()),
                                 out_specs=(P(CLIENT_AXIS), P(CLIENT_AXIS), P()), check_vma=False))

    @jax.jit
    def evaluate(flat, toks):
        def client_acc(flat_c, toks_c):
            pred = jnp.argmax(jlm.apply({"params": unravel(flat_c)}, toks_c[:, :-1]), axis=-1)
            return jnp.mean((pred == toks_c[:, 1:]).astype(jnp.float32))

        return jax.vmap(client_acc)(flat, toks)

    flat = jnp.broadcast_to(flat0[None], (k, flat0.shape[0])).astype(jnp.float32)
    train_d, test_d = jnp.asarray(train, jnp.int32), jnp.asarray(test, jnp.int32)
    out = {}
    for gid in list(part.train_order)[: CFG.max_groups]:
        z0 = jnp.zeros((part.group_size(gid),), jnp.float32)
        flat, losses, dual = make_round(gid)(flat, train_d, z0)
        out[gid] = (np.asarray(losses).T, float(dual), np.asarray(evaluate(flat, test_d)))  # losses [n_batch, K]
    return np.asarray(flat0), out


@pytest.fixture(scope="module")
def runs():
    train, test = make_corpus(CFG)
    flat0, jout = _jax_run(train, test)
    compact_cuda.reset_launch_counts()
    flash_cuda.reset_launch_counts()
    lm = FederatedLM(CFG, verbose=False, init_flat=flat_from_jax(flat0, _port_model()))
    rec = lm.run()
    launches = {**compact_cuda.LAUNCHES, **flash_cuda.LAUNCHES}
    port = {}
    for gid in lm.group_order:
        losses = np.asarray([r["value"] for r in rec.series["train_loss"] if r["group"] == gid])
        (dual,) = [r["value"] for r in rec.series["dual_residual"] if r["group"] == gid]
        (accs,) = [r["value"] for r in rec.series["test_accuracy"] if r["group"] == gid]
        port[gid] = (losses, dual, np.asarray(accs))
    return jout, port, launches


def _port_model():
    from federated_pytorch_test_tpu_torch.models import TransformerLM

    return TransformerLM(vocab=CFG.vocab, dim=CFG.dim, num_heads=CFG.num_heads, max_len=CFG.seq)


def test_corpus_is_the_examples():
    # the example's own `markov_corpus` (its module constants VOCAB=32,
    # SEQ=32) against the port's copy, from the same generator state
    import importlib.util
    import pathlib

    from federated_pytorch_test_tpu_torch.federated_lm import markov_corpus

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "federated_lm.py"
    spec = importlib.util.spec_from_file_location("federated_lm_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)  # defines functions only: main() runs under __main__
    for client in range(3):
        want = example.markov_corpus(client, 5, np.random.default_rng(client))
        got = markov_corpus(client, 5, example.SEQ, example.VOCAB, np.random.default_rng(client))
        np.testing.assert_array_equal(got, want)
    train, test = make_corpus(CFG)
    assert train.shape == (2, 2, 2, 129) and test.shape == (2, 4, 129)


def test_rounds_visit_the_same_groups(runs):
    jout, port, _ = runs
    assert sorted(port) == sorted(jout) == [0, 1]
    for gid in port:
        assert port[gid][0].shape == jout[gid][0].shape == (CFG.n_batch, CFG.k)


def test_losses_match(runs):
    jout, port, _ = runs
    for gid, (tol, _) in LIMITS.items():
        np.testing.assert_allclose(port[gid][0], jout[gid][0], rtol=tol, atol=0, err_msg=f"group {gid}")


def test_dual_residuals_match(runs):
    jout, port, _ = runs
    for gid, (_, tol) in LIMITS.items():
        np.testing.assert_allclose(port[gid][1], jout[gid][1], rtol=tol, atol=0, err_msg=f"group {gid}")


def test_accuracies_match(runs):
    jout, port, _ = runs
    n_tok = 2 * CFG.batch * CFG.seq
    for gid in port:
        assert np.all(np.abs(port[gid][2] - jout[gid][2]) * n_tok <= 1.0 + 1e-6), gid


def test_cpu_lm_path_launches_no_kernel(runs):
    _, _, launches = runs
    assert launches and all(n == 0 for n in launches.values()), launches


if __name__ == "__main__":
    # the port-vs-JAX readings behind LIMITS, round by round
    jout, port, _ = runs.__wrapped__()
    for gid in port:
        lj, dj, _ = jout[gid]
        lp, dp, _ = port[gid]
        print(f"group={gid} loss max_rel={np.max(np.abs(lp - lj) / np.abs(lj)):.3e} "
              f"dual rel={abs(dp - dj) / abs(dj):.3e}")
