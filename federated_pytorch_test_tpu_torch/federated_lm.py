"""Federated causal-LM training: K `TransformerLM` clients on one card.

Counterpart of the JAX package's `examples/federated_lm.py`: the fedavg
recipe of the CNN experiment — common init, per-group stochastic L-BFGS
epochs, a FedAvg exchange of the active group, per-client evaluation —
on `TransformerLM` clients over client-biased token streams:

- each client's corpus is a Markov chain sharing a dominant transition
  (i -> i+1, 85%) with a client-biased minor one (i -> i+2+c, 15%), drawn
  with the example's numpy recipe from `np.random.default_rng(seed)`, so
  both packages train on the same tokens;
- the partition groups are the LM's own (embeddings, each block, head),
  visited in `TRAIN_ORDER`; each round runs one epoch of lockstep
  minibatches, every client's L-BFGS step on the active group's
  coordinates (a fresh optimizer per round), then one FedAvg round from
  z = 0, whose averaged group is identical in every client afterwards;
- after each round every client's next-token accuracy is measured on its
  own held-out sequences.

The K clients are the leading axis of one `[K, N]` parameter tensor, as
in the CNN engine; their sequences share the attention's batch axis.

    python -m federated_pytorch_test_tpu_torch.federated_lm [--device cpu] [--k 4] \\
        [--seq 2048] [--nloop 1] [--attn-impl flash]

Runs on the card unless `--device cpu` is given. At the defaults (K=4,
the `TransformerLM` class defaults: vocab 256, dim 64, 4 heads, 2048
positions, sequences of 2048 tokens, batch 8, 4 minibatches per epoch)
the attention runs through the causal flash kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .engine.steps import GroupContext, _group_params, fedavg_consensus, round_init
from .models import TransformerLM, init_client_params
from .optim import LBFGSConfig, lbfgs_step
from .partition import unflatten_params
from .utils import MetricsRecorder, resolve_device


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The example's settings; the model is `TransformerLM` at its defaults."""

    k: int = 4  # clients
    vocab: int = 256
    dim: int = 64
    num_heads: int = 4
    seq: int = 2048  # tokens per training sequence (and max_len)
    batch: int = 8
    n_batch: int = 4  # lockstep minibatches per epoch
    nloop: int = 1
    attn_impl: str = "flash"
    seed: int = 0
    max_groups: Optional[int] = None  # train only the first N groups of TRAIN_ORDER
    device: str = "cuda"

    def lbfgs_config(self) -> LBFGSConfig:
        return LBFGSConfig(max_iter=4, history_size=10, line_search=True, batch_mode=True)


def markov_corpus(client: int, n_seq: int, seq: int, vocab: int, rng: np.random.Generator) -> np.ndarray:
    """Client-biased Markov chains `[n_seq, seq + 1]`: 85% i->i+1 (shared), 15% i->i+2+c."""
    minor = (2 + client) % vocab
    seqs = np.empty((n_seq, seq + 1), np.int64)
    for j in range(n_seq):
        tok = rng.integers(0, vocab)
        for t in range(seq + 1):
            seqs[j, t] = tok
            step = 1 if rng.random() < 0.85 else minor
            tok = (tok + step) % vocab
    return seqs


def make_corpus(cfg: LMConfig):
    """(train `[K, n_batch, batch, seq+1]`, test `[K, 2·batch, seq+1]`) int64, the example's draw order."""
    rng = np.random.default_rng(cfg.seed)
    train = np.stack([markov_corpus(c, cfg.n_batch * cfg.batch, cfg.seq, cfg.vocab, rng) for c in range(cfg.k)])
    test = np.stack([markov_corpus(c, 2 * cfg.batch, cfg.seq, cfg.vocab, rng) for c in range(cfg.k)])
    return train.reshape(cfg.k, cfg.n_batch, cfg.batch, cfg.seq + 1), test


def lm_loss(model: TransformerLM, params: dict, toks: torch.Tensor) -> torch.Tensor:
    """Per-client mean next-token cross-entropy `[K]` of `toks [K, B, S+1]`."""
    logits = model.forward_batched(params, toks[..., :-1])
    k, b, s, v = logits.shape
    ce = F.cross_entropy(logits.reshape(-1, v), toks[..., 1:].reshape(-1), reduction="none")
    return ce.reshape(k, b * s).mean(dim=1)


def lm_train_step(ctx: GroupContext, flat: torch.Tensor, lstate, toks: torch.Tensor):
    """One L-BFGS step of all K clients on group `ctx.gid`; `flat` is updated
    in place. Returns (flat, lstate, per-client loss at the new parameters).

    The loss is the accepted line-search evaluation's (the engine's fold);
    only where the NaN-step fallback left the new point unevaluated is it
    evaluated afresh, as the example evaluates every step's end point (one
    more batched pass without a gradient, counted in `value_passes`).
    """
    base = flat.detach()

    def objective(x):
        loss = lm_loss(ctx.model, _group_params(ctx, base, x), toks)
        return loss, (loss,)

    x0 = ctx.partition.extract(flat, ctx.gid).contiguous()
    x1, lstate, aux = lbfgs_step(objective, x0, lstate, ctx.lbfgs, has_aux=True)
    ctx.partition.insert_(flat, ctx.gid, x1)
    (loss,) = aux.aux
    if not bool(torch.all(aux.aux_ok)):
        with torch.no_grad():
            loss = torch.where(aux.aux_ok, loss, objective(x1)[0])
        lstate = lstate._replace(value_passes=lstate.value_passes + 1)
    return flat, lstate, loss


def run_epoch(ctx: GroupContext, flat: torch.Tensor, lstate, train: torch.Tensor):
    """The lockstep minibatches of `train [K, n_batch, B, S+1]`: (flat, lstate, losses [n_batch, K])."""
    losses = []
    for s in range(train.shape[1]):
        flat, lstate, loss = lm_train_step(ctx, flat, lstate, train[:, s])
        losses.append(loss)
    return flat, lstate, torch.stack(losses)


@torch.no_grad()
def next_token_accuracy(model: TransformerLM, shapes: dict, flat: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """Per-client next-token accuracy `[K]` on `test [K, B, S+1]`."""
    logits = model.forward_batched(unflatten_params(flat, shapes), test[..., :-1])
    return (logits.argmax(dim=-1) == test[..., 1:]).float().mean(dim=(1, 2))


class FederatedLM:
    """All device state of one federated-LM run, and the loop over it."""

    def __init__(self, cfg: LMConfig, verbose: bool = True, init_flat: Optional[np.ndarray] = None):
        """`init_flat` (`[N]` or `[K, N]`, this package's flat order) replaces
        the common-seed init, e.g. with parameters converted from the JAX
        package (`convert.py`)."""
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.verbose = verbose
        self.recorder = MetricsRecorder(verbose=False)
        self.model = TransformerLM(vocab=cfg.vocab, dim=cfg.dim, num_heads=cfg.num_heads, max_len=cfg.seq,
                                   attn_impl=cfg.attn_impl).to(self.device)
        self.model.requires_grad_(False)  # parameters live in `self.flat`
        self.shapes = self.model.shapes()
        self.partition = self.model.partition()
        order = list(self.partition.train_order)
        self.group_order = order[: cfg.max_groups] if cfg.max_groups is not None else order
        if init_flat is None:
            self.flat = init_client_params(self.model, cfg.k, cfg.seed, self.device)
        else:
            f = torch.as_tensor(np.asarray(init_flat, np.float32))
            self.flat = f.expand(cfg.k, -1).contiguous().to(self.device)
        train, test = make_corpus(cfg)
        self.train = torch.from_numpy(train).to(self.device)
        self.test = torch.from_numpy(test).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ctx(self, gid: int) -> GroupContext:
        return GroupContext(model=self.model, shapes=self.shapes, partition=self.partition, gid=gid,
                            lbfgs=self.cfg.lbfgs_config(), reg_on_active=False)

    def evaluate(self) -> np.ndarray:
        return next_token_accuracy(self.model, self.shapes, self.flat, self.test).cpu().numpy()

    def run_round(self, nloop: int, gid: int) -> None:
        """One group's round: an epoch of L-BFGS steps, a FedAvg round, an eval."""
        rec, ctx = self.recorder, self.ctx(gid)
        t0 = time.perf_counter()
        lstate, cstate = round_init(ctx, self.flat)  # a fresh optimizer, z = 0
        with rec.phase("epoch", sync=self._sync, nloop=nloop, group=gid, nadmm=0, epoch=0):
            self.flat, lstate, losses = run_epoch(ctx, self.flat, lstate, self.train)
            losses = losses.cpu().numpy()
        for s in range(losses.shape[0]):
            rec.batch_losses(losses[s], nloop=nloop, group=gid, nadmm=0, epoch=0, minibatch=s)
        rec.objective_passes(lstate, nloop=nloop, group=gid)
        with rec.phase("consensus", sync=self._sync, nloop=nloop, group=gid, nadmm=0):
            self.flat, _, dual = fedavg_consensus(ctx, self.flat, cstate)
            dual = float(dual)
            xg = self.partition.extract(self.flat, gid)
            if not bool(torch.equal(xg, xg[:1].expand_as(xg))):
                raise RuntimeError(f"group {gid} differs across clients after the averaging round")
        rec.residuals(None, dual, nloop=nloop, group=gid, nadmm=0, group_size=self.partition.group_size(gid))
        with rec.phase("eval", sync=self._sync, nloop=nloop, group=gid, nadmm=0):
            accs = self.evaluate()
        rec.accuracies(accs, nloop=nloop, group=gid, nadmm=0)
        rec.step_time("round", time.perf_counter() - t0, nloop=nloop, group=gid)
        if self.verbose:
            print(f"nloop {nloop} group {gid}: loss {np.mean(losses[-1]):.4f} dual {dual:.3e} "
                  f"acc {accs.round(3)}", flush=True)

    def run(self) -> MetricsRecorder:
        for nloop in range(self.cfg.nloop):
            for gid in self.group_order:
                self.run_round(nloop, gid)
        return self.recorder


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m federated_pytorch_test_tpu_torch.federated_lm",
                                description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:N' or 'cpu'")
    p.add_argument("--k", type=int, default=LMConfig.k, help="clients")
    p.add_argument("--seq", type=int, default=LMConfig.seq, help="tokens per sequence")
    p.add_argument("--nloop", type=int, default=LMConfig.nloop)
    p.add_argument("--attn-impl", default=LMConfig.attn_impl, choices=["dense", "flash", "auto"])
    p.add_argument("--metrics-out", help="write the metric series as JSON here")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = LMConfig(k=args.k, seq=args.seq, nloop=args.nloop, attn_impl=args.attn_impl, device=args.device)
    lm = FederatedLM(cfg)
    print(f"{cfg.k} LM clients on {lm.device}: {lm.partition.total} params in {lm.partition.num_groups} "
          f"groups {[lm.partition.group_size(g) for g in range(lm.partition.num_groups)]}; "
          f"chance accuracy = {1 / cfg.vocab:.3f}", flush=True)
    rec = lm.run()
    if args.metrics_out:
        rec.save(args.metrics_out)
    accs = lm.evaluate()
    print(f"final per-client next-token accuracy: {accs.round(3)}", flush=True)
    if rec.first_nonfinite is not None or not accs.mean() > 5.0 / cfg.vocab:
        print(f"federated LM failed to learn: accuracy {accs}, first non-finite {rec.first_nonfinite}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
