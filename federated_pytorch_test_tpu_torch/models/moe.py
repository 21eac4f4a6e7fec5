"""Switch-style top-1 mixture-of-experts MLP, batched over the K clients.

Counterpart of the JAX package's `models/moe.py` (`MoEMLP`), for one card:
the expert-parallel sharding helpers there (`parallel/expert.py`) are not
ported. Per client, as there:

* the gate is a dense layer to E logits; softmax, then the expert is the
  argmax of the probabilities (the first maximum, as `jnp.argmax`) and the
  gate weight its probability;
* a token's slot is its position among the tokens routed to the same
  expert, counted in (batch, sequence)-flattened order; capacity
  C = ceil(T / E · capacity_factor) for the T tokens of the call, and a
  token at slot >= C is dropped (its output is 0: it rides the block's
  residual);
* the experts' MLPs are two grouped GEMMs (`ops/grouped_gemm.py`,
  the hand-written kernel on the card), `[K·E, C, D] x [K·E, D, H]`, the
  tanh GELU, then `[K·E, C, H] x [K·E, H, D]`, each plus its bias;
* the load-balance term is E · Σ_e frac_e · mean_prob_e per client.

Under a bf16 compute dtype the dtypes follow the JAX `MoEMLP` step by
step: the gate, its softmax and the load-balance term in f32 from the f32
view of the input; the dispatched slots, the expert weights and biases,
both grouped products (the bf16 kernel, f32 accumulation) and the GELU in
bf16; the combine in f32 from the f32 view of the expert outputs, its
result cast to bf16. Parameters are kept in f32; the engine hands the
model their bf16 cast (as the JAX step does), so the gate takes the f32
view of its bf16 weights, as the JAX gate's f32 `nn.Dense` does.

The JAX package dispatches with dense one-hot einsums over `[T, E, C]`;
at the ViT path's width that mask is 2.1e10 floats a client. Here tokens
move by index instead, which gives the same numbers: each kept slot
receives exactly one token at weight 1 and every other einsum term is an
exact zero. Both moves are gathers whose backward scatters onto distinct
rows (every slot is written once; each token row is read at most once),
so the gradients are deterministic. Empty slots read a zero row; dropped
tokens read a zero row of the expert outputs. Those two pad rows are the
only rows that gather many terms in the backward, and their gradient is
thrown away.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grouped_gemm import grouped_matmul
from .base import EXPERT_BIAS, EXPERT_WEIGHT, widen_clients


class MoEMLP(nn.Module):
    """Top-1 switch MoE over `n_experts` MLPs of width `mlp_ratio · dim`.

    Parameters as the JAX package names and lays them out: the Dense `gate`
    and the bare stacked leaves `w1 [E, D, H]`, `b1 [E, H]`, `w2 [E, H, D]`,
    `b2 [E, D]`.
    """

    LEAF_KINDS = {"w1": EXPERT_WEIGHT, "w2": EXPERT_WEIGHT, "b1": EXPERT_BIAS, "b2": EXPERT_BIAS}

    def __init__(self, dim: int, n_experts: int, mlp_ratio: int = 4, capacity_factor: float = 1.25,
                 dtype=torch.float32):
        super().__init__()
        if n_experts < 1:
            raise ValueError(f"n_experts must be >= 1, got {n_experts}")
        self.dtype = dtype  # the experts' compute dtype
        self.dim, self.n_experts, self.hidden = dim, n_experts, mlp_ratio * dim
        self.capacity_factor = capacity_factor
        self.gate = nn.Linear(dim, n_experts)
        self.w1 = nn.Parameter(torch.zeros(n_experts, dim, self.hidden))
        self.b1 = nn.Parameter(torch.zeros(n_experts, self.hidden))
        self.w2 = nn.Parameter(torch.zeros(n_experts, self.hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(n_experts, dim))

    def capacity(self, tokens: int) -> int:
        """Slots per expert for a call of `tokens` tokens a client (the JAX expression)."""
        return max(1, int(math.ceil(tokens / self.n_experts * self.capacity_factor)))

    def route(self, params: Dict[str, torch.Tensor], prefix: str, y: torch.Tensor):
        """Routing of `y [K, T, D]`: (probs `[K, T, E]`, expert `[K, T]`,
        gate weight `[K, T]`, slot `[K, T]`, keep `[K, T]`), in f32 whatever
        the dtype of the gate's parameters (bf16 from the engine under a
        bf16 compute dtype)."""
        gw, gb = params[f"{prefix}.gate.weight"].float(), params[f"{prefix}.gate.bias"].float()
        probs = torch.softmax(torch.baddbmm(gb[:, None, :], y, gw.transpose(1, 2)), dim=-1)
        expert = probs.argmax(dim=-1)
        gate = probs.gather(-1, expert[..., None])[..., 0]
        # counted along the tokens as the innermost axis of [K, E, T]: a scan
        # along an outer axis gives each of the K·E columns a single thread
        member = expert[:, None, :] == torch.arange(self.n_experts, device=y.device)[None, :, None]
        slot = member.to(torch.int32).cumsum(dim=2, dtype=torch.int32).gather(1, expert[:, None, :])[:, 0] - 1
        return probs, expert, gate, slot, slot < self.capacity(y.shape[1])

    def forward_batched(self, params: Dict[str, torch.Tensor], prefix: str, y: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`y [K, T, D]` -> (output `[K, T, D]`, load-balance term `[K]`).

        Under a probe fan (`models/base.py`) a P-wide `y` meets frozen
        parameters repeated P times: the capacity counts one (client,
        probe)'s tokens, as for each probe alone."""
        names = [f"{prefix}.{n}" for n in ("gate.weight", "gate.bias", "w1", "b1", "w2", "b2")]
        kw = params[names[0]].shape[0]
        y = widen_clients(y, kw)
        if y.shape[0] > kw:
            params = {**params, **{n: widen_clients(params[n], y.shape[0]) for n in names}}
        k, t, d = y.shape
        e, h, dt = self.n_experts, self.hidden, self.dtype
        cap = self.capacity(t)
        probs, expert, gate, slot, keep = self.route(params, prefix, y.float())
        n_slots = k * e * cap
        clients = torch.arange(k, device=y.device)[:, None]
        tokens = torch.arange(k * t, device=y.device)
        row = ((clients * e + expert) * cap + slot).reshape(-1)  # each token's slot in [K·E·C]
        kept = keep.reshape(-1)

        # dispatch: slot -> its token's row of y; empty slots read the zero row k·t.
        # Dropped tokens write past the slots, each to a position of its own.
        src = torch.full((n_slots + k * t,), k * t, dtype=torch.long, device=y.device)
        src.scatter_(0, torch.where(kept, row, n_slots + tokens), tokens)
        # (each slot takes one token, so the slots in the compute dtype are exact)
        y_pad = torch.cat([y.reshape(k * t, d), y.new_zeros(1, d)]).to(dt)
        x_e = y_pad.index_select(0, src[:n_slots]).view(k * e, cap, d)

        w1 = params[f"{prefix}.w1"].reshape(k * e, d, h).to(dt)
        w2 = params[f"{prefix}.w2"].reshape(k * e, h, d).to(dt)
        hid = grouped_matmul(x_e, w1) + params[f"{prefix}.b1"].reshape(k * e, 1, h).to(dt)
        hid = F.gelu(hid, approximate="tanh")
        out_e = grouped_matmul(hid, w2) + params[f"{prefix}.b2"].reshape(k * e, 1, d).to(dt)

        # combine in f32: token -> its slot's output x gate; dropped tokens read the zero row
        out_pad = torch.cat([out_e.reshape(n_slots, d), out_e.new_zeros(1, d)]).float()
        out = out_pad.index_select(0, torch.where(kept, row, n_slots)).view(k, t, d)
        out = (out * (gate * keep)[..., None]).to(dt)

        frac = F.one_hot(expert, e).float().mean(dim=1)  # [K, E]
        aux = e * (frac * probs.mean(dim=1)).sum(dim=-1)
        return out, aux
