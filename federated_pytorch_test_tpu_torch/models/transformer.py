"""The causal decoder LM (`TransformerLM`) with partition metadata.

Counterpart of the JAX package's `models/transformer.py` (`TransformerLM`,
its `Block` and `MultiHeadAttention`): token embedding + learned
positions, four pre-norm causal blocks, a final LayerNorm and a separate
head, with the same parameter tree, partition groups and train order.
Flax defaults kept: LayerNorm ε = 1e-6, the tanh-approximate GELU, and
the fused qkv projection's head-major column order (`[h0(q,k,v), h1(q,k,v),
…]`, read as `reshape(b, s, h, 3, hd)`). The attention core runs in f32.

Attention is `'dense'` (`ops/attention.py`), `'flash'` (the causal flash
kernels, `ops/flash_cuda.py`) or `'auto'` (flash from S = 2048 where S is a
multiple of 128, the JAX package's crossover at its 'highest' precision,
which is the only precision the port has). The ring variants and the MoE
MLP need paths the port does not have yet, and raise.

As in `models/simple.py`, the modules only hold shapes and kinds: the
engine keeps every client's parameters in one flat `[K, N]` tensor and
`forward_batched` runs the K clients at once — their tokens stack along
the batch axis of the attention, and each projection is one `bmm` over K.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dense_attention
from ..ops.flash_cuda import BLOCK, flash_attention
from .base import PartitionedModel

LN_EPS = 1e-6  # flax.linen.LayerNorm's default
ATTN_IMPLS = ("dense", "flash", "auto")
AUTO_FLASH_FROM = 2048  # the JAX package's 'auto' crossover at 'highest' precision


def resolve_attn_impl(impl: str, seq: int) -> str:
    """`'dense'` or `'flash'` for a sequence of length `seq`."""
    if impl in ("ring", "ring_flash"):
        raise NotImplementedError(f"attn_impl={impl!r} needs the multi-GPU path, which is not ported yet")
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {impl!r}")
    if impl == "auto":
        return "flash" if seq >= AUTO_FLASH_FROM and seq % BLOCK == 0 else "dense"
    return impl


def _linear(params, name, x):
    """Per-client dense layer: x `[K, M, in]` -> `[K, M, out]`."""
    return torch.baddbmm(params[f"{name}.bias"][:, None, :], x, params[f"{name}.weight"].transpose(1, 2))


def _layer_norm(params, name, x):
    """Per-client LayerNorm over the last axis of `x [K, M, dim]`."""
    y = F.layer_norm(x, x.shape[-1:], eps=LN_EPS)
    return y * params[f"{name}.weight"][:, None, :] + params[f"{name}.bias"][:, None, :]


class MultiHeadAttention(nn.Module):
    """Fused qkv projection + causal attention core + output projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward_batched(self, params, prefix: str, x: torch.Tensor, impl: str) -> torch.Tensor:
        """x `[K, B, S, dim]` -> `[K, B, S, dim]`; every client attends causally."""
        k, b, s, dim = x.shape
        h = self.num_heads
        qkv = _linear(params, f"{prefix}.qkv", x.reshape(k, b * s, dim))
        qkv = qkv.reshape(k * b, s, h, 3, dim // h).float()  # head-major
        q, kk, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        if impl == "flash":
            out = flash_attention(q, kk, v, causal=True)
        else:
            out = dense_attention(q, kk, v, causal=True)
        return _linear(params, f"{prefix}.proj", out.reshape(k, b * s, dim)).reshape(k, b, s, dim)


class Block(nn.Module):
    """Pre-norm block: LN -> MHA -> +res; LN -> MLP (GELU, tanh) -> +res."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, mlp_ratio * dim)
        self.fc2 = nn.Linear(mlp_ratio * dim, dim)

    def forward_batched(self, params, prefix: str, x: torch.Tensor, impl: str) -> torch.Tensor:
        k, b, s, dim = x.shape
        y = _layer_norm(params, f"{prefix}.ln1", x.reshape(k, b * s, dim)).reshape(k, b, s, dim)
        x = x + self.attn.forward_batched(params, f"{prefix}.attn", y, impl)
        y = _layer_norm(params, f"{prefix}.ln2", x.reshape(k, b * s, dim))
        y = F.gelu(_linear(params, f"{prefix}.fc1", y), approximate="tanh")
        return x + _linear(params, f"{prefix}.fc2", y).reshape(k, b, s, dim)


class TransformerLM(PartitionedModel):
    """Causal decoder LM over int token ids (the JAX package's defaults).

    Partition groups: 0 = token embedding + positions, 1..4 = the blocks
    (the last one also carries the pre-head LayerNorm), 5 = the head alone
    (the only group that takes the elastic net).
    """

    GROUP_PATHS = (
        (("embed",), ("pos_embed",)),
        (("block0",),),
        (("block1",),),
        (("block2",),),
        (("block3",), ("ln_out",)),
        (("head",),),
    )
    LINEAR_GROUP_IDS = (5,)
    TRAIN_ORDER = (0, 1, 2, 3, 4, 5)
    DEPTH = 4  # pinned by the four block groups above

    def __init__(self, vocab: int = 256, dim: int = 64, num_heads: int = 4, max_len: int = 2048,
                 attn_impl: str = "dense", moe_experts: int = 0):
        super().__init__()
        if moe_experts:
            raise NotImplementedError("moe_experts > 0 is not ported yet (the MoE MLP has no path here)")
        resolve_attn_impl(attn_impl, max_len)  # reject unknown or unported values early
        self.vocab, self.dim, self.num_heads, self.max_len = vocab, dim, num_heads, max_len
        self.attn_impl = attn_impl
        self.embed = nn.Embedding(vocab, dim)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, dim))
        for i in range(self.DEPTH):
            setattr(self, f"block{i}", Block(dim, num_heads))
        self.ln_out = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, vocab)

    def forward_batched(self, params: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
        """Logits `[K, B, S, vocab]` of K clients on token ids `[K, B, S]`."""
        k, b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(f"sequence length {s} exceeds max_len={self.max_len}")
        impl = resolve_attn_impl(self.attn_impl, s)
        # client k's ids index rows k·vocab … of the stacked tables
        offset = (torch.arange(k, device=tokens.device) * self.vocab)[:, None, None]
        x = F.embedding(tokens.long() + offset, params["embed.weight"].reshape(k * self.vocab, self.dim))
        x = x + params["pos_embed"][:, None, :s, :]
        for i in range(self.DEPTH):
            x = getattr(self, f"block{i}").forward_batched(params, f"block{i}", x, impl)
        x = _layer_norm(params, "ln_out", x.reshape(k, b * s, self.dim))
        return _linear(params, "head", x).reshape(k, b, s, self.vocab)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """One client's logits `[B, S, vocab]` from token ids `[B, S]`."""
        params = {n: p[None] for n, p in self.named_parameters()}
        return self.forward_batched(params, tokens[None])[0]
