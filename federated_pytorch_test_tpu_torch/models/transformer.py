"""The transformer models (`TransformerLM`, `ViT`) with partition metadata.

Counterpart of the JAX package's `models/transformer.py`:
* `TransformerLM` — token embedding + learned positions, four pre-norm
  causal blocks, a final LayerNorm and a separate head;
* `ViT` — a patch embedding (a convolution with kernel = stride = patch)
  over 32x32 images, learned positions, four pre-norm bidirectional blocks,
  a final LayerNorm, a mean pool over the tokens and the classifier head;
both with the same parameter trees, partition groups and train orders.
Flax defaults kept: LayerNorm ε = 1e-6, the tanh-approximate GELU, and
the fused qkv projection's head-major column order (`[h0(q,k,v), h1(q,k,v),
…]`, read as `reshape(b, s, h, 3, hd)`). The attention core runs in f32.

Mixed precision (`dtype=torch.bfloat16`, the JAX models' `dtype`): the
projections, the patch embedding, the MLP and the head run in bf16, and
LayerNorm takes its statistics and normalizes in f32 (Flax's default)
before rounding its output to bf16; the attention core still takes f32
q, k, v. The residual stream carries the dtype its terms promote to, as
in the JAX models.

Attention is `'dense'` (`ops/attention.py`), `'flash'` (the flash kernels,
`ops/flash_cuda.py`: the aligned causal family for the LM, the rectangular
one for the ViT) or `'auto'`: flash where S is a multiple of 128 and at
least the JAX package's crossover at the attention precision
(`AUTO_FLASH_FROM`: 2048 at 'highest', 1024 at 'default'; PERF.md states
where the card's own crossover lies). `attn_precision` is the flash
kernels' `precision` (None: 'highest'; 'default': one TF32 pass a product).
The ring variants need the multi-GPU path,
which the port does not have yet, and raise. `moe_experts = E > 0` swaps
every block's MLP for a switch MoE of E experts (`models/moe.py`);
`forward_batched(..., return_aux=True)` then also returns each client's
load-balance term summed over the blocks, `[K]`.

As in `models/simple.py`, the modules only hold shapes and kinds: the
engine keeps every client's parameters in one flat `[K, N]` tensor and
`forward_batched` runs the K clients at once — their sequences stack along
the batch axis of the attention, and each projection (the patch embedding
included) is one `bmm` over K.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dense_attention
from ..ops.flash_cuda import BLOCK, check_shape, flash_attention
from .base import PartitionedModel, client_affine, client_linear, resolve_dtype, widen_clients
from .moe import MoEMLP

LN_EPS = 1e-6  # flax.linen.LayerNorm's default
ATTN_IMPLS = ("dense", "flash", "auto")
ATTN_PRECISIONS = ("highest", "default")
# the JAX package's 'auto' crossover by attention precision (its TPU measurement, models/transformer.py:88-99)
AUTO_FLASH_FROM = {"highest": 2048, "default": 1024}


def resolve_attn_precision(precision) -> str:
    """The flash kernels' precision for `attn_precision` (None: 'highest')."""
    prec = precision or "highest"
    if prec not in ATTN_PRECISIONS:
        raise ValueError(f"attn_precision must be None, 'highest' or 'default', got {precision!r}")
    return prec


def resolve_attn_impl(impl: str, seq: int, precision: str = "highest") -> str:
    """`'dense'` or `'flash'` for a sequence of length `seq` at the attention `precision`."""
    if impl in ("ring", "ring_flash"):
        raise NotImplementedError(f"attn_impl={impl!r} needs the multi-GPU path, which is not ported yet")
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {impl!r}")
    if impl == "auto":
        return "flash" if seq >= AUTO_FLASH_FROM[precision] and seq % BLOCK == 0 else "dense"
    return impl


def _linear(params, name, x, dt=torch.float32):
    """Per-client dense layer in `dt`: x `[K, M, in]` -> `[K, M, out]` (a
    probe fan's widths as `models/base.py` `client_linear`)."""
    return client_linear(x.to(dt), params[f"{name}.weight"].to(dt), params[f"{name}.bias"].to(dt))


def _layer_norm(params, name, x, dt=torch.float32):
    """Per-client LayerNorm over the last axis of `x [K, M, dim]`: statistics,
    normalization, scale and bias in f32, the output in `dt`."""
    y = F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS)
    return client_affine(y, params[f"{name}.weight"].float(), params[f"{name}.bias"].float()).to(dt)


class MultiHeadAttention(nn.Module):
    """Fused qkv projection + attention core + output projection."""

    def __init__(self, dim: int, num_heads: int, causal: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.dim, self.num_heads, self.causal = dim, num_heads, causal
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward_batched(self, params, prefix: str, x: torch.Tensor, impl: str, precision: str = "highest",
                        dt=torch.float32) -> torch.Tensor:
        """x `[K, B, S, dim]` -> `[K, B, S, dim]`; each client attends within its own sequences."""
        k, b, s, dim = x.shape
        h = self.num_heads
        qkv = _linear(params, f"{prefix}.qkv", x.reshape(k, b * s, dim), dt)
        qkv = qkv.reshape(k * b, s, h, 3, dim // h).float()  # head-major; the core in f32
        q, kk, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        if impl == "flash":
            out = flash_attention(q, kk, v, causal=self.causal, precision=precision)
        else:
            out = dense_attention(q, kk, v, causal=self.causal)
        return _linear(params, f"{prefix}.proj", out.reshape(k, b * s, dim), dt).reshape(k, b, s, dim)


class Block(nn.Module):
    """Pre-norm block: LN -> MHA -> +res; LN -> MLP (GELU, tanh) or switch MoE -> +res."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4, causal: bool = False, moe_experts: int = 0,
                 dtype=torch.float32):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, num_heads, causal)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        if moe_experts < 0:
            raise ValueError(f"moe_experts must be >= 0, got {moe_experts}")
        if moe_experts:
            self.moe = MoEMLP(dim, moe_experts, mlp_ratio, dtype=dtype)
        else:
            self.moe = None
            self.fc1 = nn.Linear(dim, mlp_ratio * dim)
            self.fc2 = nn.Linear(mlp_ratio * dim, dim)

    def forward_batched(self, params, prefix: str, x: torch.Tensor, impl: str, precision: str = "highest",
                        dt=torch.float32):
        """x `[K, B, S, dim]` -> (`[K, B, S, dim]`, the MoE's load-balance term `[K]`, or None).

        Under a probe fan a block whose leaves are P-wide widens its input
        first, so that the residual stream is P-wide from there on."""
        x = widen_clients(x, params[f"{prefix}.ln1.weight"].shape[0])
        k, b, s, dim = x.shape
        y = _layer_norm(params, f"{prefix}.ln1", x.reshape(k, b * s, dim), dt).reshape(k, b, s, dim)
        x = x + self.attn.forward_batched(params, f"{prefix}.attn", y, impl, precision, dt)
        y = _layer_norm(params, f"{prefix}.ln2", x.reshape(k, b * s, dim), dt)
        aux = None
        if self.moe is not None:
            y, aux = self.moe.forward_batched(params, f"{prefix}.moe", y)
        else:
            y = _linear(params, f"{prefix}.fc2", F.gelu(_linear(params, f"{prefix}.fc1", y, dt), approximate="tanh"),
                        dt)
        return x + y.reshape(k, b, s, dim), aux


def _blocks(model, params, x, impl):
    """Run the model's blocks on x `[K, B, S, dim]`; (x, load-balance term `[K]` summed over the blocks)."""
    aux = x.new_zeros(x.shape[0], dtype=torch.float32)
    for i in range(model.DEPTH):
        x, block_aux = getattr(model, f"block{i}").forward_batched(params, f"block{i}", x, impl,
                                                                    model.attn_precision, model.dtype)
        if block_aux is not None:
            aux = widen_clients(aux, block_aux.shape[0]) + block_aux
    return x, aux


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
                 attn_impl: str = "dense", moe_experts: int = 0, attn_precision=None, dtype=torch.float32):
        super().__init__()
        self.attn_precision = resolve_attn_precision(attn_precision)
        resolve_attn_impl(attn_impl, max_len, self.attn_precision)  # reject unknown or unported values early
        self.vocab, self.dim, self.num_heads, self.max_len = vocab, dim, num_heads, max_len
        self.attn_impl = attn_impl
        self.moe_experts = moe_experts
        self.dtype = resolve_dtype(dtype)
        self.embed = nn.Embedding(vocab, dim)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, dim))
        for i in range(self.DEPTH):
            setattr(self, f"block{i}", Block(dim, num_heads, causal=True, moe_experts=moe_experts, dtype=self.dtype))
        self.ln_out = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, vocab)

    def forward_batched(self, params: Dict[str, torch.Tensor], tokens: torch.Tensor, return_aux: bool = False):
        """Logits `[K, B, S, vocab]` of K clients on token ids `[K, B, S]`
        (and with `return_aux`, the load-balance term `[K]`, 0 without experts)."""
        k, b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(f"sequence length {s} exceeds max_len={self.max_len}")
        impl = resolve_attn_impl(self.attn_impl, s, self.attn_precision)
        # client k's ids index rows k·vocab … of the stacked tables
        offset = (torch.arange(k, device=tokens.device) * self.vocab)[:, None, None]
        x = F.embedding(tokens.long() + offset, params["embed.weight"].reshape(k * self.vocab, self.dim))
        x = x + params["pos_embed"][:, None, :s, :]
        x, aux = _blocks(self, params, x, impl)
        x = _layer_norm(params, "ln_out", x.reshape(k, b * s, self.dim), self.dtype)
        logits = _linear(params, "head", x, self.dtype).reshape(k, b, s, self.vocab)
        return (logits, aux) if return_aux else logits

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """One client's logits `[B, S, vocab]` from token ids `[B, S]`."""
        params = {n: p[None] for n, p in self.named_parameters()}
        return self.forward_batched(params, tokens[None])[0]


class ViT(PartitionedModel):
    """Tiny vision transformer for 32x32 NHWC images (the JAX package's defaults).

    The patch embedding is a convolution with kernel = stride = `patch`
    (Flax's "SAME" padding adds none there), its output read as
    (32/patch)² tokens in (h, w) row-major order. Partition groups: 0 =
    patch embedding + positions, 1..4 = the blocks (the last one also
    carries the pre-head LayerNorm), 5 = the head alone (the only group
    that takes the elastic net).
    """

    GROUP_PATHS = TransformerLM.GROUP_PATHS
    LINEAR_GROUP_IDS = (5,)
    TRAIN_ORDER = (0, 1, 2, 3, 4, 5)
    DEPTH = 4  # pinned by the four block groups
    IMAGE = 32  # input height and width (CIFAR)
    CHANNELS = 3

    def __init__(self, num_classes: int = 10, dim: int = 64, num_heads: int = 4, patch: int = 4,
                 attn_impl: str = "dense", moe_experts: int = 0, attn_precision=None, dtype=torch.float32):
        super().__init__()
        if self.IMAGE % patch:
            raise ValueError(f"patch {patch} does not divide the {self.IMAGE}x{self.IMAGE} image")
        self.num_classes, self.dim, self.num_heads, self.patch = num_classes, dim, num_heads, patch
        self.tokens = (self.IMAGE // patch) ** 2
        self.attn_impl = attn_impl
        self.attn_precision = resolve_attn_precision(attn_precision)
        self.moe_experts = moe_experts
        self.dtype = resolve_dtype(dtype)
        if resolve_attn_impl(attn_impl, self.tokens, self.attn_precision) == "flash":  # reject what the kernels refuse
            check_shape(self.tokens, dim // num_heads)
        self.embed = nn.Conv2d(self.CHANNELS, dim, patch, stride=patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.tokens, dim))
        for i in range(self.DEPTH):
            setattr(self, f"block{i}", Block(dim, num_heads, moe_experts=moe_experts, dtype=self.dtype))
        self.ln_out = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    def forward_batched(self, params: Dict[str, torch.Tensor], x: torch.Tensor, return_aux: bool = False):
        """Logits `[K, B, classes]` of K clients on NHWC images `[K, B, 32, 32, 3]`
        (and with `return_aux`, the load-balance term `[K]`, 0 without experts)."""
        k, b, hh, ww, c = x.shape
        if (hh, ww, c) != (self.IMAGE, self.IMAGE, self.CHANNELS):
            raise ValueError(f"ViT takes {self.IMAGE}x{self.IMAGE}x{self.CHANNELS} images, got {hh}x{ww}x{c}")
        p, t = self.patch, self.tokens
        # each patch as a (c, kh, kw) vector, the order of the OIHW weight's rows
        patches = x.reshape(k, b, hh // p, p, ww // p, p, c).permute(0, 1, 2, 4, 6, 3, 5)
        patches = patches.reshape(k, b * t, c * p * p)
        dt = self.dtype
        w = params["embed.weight"].reshape(-1, self.dim, c * p * p).to(dt)
        h = client_linear(patches.to(dt), w, params["embed.bias"].to(dt))
        h = h.reshape(-1, b, t, self.dim) + params["pos_embed"]  # [K, 1, T, dim]
        impl = resolve_attn_impl(self.attn_impl, t, self.attn_precision)
        h, aux = _blocks(self, params, h, impl)
        kc = h.shape[0]
        h = _layer_norm(params, "ln_out", h.reshape(kc, b * t, self.dim), dt).reshape(kc, b, t, self.dim)
        logits = _linear(params, "head", h.mean(dim=2), dt)
        return (logits, aux) if return_aux else logits
