"""GPT-style causal transformer LM — the paged serving modes.

Port of ``apex_tpu/models/transformer_lm.py``: pre-LN blocks with
:class:`~apex_tpu_torch.normalization.FusedLayerNorm`, a tanh-GELU MLP
computed in fp32, learned position embeddings and a tied LM head whose
logits are fp32. Parameters are ``nn.Module`` state; their names map
one-to-one onto the JAX parameter tree (:mod:`.convert`).

This slice ports the two cache modes the serving engine runs, over its
paged pool (``cache=(k_pool, v_pool, page_table)``, pools ``[layers,
num_pages, heads, page_len, head_dim]``, table ``[B, max_pages]`` int32):

- **decode** (``S == 1``): each row's token K/V is written at page
  ``page_table[b, pos // page_len]``, offset ``pos % page_len``, then the
  token attends ``[0, pos]`` through the paged decode kernel
  (``lengths = pos + 1``). Inactive rows' tables point at the sentinel
  page 0, so their discarded writes land there.
- **chunk prefill** (``S > 1``, ``S % page_len == 0``, page-aligned
  ``pos``): the chunk's K/V fills ``S // page_len`` whole pages, then the
  shifted-causal paged prefill kernel attends from ``offsets = pos``.

Unlike JAX, which returns new pool arrays, the pools are updated IN
PLACE (the returned pair is the same tensors): a serving pool is the
largest allocation on the device, and a copy per call would double it.

Positions are clipped twice, as in the reference: ``clip(pos, 0, L - S)``
for the cache write/attend window (``L = max_pages * page_len``) and
``clip(pos + s, 0, max_seq_len - 1)`` for the position embedding.

The **no-cache forward** (``cache=None``) is the training path: causal
:func:`~apex_tpu_torch.kernels.flash_attention.flash_attention` over the
whole sequence at positions ``[0, S)``, differentiable end to end
(LayerNorm and attention through their CUDA kernels' backward).
``return_kv`` (monolithic prefill) belongs to the contiguous engine, a
later slice, and raises; so do ``dropout > 0`` and ``remat``.

Under amp O1 (an active :func:`~apex_tpu_torch.amp.autocast.autocast`
policy with per-op casts) the dense sites resolve ``"linear"`` per call,
as the JAX modules do: the embedding sum, the GEMMs and the MLP input
run in bf16 from fp32 parameters cast per call (so the gradients reach
the fp32 parameters), q/k/v enter flash attention in bf16, the
LayerNorms run in fp32 (``"layer_norm"``) and the tied head stays fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp.autocast import resolve_dtype
from apex_tpu_torch.kernels.decode_attention import paged_decode_attention
from apex_tpu_torch.kernels.flash_attention import flash_attention
from apex_tpu_torch.kernels.prefill_attention import (
    paged_prefill_attention)
from apex_tpu_torch.normalization import FusedLayerNorm

__all__ = ["SelfAttention", "TransformerBlock", "TransformerLM",
           "create_lm", "_LM_SIZES"]

_NO_RETURN_KV = ("return_kv (monolithic prefill) belongs to the contiguous "
                 "engine, a later slice of the port (ROADMAP Queue 3); "
                 "serve through the paged cache modes")


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in the dtype the active amp policy gives ``linear``
    (O1: bf16, with ``x``, the weight and the bias cast per call), else
    in the operands' own dtypes."""
    dtype = resolve_dtype(None, "linear")
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _dense_dtype(like: torch.Tensor) -> torch.dtype:
    """The dense sites' activation dtype: the policy's ``linear`` dtype
    under O1, else the parameters' (``like``'s)."""
    return resolve_dtype(None, "linear", like.dtype)


class SelfAttention(nn.Module):
    """Causal multi-head attention: over the whole sequence with no
    cache (training), or over the paged pool (decode and chunk prefill;
    see the module docstring). ``qkv`` output columns are ordered
    ``[3][heads][head_dim]``, as the JAX Dense kernel's."""

    def __init__(self, hidden: int, num_heads: int):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} must divide into "
                             f"{num_heads} heads")
        self.hidden = hidden
        self.num_heads = num_heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x, cache=None, positions=None):
        B, S, H = x.shape
        heads = self.num_heads
        d = H // heads
        qkv = _linear(self.qkv, x).reshape(B, S, 3, heads, d).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                  # [B, h, S, d]
        if cache is None:
            ctx = flash_attention(q, k, v, causal=True)
            return _linear(self.proj, ctx.transpose(1, 2).reshape(B, S, H))
        k_pool, v_pool, page_table = cache
        page_len = k_pool.shape[2]
        L = page_table.shape[1] * page_len
        # a traced-value safety net in the reference: callers bound
        # positions host-side (the engine checks offset + chunk_len)
        pos = positions.clamp(0, L - S)
        if S == 1:
            page_ids = page_table.gather(
                1, (pos // page_len)[:, None].long())[:, 0].long()
            off = (pos % page_len).long()
            k_pool[page_ids, :, off] = k[:, :, 0].to(k_pool.dtype)
            v_pool[page_ids, :, off] = v[:, :, 0].to(v_pool.dtype)
            ctx = paged_decode_attention(q[:, :, 0].contiguous(), k_pool,
                                         v_pool, page_table, pos + 1)
        else:
            if S % page_len:
                raise ValueError(f"paged chunk prefill needs S ({S}) to be "
                                 f"a multiple of page_len ({page_len})")
            npg = S // page_len
            idx = (pos // page_len)[:, None].long() + torch.arange(
                npg, device=pos.device)[None, :]
            pages = page_table.gather(1, idx).long()      # [B, npg]

            def _pages(t):                     # -> [B, npg, h, pl, d]
                return t.to(k_pool.dtype).reshape(
                    B, heads, npg, page_len, d).transpose(1, 2)

            k_pool[pages] = _pages(k)
            v_pool[pages] = _pages(v)
            ctx = paged_prefill_attention(q.contiguous(), k_pool, v_pool,
                                          page_table, pos)
        out = ctx.reshape(B, heads, S, d).transpose(1, 2).reshape(B, S, H)
        return _linear(self.proj, out)


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + attn(LN(x))``, then ``x + mlp(LN(x))`` with the
    tanh-GELU (GPT-2's) taken on the fp32 accumulator."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.ln_attn = FusedLayerNorm(hidden)
        self.attn = SelfAttention(hidden, num_heads)
        self.ln_mlp = FusedLayerNorm(hidden)
        self.mlp_in = nn.Linear(hidden, mlp_ratio * hidden)
        self.mlp_out = nn.Linear(mlp_ratio * hidden, hidden)

    def forward(self, x, cache=None, positions=None):
        x = x + self.attn(self.ln_attn(x), cache, positions)
        h = _linear(self.mlp_in, self.ln_mlp(x))
        h = F.gelu(h.float(), approximate="tanh").to(
            _dense_dtype(self.mlp_out.weight))
        return x + _linear(self.mlp_out, h)


class TransformerLM(nn.Module):
    """Causal LM: tied-embedding GPT with pre-LN blocks and a final
    FusedLayerNorm.

    ``forward(tokens [B, S]) -> logits [B, S, vocab] fp32`` is the
    training forward (no cache, token ``s`` at position ``s``).
    ``forward(tokens [B, S], cache=(k_pools, v_pools, page_table),
    positions [B] int32) -> (logits [B, S, vocab] fp32, (k_pools,
    v_pools))`` serves from the paged pool — token ``s`` of row ``b``
    sits at ``positions[b] + s``. ``features_only=True`` returns the
    pre-head hidden states ``[B, S, hidden]`` instead of logits (the
    fused LM-head loss and the engine apply the head themselves).
    Compute runs in the parameters' dtype (the embedding's under amp O2,
    whose fp32 LayerNorm parameters take bf16 activations); the head is
    fp32 (:meth:`head`). ``dropout`` and ``remat`` are not ported yet and
    raise when set."""

    def __init__(self, vocab_size: int, hidden: int = 512,
                 num_layers: int = 6, num_heads: int = 8,
                 max_seq_len: int = 1024, mlp_ratio: int = 4,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        if dropout > 0.0 or remat:
            raise NotImplementedError(
                "TransformerLM dropout > 0 and remat (activation "
                "checkpointing) are not ported yet (ROADMAP Queue 3): the "
                "flash kernels take no dropout mask")
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.mlp_ratio = mlp_ratio
        self.wte = nn.Embedding(vocab_size, hidden)
        self.wpe = nn.Parameter(torch.zeros(max_seq_len, hidden))
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden, num_heads, mlp_ratio)
            for _ in range(num_layers))
        self.ln_f = FusedLayerNorm(hidden)
        self._head32: Optional[torch.Tensor] = None

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "TransformerLM":
        """Seeded initialisation at the reference's scales: embedding
        N(0, 1/hidden), position embedding N(0, 0.02^2), Dense kernels
        N(0, 1/fan_in) with zero bias, LayerNorm ones/zeros."""
        g = torch.Generator().manual_seed(seed)

        def normal_(p, std):
            p.copy_(torch.randn(p.shape, generator=g) * std)

        normal_(self.wte.weight, 1.0 / math.sqrt(self.hidden))
        normal_(self.wpe, 0.02)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal_(mod.weight, 1.0 / math.sqrt(mod.in_features))
                mod.bias.zero_()
            elif isinstance(mod, FusedLayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self._head32 = None
        return self

    def cache_head_fp32(self) -> None:
        """Keep an fp32 copy of the tied embedding for :meth:`head`, so
        a half-precision model does not cast the ``[vocab, hidden]``
        matrix on every call (an fp32 model's copy is the weight
        itself). Call again after changing or moving the weights."""
        self._head32 = self.wte.weight.detach().float()

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The tied LM head in fp32: ``x.float() @ wte.T``."""
        w = self._head32 if self._head32 is not None \
            else self.wte.weight.float()
        return torch.matmul(x.float(), w.t())

    def forward(self, tokens, *, cache=None, positions=None,
                features_only: bool = False, return_kv: bool = False):
        if return_kv:
            raise NotImplementedError(_NO_RETURN_KV)
        if cache is None:
            return self._forward_full(tokens, features_only)
        if len(cache) != 3:
            raise NotImplementedError(
                "the contiguous (k, v) cache belongs to the paged=False "
                "engine, a later slice of the port; pass (k_pools, "
                "v_pools, page_table)")
        k_pools, v_pools, page_table = cache
        B, S = tokens.shape
        positions = torch.as_tensor(positions, dtype=torch.int32,
                                    device=tokens.device)
        ppos = (positions[:, None].long()
                + torch.arange(S, device=tokens.device)[None, :]).clamp(
                    0, self.max_seq_len - 1)
        x = (self.wte(tokens) + self.wpe[ppos]).to(
            _dense_dtype(self.wte.weight))
        for i, block in enumerate(self.blocks):
            x = block(x, (k_pools[i], v_pools[i], page_table), positions)
        x = self.ln_f(x)
        if features_only:
            return x
        return self.head(x), (k_pools, v_pools)


    def _forward_full(self, tokens, features_only: bool):
        S = tokens.shape[1]
        if S > self.max_seq_len:
            raise ValueError(f"sequence {S} > max_seq_len "
                             f"{self.max_seq_len}")
        x = (self.wte(tokens) + self.wpe[:S][None]).to(
            _dense_dtype(self.wte.weight))
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        if features_only:
            return x
        return self.head(x)


_LM_SIZES = {
    # (hidden, layers, heads) — as apex_tpu.models.transformer_lm
    "tiny": (128, 2, 4),
    "small": (512, 6, 8),
    "medium": (1024, 12, 16),
    "gpt2": (768, 12, 12),
}


def create_lm(size: str = "small", vocab_size: int = 32768,
              max_seq_len: int = 1024, seed: int = 0) -> TransformerLM:
    """A :class:`TransformerLM` of a named size, on the CPU in fp32,
    initialised from ``seed`` (:meth:`TransformerLM.init_weights`)."""
    if size not in _LM_SIZES:
        raise ValueError(f"unknown LM size {size!r}; one of "
                         f"{sorted(_LM_SIZES)}")
    hidden, layers, heads = _LM_SIZES[size]
    model = TransformerLM(vocab_size=vocab_size, hidden=hidden,
                          num_layers=layers, num_heads=heads,
                          max_seq_len=max_seq_len)
    return model.init_weights(seed)
