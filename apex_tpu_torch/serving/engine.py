"""The paged inference engine: chunk prefill and decode over a page pool.

Port of ``apex_tpu/serving/engine.py`` (the paged layout, single device).
The JAX engine owns two compiled programs on this path; here they are two
methods that run the model eagerly under ``torch.inference_mode``:

- **chunk prefill** (:meth:`Engine.prefill_chunk`): ``[1, chunk_len]``
  tokens — one chunk of a prompt, right-padded on the final partial chunk
  — through the model's chunk mode against the slot's pages, K/V written
  at ``[offset, offset + chunk_len)``, a token sampled from the last
  VALID row (the request's first token when the chunk is final,
  discarded otherwise);
- **decode** (:meth:`Engine.decode_step`): ``[slots, 1]`` tokens, one new
  token per slot. Inactive slots compute too (their page-table rows
  point at the sentinel page 0 and their output is discarded).

Host bookkeeping is the reference's, in numpy: ``page_len`` positions per
page (``min(chunk_len, 128)`` by default, degraded to divide
``chunk_len``), a ``[slots, max_pages]`` page table uploaded with every
call, per-slot lengths, and a worst-case page reservation at admission
(:meth:`Engine.try_reserve_slot`) so an admitted request can always grow
to its token budget.

Sampling: greedy when a slot's temperature is 0 (``argmax``, first
maximum on ties, as ``jnp.argmax``), else a temperature softmax draw,
optionally truncated to the static ``top_k``, from a ``torch.Generator``
seeded by ``seed``. Every sampled row also passes the non-finite guard
(``all(isfinite)``), whose verdicts land in
:attr:`Engine.last_decode_finite` / :attr:`Engine.last_chunk_finite`.

Weights are cast once at construction through the amp policy (default
pure-half O3 — bf16 weights, LayerNorm's included, and a bf16 pool;
``resolve_policy("O0")`` for an exact-fp32 engine). The LM head runs in
fp32 against an fp32 copy of the tied embedding kept on the device. TF32
is off inside the engine's two calls and left as the caller set it
everywhere else.

Later slices: the contiguous layout (``paged=False``), prefix caching,
monolithic prefill, speculative verify, tensor parallelism, the
quantized KV / weight tiers, the host tier, LoRA and the dispatch-ahead
halves — each raises here if asked for.
"""

from __future__ import annotations

import contextlib
import copy
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.amp.policy import resolve_policy
from apex_tpu_torch.kernels import on_cuda
from apex_tpu_torch.log_util import get_logger

from .kv_cache import PagedKVCache, PagePool

__all__ = ["Engine", "resolve_page_len", "sample_tokens"]

_logger = get_logger("serving")


def resolve_page_len(chunk_len: int, page_len: Optional[int] = None) -> int:
    """Page size: an explicit ``page_len`` must divide ``chunk_len``
    (chunk writes cover whole pages); the default is ``min(chunk_len,
    128)`` degraded to the largest common divisor of ``chunk_len``."""
    chunk_len = int(chunk_len)
    if page_len is None:
        page_len = min(chunk_len, 128)
        if chunk_len % page_len:
            page_len = math.gcd(page_len, chunk_len)
    page_len = int(page_len)
    if page_len < 1 or chunk_len % page_len:
        raise ValueError(
            f"page_len {page_len} must divide chunk_len {chunk_len} "
            f"(chunk writes must cover whole pages)")
    return page_len


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  generator: torch.Generator, top_k: int = 0
                  ) -> torch.Tensor:
    """One token per row of ``logits`` [N, V]: ``argmax`` where
    ``temperature`` [N] is 0, else a draw from ``softmax(logits / t)``
    (Gumbel-max with uniforms from ``generator``), restricted to each
    row's top ``top_k`` logits when ``top_k`` > 0. Returns int64 [N]."""
    logits = logits.float()
    greedy = logits.argmax(-1)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    scaled = logits / temperature.float().clamp_min(1e-6)[:, None]
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    sampled = (scaled - torch.log(-torch.log(u))).argmax(-1)
    return torch.where(temperature > 0, sampled, greedy)


@contextlib.contextmanager
def _full_fp32_matmuls():
    """TF32 off for the engine's own calls, the caller's setting restored
    after: the fp32 LM head and the O0 engine are exact-fp32 contracts
    (logits within 1e-3 of the CPU's at GPT-2 width), and TF32 keeps
    about 3 significant digits."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _resolve_device(device) -> torch.device:
    if device is None:
        if not on_cuda():
            raise RuntimeError(
                "Engine(device=None) serves on the GPU and torch sees no "
                "CUDA device; pass device='cpu' to run the plain PyTorch "
                "path")
        return torch.device("cuda")
    return torch.device(device)


class Engine:
    """Paged KV-cache inference engine over a
    :class:`~apex_tpu_torch.models.TransformerLM`.

    ``model`` is copied (the caller's module is left as it is), cast by
    ``policy`` and moved to ``device`` (None: the GPU; raises when there
    is none). ``slots``, ``max_len``, ``prefill_len``, ``chunk_len``,
    ``page_len``, ``num_pages``, ``top_k`` and ``seed`` mean what they
    mean in ``apex_tpu.serving.Engine``; the geometry checks are the
    same."""

    def __init__(self, model, *, slots: int, max_len: int,
                 prefill_len: Optional[int] = None,
                 chunk_len: Optional[int] = None, policy=None,
                 prefix_pool: int = 0, top_k: int = 0, seed: int = 0,
                 paged: bool = True, page_len: Optional[int] = None,
                 num_pages: Optional[int] = None, device=None,
                 spec=None, mesh=None, kv_quant=None, weight_quant=None,
                 host_tier=None, lora=None):
        for name, val in (("spec", spec), ("mesh", mesh),
                          ("kv_quant", kv_quant),
                          ("weight_quant", weight_quant),
                          ("host_tier", host_tier), ("lora", lora)):
            if val is not None:
                raise NotImplementedError(
                    f"Engine({name}=...) belongs to a later slice of the "
                    "port")
        if not paged:
            raise NotImplementedError(
                "Engine(paged=False), the contiguous layout, belongs to a "
                "later slice of the port")
        if prefix_pool:
            raise NotImplementedError(
                "Engine(prefix_pool=...), prefix caching, belongs to a "
                "later slice of the port")
        self.device = _resolve_device(device)
        if policy is None:
            policy = resolve_policy("O3", verbose=False)
        self.policy = policy
        max_seq = int(getattr(model, "max_seq_len", max_len))
        if max_len > max_seq:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"max_seq_len {max_seq}")
        if prefill_len is None:
            prefill_len = max_len
        if not 0 < prefill_len <= max_len:
            raise ValueError(f"prefill_len {prefill_len} must be in "
                             f"(0, max_len={max_len}]")
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if chunk_len is None:
            chunk_len = min(int(prefill_len), 256)
            if -(-int(prefill_len) // chunk_len) * chunk_len > max_len:
                chunk_len = int(prefill_len)
        if not 0 < chunk_len <= prefill_len:
            raise ValueError(f"chunk_len {chunk_len} must be in "
                             f"(0, prefill_len={prefill_len}]")
        # every chunk writes a full chunk_len-wide window (the final
        # partial chunk is padded), so the LAST window must fit the cache
        # or the model's position clip would relocate it over earlier K/V
        n_chunks = -(-int(prefill_len) // int(chunk_len))
        if n_chunks * int(chunk_len) > max_len:
            raise ValueError(
                f"chunk_len {chunk_len}: the final chunk window "
                f"[{(n_chunks - 1) * chunk_len}, {n_chunks * chunk_len})"
                f" of a prefill_len={prefill_len} prompt exceeds "
                f"max_len={max_len}; pick a chunk_len with "
                f"ceil(prefill_len/chunk_len)*chunk_len <= max_len")
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.prefill_len = int(prefill_len)
        self.chunk_len = int(chunk_len)
        self.top_k = int(top_k)
        heads = int(model.num_heads)
        layers = int(model.num_layers)
        head_dim = int(model.hidden) // heads

        self.model = policy.cast_params(copy.deepcopy(model)).to(
            self.device).eval()
        self.model.requires_grad_(False)
        self.model.cache_head_fp32()
        cache_dtype = policy.compute_dtype

        self.page_len = page_len = resolve_page_len(self.chunk_len, page_len)
        self.max_pages = -(-self.max_len // page_len)
        if num_pages is None:
            num_pages = self.slots * self.max_pages + 1
        num_pages = int(num_pages)
        if num_pages < self.max_pages + 1:
            raise ValueError(
                f"num_pages {num_pages} cannot hold even one max_len "
                f"request ({self.max_pages} pages) plus the sentinel page")
        self.num_pages = num_pages
        self.cache = PagedKVCache.create(
            layers=layers, num_pages=num_pages, heads=heads,
            page_len=page_len, head_dim=head_dim, dtype=cache_dtype,
            device=self.device)
        self.pool = PagePool(num_pages, page_len)
        self._page_table = np.zeros((self.slots, self.max_pages), np.int32)
        self._n_pages = np.zeros(self.slots, np.int32)
        self._host_len = np.zeros(self.slots, np.int32)
        self._slot_reserved = np.zeros(self.slots, np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.tokens_generated = 0
        self.decode_steps = 0
        self.decode_s = 0.0             # host wall time in decode_step
        self.last_decode_finite = np.ones(self.slots, bool)
        self.last_chunk_finite = True
        # the fp32 logits rows the last call sampled from (a reference to
        # the device tensor, no copy) — what parity checks compare
        self.last_logits: Optional[torch.Tensor] = None
        _logger.info(
            "serving engine (paged, %s): %d slots x %d positions, "
            "prefill_len=%d, chunk_len=%d, page_len=%d, %d pages (+1 "
            "sentinel in count), cache %s (%.1f MiB), top_k=%d",
            self.device, self.slots, self.max_len, self.prefill_len,
            self.chunk_len, self.page_len, self.num_pages,
            str(cache_dtype).replace("torch.", ""),
            self.cache.nbytes() / 2**20, self.top_k)

    # ------------------------------------------------------- the two calls
    def _sample(self, rows: torch.Tensor, temperatures):
        """Sample ``rows`` [N, V] fp32 and bring tokens and finiteness
        verdicts to the host in ONE transfer."""
        temps = torch.as_tensor(np.asarray(temperatures, np.float32),
                                device=self.device)
        finite = torch.isfinite(rows).all(-1)
        tokens = sample_tokens(rows, temps, self._gen, self.top_k)
        self.last_logits = rows
        out = torch.stack([tokens, finite.long()]).cpu().numpy()
        return out[0], out[1].astype(bool)

    @torch.inference_mode()
    @_full_fp32_matmuls()
    def _chunk_call(self, tokens: np.ndarray, slot: int, offset: int,
                    n_valid: int, temperature: float):
        dev = self.device
        pt = torch.from_numpy(self._page_table[slot:slot + 1]).to(dev)
        feats = self.model(
            torch.from_numpy(tokens).to(dev),
            cache=(self.cache.k, self.cache.v, pt),
            positions=torch.tensor([offset], dtype=torch.int32, device=dev),
            features_only=True)
        # sample at the last VALID row: the request's first token when
        # the chunk is final, a throwaway otherwise
        row = self.model.head(feats[0, n_valid - 1])[None]        # [1, V]
        tokens, finite = self._sample(row, [temperature])
        return int(tokens[0]), bool(finite[0])

    @torch.inference_mode()
    @_full_fp32_matmuls()
    def _decode_call(self, last_tokens, positions: np.ndarray,
                     temperatures):
        dev = self.device
        tok = torch.as_tensor(np.asarray(last_tokens, np.int64),
                              device=dev)[:, None]
        logits, _ = self.model(
            tok, cache=(self.cache.k, self.cache.v,
                        torch.from_numpy(self._page_table).to(dev)),
            positions=torch.from_numpy(positions).to(dev))
        return self._sample(logits[:, 0], temperatures)

    # ------------------------------------------------------------ host API
    def prefill_chunk(self, slot: int, chunk: Sequence[int], offset: int,
                      temperature: float = 0.0, *,
                      final: bool = True) -> int:
        """Ingest one chunk of a prompt into ``slot`` at cache position
        ``offset`` (page-aligned) and return the token sampled at the
        chunk's last valid row. ``final`` is accounting only: the token
        is the request's first output when True, a throwaway otherwise.
        The finiteness verdict lands in :attr:`last_chunk_finite`."""
        n = len(chunk)
        if not 0 < n <= self.chunk_len:
            raise ValueError(f"chunk length {n} not in (0, "
                             f"chunk_len={self.chunk_len}]")
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} not in [0, {self.slots})")
        if not 0 <= offset <= self.prefill_len - n:
            raise ValueError(
                f"chunk [{offset}, {offset + n}) exceeds prefill_len="
                f"{self.prefill_len}")
        if offset + self.chunk_len > self.max_len:
            raise ValueError(
                f"padded chunk window [{offset}, "
                f"{offset + self.chunk_len}) exceeds max_len="
                f"{self.max_len}")
        if offset % self.page_len:
            raise ValueError(
                f"paged chunk offset {offset} must be page-aligned "
                f"(page_len={self.page_len})")
        tokens = np.zeros((1, self.chunk_len), np.int64)
        tokens[0, :n] = chunk
        if offset == 0:
            # cold start on a (possibly re-used) slot: stale pages back
            # to the pool, the admission reservation kept
            self.release_slot(slot, keep_reservation=True)
        self._grow_slot(slot, -(-(offset + self.chunk_len) // self.page_len))
        token, finite = self._chunk_call(tokens, slot, offset, n,
                                         temperature)
        self._host_len[slot] = offset + n
        self.last_chunk_finite = finite
        if final:
            self.tokens_generated += 1
        return token

    def prefill_chunked(self, slot: int, prompt: Sequence[int],
                        temperature: float = 0.0) -> int:
        """Drain a whole prompt through :meth:`prefill_chunk` and return
        the first sampled token (callers without a scheduler)."""
        n = len(prompt)
        if not 0 < n <= self.prefill_len:
            raise ValueError(f"prompt length {n} not in (0, "
                             f"prefill_len={self.prefill_len}]")
        token = None
        for lo in range(0, n, self.chunk_len):
            hi = min(lo + self.chunk_len, n)
            token = self.prefill_chunk(slot, list(prompt[lo:hi]), lo,
                                       temperature, final=hi == n)
        return token

    def decode_step(self, last_tokens, active, temperatures) -> np.ndarray:
        """One decode step over every slot: ``last_tokens`` [slots]
        (each slot's latest token), ``active`` [slots] bool,
        ``temperatures`` [slots]. Returns the next token per slot (host
        int64; inactive rows are noise to discard). Verdicts land in
        :attr:`last_decode_finite`."""
        act = np.asarray(active, bool)
        t0 = time.perf_counter()
        # write-then-attend writes at the slot's length: its write page
        # must exist before the call (the admission reservation covers
        # it; a slot at max_len clamps onto its last page)
        for s in np.flatnonzero(act):
            pos = int(self._host_len[s])
            if pos < self.max_len:
                self._grow_slot(s, self.pool.pages_for(pos + 1))
        positions = np.minimum(self._host_len, self.max_len - 1)
        tokens, finite = self._decode_call(last_tokens, positions,
                                           temperatures)
        grow = act & (self._host_len < self.max_len)
        self._host_len[grow] += 1
        self.last_decode_finite = finite
        self.tokens_generated += int(act.sum())
        self.decode_steps += 1
        self.decode_s += time.perf_counter() - t0
        return tokens

    def chunks_for(self, prompt_len: int) -> int:
        """Chunk-prefill calls a prompt of ``prompt_len`` costs."""
        return -(-int(prompt_len) // self.chunk_len)

    # ------------------------------------------------- paged bookkeeping
    def _alloc_page(self, slot: int) -> int:
        reserved = self._slot_reserved[slot] > 0
        page = self.pool.alloc(reserved=reserved)
        if page is None:
            raise RuntimeError(
                f"KV page pool exhausted ({self.num_pages} pages, "
                f"page_len={self.page_len}) — admit through the "
                "scheduler (page reservation) or build a larger pool")
        if reserved:
            self._slot_reserved[slot] -= 1
        return page

    def _grow_slot(self, slot: int, n_pages: int) -> None:
        """Ensure ``slot`` owns at least ``n_pages`` pages."""
        for i in range(int(self._n_pages[slot]),
                       min(int(n_pages), self.max_pages)):
            self._page_table[slot, i] = self._alloc_page(slot)
            self._n_pages[slot] = i + 1

    def release_slot(self, slot: int,
                     keep_reservation: bool = False) -> None:
        """Return ``slot``'s pages to the pool and point its table row
        at the sentinel; ``keep_reservation`` keeps its admission
        reservation (a cold start inside an admitted request)."""
        n = int(self._n_pages[slot])
        if n:
            self.pool.release(self._page_table[slot, :n].tolist())
        self._page_table[slot, :] = 0
        self._n_pages[slot] = 0
        self._host_len[slot] = 0
        if not keep_reservation and self._slot_reserved[slot]:
            self.pool.unreserve(int(self._slot_reserved[slot]))
            self._slot_reserved[slot] = 0

    def pages_required(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pages a request can touch: its padded prefill
        extent (whole chunks) or its decode growth to the token budget,
        whichever reaches further, capped at ``max_len``."""
        prefill_extent = min(self.chunks_for(prompt_len) * self.chunk_len,
                             self.max_len)
        occupied = min(int(prompt_len) + int(max_new_tokens), self.max_len)
        return self.pool.pages_for(max(prefill_extent, occupied))

    def try_reserve_slot(self, slot: int, n_pages: int) -> bool:
        """Admission gate: set aside ``n_pages`` for ``slot``; False
        (nothing changed) when the pool cannot cover the promise."""
        if not self.pool.reserve(int(n_pages)):
            return False
        self._slot_reserved[slot] += int(n_pages)
        return True

    def pool_stats(self) -> dict:
        """Allocator counters plus per-slot fragmentation."""
        stats = self.pool.stats()
        stats["fragmentation"] = self.pool.fragmentation(self._host_len,
                                                         self._n_pages)
        return stats

    def lengths(self) -> np.ndarray:
        """Per-slot cache lengths (host state)."""
        return self._host_len.copy()

    def reset(self) -> None:
        """Release every slot's pages and reservations (K/V stays in
        place — length masking makes it unreachable)."""
        for s in range(self.slots):
            self.release_slot(s)
