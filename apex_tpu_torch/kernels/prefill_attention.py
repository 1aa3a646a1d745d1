"""Paged chunked-prefill attention: CUDA kernel + plain PyTorch version.

Port of ``apex_tpu/kernels/prefill_attention.py``. A chunk of ``C``
consecutive prompt tokens per sequence, already written into the paged
pool at positions ``[offsets[b], offsets[b] + C)``, each attending
causally over everything before and including itself: query ``i`` of
row ``b`` sits at global position ``offsets[b] + i`` and attends
positions ``[0, offsets[b] + i]`` (the shifted-causal mask). The kernel
is ``apex_paged_prefill`` in ``csrc/paged_attention.cu``: one block per
(16-query tile, head, row), K/V staged in shared memory one 32-position
tile at a time, online softmax in fp32, and no read past the row's last
reachable page ``(offsets[b] + C - 1) // page_len``.

Layouts are the JAX package's: ``q`` [batch, heads, C, head_dim], pools
and page table as in :mod:`.decode_attention`, ``offsets`` [batch]
int32. Pad rows of a partial final chunk compute values the engine never
samples.

The contiguous ``prefill_attention`` kernel and the int8 scale path
belong to later slices; the contiguous plain version is here because
the paged one is built on it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, check_launch, kernel_route, launches, stream_handle
from .decode_attention import (_DTYPES, _NEG_INF, _refuse_quant,
                               check_paged_operands, gather_pages)

__all__ = ["paged_prefill_attention", "paged_prefill_attention_reference",
           "prefill_attention_reference"]


# ---------------------------------------------------------------- plain
def prefill_attention_reference(q, k, v, offsets, *, scale: float = 1.0):
    """fp32 per-row shifted-causal softmax over the cache. ``q`` [b, h,
    C, d]; ``k``/``v`` [b, h, L, d]; ``offsets`` [b]. Query row ``i``
    attends cache positions ``j <= offsets[b] + i``. Returns [b, h, C,
    d] in ``q.dtype``."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhld->bhql", q32, k32) * scale
    C, L = q.shape[2], k.shape[2]
    offsets = offsets.to(device=q.device)
    rows = (offsets[:, None, None, None]
            + torch.arange(C, device=q.device)[None, None, :, None])
    cols = torch.arange(L, device=q.device)[None, None, None, :]
    s = torch.where(cols <= rows, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhql,bhld->bhqd", p, v32).to(q.dtype)


def paged_prefill_attention_reference(q, k_pool, v_pool, page_table,
                                      offsets, *, scale: float = 1.0):
    """Plain version of :func:`paged_prefill_attention`: gather the
    page-table view, then :func:`prefill_attention_reference`."""
    k = gather_pages(k_pool, page_table)
    v = gather_pages(v_pool, page_table)
    return prefill_attention_reference(q, k, v, offsets, scale=scale)


# --------------------------------------------------------------- kernel
def _lib():
    lib = _build.load("paged_attention")
    fn = lib.apex_paged_prefill
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def paged_prefill_attention(q, k_pool, v_pool, page_table, offsets, *,
                            scale: Optional[float] = None,
                            k_scale=None, v_scale=None):
    """Chunk-of-queries attention against a paged cached prefix.

    ``q`` [batch, heads, C, head_dim] — C consecutive tokens whose K/V
    are already in the pool at logical positions ``[offsets[b],
    offsets[b] + C)`` of row ``b``'s pages; ``k_pool``/``v_pool``
    [num_pages, heads, page_len, head_dim]; ``page_table`` [batch,
    max_pages] int32; ``offsets`` [batch] int32. ``scale`` defaults to
    ``1/sqrt(head_dim)``. Returns [batch, heads, C, head_dim] in
    ``q.dtype``.

    CPU tensors take :func:`paged_prefill_attention_reference`; CUDA
    tensors launch the kernel (float32 or bfloat16, head_dim 64,
    contiguous operands) or raise. Inference-only."""
    B, h, C, d = q.shape
    P, hp, page_len, dp = k_pool.shape
    if v_pool.shape != k_pool.shape or hp != h or dp != d:
        raise ValueError(f"paged_prefill_attention: pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != B:
        raise ValueError(f"paged_prefill_attention: page_table "
                         f"{tuple(page_table.shape)} must be [{B}, "
                         f"max_pages]")
    if offsets.shape != (B,):
        raise ValueError(f"paged_prefill_attention: offsets "
                         f"{tuple(offsets.shape)} must be [{B}]")
    _refuse_quant("paged_prefill_attention", k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not kernel_route("paged_prefill_attention", q, k_pool, v_pool,
                        page_table, offsets):
        return paged_prefill_attention_reference(
            q, k_pool, v_pool, page_table, offsets, scale=scale)
    check_paged_operands("paged_prefill_attention", q, k_pool, v_pool,
                         page_table, offsets)
    out = torch.empty_like(q)
    err = _lib().apex_paged_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), offsets.data_ptr(), out.data_ptr(), B, h, C,
        d, page_len, page_table.shape[1], float(scale), _DTYPES[q.dtype],
        stream_handle())
    check_launch("paged_prefill_attention", err)
    launches["paged_prefill_attention"] += 1
    return out
