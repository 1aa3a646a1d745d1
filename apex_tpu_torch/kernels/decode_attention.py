"""Paged single-token decode attention: CUDA kernel + plain PyTorch version.

Port of ``apex_tpu/kernels/decode_attention.py``. ONE new query per
sequence attends the first ``lengths[b]`` positions of its KV cache, which
lives in a dense pool of fixed-size pages addressed through a
``[batch, max_pages]`` page table (the serving engine's paged layout).
The kernel is ``apex_paged_decode`` in ``csrc/paged_attention.cu``: one
block per (head, row) walking only the row's own pages up to its length,
online softmax in fp32.

Layouts are the JAX package's:

- ``q``: ``[batch, heads, head_dim]``;
- ``k_pool``/``v_pool``: ``[num_pages, heads, page_len, head_dim]`` (one
  layer of the pool; pages are shared across rows, page 0 is the sentinel
  that inactive rows point at);
- ``page_table``: ``[batch, max_pages]`` int32;
- ``lengths``: ``[batch]`` int32 — the current token's K/V must already
  be written at ``lengths[b] - 1`` (write-then-attend). Rows with
  ``lengths == 0`` return zeros.

The contiguous ``decode_attention`` kernel (the ``paged=False`` engine)
and the int8 ``k_scale``/``v_scale`` path belong to later slices; the
contiguous plain version is here because the paged one is built on it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, check_launch, kernel_route, launches, stream_handle

__all__ = ["decode_attention_reference", "gather_pages",
           "paged_decode_attention", "paged_decode_attention_reference"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)          # the widths csrc/paged_attention.cu is built for


def _refuse_quant(name: str, k_scale, v_scale) -> None:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            f"{name}: the int8 k_scale/v_scale cache belongs to the "
            "kv-quant slice of the port, not yet ported")


# ---------------------------------------------------------------- plain
def decode_attention_reference(q, k, v, lengths, *, scale: float = 1.0):
    """fp32 masked softmax over the valid cache prefix. ``q`` [b, h, d];
    ``k``/``v`` [b, h, L, d]; ``lengths`` [b]. Returns [b, h, d] in
    ``q.dtype``; rows with ``lengths == 0`` are 0."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = torch.einsum("bhd,bhld->bhl", q32, k32) * scale
    L = k.shape[2]
    lengths = lengths.to(device=q.device)
    valid = (torch.arange(L, device=q.device)[None, None, :]
             < lengths[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhl,bhld->bhd", p, v32)
    live = (lengths > 0)[:, None, None]
    return torch.where(live, out, torch.zeros_like(out)).to(q.dtype)


def gather_pages(pool, page_table):
    """A contiguous per-row cache view from a paged pool: ``pool``
    [num_pages, heads, page_len, d] + ``page_table`` [batch, max_pages]
    -> [batch, heads, max_pages * page_len, d]. Positions ``[j*page_len,
    (j+1)*page_len)`` of row ``b`` are pool page ``page_table[b, j]``."""
    B, P = page_table.shape
    h, page_len, d = pool.shape[1], pool.shape[2], pool.shape[3]
    gathered = pool[page_table.long()]          # [B, P, h, page_len, d]
    return gathered.permute(0, 2, 1, 3, 4).reshape(B, h, P * page_len, d)


def paged_decode_attention_reference(q, k_pool, v_pool, page_table,
                                     lengths, *, scale: float = 1.0):
    """Plain version of :func:`paged_decode_attention`: gather the
    page-table view, then :func:`decode_attention_reference`."""
    k = gather_pages(k_pool, page_table)
    v = gather_pages(v_pool, page_table)
    return decode_attention_reference(q, k, v, lengths, scale=scale)


# --------------------------------------------------------------- kernel
def _lib():
    lib = _build.load("paged_attention")
    fn = lib.apex_paged_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_paged_operands(name, q, k_pool, v_pool, page_table, index):
    """The CUDA wrappers' shared operand check: one float32/bfloat16
    dtype, contiguous tensors on one device, int32 ``page_table`` and
    per-row ``index`` (lengths or offsets), a head_dim the kernels are
    instantiated for."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: pools {k_pool.dtype}/{v_pool.dtype} must "
                        f"match q {q.dtype}")
    if page_table.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and lengths/offsets must be "
                        f"int32, got {page_table.dtype}/{index.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in "
                         f"{_HEAD_DIMS}")
    ts = (q, k_pool, v_pool, page_table, index)
    if any(not t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: every operand must be contiguous")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: operands on several devices "
                         f"{sorted({str(t.device) for t in ts})}")


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths, *,
                           scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Single-token attention against a paged, length-masked KV pool.

    ``q`` [batch, heads, head_dim]; ``k_pool``/``v_pool`` [num_pages,
    heads, page_len, head_dim]; ``page_table`` [batch, max_pages] int32;
    ``lengths`` [batch] int32 — positions ``[0, lengths[b])`` of row
    ``b``'s pages are attended. ``scale`` defaults to ``1/sqrt(head_dim)``.
    Returns [batch, heads, head_dim] in ``q.dtype``.

    CPU tensors take :func:`paged_decode_attention_reference`; CUDA
    tensors launch the kernel (float32 or bfloat16, head_dim 64,
    contiguous operands) or raise. Inference-only."""
    B, h, d = q.shape
    P, hp, page_len, dp = k_pool.shape
    if v_pool.shape != k_pool.shape or hp != h or dp != d:
        raise ValueError(f"paged_decode_attention: pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != B:
        raise ValueError(f"paged_decode_attention: page_table "
                         f"{tuple(page_table.shape)} must be [{B}, "
                         f"max_pages]")
    if lengths.shape != (B,):
        raise ValueError(f"paged_decode_attention: lengths "
                         f"{tuple(lengths.shape)} must be [{B}]")
    _refuse_quant("paged_decode_attention", k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not kernel_route("paged_decode_attention", q, k_pool, v_pool,
                        page_table, lengths):
        return paged_decode_attention_reference(
            q, k_pool, v_pool, page_table, lengths, scale=scale)
    check_paged_operands("paged_decode_attention", q, k_pool, v_pool,
                         page_table, lengths)
    out = torch.empty_like(q)
    err = _lib().apex_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, h, d,
        page_len, page_table.shape[1], float(scale), _DTYPES[q.dtype],
        stream_handle())
    check_launch("paged_decode_attention", err)
    launches["paged_decode_attention"] += 1
    return out
