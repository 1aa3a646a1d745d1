"""Blockwise (flash) attention: CUDA kernels + plain PyTorch versions.

Port of ``apex_tpu/kernels/flash_attention.py`` (the ``_fwd_kernel``,
``_bwd_dkdv_kernel`` and ``_bwd_dq_kernel`` Pallas bodies and the
``_flash`` custom VJP around them). The kernels are
``csrc/flash_attention.cu``:

- the forward writes ``o`` in the input dtype and ``lse`` [bh, sq] fp32;
- the backward computes ``delta = rowsum(float(dO) * float(O))`` here in
  plain torch (as the JAX wrapper does in jnp), then launches the dK/dV
  kernel and the dQ kernel.

Every product runs in fp32 on the upcast inputs, P and dS included.
Layout at the public function is the JAX package's, ``[batch, heads,
seq, head_dim]``; the ``autograd.Function`` makes q, k, v (and dO) a
contiguous ``[batch * heads, seq, head_dim]`` once, so the strided
views the model's ``qkv`` split hands in are copied exactly once.

On CUDA the kernels take head_dim 64 in float32 or bfloat16.
``segment_ids`` and an additive ``bias`` need kernel #10
(``_dbias_kernel``), a later slice: on CUDA they raise; on the CPU they
take :func:`mha_reference` (as the JAX dispatch falls back to it),
differentiated by autograd. ``dropout_rate > 0`` (in-kernel dropout
with the mask replayed in the backward) raises on both.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, check_launch, kernel_route, launches, stream_handle

__all__ = ["flash_attention", "mha_reference", "flash_fwd_reference",
           "flash_bwd_reference"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64              # csrc/flash_attention.cu: kD
_LATER = ("needs kernel #10 (flash_attention.py _dbias_kernel), not ported "
          "yet (ROADMAP Queue 2); the CUDA path takes causal or full "
          "attention only")


# ---------------------------------------------------------------- plain
def mha_reference(q, k, v, *, causal: bool = False, scale: float = 1.0,
                  segment_ids=None, mask=None, bias=None):
    """fp32-math attention over ``[b, h, s, d]`` (the JAX package's
    ``mha_reference`` without dropout), returned in ``q.dtype``. ``bias``
    is additive on the scaled logits; ``mask`` and ``segment_ids``
    (``[b, s]``) mask to -1e30."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    if bias is not None:
        s = s + bias.float()
    sq, sk = s.shape[-2], s.shape[-1]
    neg = torch.tensor(_NEG_INF, dtype=s.dtype, device=s.device)
    if causal:
        s = torch.where(torch.ones(sq, sk, dtype=torch.bool,
                                   device=s.device).tril(), s, neg)
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        s = torch.where(seg, s, neg)
    if mask is not None:
        s = torch.where(mask, s, neg)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v32).to(q.dtype)


def _causal_fill(s, causal: bool):
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return s


def flash_fwd_reference(q3, k3, v3, scale: float, causal: bool):
    """Plain forward over ``[bh, s, d]`` (``_ref_chunk_fwd``): ``(o fp32
    softmax-normalized, lse [bh, sq] fp32)``, with the kernels' -1e30
    mask and ``l == 0 -> 1`` guard."""
    q32, k32, v32 = q3.float(), k3.float(), v3.float()
    s = _causal_fill(torch.einsum("bqd,bkd->bqk", q32, k32) * scale,
                     causal)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bqk,bkd->bqd", p, v32) / l_safe[..., None]
    return o, m + torch.log(l_safe)


def flash_bwd_reference(q3, k3, v3, do3, lse, delta, scale: float,
                        causal: bool):
    """Plain backward over ``[bh, s, d]`` given the forward's ``lse`` and
    ``delta = rowsum(dO * O)`` (``_ref_chunk_bwd``): fp32 ``(dq, dk,
    dv)``."""
    q32, k32, v32 = q3.float(), k3.float(), v3.float()
    do32 = do3.float()
    s = _causal_fill(torch.einsum("bqd,bkd->bqk", q32, k32) * scale,
                     causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do32, v32)
    dv = torch.einsum("bqk,bqd->bkd", p, do32)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k32)
    dk = torch.einsum("bqk,bqd->bkd", ds, q32)
    return dq, dk, dv


# --------------------------------------------------------------- kernel
def _lib():
    lib = _build.load("flash_attention")
    if lib.apex_flash_fwd.argtypes is None:
        lib.apex_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.apex_flash_fwd.restype = ctypes.c_int
        lib.apex_flash_bwd_dkdv.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.apex_flash_bwd_dkdv.restype = ctypes.c_int
        lib.apex_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.apex_flash_bwd_dq.restype = ctypes.c_int
    return lib


def _check_kernel_operands(name, *tensors):
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: the CUDA kernels take float32 or bfloat16,"
                        f" got {dtype}")
    for t in tensors:
        if t.dtype != dtype or t.shape[-1] != _HEAD_DIM \
                or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous [bh, s, "
                             f"{_HEAD_DIM}] {dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    return _DTYPES[dtype]


def flash_fwd_kernel(q3, k3, v3, scale: float, causal: bool):
    """Launch the forward kernel on contiguous CUDA ``[bh, s, 64]``
    operands: ``(o in q3.dtype, lse [bh, sq] fp32)``."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    dt = _check_kernel_operands("flash_attention", q3, k3, v3)
    o = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    err = _lib().apex_flash_fwd(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d, float(scale), int(causal), dt,
        stream_handle())
    check_launch("flash_attention", err)
    launches["flash_fwd"] += 1
    return o, lse


def _check_bwd_operands(name, q3, k3, v3, do3, lse, delta):
    bh, sq = q3.shape[:2]
    dt = _check_kernel_operands(name, q3, k3, v3, do3)
    for nm, t in (("lse", lse), ("delta", delta)):
        if t.shape != (bh, sq) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be a contiguous [{bh}, "
                             f"{sq}] float32 tensor")
    return dt


def flash_bwd_dkdv_kernel(q3, k3, v3, do3, lse, delta, scale: float,
                          causal: bool):
    """Launch the dK/dV kernel on contiguous CUDA ``[bh, s, 64]``
    operands with the forward's ``lse`` and ``delta = rowsum(dO * O)``
    (contiguous [bh, sq] fp32): ``(dk, dv)`` in the inputs' dtype."""
    bh, sq, d = q3.shape
    dt = _check_bwd_operands("flash_attention dK/dV", q3, k3, v3, do3, lse,
                             delta)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    err = _lib().apex_flash_bwd_dkdv(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        sq, k3.shape[1], d, float(scale), int(causal), dt, stream_handle())
    check_launch("flash_attention dK/dV", err)
    launches["flash_bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_dq_kernel(q3, k3, v3, do3, lse, delta, scale: float,
                        causal: bool):
    """Launch the dQ kernel (operands as :func:`flash_bwd_dkdv_kernel`):
    ``dq`` in the inputs' dtype."""
    bh, sq, d = q3.shape
    dt = _check_bwd_operands("flash_attention dQ", q3, k3, v3, do3, lse,
                             delta)
    dq = torch.empty_like(q3)
    err = _lib().apex_flash_bwd_dq(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq,
        k3.shape[1], d, float(scale), int(causal), dt, stream_handle())
    check_launch("flash_attention dQ", err)
    launches["flash_bwd_dq"] += 1
    return dq


def _flat(t):
    b, h, s, d = t.shape
    return t.reshape(b * h, s, d).contiguous()


class _FlashFn(torch.autograd.Function):
    """``_flash``'s custom VJP: the forward saves ``(q, k, v, o, lse)``
    as ``[bh, s, d]``; the backward forms ``delta`` and runs dK/dV then
    dQ."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        b, h, sq, d = q.shape
        q3, k3, v3 = _flat(q), _flat(k), _flat(v)
        if kernel_route("flash_attention", q3, k3, v3):
            o3, lse = flash_fwd_kernel(q3, k3, v3, scale, causal)
        else:
            o32, lse = flash_fwd_reference(q3, k3, v3, scale, causal)
            o3 = o32.to(q.dtype)
        ctx.save_for_backward(q3, k3, v3, o3, lse)
        ctx.causal, ctx.scale, ctx.shapes = causal, scale, (q.shape,
                                                            k.shape)
        return o3.reshape(b, h, sq, d)

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, o3, lse = ctx.saved_tensors
        qshape, kshape = ctx.shapes
        do3 = _flat(g.to(q3.dtype))
        delta = (do3.float() * o3.float()).sum(-1)
        if kernel_route("flash_attention", q3, k3, v3, do3):
            args = (q3, k3, v3, do3, lse, delta, ctx.scale, ctx.causal)
            dk, dv = flash_bwd_dkdv_kernel(*args)
            dq = flash_bwd_dq_kernel(*args)
        else:
            dq, dk, dv = flash_bwd_reference(q3, k3, v3, do3, lse, delta,
                                             ctx.scale, ctx.causal)
            dq, dk, dv = dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)
        return (dq.reshape(qshape), dk.reshape(kshape), dv.reshape(kshape),
                None, None)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, segment_ids=None,
                    bias=None, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None):
    """Fused attention over ``q, k, v [batch, heads, seq, head_dim]``,
    differentiable in all three. ``scale`` defaults to
    ``1/sqrt(head_dim)``; ``causal`` masks position ``j > i``.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (head_dim 64, float32 or bfloat16) or raise. ``segment_ids`` and
    ``bias`` raise ``NotImplementedError`` on CUDA and take
    :func:`mha_reference` on the CPU; ``dropout_rate > 0`` raises on
    both (``dropout_seed`` is the JAX signature's)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attention dropout (in-kernel masks replayed in the "
            "backward) is not ported yet (ROADMAP Queue 3)")
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[-1] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "[batch, heads, seq, head_dim] alike")
    if segment_ids is not None or bias is not None:
        if kernel_route("flash_attention", q, k, v, segment_ids, bias):
            raise NotImplementedError(
                f"flash_attention with segment_ids or bias {_LATER}")
        return mha_reference(q, k, v, causal=causal, scale=scale,
                             segment_ids=segment_ids, bias=bias)
    return _FlashFn.apply(q, k, v, bool(causal), float(scale))
