"""Fused LayerNorm / RMSNorm: CUDA kernels + plain PyTorch versions.

Port of ``apex_tpu/kernels/layer_norm.py`` (the ``_ln_fwd_kernel`` and
``_ln_bwd_kernel`` Pallas bodies). The kernels are ``csrc/layer_norm.cu``:
one warp per row, fp32 statistics whatever the I/O dtype.

- The forward writes ``y`` in ``x``'s dtype plus ``mean`` and ``rstd``
  (fp32) per row — the residuals the backward reads.
- The backward writes ``dx`` in ``x``'s dtype and ``dgamma`` / ``dbeta``
  in gamma's dtype. The column sums reduce in two deterministic stages
  (per-block fp32 partials, then one sum per column in block order), so
  two runs give bitwise-equal gradients.
- ``memory_efficient`` (apex's flag) saves the OUTPUT ``y`` instead of
  ``x`` and rebuilds ``xhat = (y - beta) / gamma`` in the backward, so
  ``x`` can die after the forward; gamma must be nonzero.

On CUDA, x and gamma / beta may be (float32, float32), (bfloat16,
bfloat16) — the serve path — or (bfloat16, float32), amp O2's bf16
activations with fp32 LayerNorm parameters.

:func:`layer_norm` / :func:`rms_norm` are differentiable in ``x``,
``weight`` and ``bias`` through one ``autograd.Function``; under
``torch.no_grad()`` it saves nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, check_launch, kernel_route, launches, stream_handle

__all__ = ["layer_norm", "rms_norm", "layer_norm_reference",
           "rms_norm_reference", "layer_norm_bwd_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (x dtype, gamma/beta dtype) pairs the kernels are built for
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)}
_MAX_HIDDEN = 1024          # csrc/layer_norm.cu: 32 lanes x 32 values


# ---------------------------------------------------------------- plain
def _ln_plain(x2, weight, bias, eps: float, rms: bool):
    """The plain PyTorch forward over rows ``x2 [N, H]``: ``(y, mean,
    rstd)``, statistics in fp32 (``_ln_fwd_kernel``'s arithmetic)."""
    x32 = x2.float()
    if rms:
        mean = torch.zeros(x32.shape[0], dtype=torch.float32,
                           device=x2.device)
        var = (x32 * x32).mean(-1)
    else:
        mean = x32.mean(-1)
        var = (x32 - mean[:, None]).square().mean(-1)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean[:, None]) * rstd[:, None]
    if weight is not None:
        y = y * weight.float()
        if bias is not None and not rms:
            y = y + bias.float()
    return y.to(x2.dtype), mean, rstd


def _bwd_from_xhat(dy, xhat, dyg, rstd, rms: bool):
    """``_bwd_from_xhat``: ``dx = rstd * (dyg - mean(dyg) - xhat *
    mean(dyg * xhat))`` (no ``mean(dyg)`` term for RMSNorm). Returns
    ``(dx, dgamma_rows, dbeta_rows)`` in fp32; the row terms still need
    their column sums."""
    c2 = (dyg * xhat).mean(-1, keepdim=True)
    if rms:
        dx = rstd * (dyg - xhat * c2)
    else:
        c1 = dyg.mean(-1, keepdim=True)
        dx = rstd * (dyg - c1 - xhat * c2)
    return dx, dy * xhat, dy


def layer_norm_bwd_reference(dy2, src2, weight, bias, mean, rstd,
                             rms: bool = False, mem_eff: bool = False):
    """The plain backward over rows: ``(dx, dgamma, dbeta)``. ``src2`` is
    the saved input x (with its ``mean``) or, under ``mem_eff``, the
    saved output y (xhat rebuilt as ``(y - beta) / gamma``). ``dx`` is in
    ``src2``'s dtype, ``dgamma``/``dbeta`` in ``weight``'s (None without
    affine params; ``dbeta`` None for RMSNorm)."""
    dy32, src32 = dy2.float(), src2.float()
    rstd = rstd[:, None]
    affine = weight is not None
    if mem_eff:
        if affine:
            b32 = bias.float() if (bias is not None and not rms) else 0.0
            xhat = (src32 - b32) / weight.float()
        else:
            xhat = src32
    else:
        xhat = (src32 - mean[:, None]) * rstd
    dyg = dy32 * weight.float() if affine else dy32
    dx, dg_rows, db_rows = _bwd_from_xhat(dy32, xhat, dyg, rstd, rms)
    dx = dx.to(src2.dtype)
    if not affine:
        return dx, None, None
    dgamma = dg_rows.sum(0).to(weight.dtype)
    dbeta = None if rms else db_rows.sum(0).to(weight.dtype)
    return dx, dgamma, dbeta


def layer_norm_reference(x, weight=None, bias=None, eps: float = 1e-5):
    """Plain LayerNorm over the last dim in fp32, cast back to ``x``'s
    dtype (``apex_tpu.kernels.layer_norm.layer_norm_reference``)."""
    y, _, _ = _ln_plain(x.reshape(-1, x.shape[-1]), weight, bias, eps,
                        False)
    return y.reshape(x.shape)


def rms_norm_reference(x, weight=None, eps: float = 1e-5):
    """Plain RMSNorm over the last dim in fp32
    (``apex_tpu.kernels.layer_norm.rms_norm_reference``)."""
    y, _, _ = _ln_plain(x.reshape(-1, x.shape[-1]), weight, None, eps,
                        True)
    return y.reshape(x.shape)


# --------------------------------------------------------------- kernel
def _lib():
    lib = _build.load("layer_norm")
    if lib.apex_ln_fwd.argtypes is None:
        lib.apex_ln_fwd.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.apex_ln_fwd.restype = ctypes.c_int
        lib.apex_ln_bwd.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.apex_ln_bwd.restype = ctypes.c_int
        lib.apex_ln_bwd_blocks.argtypes = [ctypes.c_int]
        lib.apex_ln_bwd_blocks.restype = ctypes.c_int
    return lib


def _check_operands(name, x2, weight, bias):
    n, h = x2.shape
    if x2.dtype not in _DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16,"
                        f" got {x2.dtype}")
    if not 0 < h <= _MAX_HIDDEN:
        raise ValueError(f"{name}: hidden {h} not in (0, {_MAX_HIDDEN}]")
    pdtype = x2.dtype if weight is None else weight.dtype
    for nm, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.shape != (h,) or t.dtype != pdtype or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be a contiguous [{h}] "
                             f"{pdtype} tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != x2.device:
            raise ValueError(f"{name}: {nm} on {t.device}, x on "
                             f"{x2.device}")
    if (x2.dtype, pdtype) not in _PAIRS:
        raise TypeError(f"{name}: the CUDA kernel takes (x, weight) dtypes "
                        f"{sorted((str(a), str(b)) for a, b in _PAIRS)}, "
                        f"got ({x2.dtype}, {pdtype})")
    return _DTYPES[x2.dtype], _DTYPES[pdtype]


def _ln_kernel(x2, weight, bias, eps: float, rms: bool):
    n, h = x2.shape
    name = "rms_norm" if rms else "layer_norm"
    dt, pdt = _check_operands(name, x2, weight, bias)
    y = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    # beta without gamma is ignored, as in the plain version
    use_bias = bias is not None and weight is not None and not rms
    err = _lib().apex_ln_fwd(
        x2.data_ptr(), weight.data_ptr() if weight is not None else None,
        bias.data_ptr() if use_bias else None,
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, h, float(eps),
        int(rms), dt, pdt, stream_handle())
    check_launch(name, err)
    launches["layer_norm"] += 1
    return y, mean, rstd


def _ln_bwd_kernel(dy2, src2, weight, bias, mean, rstd, rms: bool,
                   mem_eff: bool):
    n, h = src2.shape
    name = "rms_norm backward" if rms else "layer_norm backward"
    dt, pdt = _check_operands(name, src2, weight, bias)
    if dy2.shape != src2.shape or dy2.dtype != src2.dtype:
        raise ValueError(f"{name}: dy {tuple(dy2.shape)} {dy2.dtype} does "
                         f"not match {tuple(src2.shape)} {src2.dtype}")
    lib = _lib()
    affine = weight is not None
    dx = torch.empty_like(src2)
    dgamma = torch.empty_like(weight) if affine else None
    dbeta = torch.empty_like(weight) if (affine and not rms) else None
    part = torch.empty((2, lib.apex_ln_bwd_blocks(n), h) if affine
                       else (1,), dtype=torch.float32, device=src2.device)
    err = lib.apex_ln_bwd(
        dy2.data_ptr(), src2.data_ptr(),
        weight.data_ptr() if affine else None,
        bias.data_ptr() if (bias is not None and not rms) else None,
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        dgamma.data_ptr() if affine else None,
        dbeta.data_ptr() if dbeta is not None else None, part.data_ptr(),
        n, h, int(rms), int(mem_eff), dt, pdt, stream_handle())
    check_launch(name, err)
    launches["layer_norm_bwd"] += 1
    return dx, dgamma, dbeta


def _fwd(x2, weight, bias, eps, rms):
    if kernel_route("rms_norm" if rms else "layer_norm", x2, weight, bias):
        return _ln_kernel(x2.contiguous(), weight, bias, eps, rms)
    return _ln_plain(x2, weight, bias, eps, rms)


class _LayerNormFn(torch.autograd.Function):
    """The kernels' forward and backward around one row LayerNorm /
    RMSNorm (``_layer_norm``'s custom VJP). Returns ``(y, mean, rstd)``;
    ``mean`` and ``rstd`` carry no gradient."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps, rms, mem_eff):
        y, mean, rstd = _fwd(x2, weight, bias, eps, rms)
        bias_used = None if (rms or weight is None) else bias
        # keep the OUTPUT under memory_efficient (x may die), else the input
        src = y if mem_eff else x2
        ctx.save_for_backward(src, weight, bias_used, mean, rstd)
        ctx.rms, ctx.mem_eff = rms, mem_eff
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        src, weight, bias, mean, rstd = ctx.saved_tensors
        src = src.contiguous()
        dy = dy.contiguous()
        name = "rms_norm" if ctx.rms else "layer_norm"
        if kernel_route(name, dy, src, weight, bias):
            dx, dg, db = _ln_bwd_kernel(dy, src, weight, bias, mean, rstd,
                                        ctx.rms, ctx.mem_eff)
        else:
            dx, dg, db = layer_norm_bwd_reference(
                dy, src, weight, bias, mean, rstd, ctx.rms, ctx.mem_eff)
        if bias is None:
            db = None
        return dx, dg, db, None, None, None


def _norm(x, weight, bias, eps: float, rms: bool, mem_eff: bool):
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    y, mean, rstd = _LayerNormFn.apply(x2, weight, bias, float(eps), rms,
                                       bool(mem_eff))
    return y.reshape(shape), mean.reshape(shape[:-1]), \
        rstd.reshape(shape[:-1])


# ---------------------------------------------------------- public API
def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
               memory_efficient: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over the last dim: ``(y, mean, rstd)`` with ``y`` in
    ``x``'s dtype and ``mean``/``rstd`` fp32 of shape ``x.shape[:-1]``.
    ``weight``/``bias`` are ``[H]`` or None (the non-affine variant); on
    CUDA they share a dtype, ``x``'s or float32 for a bfloat16 ``x``.
    Differentiable in ``x``, ``weight`` and ``bias``;
    ``memory_efficient`` saves ``y`` rather than ``x`` for the backward
    (gamma must be nonzero)."""
    return _norm(x, weight, bias, eps, False, memory_efficient)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5, memory_efficient: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RMSNorm over the last dim: ``(y, mean, rstd)`` as
    :func:`layer_norm`, ``mean`` all zeros (no mean is subtracted)."""
    return _norm(x, weight, None, eps, True, memory_efficient)
