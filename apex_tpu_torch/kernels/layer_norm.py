"""Fused LayerNorm / RMSNorm forward: CUDA kernel + plain PyTorch version.

Port of ``apex_tpu/kernels/layer_norm.py`` (the ``_ln_fwd_kernel`` Pallas
body). The kernel is ``csrc/layer_norm.cu``: one warp per row, fp32
statistics whatever the I/O dtype, ``y`` in the I/O dtype plus ``mean``
and ``rstd`` (fp32) per row — the residuals the TPU forward saves for its
backward.

Forward only: the backward (``_ln_bwd_kernel``) and ``memory_efficient``
come with the training slice, so a CUDA input that requires grad while
autograd is recording raises here rather than silently losing its
gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, check_launch, kernel_route, launches, stream_handle

__all__ = ["layer_norm", "rms_norm", "layer_norm_reference",
           "rms_norm_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
def _ln_kernel(x2, weight, bias, eps: float, rms: bool):
    n, h = x2.shape
    name = "rms_norm" if rms else "layer_norm"
    if x2.dtype not in _DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16,"
                        f" got {x2.dtype}")
    if not 0 < h <= _MAX_HIDDEN:
        raise ValueError(f"{name}: hidden {h} not in (0, {_MAX_HIDDEN}]")
    for nm, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.shape != (h,) or t.dtype != x2.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be a contiguous [{h}] "
                             f"{x2.dtype} tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != x2.device:
            raise ValueError(f"{name}: {nm} on {t.device}, x on "
                             f"{x2.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, weight, bias)):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward-only — its backward comes "
            "with the training slice; run under torch.no_grad() / "
            "inference_mode()")
    y = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    lib = _lib()
    err = lib.apex_ln_fwd(
        x2.data_ptr(), weight.data_ptr() if weight is not None else None,
        bias.data_ptr() if (bias is not None and not rms) else None,
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, h, float(eps),
        int(rms), _DTYPES[x2.dtype], stream_handle())
    check_launch(name, err)
    launches["layer_norm"] += 1
    return y, mean, rstd


def _lib():
    lib = _build.load("layer_norm")
    fn = lib.apex_ln_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _norm(x, weight, bias, eps: float, rms: bool):
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if kernel_route("rms_norm" if rms else "layer_norm", x2, weight, bias):
        y, mean, rstd = _ln_kernel(x2.contiguous(), weight, bias, eps, rms)
    else:
        y, mean, rstd = _ln_plain(x2, weight, bias, eps, rms)
    return y.reshape(shape), mean.reshape(shape[:-1]), \
        rstd.reshape(shape[:-1])


# ---------------------------------------------------------- public API
def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over the last dim: ``(y, mean, rstd)`` with ``y`` in
    ``x``'s dtype and ``mean``/``rstd`` fp32 of shape ``x.shape[:-1]``.
    ``weight``/``bias`` are ``[H]`` or None (the non-affine variant); on
    CUDA they must have ``x``'s dtype (float32 or bfloat16)."""
    return _norm(x, weight, bias, eps, False)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RMSNorm over the last dim: ``(y, mean, rstd)`` as
    :func:`layer_norm`, ``mean`` all zeros (no mean is subtracted)."""
    return _norm(x, weight, None, eps, True)
