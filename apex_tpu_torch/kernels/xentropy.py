"""Fused softmax cross-entropy with label smoothing: CUDA kernels + plain
PyTorch versions.

Port of ``apex_tpu/kernels/xentropy.py``. :func:`softmax_cross_entropy_loss`
is apex's ``SoftmaxCrossEntropyLoss``: per-row losses of ``logits [...,
V]`` (fp32 or bf16) against integer ``labels [...]``, in fp32. As the JAX
custom VJP (``_xent``), the forward saves only ``(logits, labels, lse)``,
never the softmax; the backward recomputes it. The kernels are
``csrc/xentropy.cu`` (one block per row, the row read once):

- forward (``_fwd_kernel``): ``lse`` by an online max / sum-exp and
  ``loss = (1 - s) * (lse - x[y]) - s * mean(x - lse)``;
- backward (``_bwd_kernel``): ``dlogits = g * (softmax - ((1 - s) *
  onehot + s / V))`` in the logits' dtype.

Out-of-range labels (ignore-index ``-100``, ids ``>= V``) give a NaN loss
and no onehot gradient — only the smoothing term ``g * s * (softmax -
1/V)`` flows — on every path; mask the returned losses to ignore them.

The JAX function takes its jnp reference when ``V % 128 != 0`` (GPT-2's
50257) or for dtypes Mosaic cannot take; the CUDA kernels take any ``V``
and ``N``, fp32 or bf16, so on the card the function always runs them.
The function is the same either way.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, check_launch, kernel_route, launches, stream_handle

__all__ = ["softmax_cross_entropy_loss", "xent_reference",
           "xent_fwd_reference", "xent_bwd_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = torch.float32


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a Python float."""
    return float(torch.tensor(x, dtype=_F32))


# ---------------------------------------------------------------- plain
def xent_reference(logits, labels, smoothing: float = 0.0):
    """Per-row cross-entropy in fp32 (apex ``SoftmaxCrossEntropyLoss``
    semantics): ``(1 - s) * nll - s * mean(logp)``.

    Out-of-range labels (ignore-index ``-100``, ids ``>= V``) give a NaN
    loss and no onehot gradient — explicitly, never a wrapped index;
    mask the returned losses to ignore such rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = (labels >= 0) & (labels < logp.shape[-1])
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.full_like(nll, float("nan")))
    if smoothing > 0.0:
        return (1.0 - smoothing) * nll - smoothing * logp.mean(-1)
    return nll


def _valid_safe(labels, v):
    valid = (labels >= 0) & (labels < v)
    return valid, torch.where(valid, labels, torch.zeros_like(labels)).long()


def xent_fwd_reference(logits2, labels, smoothing: float = 0.0):
    """The plain forward over rows ``logits2 [N, V]``: ``(loss, lse)``
    in fp32, with ``_fwd_kernel``'s arithmetic (``lse`` then ``nll = lse
    - x[y]``, NaN for an out-of-range label)."""
    x = logits2.float()
    v = x.shape[-1]
    lse = torch.logsumexp(x, -1)
    valid, safe = _valid_safe(labels, v)
    nll = lse - x.gather(-1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.full_like(nll, float("nan")))
    if smoothing > 0.0:
        mean_logp = (x - lse[:, None]).mean(-1)
        return (_f32(1.0 - smoothing) * nll
                - _f32(smoothing) * mean_logp), lse
    return nll, lse


def xent_bwd_reference(logits2, labels, lse, g, smoothing: float = 0.0):
    """The plain backward (``_bwd_kernel``): ``dlogits [N, V]`` in the
    logits' dtype from the forward's ``lse`` and the per-row upstream
    gradient ``g`` (fp32 ``[N]``)."""
    x = logits2.float()
    n, v = x.shape
    softmax = torch.exp(x - lse[:, None])
    valid, safe = _valid_safe(labels, v)
    onehot = torch.zeros_like(x).scatter_(
        1, safe[:, None], valid[:, None].to(_F32))
    if smoothing > 0.0:
        target = onehot * _f32(1.0 - smoothing) + _f32(smoothing / v)
        inv_dl = _f32(smoothing) * (softmax - _f32(1.0 / v))
    else:
        target = onehot
        inv_dl = torch.zeros_like(softmax)
    dl = torch.where(valid[:, None], softmax - target, inv_dl)
    return (dl * g.float()[:, None]).to(logits2.dtype)


# --------------------------------------------------------------- kernel
def _lib():
    lib = _build.load("xentropy")
    if lib.apex_xent_fwd.argtypes is None:
        lib.apex_xent_fwd.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        lib.apex_xent_fwd.restype = ctypes.c_int
        lib.apex_xent_bwd.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
        lib.apex_xent_bwd.restype = ctypes.c_int
    return lib


def _check(name, logits2, labels):
    if logits2.dtype not in _DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16 "
                        f"logits, got {logits2.dtype}")
    if labels.shape != logits2.shape[:1] or labels.device != logits2.device:
        raise ValueError(f"{name}: labels {tuple(labels.shape)} on "
                         f"{labels.device} for logits "
                         f"{tuple(logits2.shape)} on {logits2.device}")
    if logits2.shape[0] < 1 or logits2.shape[1] < 1:
        raise ValueError(f"{name}: empty logits {tuple(logits2.shape)}")


def xent_fwd_kernel(logits2, labels, smoothing: float = 0.0):
    """Kernel 11 on CUDA rows ``logits2 [N, V]`` (contiguous) and int64
    ``labels [N]``: ``(loss, lse)`` fp32."""
    _check("softmax_cross_entropy_loss", logits2, labels)
    n, v = logits2.shape
    loss = torch.empty(n, dtype=_F32, device=logits2.device)
    lse = torch.empty(n, dtype=_F32, device=logits2.device)
    err = _lib().apex_xent_fwd(
        logits2.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), n, v, _DTYPES[logits2.dtype], _f32(smoothing),
        _f32(1.0 - smoothing), stream_handle())
    check_launch("softmax_cross_entropy_loss", err)
    launches["xent_fwd"] += 1
    return loss, lse


def xent_bwd_kernel(logits2, labels, lse, g, smoothing: float = 0.0):
    """Kernel 12: ``dlogits [N, V]`` in the logits' dtype (all operands
    contiguous CUDA tensors; ``lse``, ``g`` fp32 ``[N]``)."""
    name = "softmax_cross_entropy_loss backward"
    _check(name, logits2, labels)
    n, v = logits2.shape
    for nm, t in (("lse", lse), ("g", g)):
        if t.shape != (n,) or t.dtype != _F32 or t.device != logits2.device:
            raise ValueError(f"{name}: {nm} must be fp32 [{n}] on "
                             f"{logits2.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    dlogits = torch.empty_like(logits2)
    s = float(smoothing)
    on_label = _f32(_f32(1.0 - s) + _f32(s / v)) if s > 0.0 else 1.0
    err = _lib().apex_xent_bwd(
        logits2.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dlogits.data_ptr(), n, v, _DTYPES[logits2.dtype], _f32(s), on_label,
        _f32(s / v) if s > 0.0 else 0.0, _f32(1.0 / v), stream_handle())
    check_launch(name, err)
    launches["xent_bwd"] += 1
    return dlogits


class _XentFn(torch.autograd.Function):
    """Kernels 11 and 12 around one row cross-entropy (``_xent``'s custom
    VJP): saves ``(logits, labels, lse)`` only."""

    @staticmethod
    def forward(ctx, logits2, labels, smoothing):
        if kernel_route("softmax_cross_entropy_loss", logits2, labels):
            loss, lse = xent_fwd_kernel(logits2, labels, smoothing)
        else:
            loss, lse = xent_fwd_reference(logits2, labels, smoothing)
        ctx.save_for_backward(logits2, labels, lse)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        logits2, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if kernel_route("softmax_cross_entropy_loss", logits2, labels, g):
            d = xent_bwd_kernel(logits2, labels, lse, g, ctx.smoothing)
        else:
            d = xent_bwd_reference(logits2, labels, lse, g, ctx.smoothing)
        return d, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0) -> torch.Tensor:
    """Per-example fused cross-entropy: ``logits [..., V]`` (fp32 or
    bf16), integer ``labels [...]`` -> fp32 losses ``[...]``.
    Differentiable in ``logits``. Reference: apex
    ``contrib/xentropy/softmax_xentropy.py`` — ``SoftmaxCrossEntropyLoss
    (logits, labels, smoothing)``.

    Out-of-range labels (ignore-index ``-100``, ids ``>= V``) give a NaN
    loss and drop the onehot gradient; to ignore such positions, mask
    the losses before reducing: ``torch.where(labels != -100, losses,
    0.0)``."""
    shape = logits.shape[:-1]
    v = logits.shape[-1]
    lg2 = logits.reshape(-1, v).contiguous()
    lb = labels.reshape(-1).to(torch.int64).contiguous()
    return _XentFn.apply(lg2, lb, float(smoothing)).reshape(shape)
