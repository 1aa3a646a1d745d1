"""Fused LM-head projection + softmax cross-entropy, chunked over vocab.

Port of ``apex_tpu/kernels/lm_head_loss.py`` (``_fused_fwd`` /
``_fused_bwd``). The ``[N, V]`` logits are never held whole: the forward
streams vocab chunks through the head GEMM and carries an online
logsumexp (running max, rebased sum) plus the label logit and the logit
sum for label smoothing; the backward recomputes each chunk's logits
from the saved ``lse`` and feeds that chunk's ``dlogits`` straight into
the ``dW`` and ``dx`` GEMMs. The JAX package runs no Pallas kernel here
(XLA GEMMs in a scan), so the port's GEMMs are ``torch.matmul``.

Numerics follow the JAX op:

- GEMM inputs are rounded to ``compute_dtype`` and the logits are fp32.
  JAX multiplies the ``compute_dtype`` operands with an fp32 accumulator
  (``preferred_element_type``). A bf16 ``torch.matmul`` would round the
  logits to bf16, which moves the loss by ~1e-2, so the port runs an
  fp32 GEMM on the chunk's operands upcast from ``compute_dtype``: the
  same products, exactly representable, accumulated in fp32.
- ``dlogits`` are rounded to ``compute_dtype`` before the ``dW`` and
  ``dx`` GEMMs; ``dx`` accumulates in fp32 across chunks and ``dW`` is
  written once per chunk.
- Out-of-range labels give a NaN loss and no onehot gradient (only the
  smoothing term flows), as ``xent_reference``.

The vocab is cut into ``ceil(V / chunk)`` chunks. JAX zero-pads the last
one to full width and masks its pad columns to -inf; a pad column then
adds exactly 0 to every sum and max, so the port computes the last chunk
at its real width instead, the same arithmetic without the pad GEMM.
``axis_name`` (vocab-parallel heads) is a later slice and raises.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.log_util import get_logger

from .xentropy import xent_reference

__all__ = ["lm_head_xentropy", "lm_head_xent_reference"]

_logger = get_logger("kernels.lm_head_loss")

# the JAX op's clamps on the chunk count and the auto-widened chunk
_MAX_UNROLLED_CHUNKS = 64
_MAX_WIDENED_CHUNK = 8192


def lm_head_xent_reference(x, kernel, labels, smoothing: float = 0.0,
                           compute_dtype=None):
    """The unfused composition the fused op is held against: fp32
    ``logits = x @ kernel.T`` on ``compute_dtype``-rounded inputs, then
    :func:`xent_reference`."""
    cd = compute_dtype or x.dtype
    logits = torch.matmul(x.to(cd).float(), kernel.to(cd).float().t())
    return xent_reference(logits, labels, smoothing)


def _pick_chunk(v: int, chunk: int) -> int:
    """``_pick_chunk``: the requested chunk floored to a multiple of 128
    (at least 128) and clamped to the 128-padded vocab; raised, with a
    warning, when it would cut the vocab into more than 64 chunks, but
    never beyond ``max(chunk, 8192)``."""
    c = max(128, min(chunk, v + (-v) % 128))
    c -= c % 128
    nc = -(-v // c)
    if nc > _MAX_UNROLLED_CHUNKS:
        c_min = -(-v // _MAX_UNROLLED_CHUNKS)
        widened = c_min + (-c_min) % 128
        ceiling = max(c, _MAX_WIDENED_CHUNK)
        if widened <= ceiling:
            _logger.warning(
                "lm_head_xentropy chunk=%d at vocab %d would take %d GEMM "
                "chunks; raising the chunk to %d (%d chunks). Pass "
                "chunk>=%d explicitly to silence.", c, v, nc, widened,
                -(-v // widened), widened)
            c = widened
        else:
            _logger.warning(
                "lm_head_xentropy vocab %d cannot keep the chunk count <= "
                "%d at any chunk up to %d; using chunk=%d (%d chunks).",
                v, _MAX_UNROLLED_CHUNKS, ceiling, ceiling,
                -(-v // ceiling))
            c = ceiling
    return c


def _chunks(v: int, chunk: int):
    for off in range(0, v, chunk):
        yield off, min(chunk, v - off)


def _label_logit(lg, labels, off: int, width: int):
    """Each row's logit at its label when the label falls in this chunk,
    else 0 (the masked sum of the JAX op, one term per row)."""
    inside = (labels >= off) & (labels < off + width)
    idx = torch.where(inside, labels - off, torch.zeros_like(labels))
    picked = lg.gather(1, idx[:, None])[:, 0]
    return torch.where(inside, picked, torch.zeros_like(picked)), inside, idx


class _LMHeadFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, labels, smoothing, chunk, cd):
        n = x.shape[0]
        v = kernel.shape[0]
        xc = x.to(cd).float()
        f32 = dict(dtype=torch.float32, device=x.device)
        m = torch.full((n,), float("-inf"), **f32)
        s = torch.zeros(n, **f32)
        zy = torch.zeros(n, **f32)
        slg = torch.zeros(n, **f32)
        for off, width in _chunks(v, chunk):
            wc = kernel[off:off + width].to(cd).float()
            lg = torch.matmul(xc, wc.t())                   # [N, C] fp32
            m2 = torch.maximum(m, lg.amax(-1))
            s = s * torch.exp(m - m2) + torch.exp(lg - m2[:, None]).sum(-1)
            zy = zy + _label_logit(lg, labels, off, width)[0]
            slg = slg + lg.sum(-1)
            m = m2
        lse = m + torch.log(s)
        nll = lse - zy
        if smoothing > 0.0:
            loss = (1.0 - smoothing) * nll - smoothing * (slg / v - lse)
        else:
            loss = nll
        valid = (labels >= 0) & (labels < v)
        loss = torch.where(valid, loss, torch.full_like(loss, float("nan")))
        ctx.save_for_backward(x, kernel, labels, lse)
        ctx.smoothing, ctx.chunk, ctx.cd = smoothing, chunk, cd
        return loss

    @staticmethod
    def backward(ctx, g):
        x, kernel, labels, lse = ctx.saved_tensors
        smoothing, chunk, cd = ctx.smoothing, ctx.chunk, ctx.cd
        v = kernel.shape[0]
        xc = x.to(cd).float()
        g32 = g.float()[:, None]
        valid = ((labels >= 0) & (labels < v))[:, None]
        # the JAX op's fp32 targets: s / V off the label, (1 - s) + s / V
        # on it
        floor = torch.tensor(smoothing / v, dtype=torch.float32)
        on_label = (torch.tensor(1.0 - smoothing, dtype=torch.float32)
                    + floor).item()
        floor = floor.item()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty_like(kernel)
        for off, width in _chunks(v, chunk):
            wc = kernel[off:off + width].to(cd).float()
            p = torch.matmul(xc, wc.t()).sub_(lse[:, None]).exp_()
            _, inside, idx = _label_logit(p, labels, off, width)
            hit = torch.zeros_like(p, dtype=torch.bool).scatter_(
                1, idx[:, None], inside[:, None])
            if smoothing > 0.0:
                target = torch.where(hit, on_label, floor)
                inv_dl = smoothing * (p - 1.0 / v)
            else:
                target = hit.float()
                inv_dl = torch.zeros((), dtype=torch.float32,
                                     device=x.device)
            dl = torch.where(valid, p - target, inv_dl) * g32
            dlc = dl.to(cd).float()
            dw[off:off + width] = torch.matmul(dlc.t(), xc).to(kernel.dtype)
            dx += torch.matmul(dlc, wc)
        return dx.to(x.dtype), dw, None, None, None, None


def lm_head_xentropy(x: torch.Tensor, kernel: torch.Tensor,
                     labels: torch.Tensor, *, smoothing: float = 0.0,
                     chunk: int = 8192, compute_dtype=None,
                     axis_name=None) -> torch.Tensor:
    """Per-example CE of ``softmax(x @ kernel.T)`` without holding the
    logits. ``x [..., H]`` hidden states, ``kernel [V, H]`` vocab-major
    head weight (the tied embedding table), ``labels [...]`` int targets.
    Returns fp32 losses shaped like ``labels``, differentiable in ``x``
    and ``kernel``. ``compute_dtype`` (default ``x.dtype``) is the GEMM
    input dtype; logits and loss math are fp32 on every path."""
    if axis_name is not None:
        raise NotImplementedError(
            "lm_head_xentropy(axis_name=...) is the vocab-parallel head of "
            "the model-parallel tiers, a later slice of the port (ROADMAP "
            "Queue 3)")
    if not 0.0 <= smoothing < 1.0:
        raise ValueError(f"smoothing must be in [0, 1), got {smoothing}")
    h = x.shape[-1]
    v, hk = kernel.shape
    if hk != h:
        raise ValueError(f"kernel must be [V, H={h}] vocab-major, got "
                         f"{tuple(kernel.shape)}")
    shape = x.shape[:-1]
    if labels.shape != shape:
        raise ValueError(f"labels shape {tuple(labels.shape)} != x leading "
                         f"dims {tuple(shape)}")
    cd = compute_dtype or x.dtype
    n = labels.numel()
    if n == 0:
        return lm_head_xent_reference(x, kernel, labels, smoothing, cd)
    loss = _LMHeadFn.apply(x.reshape(n, h), kernel,
                           labels.reshape(n).long(), float(smoothing),
                           _pick_chunk(v, chunk), cd)
    return loss.reshape(shape)
