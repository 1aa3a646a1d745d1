"""Softmax cross-entropy with label smoothing: the plain version.

Port of ``apex_tpu/kernels/xentropy.py``'s ``xent_reference``, which the
fused LM-head loss (:mod:`.lm_head_loss`) is held against. The fused
``softmax_cross_entropy_loss`` and its two kernels (forward and
backward, #11 and #12) are the next slice of the port (ROADMAP).
"""

from __future__ import annotations

import torch

__all__ = ["xent_reference"]


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
