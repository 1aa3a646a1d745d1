"""Tensor-list frontend over the multi-tensor kernels — the port of
``apex_tpu/multi_tensor_apply`` (apex's ``multi_tensor_apply.py``: class
``MultiTensorApply`` and its ``multi_tensor_applier`` instance) plus the
list-level ops of the JAX package.

``multi_tensor_applier(op, noop_flag, tensor_lists, *args)`` calls
``op(noop_flag, tensor_lists, *args)``; the in-place ``amp_C``-style ops
it takes are :func:`~apex_tpu_torch.kernels.multi_tensor.
multi_tensor_scale_` (``tensor_lists = [inputs, outputs]``). The
list-level ops below return new lists, as the JAX package's do:
:func:`multi_tensor_scale` and :func:`multi_tensor_adam` run kernels 21
and 24 on CUDA tensors (their plain versions on CPU tensors);
``multi_tensor_axpby`` (kernel 22), ``multi_tensor_l2norm`` (23) and
``multi_tensor_sgd`` (25) are not ported yet and raise.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import multi_tensor as _k

__all__ = [
    "MultiTensorApply", "multi_tensor_applier", "multi_tensor_scale",
    "multi_tensor_axpby", "multi_tensor_l2norm", "multi_tensor_adam",
    "multi_tensor_sgd", "available",
]

available = True  # apex checks multi_tensor_applier.available


class MultiTensorApply:
    """apex's ``MultiTensorApply``. ``chunk_size`` is kept for apex's
    API; the CUDA harness cuts tensors into its own fixed chunks."""

    available = True

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag_buffer, tensor_lists, *args, **kwargs):
        return op(noop_flag_buffer, tensor_lists, *args, **kwargs)


multi_tensor_applier = MultiTensorApply()


def _flag(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int32, device=like.device)


def multi_tensor_scale(tensors: Sequence[torch.Tensor], scale):
    """``amp_C.multi_tensor_scale`` over a list -> ``(scaled list, each
    in its input's dtype, found_inf)`` with ``found_inf`` a bool."""
    tensors = list(tensors)
    if not tensors:
        return [], False
    outs = [torch.empty_like(t) for t in tensors]
    flag = _flag(tensors[0])
    _k.multi_tensor_scale_(flag, [[t.contiguous() for t in tensors], outs],
                           scale)
    return outs, bool(flag.item())


def multi_tensor_adam(params, exp_avgs, exp_avg_sqs, grads, *, lr, beta1,
                      beta2, eps, step, weight_decay=0.0, adam_w_mode=True):
    """``amp_C.multi_tensor_adam`` over lists -> new ``(params, m, v)``
    lists (the inputs are left as they are); params come back in their
    own dtype, ``m``/``v`` in fp32."""
    p = [t.detach().clone() for t in params]
    m = [t.detach().clone() for t in exp_avgs]
    v = [t.detach().clone() for t in exp_avg_sqs]
    _k.multi_tensor_adam_([[g.contiguous() for g in grads], p, m, v],
                          lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                          weight_decay=weight_decay, step=step,
                          adam_w_mode=adam_w_mode)
    return p, m, v


def multi_tensor_axpby(xs, ys, a, b):
    """``amp_C.multi_tensor_axpby`` — kernel #22, not ported yet."""
    return _k.fused_axpby(xs, ys, a, b)


def multi_tensor_l2norm(tensors, per_tensor: bool = False):
    """``amp_C.multi_tensor_l2norm`` — kernel #23, not ported yet."""
    return _k.fused_l2norm(tensors)


def multi_tensor_sgd(params, momentum_bufs, grads, **kwargs):
    """``amp_C.multi_tensor_sgd`` — kernel #25, not ported yet."""
    return _k.fused_sgd_step(params, momentum_bufs, grads, **kwargs)
