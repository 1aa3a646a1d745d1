"""O1 cast-policy op tables — the port of ``apex_tpu/amp/lists.py``
(apex's ``amp/lists/``: ``FP16_FUNCS``, ``FP32_FUNCS``, ``CASTS``,
``SEQUENCE_CASTS``).

Under O1 these decide, per op, whether it runs in half (tensor-core
ops), in fp32 (reductions, losses, norms) or with its floating operands
promoted to the widest. The port does not patch torch call sites: its
policy-aware modules ask :func:`~apex_tpu_torch.amp.autocast.
op_compute_dtype` for the table's dtype at call time. The tables are the
JAX package's, name for name (``torch.autocast``'s own lists differ, so
the port does not use it).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["FP16_FUNCS", "FP32_FUNCS", "CASTS", "SEQUENCE_CASTS",
           "compute_dtype_for", "promote_dtype"]

# Ops that benefit from half (tensor-core) math — apex FP16_FUNCS.
FP16_FUNCS = frozenset({
    "conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d",
    "conv_transpose3d", "conv_tbc", "prelu",
    "addmm", "addmv", "addr", "matmul", "mm", "mv", "bmm", "baddbmm",
    "addbmm", "chain_matmul", "linear", "dot", "einsum",
    "dot_general", "conv_general_dilated",  # the JAX package's spellings
})

# Ops kept in fp32 for range/precision — apex FP32_FUNCS (+ functional /
# loss entries from functional_overrides.py).
FP32_FUNCS = frozenset({
    "acos", "asin", "cosh", "erfinv", "exp", "expm1", "log", "log10", "log2",
    "log1p", "reciprocal", "rsqrt", "sinh", "tan", "pow",
    "softmax", "log_softmax", "cumprod", "cumsum", "dist", "mean", "norm",
    "prod", "std", "sum", "var", "renorm", "logsumexp",
    "cross_entropy", "nll_loss", "l1_loss", "mse_loss", "smooth_l1_loss",
    "kl_div", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "poisson_nll_loss", "cosine_embedding_loss", "hinge_embedding_loss",
    "margin_ranking_loss", "multilabel_margin_loss", "soft_margin_loss",
    "triplet_margin_loss", "ctc_loss",
    "layer_norm", "group_norm", "instance_norm", "batch_norm",
    "gelu",  # kept half in some vintages; fp32 is the safe classification
})

# Ops whose operands are promoted to the widest input dtype — apex CASTS.
CASTS = frozenset({
    "addcdiv", "addcmul", "atan2", "cross", "bilinear",
    "add", "div", "mul", "sub", "eq", "ne", "lt", "le", "gt", "ge",
    "equal", "cat", "stack", "index_put",
})

# Sequence-of-tensors variants promoted elementwise — apex SEQUENCE_CASTS.
SEQUENCE_CASTS = frozenset({"cat", "stack", "concatenate"})


def compute_dtype_for(op_name: str,
                      half_dtype: torch.dtype = torch.bfloat16
                      ) -> Optional[torch.dtype]:
    """The compute dtype O1 assigns to ``op_name``: ``half_dtype`` for
    FP16_FUNCS, fp32 for FP32_FUNCS, None ("no opinion") otherwise."""
    if op_name in FP16_FUNCS:
        return half_dtype
    if op_name in FP32_FUNCS:
        return torch.float32
    return None


def promote_dtype(*dtypes) -> Optional[torch.dtype]:
    """The widest floating dtype among ``dtypes`` (apex's CASTS
    promotion: fp16 < fp32 < fp64); non-floating ones are skipped, and
    None comes back when there is no floating dtype."""
    result = None
    for d in dtypes:
        if d is None or not d.is_floating_point:
            continue
        result = d if result is None else torch.promote_types(result, d)
    return result
