"""Opt-level cast policies — the serving subset of ``amp/policy.py``.

Apex resolves an opt-level string into the properties a model is cast
by. This port keeps that resolution for the two levels the serving path
uses:

- ``O0`` — pure fp32 (the exact engine of the parity checks);
- ``O3`` — pure half, the serving engine's default: every floating
  parameter, LayerNorm's included (apex's ``keep_batchnorm_fp32=False``
  at O3), is stored and computed in ``half_dtype`` (bfloat16).

``O1`` and ``O2`` (per-op casts, fp32 norms and master weights, the loss
scaler) and the keyword overrides come with the training slice; the two
levels raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.log_util import get_logger

__all__ = ["Policy", "resolve_policy"]

_logger = get_logger("amp")

_LEVEL_DOC = {"O0": "Pure FP32.", "O3": "Pure half."}


@dataclasses.dataclass(frozen=True)
class Policy:
    """A resolved opt level: ``cast_model_type`` is the dtype parameters
    and compute are cast to, or None for fp32 (apex's "no cast")."""

    opt_level: str = "O3"
    cast_model_type: Optional[torch.dtype] = torch.bfloat16

    @property
    def compute_dtype(self) -> torch.dtype:
        """Dtype matmul compute runs in under this policy."""
        return self.cast_model_type or torch.float32

    @property
    def param_dtype(self) -> torch.dtype:
        """Dtype the model's parameters are stored in (the compute dtype
        at O0 and O3)."""
        return self.compute_dtype

    def cast_params(self, module: nn.Module) -> nn.Module:
        """Cast ``module``'s floating parameters and buffers IN PLACE to
        :attr:`param_dtype`; returns ``module``."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                if t.is_floating_point():
                    t.data = t.data.to(self.param_dtype)
        return module


def resolve_policy(opt_level: str = "O3",
                   half_dtype: torch.dtype = torch.bfloat16,
                   verbose: bool = True) -> Policy:
    """Resolve an opt level into a frozen :class:`Policy`. Unknown levels
    raise ``ValueError`` (apex's message); ``O1``/``O2`` raise
    ``NotImplementedError`` until the training slice ports them."""
    if opt_level in ("O1", "O2"):
        raise NotImplementedError(
            f"opt level {opt_level} (per-op casts / fp32 master weights) "
            "comes with the training slice of the port; serving uses O0 "
            "or O3")
    if opt_level not in _LEVEL_DOC:
        raise ValueError(
            "Unexpected optimization level {}. Options are 'O0', 'O1', "
            "'O2', 'O3'. Note that in `O0`, `O1`, etc., the prefix O is "
            "the letter O, not the number zero.".format(opt_level))
    policy = Policy(opt_level=opt_level,
                    cast_model_type=half_dtype if opt_level == "O3"
                    else None)
    if verbose:
        _logger.info("%s opt_level=%s cast_model_type=%s",
                     _LEVEL_DOC[opt_level], opt_level,
                     policy.cast_model_type)
    return policy
