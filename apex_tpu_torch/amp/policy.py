"""Opt-level cast policies — the port of ``apex_tpu/amp/policy.py``.

Apex resolves an opt-level string into the properties a model is cast
and trained by (``cast_model_type``, ``keep_batchnorm_fp32``,
``master_weights``, ``loss_scale``); explicit keywords override the
table, and the resolved options are printed as a banner. This port keeps
that table for three levels:

- ``O0`` — pure fp32 training and serving (the exact engine of the
  parity checks);
- ``O2`` — half training: every floating parameter is cast to
  ``half_dtype`` (bfloat16) EXCEPT those whose name holds a norm token
  (``ln``, ``norm``, ``bn``, ...), which stay fp32 (apex's
  ``keep_batchnorm_fp32=True``); the optimizer steps fp32 master
  weights, and the loss is scaled dynamically;
- ``O3`` — pure half, the serving engine's default: every floating
  parameter, LayerNorm's included, in ``half_dtype``.

``O1`` (per-op casts through the op tables: GEMMs in half, norms and
losses in fp32) needs an autocast engine around every op, which the port
does not have yet; it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from apex_tpu_torch.log_util import get_logger

__all__ = ["Policy", "resolve_policy", "is_norm_param", "opt_levels"]

_logger = get_logger("amp")

_NORM_TOKENS = ("bn", "batchnorm", "batch_norm", "batch_stats", "norm", "ln")

# apex/amp/frontend.py's opt_levels, for the ported levels: None means
# "no opinion", as in apex
opt_levels = {
    "O0": dict(cast_model_type=None, keep_batchnorm_fp32=None,
               master_weights=False, loss_scale=1.0),
    "O2": dict(cast_model_type="half", keep_batchnorm_fp32=True,
               master_weights=True, loss_scale="dynamic"),
    "O3": dict(cast_model_type="half", keep_batchnorm_fp32=False,
               master_weights=False, loss_scale=1.0),
}

_LEVEL_DOC = {
    "O0": "Pure FP32 training.",
    "O2": "Half training with FP32 batchnorm and FP32 master weights.",
    "O3": "Pure half training.",
}


def is_norm_param(name: str) -> bool:
    """``default_is_norm_param`` on a module's dotted parameter name:
    True when any segment holds a norm token (``blocks.0.ln_attn.weight``
    does, ``wte.weight`` does not)."""
    return any(tok in seg.lower() for seg in name.split(".")
               for tok in _NORM_TOKENS)


@dataclasses.dataclass(frozen=True)
class Policy:
    """A resolved opt level, with apex's property names:
    ``cast_model_type`` is the dtype parameters and compute are cast to,
    or None for fp32 (apex's "no cast"); ``keep_batchnorm_fp32`` keeps
    norm parameters fp32 when the model is cast; ``master_weights``
    keeps an fp32 copy for the optimizer; ``loss_scale`` is a float or
    ``"dynamic"``."""

    opt_level: str = "O3"
    cast_model_type: Optional[torch.dtype] = torch.bfloat16
    keep_batchnorm_fp32: Optional[bool] = False
    master_weights: bool = False
    loss_scale: Union[float, str] = 1.0

    @property
    def compute_dtype(self) -> torch.dtype:
        """Dtype matmul compute runs in under this policy."""
        return self.cast_model_type or torch.float32

    @property
    def param_dtype(self) -> torch.dtype:
        """Dtype the model's (non-norm) parameters are stored in."""
        return self.compute_dtype

    @property
    def keep_bn_fp32(self) -> bool:
        """Whether norm parameters stay fp32 (apex's default: whenever
        the model is cast to half)."""
        if self.keep_batchnorm_fp32 is None:
            return self.param_dtype != torch.float32
        return bool(self.keep_batchnorm_fp32)

    def cast_params(self, module: nn.Module) -> nn.Module:
        """Cast ``module``'s floating parameters and buffers IN PLACE to
        :attr:`param_dtype`, norm ones (:func:`is_norm_param`) to fp32
        when :attr:`keep_bn_fp32`; returns ``module``."""
        keep = self.keep_bn_fp32 and self.param_dtype != torch.float32
        with torch.no_grad():
            for name, t in list(module.named_parameters()) + list(
                    module.named_buffers()):
                if t.is_floating_point():
                    dtype = torch.float32 if keep and is_norm_param(name) \
                        else self.param_dtype
                    t.data = t.data.to(dtype)
        return module

    def banner(self) -> str:
        """The resolved-options banner apex prints from
        ``frontend.initialize``."""
        lines = [f"Selected optimization level {self.opt_level}",
                 "Defaults for this optimization level are:"]
        for k in ("cast_model_type", "keep_batchnorm_fp32",
                  "master_weights", "loss_scale"):
            lines.append(f"{k:28} : {getattr(self, k)}")
        return "\n".join(lines)


def resolve_policy(opt_level: str = "O3",
                   half_dtype: torch.dtype = torch.bfloat16,
                   loss_scale: Union[float, str, None] = None,
                   verbose: bool = True) -> Policy:
    """Resolve an opt level into a frozen :class:`Policy`; an explicit
    ``loss_scale`` (a float, a numeric string or ``"dynamic"``) beats the
    table's. Unknown levels raise ``ValueError`` (apex's message); ``O1``
    raises ``NotImplementedError``."""
    if opt_level == "O1":
        raise NotImplementedError(
            "opt level O1 casts per op through the amp op tables (GEMMs in "
            "half, norms and losses in fp32); the port has no autocast "
            "engine yet (ROADMAP Queue 1). Use O2 for mixed-precision "
            "training, O0 or O3 otherwise")
    if opt_level not in opt_levels:
        raise ValueError(
            "Unexpected optimization level {}. Options are 'O0', 'O1', "
            "'O2', 'O3'. Note that in `O0`, `O1`, etc., the prefix O is "
            "the letter O, not the number zero.".format(opt_level))
    opts = dict(opt_levels[opt_level])
    if loss_scale is not None:
        opts["loss_scale"] = loss_scale
    ls = opts["loss_scale"]
    if isinstance(ls, str) and ls != "dynamic":
        ls = float(ls)
    policy = Policy(
        opt_level=opt_level,
        cast_model_type=half_dtype if opts["cast_model_type"] == "half"
        else None,
        keep_batchnorm_fp32=opts["keep_batchnorm_fp32"],
        master_weights=bool(opts["master_weights"]),
        loss_scale=ls)
    if verbose:
        _logger.info("%s\n%s", _LEVEL_DOC[opt_level], policy.banner())
    return policy
