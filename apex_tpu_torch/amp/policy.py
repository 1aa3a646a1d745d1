"""Opt-level cast policies — the port of ``apex_tpu/amp/policy.py``.

Apex resolves an opt-level string into the properties a model is cast
and trained by (``cast_model_type``, ``patch_torch_functions``,
``keep_batchnorm_fp32``, ``master_weights``, ``loss_scale``); explicit
keywords override the table, and the resolved options are printed as a
banner. This port keeps that table for the four levels:

- ``O0`` — pure fp32 training and serving (the exact engine of the
  parity checks);
- ``O1`` — per-op casts through the op tables (:mod:`.lists`): the
  parameters stay fp32; under :func:`~apex_tpu_torch.amp.autocast.
  autocast` GEMMs run in ``half_dtype`` (bfloat16) and norms, softmax
  and losses in fp32 (:meth:`Policy.op_dtype`); no master weights, and
  the loss is scaled dynamically;
- ``O2`` — half training: every floating parameter is cast to
  ``half_dtype`` (bfloat16) EXCEPT those whose name holds a norm token
  (``ln``, ``norm``, ``bn``, ...), which stay fp32 (apex's
  ``keep_batchnorm_fp32=True``); the optimizer steps fp32 master
  weights, and the loss is scaled dynamically;
- ``O3`` — pure half, the serving engine's default: every floating
  parameter, LayerNorm's included, in ``half_dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from apex_tpu_torch.log_util import get_logger

from . import lists

__all__ = ["Policy", "resolve_policy", "is_norm_param", "opt_levels"]

_logger = get_logger("amp")

_NORM_TOKENS = ("bn", "batchnorm", "batch_norm", "batch_stats", "norm", "ln")

# apex/amp/frontend.py's opt_levels: None means "no opinion", as in apex
opt_levels = {
    "O0": dict(cast_model_type=None, patch_torch_functions=False,
               keep_batchnorm_fp32=None, master_weights=False,
               loss_scale=1.0),
    "O1": dict(cast_model_type=None, patch_torch_functions=True,
               keep_batchnorm_fp32=None, master_weights=None,
               loss_scale="dynamic"),
    "O2": dict(cast_model_type="half", patch_torch_functions=False,
               keep_batchnorm_fp32=True, master_weights=True,
               loss_scale="dynamic"),
    "O3": dict(cast_model_type="half", patch_torch_functions=False,
               keep_batchnorm_fp32=False, master_weights=False,
               loss_scale=1.0),
}

_LEVEL_DOC = {
    "O0": "Pure FP32 training.",
    "O1": "Insert automatic casts around ops (op-table policy).",
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
    or None for fp32 (apex's "no cast"); ``patch_torch_functions`` is
    O1's per-op cast policy (:meth:`op_dtype`); ``keep_batchnorm_fp32``
    keeps norm parameters fp32 when the model is cast;
    ``master_weights`` keeps an fp32 copy for the optimizer;
    ``loss_scale`` is a float or ``"dynamic"``; ``half_dtype`` is what
    "half" means (bfloat16)."""

    opt_level: str = "O3"
    cast_model_type: Optional[torch.dtype] = torch.bfloat16
    keep_batchnorm_fp32: Optional[bool] = False
    master_weights: bool = False
    loss_scale: Union[float, str] = 1.0
    patch_torch_functions: bool = False
    half_dtype: torch.dtype = torch.bfloat16

    @property
    def compute_dtype(self) -> torch.dtype:
        """Dtype matmul compute runs in under this policy (O1: the half
        dtype of its FP16_FUNCS ops)."""
        if self.cast_model_type is not None:
            return self.cast_model_type
        if self.patch_torch_functions:
            return self.half_dtype
        return torch.float32

    @property
    def param_dtype(self) -> torch.dtype:
        """Dtype the model's (non-norm) parameters are stored in."""
        return self.cast_model_type or torch.float32

    @property
    def model_dtype(self) -> Optional[torch.dtype]:
        """A module's blanket compute dtype: None under O1 (modules
        resolve per op through the autocast engine), the compute dtype
        otherwise."""
        if self.patch_torch_functions:
            return None
        return self.compute_dtype

    def op_dtype(self, op_name: str, *operand_dtypes
                 ) -> Optional[torch.dtype]:
        """Per-op compute dtype — the O1 engine's core. Only O1
        (``patch_torch_functions``) has opinions: FP16_FUNCS run in
        ``half_dtype``, FP32_FUNCS in fp32, CASTS promote to the widest
        floating operand; O0/O2/O3 return None (the model dtype
        governs)."""
        if not self.patch_torch_functions:
            return None
        d = lists.compute_dtype_for(op_name, self.half_dtype)
        if d is not None:
            return d
        if op_name in lists.CASTS or op_name in lists.SEQUENCE_CASTS:
            return lists.promote_dtype(*operand_dtypes)
        return None

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
        for k in ("cast_model_type", "patch_torch_functions",
                  "keep_batchnorm_fp32", "master_weights", "loss_scale"):
            lines.append(f"{k:28} : {getattr(self, k)}")
        return "\n".join(lines)


def resolve_policy(opt_level: str = "O3",
                   half_dtype: torch.dtype = torch.bfloat16,
                   loss_scale: Union[float, str, None] = None,
                   verbose: bool = True) -> Policy:
    """Resolve an opt level into a frozen :class:`Policy`; an explicit
    ``loss_scale`` (a float, a numeric string or ``"dynamic"``) beats the
    table's. Unknown levels raise ``ValueError`` (apex's message)."""
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
        loss_scale=ls, patch_torch_functions=bool(
            opts["patch_torch_functions"]), half_dtype=half_dtype)
    if verbose:
        _logger.info("%s\n%s", _LEVEL_DOC[opt_level], policy.banner())
    return policy
