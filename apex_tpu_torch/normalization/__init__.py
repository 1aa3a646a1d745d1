"""apex_tpu_torch.normalization — FusedLayerNorm / FusedRMSNorm modules.

Port of ``apex_tpu/normalization/__init__.py``'s ``FusedLayerNorm`` and
``FusedRMSNorm`` over the CUDA LayerNorm kernels
(:mod:`apex_tpu_torch.kernels.layer_norm`), differentiable through
their backward kernel. ``weight``/``bias`` have shape
``normalized_shape`` (apex's state-dict shape); the kernels see them
flat. Statistics are fp32 in every case. Parameters are created in
``param_dtype`` (fp32 by default) and stay fp32 under amp O2, which
casts the activations around them to bf16 (apex's "Mixed" variants:
fp32 params with half I/O).

With ``dtype=None`` an active amp policy decides the I/O dtype
(``resolve_dtype(dtype, "layer_norm")``, as the JAX modules do): under
O1 ``layer_norm`` is an FP32_FUNCS op, so the input is lifted to fp32
and, with O1's fp32 parameters, the kernels run their (fp32, fp32)
instantiation; the next half op casts back down.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from apex_tpu_torch.amp.autocast import resolve_dtype
from apex_tpu_torch.kernels.layer_norm import layer_norm, rms_norm

__all__ = ["FusedLayerNorm", "FusedRMSNorm"]


class _FusedNorm(nn.Module):
    _rms = False

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 memory_efficient: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.eps = float(eps)
        self.memory_efficient = bool(memory_efficient)
        self.dtype = dtype
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=device))
        else:
            self.register_parameter("weight", None)
        if elementwise_affine and not self._rms:
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=param_dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = resolve_dtype(self.dtype, "layer_norm")
        if dtype is not None:
            x = x.to(dtype)
        n = len(self.normalized_shape)
        shape = x.shape
        x2 = x.reshape(shape[:x.ndim - n] + (-1,))
        weight = None if self.weight is None else self.weight.reshape(-1)
        if self._rms:
            y = rms_norm(x2, weight, eps=self.eps,
                         memory_efficient=self.memory_efficient)[0]
        else:
            bias = None if self.bias is None else self.bias.reshape(-1)
            y = layer_norm(x2, weight, bias, eps=self.eps,
                           memory_efficient=self.memory_efficient)[0]
        return y.reshape(shape)


class FusedLayerNorm(_FusedNorm):
    """LayerNorm over the trailing ``normalized_shape`` dims.

    ``dtype=None`` (the default) keeps the input dtype for the I/O —
    unless an active amp policy assigns ``layer_norm`` one (O1: fp32) —
    with fp32 statistics in the kernel; a dtype casts the input to it
    first.
    ``elementwise_affine=False`` is the non-affine variant (no params).
    ``memory_efficient`` keeps the output, not the input, for the
    backward (apex's flag; gamma must stay nonzero).
    """


class FusedRMSNorm(_FusedNorm):
    """RMSNorm over the trailing ``normalized_shape`` dims (a ``weight``,
    no ``bias``); arguments as :class:`FusedLayerNorm`."""

    _rms = True
