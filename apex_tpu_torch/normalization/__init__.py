"""apex_tpu_torch.normalization — the FusedLayerNorm module.

Port of ``apex_tpu/normalization/__init__.py``'s ``FusedLayerNorm`` over
the CUDA LayerNorm kernel (:mod:`apex_tpu_torch.kernels.layer_norm`).
``weight``/``bias`` have shape ``normalized_shape`` (apex's state-dict
shape); the kernel sees them flat. Statistics are fp32 in every case.
``FusedRMSNorm`` and ``memory_efficient`` come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from apex_tpu_torch.kernels.layer_norm import layer_norm

__all__ = ["FusedLayerNorm"]


class FusedLayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims.

    ``dtype=None`` (the default) keeps the input dtype for the I/O, with
    fp32 statistics in the kernel; a dtype casts the input to it first.
    ``elementwise_affine=False`` is the non-affine variant (no params).
    """

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.eps = float(eps)
        self.dtype = dtype
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=device))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=param_dtype, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        n = len(self.normalized_shape)
        shape = x.shape
        x2 = x.reshape(shape[:x.ndim - n] + (-1,))
        weight = None if self.weight is None else self.weight.reshape(-1)
        bias = None if self.bias is None else self.bias.reshape(-1)
        return layer_norm(x2, weight, bias, eps=self.eps)[0].reshape(shape)

