"""Dynamic loss scaling — the port of ``apex_tpu/amp/scaler.py``.

Apex's ``LossScaler("dynamic")`` starts at ``min(max_loss_scale,
2**16)``, doubles after ``scale_window`` (2000) consecutive clean steps,
halves on overflow (floored at ``min_loss_scale``), and resets the
clean-step counter in both cases; ``hysteresis`` (Megatron's
``DynamicGradScaler``) tolerates that many overflows before backing
off. ``unscale`` multiplies grads by ``1/scale`` into fp32 master grads
and reports ``found_inf`` — on CUDA through multi-tensor kernel #21, one
host read of its flag per step: on overflow the step is skipped and the
optimizer state does not advance.

As in the JAX package the scaler is a value (:class:`ScalerState`) that
:func:`update_scale` replaces, so a train step carries it. The scale is
a 0-dim fp32 tensor and every update is the JAX package's fp32
arithmetic, step for step.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple, Union

import torch

from apex_tpu_torch.kernels.multi_tensor import multi_tensor_scale_

__all__ = ["ScalerState", "init_scaler", "scale_loss", "unscale",
           "update_scale"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ScalerState:
    """Loss-scaler state: ``loss_scale`` (fp32 0-dim CPU tensor), the
    clean-step count since the last change (``unskipped``), the number of
    :func:`update_scale` calls (``steps``) and overflows seen
    (``overflows``), and the overflows still tolerated before the next
    backoff (``hysteresis_left``); then the static configuration."""

    loss_scale: torch.Tensor
    unskipped: int = 0
    steps: int = 0
    overflows: int = 0
    hysteresis_left: int = 1
    dynamic: bool = True
    scale_factor: float = 2.0
    scale_window: int = 2000
    min_loss_scale: float = 0.0
    max_loss_scale: float = 2.0 ** 24
    hysteresis: int = 1

    def replace(self, **kw) -> "ScalerState":
        return dataclasses.replace(self, **kw)


def init_scaler(loss_scale: Union[float, str] = "dynamic",
                init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                scale_window: int = 2000,
                min_loss_scale: Optional[float] = None,
                max_loss_scale: float = 2.0 ** 24,
                hysteresis: int = 1) -> ScalerState:
    """A :class:`ScalerState` with ``LossScaler.__init__``'s defaults:
    ``"dynamic"`` starts at ``min(max_loss_scale, init_scale)``, a float
    is a static scale."""
    dynamic = isinstance(loss_scale, str) and loss_scale == "dynamic"
    scale = min(max_loss_scale, init_scale) if dynamic else float(loss_scale)
    if hysteresis < 1:
        raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
    return ScalerState(
        loss_scale=torch.tensor(scale, dtype=_F32),
        hysteresis_left=int(hysteresis), dynamic=dynamic,
        scale_factor=float(scale_factor), scale_window=int(scale_window),
        min_loss_scale=0.0 if min_loss_scale is None
        else float(min_loss_scale),
        max_loss_scale=float(max_loss_scale), hysteresis=int(hysteresis))


def scale_loss(loss: torch.Tensor, state: ScalerState) -> torch.Tensor:
    """``loss * scale`` in the loss's dtype."""
    return loss * state.loss_scale.to(device=loss.device, dtype=loss.dtype)


def unscale(grads: Iterable[Optional[torch.Tensor]], state: ScalerState,
            out_dtype: torch.dtype = _F32
            ) -> Tuple[List[Optional[torch.Tensor]], bool]:
    """``grads * (1/scale)`` in ``out_dtype`` (fp32 master grads), and
    ``found_inf``: whether any gradient holds an inf or a NaN. ``None``
    entries (parameters without a gradient) pass through.

    On CUDA gradients this is multi-tensor kernel #21
    (``amp_C.multi_tensor_scale``, the JAX package's ``fused_scale``):
    one launch per gradient dtype writes every output — views of one
    new ``out_dtype`` buffer — and sets one device flag, which the host
    reads once. On CPU tensors it is the plain version, tensor by
    tensor."""
    # the fp32 reciprocal, exact as a Python float: the multiply runs in
    # fp32 on the gradient's device with no scalar copy
    inv = float((1.0 / state.loss_scale).to(_F32))
    grads = list(grads)
    present = [g for g in grads if g is not None]
    if not present:
        return grads, False
    dev = present[0].device
    sizes = [g.numel() for g in present]
    pieces = iter(torch.split(torch.empty(sum(sizes), dtype=out_dtype,
                                          device=dev), sizes))
    out = [None if g is None else next(pieces).view(g.shape) for g in grads]
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    multi_tensor_scale_(flag, [[g.contiguous() for g in present],
                               [o for o in out if o is not None]], inv)
    return out, bool(flag.item())


def update_scale(state: ScalerState, found_inf: bool) -> ScalerState:
    """The post-step schedule (``scaler.py`` ``update_scale``):

    overflow: spend one hysteresis point; once none are left the scale
    halves (floored at ``min_loss_scale``, else the smallest normal
    fp32); ``unskipped = 0``.
    clean: ``unskipped += 1``; at ``scale_window`` the scale doubles
    (capped at ``max_loss_scale``), ``unskipped = 0`` and the hysteresis
    refills.
    Static scalers keep their scale and still count."""
    found_inf = bool(found_inf)
    hyst = state.hysteresis_left
    scale = state.loss_scale
    if state.dynamic:
        if found_inf:
            hyst = max(hyst - 1, 0)
        if found_inf and hyst <= 0:
            floor = torch.tensor(state.min_loss_scale
                                 if state.min_loss_scale
                                 else torch.finfo(_F32).tiny, dtype=_F32)
            scale = torch.maximum(
                scale / torch.tensor(state.scale_factor, dtype=_F32), floor)
        unskipped = 0 if found_inf else state.unskipped + 1
        if unskipped >= state.scale_window:
            scale = torch.minimum(
                scale * torch.tensor(state.scale_factor, dtype=_F32),
                torch.tensor(state.max_loss_scale, dtype=_F32))
            unskipped = 0
            hyst = state.hysteresis
    else:
        unskipped = 0 if found_inf else state.unskipped + 1
    return state.replace(loss_scale=scale, unskipped=unskipped,
                         steps=state.steps + 1,
                         overflows=state.overflows + int(found_inf),
                         hysteresis_left=hyst)
