"""Tensor-list flatten / unflatten — apex_C parity.

Port of ``apex_tpu/utils/pytree.py``'s ``flatten`` / ``unflatten``
(apex's ``csrc/flatten_unflatten.cpp``, thin wraps of
``torch.utils.flatten_dense_tensors``), which makes the superbuffer of the
flat multi-tensor layout (``FusedAdam(layout="flat")``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["flatten", "unflatten"]


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate tensors into one 1-D buffer of their promoted dtype
    (``apex_C.flatten``); an empty list gives an empty fp32 buffer."""
    if not tensors:
        return torch.zeros((0,), dtype=torch.float32)
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def unflatten(flat: torch.Tensor,
              like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Split a flat buffer back into tensors shaped (and typed) like
    ``like`` (``apex_C.unflatten``); a piece whose dtype already matches
    is a view of ``flat``."""
    outs, offset = [], 0
    for t in like:
        n = t.numel()
        outs.append(flat[offset:offset + n].reshape(t.shape).to(t.dtype))
        offset += n
    return outs
