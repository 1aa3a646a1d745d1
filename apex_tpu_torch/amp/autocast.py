"""The O1 per-op cast engine — the port of ``apex_tpu/amp/autocast.py``.

apex installs wrappers over every op its tables name (``amp/lists``) so
that under O1 tensor-core ops run in half, reductions, losses and norms
in fp32, and CASTS ops promote their operands. The port, like the JAX
package, consults instead of patching: :func:`autocast` installs a
policy for a scope (``make_train_step`` does so around the forward and
backward), and policy-aware modules ask :func:`op_compute_dtype` /
:func:`resolve_dtype` what the table assigns their op at call time.

The context is thread-local. It is not ``torch.autocast``: that engine
casts by PyTorch's own op lists, which are not apex's tables, so parity
with the JAX package would not hold.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

__all__ = ["autocast", "active_policy", "op_compute_dtype",
           "resolve_dtype", "cast_op_inputs"]

_tls = threading.local()


def active_policy():
    """The Policy installed by the innermost :func:`autocast`, or None."""
    return getattr(_tls, "policy", None)


@contextlib.contextmanager
def autocast(policy):
    """Install ``policy`` as the ambient op-cast policy for the scope
    (nested scopes restore the outer policy on exit)."""
    prev = getattr(_tls, "policy", None)
    _tls.policy = policy
    try:
        yield policy
    finally:
        _tls.policy = prev


def op_compute_dtype(op_name: str, *operand_dtypes) -> Optional[torch.dtype]:
    """The dtype the active policy assigns to ``op_name``
    (:meth:`Policy.op_dtype`), or None: no policy, or no opinion."""
    pol = active_policy()
    if pol is None:
        return None
    return pol.op_dtype(op_name, *operand_dtypes)


def resolve_dtype(explicit, op_name: str, default=None):
    """A module's dtype for ``op_name``: an explicit dtype always wins;
    else the active policy's table opinion; else ``default``."""
    if explicit is not None:
        return explicit
    d = op_compute_dtype(op_name)
    return d if d is not None else default


def cast_op_inputs(op_name: str, *tensors):
    """Cast the floating tensors to the table's dtype for ``op_name``
    (for CASTS entries, the widest floating operand's); others, and every
    operand when the policy has no opinion, pass as they are. Returns
    the tensors in order (one tensor alone, not a tuple)."""
    dtypes = [t.dtype if isinstance(t, torch.Tensor) else None
              for t in tensors]
    target = op_compute_dtype(op_name, *[d for d in dtypes if d is not None])
    if target is None:
        out = tensors
    else:
        out = tuple(t.to(target) if d is not None and d.is_floating_point
                    else t for t, d in zip(tensors, dtypes))
    return out[0] if len(out) == 1 else tuple(out)
