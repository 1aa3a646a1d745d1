"""FusedAdam — the port of ``apex_tpu/optimizers/fused_adam.py``.

Adam / AdamW (``adam_w_mode``, True by default, so FusedAdam is AdamW by
default, as apex's) with per-tensor fp32 ``exp_avg`` / ``exp_avg_sq``:
the JAX package's default ``layout="tree"``, which runs
``adam_tree_step`` in plain jnp, so the port runs plain torch ops too.
The superbuffer ``layout="flat"`` goes through multi-tensor kernel #24
(``multi_tensor.py`` ``_adam_kernel``), a later slice: it raises.

The arithmetic is the JAX package's, step for step, not just the
formula: every scalar (``beta1``, ``1 - beta1``, the bias corrections
``1 - beta ** step``, ``lr``, ``eps``, ``weight_decay``) is an fp32
value; the update computes ``new_p`` in fp32, forms ``delta = new_p -
p32`` cast to the parameter's dtype, and adds it to the parameter
(``optax.apply_updates``), which rounds differently from writing
``new_p`` back.
"""

from __future__ import annotations

import torch

__all__ = ["FusedAdam"]

_F32 = torch.float32


def _f32(x) -> float:
    """``x`` rounded to fp32, as a Python float (exact in a torch
    scalar operand of an fp32 op)."""
    return float(torch.tensor(x, dtype=_F32))


class FusedAdam(torch.optim.Optimizer):
    """apex's ``FusedAdam`` over ``params``: ``lr``, ``betas``, ``eps``,
    ``weight_decay``, ``adam_w_mode`` (decoupled decay) and
    ``bias_correction`` keep apex's names and defaults. ``amsgrad=True``
    raises as apex's does; ``layout="flat"`` is not ported yet."""

    def __init__(self, params, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 layout: str = "tree"):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        if layout == "flat":
            raise NotImplementedError(
                "FusedAdam(layout='flat') steps one flat fp32 superbuffer "
                "through multi-tensor kernel #24 (multi_tensor.py "
                "_adam_kernel), not ported yet (ROADMAP Queue 2); the "
                "per-tensor layout='tree' is the default")
        if layout != "tree":
            raise ValueError(f"layout must be 'tree' or 'flat', got "
                             f"{layout!r}")
        defaults = dict(lr=lr, bias_correction=bias_correction,
                        betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.adam_w_mode = bool(adam_w_mode)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            step = group.get("step", 0) + 1
            group["step"] = step
            b1, b2 = (torch.tensor(b, dtype=_F32) for b in group["betas"])
            if group["bias_correction"]:
                t = torch.tensor(step, dtype=_F32)
                bc1, bc2 = float(1.0 - b1 ** t), float(1.0 - b2 ** t)
            else:
                bc1 = bc2 = 1.0
            c1, c2 = float(b1), float(b2)
            d1, d2 = float(1.0 - b1), float(1.0 - b2)
            lr, eps = _f32(group["lr"]), _f32(group["eps"])
            wd = _f32(group["weight_decay"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p, dtype=_F32)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=_F32)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                p32 = p.float()
                g32 = p.grad.float()
                if not self.adam_w_mode:
                    g32 = g32 + wd * p32         # L2 folded into the grad
                m2 = c1 * m + d1 * g32
                v2 = c2 * v + d2 * g32 * g32
                upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
                if self.adam_w_mode:
                    upd = upd + wd * p32         # decoupled decay
                new_p = p32 - lr * upd
                p.add_((new_p - p32).to(p.dtype))
                m.copy_(m2)
                v.copy_(v2)
        return loss
