"""FusedAdam — the port of ``apex_tpu/optimizers/fused_adam.py``.

Adam / AdamW (``adam_w_mode``, True by default, so FusedAdam is AdamW by
default, as apex's) with fp32 ``exp_avg`` / ``exp_avg_sq``, in the JAX
package's two layouts, both stepping through multi-tensor kernel #24
(``multi_tensor.py`` ``_adam_kernel``, :func:`~apex_tpu_torch.kernels.
multi_tensor.multi_tensor_adam_`) on CUDA:

- ``layout="tree"`` (default): per-tensor state, the whole list in one
  kernel launch per (grad, param) dtype pair — apex's own FusedAdam. The
  kernel adds each update to its parameter in place.
- ``layout="flat"``: one flat fp32 ``exp_avg`` / ``exp_avg_sq`` per
  parameter group; each step flattens the parameters and grads to fp32,
  makes one kernel pass over the superbuffer and adds each tensor's delta
  back (``fused_adam.py`` ``update_fn``'s flat branch).

The arithmetic is the JAX package's, step for step, not just the
formula: every scalar (``beta1``, ``1 - beta1``, the bias corrections
``1 - beta ** step``, ``lr``, ``eps``, ``weight_decay``) is an fp32
value computed on the host; the update computes ``new_p`` in fp32, forms
``delta = new_p - p32`` cast to the parameter's dtype, and adds it to the
parameter (``optax.apply_updates``), which rounds differently from
writing ``new_p`` back. Both layouts run that arithmetic, so they give
bitwise-equal parameters. On CPU tensors the plain versions run.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from apex_tpu_torch.kernels.multi_tensor import multi_tensor_adam_
from apex_tpu_torch.utils.pytree import flatten

__all__ = ["FusedAdam"]

_F32 = torch.float32
_STATE_KEYS = ("exp_avg", "exp_avg_sq")


class FusedAdam(torch.optim.Optimizer):
    """apex's ``FusedAdam`` over ``params``: ``lr``, ``betas``, ``eps``,
    ``weight_decay``, ``adam_w_mode`` (decoupled decay) and
    ``bias_correction`` keep apex's names and defaults. ``amsgrad=True``
    raises as apex's does. ``layout`` is ``"tree"`` (per-tensor state)
    or ``"flat"`` (one fp32 superbuffer per group; every parameter of a
    stepped group needs a gradient)."""

    def __init__(self, params, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 layout: str = "tree"):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        if layout not in ("tree", "flat"):
            raise ValueError(f"layout must be 'tree' or 'flat', got "
                             f"{layout!r}")
        defaults = dict(lr=lr, bias_correction=bias_correction,
                        betas=tuple(betas), eps=eps,
                        weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.adam_w_mode = bool(adam_w_mode)
        self.layout = layout
        #: the flat layout's state, by parameter-group index
        self.flat_state: Dict[int, Dict[str, torch.Tensor]] = {}

    def _kw(self, group, step):
        b1, b2 = group["betas"]
        return dict(lr=group["lr"], beta1=b1, beta2=b2, eps=group["eps"],
                    weight_decay=group["weight_decay"], step=step,
                    adam_w_mode=self.adam_w_mode,
                    bias_correction=group["bias_correction"])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for gi, group in enumerate(self.param_groups):
            stepped = [p for p in group["params"] if p.grad is not None]
            if not stepped:
                continue
            step = group.get("step", 0) + 1
            group["step"] = step
            if self.layout == "tree":
                self._step_tree(stepped, self._kw(group, step))
            else:
                self._step_flat(gi, group["params"], self._kw(group, step))
        return loss

    def _step_tree(self, params: List[torch.Tensor], kw) -> None:
        for p in params:
            if not self.state[p]:
                for k in _STATE_KEYS:
                    self.state[p][k] = torch.zeros_like(p, dtype=_F32)
        multi_tensor_adam_(
            [[p.grad.contiguous() for p in params], params,
             [self.state[p]["exp_avg"] for p in params],
             [self.state[p]["exp_avg_sq"] for p in params]],
            apply_delta=True, **kw)

    def _step_flat(self, gi: int, params: List[torch.Tensor], kw) -> None:
        if any(p.grad is None for p in params):
            raise ValueError("FusedAdam(layout='flat') steps every "
                             "parameter of a group: each needs a grad")
        flat_p = flatten([p.float() for p in params])
        flat_g = flatten([p.grad.float() for p in params])
        st = self.flat_state.get(gi)
        if st is None:
            st = self.flat_state[gi] = {
                k: torch.zeros_like(flat_p) for k in _STATE_KEYS}
        # flat_p becomes new_p (fp32); each tensor then adds its delta
        multi_tensor_adam_([[flat_g], [flat_p], [st["exp_avg"]],
                            [st["exp_avg_sq"]]], **kw)
        off = 0
        for p in params:
            n = p.numel()
            new_p = flat_p[off:off + n].view(p.shape)
            p.add_((new_p - p.float()).to(p.dtype))
            off += n

    # ------------------------------------------------------ checkpoints
    def state_dict(self):
        """``{"layout", "param_groups", "state"}``: the groups' settings
        and step counts (parameters as indices, as torch's), and the
        fp32 moments — by parameter index (tree) or by group index
        (flat) — as copies."""
        groups, index, start = [], {}, 0
        for g in self.param_groups:
            sg = {k: v for k, v in g.items() if k != "params"}
            sg["params"] = list(range(start, start + len(g["params"])))
            index.update({id(p): start + i for i, p in
                          enumerate(g["params"])})
            start += len(g["params"])
            groups.append(sg)
        if self.layout == "tree":
            state = {index[id(p)]: {k: v.clone() for k, v in st.items()}
                     for p, st in self.state.items() if st}
        else:
            state = {gi: {k: v.clone() for k, v in st.items()}
                     for gi, st in self.flat_state.items()}
        return {"layout": self.layout, "param_groups": groups,
                "state": state}

    def load_state_dict(self, state_dict) -> None:
        """Restore :meth:`state_dict`'s output into an optimizer over the
        same parameters and layout; the moments land in fp32 on the
        parameters' device."""
        layout = state_dict.get("layout", "tree")
        if layout != self.layout:
            raise ValueError(f"a layout={layout!r} state_dict does not "
                             f"load into a layout={self.layout!r} FusedAdam")
        saved = state_dict["param_groups"]
        if [len(g["params"]) for g in saved] != [
                len(g["params"]) for g in self.param_groups]:
            raise ValueError("the state_dict's parameter groups do not "
                             "match this optimizer's")
        params = [p for g in self.param_groups for p in g["params"]]
        for g, sg in zip(self.param_groups, saved):
            g.update({k: v for k, v in sg.items() if k != "params"})
        self.state.clear()
        self.flat_state = {}
        for key, st in state_dict["state"].items():
            if self.layout == "tree":
                p = params[int(key)]
                self.state[p] = {k: v.to(device=p.device, dtype=_F32,
                                         copy=True) for k, v in st.items()}
            else:
                dev = self.param_groups[int(key)]["params"][0].device
                self.flat_state[int(key)] = {
                    k: v.to(device=dev, dtype=_F32, copy=True)
                    for k, v in st.items()}
