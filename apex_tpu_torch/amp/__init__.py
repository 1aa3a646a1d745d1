"""apex_tpu_torch.amp — opt-level policies, the loss scaler and the
mixed-precision train step (the port of ``apex_tpu/amp``).

:func:`make_train_step` is apex's iteration as one call per step, with
the semantics of ``apex_tpu.amp.make_train_step``:

1. the loss is scaled and backpropagated (``accum_steps`` microbatches'
   SCALED grads summed in an fp32 accumulator, then divided by N), with
   the policy installed as the ambient :func:`autocast` policy around
   the forward and backward (O1's per-op casts);
2. the grads are unscaled into fp32 master grads, and ``found_inf``
   reports any inf or NaN among them;
3. on ``found_inf`` the step is skipped: parameters, masters and the
   optimizer state (its step count included) are left untouched;
4. otherwise the optimizer steps the fp32 masters (O2) or the model's
   own parameters (O0), and the masters are copied back into the model
   in each parameter's dtype;
5. the scaler schedule advances once per step.

As apex's ``amp.initialize`` does, :func:`make_train_step`'s ``init_fn``
casts the model in place and, when the policy keeps master weights,
points the optimizer's parameter groups at fp32 master copies (apex
``_process_optimizer``). Parameters update in place; the step returns
the same state object with its scaler replaced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
from torch import nn

from . import lists
from .autocast import (active_policy, autocast, cast_op_inputs,
                       op_compute_dtype, resolve_dtype)
from .policy import Policy, is_norm_param, opt_levels, resolve_policy
from .scaler import (ScalerState, init_scaler, scale_loss, unscale,
                     update_scale)

__all__ = ["Policy", "resolve_policy", "is_norm_param", "opt_levels",
           "ScalerState", "init_scaler", "scale_loss", "unscale",
           "update_scale", "AmpState", "make_train_step",
           "to_microbatches", "autocast", "active_policy",
           "op_compute_dtype", "resolve_dtype", "cast_op_inputs", "lists"]


@dataclasses.dataclass
class AmpState:
    """What one train step touches: the model, its parameters in a fixed
    order, their fp32 masters (None without master weights), the
    optimizer (stepping the masters, or the parameters) and the
    scaler."""

    model: nn.Module
    params: List[nn.Parameter]
    master_params: Optional[List[nn.Parameter]]
    optimizer: torch.optim.Optimizer
    scaler: ScalerState


def _map_batch(batch, fn):
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map_batch(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_batch(v, fn) for v in batch)
    return batch


def to_microbatches(batch, accum_steps: int):
    """Reshape every tensor of ``batch`` ``[B, ...]`` to ``[N, B/N,
    ...]``, the leading microbatch axis ``make_train_step(accum_steps=N)``
    expects; identity at ``N = 1``. A leading dim that does not divide, or
    a 0-dim tensor, raises."""
    accum_steps = int(accum_steps)
    if accum_steps == 1:
        return batch

    def one(a):
        if a.ndim == 0:
            raise ValueError("to_microbatches needs a leading batch dim on "
                             f"every tensor; got a 0-dim {a!r}")
        b = a.shape[0]
        if b % accum_steps:
            raise ValueError(f"leading batch dim {b} does not divide by "
                             f"accum_steps {accum_steps}")
        return a.reshape((accum_steps, b // accum_steps) + a.shape[1:])

    return _map_batch(batch, one)


def make_train_step(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                    optimizer: torch.optim.Optimizer, policy: Policy,
                    accum_steps: int = 1):
    """``(init_fn, step_fn)`` for apex's mixed-precision iteration.

    ``loss_fn(model, batch) -> loss`` (a scalar). ``optimizer`` is built
    over the model's parameters before ``init_fn`` runs and holds no
    state yet. ``init_fn(model) -> AmpState`` casts the model per
    ``policy`` in place and, when the policy keeps master weights, swaps
    the optimizer's parameters for fp32 masters. ``step_fn(state, batch)
    -> (state, metrics)`` runs one step (module docstring); ``metrics``
    holds ``loss`` (the unscaled loss, the microbatch mean under
    accumulation), ``found_inf`` (bool) and ``loss_scale`` (the scale
    this step used). With ``accum_steps = N > 1`` every tensor of
    ``batch`` carries a leading microbatch axis of N
    (:func:`to_microbatches`)."""
    accum_steps = int(accum_steps)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def init_fn(model: nn.Module) -> AmpState:
        ids = {id(p): p for p in model.parameters()}
        opt_params = [p for g in optimizer.param_groups for p in g["params"]]
        if any(id(p) not in ids for p in opt_params):
            raise ValueError("the optimizer must be built over the model's "
                             "own parameters")
        if optimizer.state:
            raise ValueError("the optimizer already holds state; build it "
                             "fresh for make_train_step")
        with torch.no_grad():
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.float()
        masters = None
        if policy.master_weights:
            # the fp32 values before the cast are the masters
            masters = [nn.Parameter(p.detach().clone()) for p in opt_params]
            by_id = {id(p): m for p, m in zip(opt_params, masters)}
            for g in optimizer.param_groups:
                g["params"] = [by_id[id(p)] for p in g["params"]]
        policy.cast_params(model)
        return AmpState(model=model, params=opt_params,
                        master_params=masters, optimizer=optimizer,
                        scaler=init_scaler(policy.loss_scale))

    def _backward(state: AmpState, batch):
        """Scaled backward of one microbatch; returns the unscaled loss
        and the SCALED grads, and clears the parameters' grads."""
        for p in state.params:
            p.grad = None
        with autocast(policy):
            loss = loss_fn(state.model, batch)
            scale_loss(loss, state.scaler).backward()
        grads = [p.grad for p in state.params]
        for p in state.params:
            p.grad = None
        return loss.detach(), grads

    def step_fn(state: AmpState, batch):
        scaler = state.scaler
        if policy.compute_dtype != torch.float32:
            # the patched forward's input cast: floating leaves enter in
            # the compute dtype, integer ones (tokens) untouched
            batch = _map_batch(batch, lambda a: a.to(policy.compute_dtype)
                               if a.is_floating_point() else a)
        if accum_steps == 1:
            loss, grads = _backward(state, batch)
        else:
            # apex delay_unscale: SCALED grads sum in fp32 across the
            # window, then one division by N; a non-finite microbatch
            # grad survives the sum and skips the whole window
            acc = [None] * len(state.params)
            loss_sum = torch.zeros((), dtype=torch.float32)
            for i in range(accum_steps):
                loss, grads = _backward(
                    state, _map_batch(batch, lambda a, i=i: a[i]))
                loss_sum = loss_sum + loss.float().cpu()
                for j, g in enumerate(grads):
                    if g is not None:
                        acc[j] = g.float() if acc[j] is None \
                            else acc[j] + g.float()
            loss = loss_sum / accum_steps
            grads = [None if a is None else a / accum_steps for a in acc]
        unscaled, found_inf = unscale(grads, scaler, torch.float32)
        if not found_inf:
            targets = state.master_params or state.params
            for t, g in zip(targets, unscaled):
                t.grad = None if g is None else g.to(t.dtype)
            state.optimizer.step()
            for t in targets:
                t.grad = None
            if state.master_params is not None:
                with torch.no_grad():
                    for p, m in zip(state.params, state.master_params):
                        p.copy_(m)
        state.scaler = update_scale(scaler, found_inf)
        metrics = {"loss": loss, "found_inf": found_inf,
                   "loss_scale": float(scaler.loss_scale)}
        return state, metrics

    return init_fn, step_fn
