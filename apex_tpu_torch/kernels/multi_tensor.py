"""Multi-tensor fused updates: one CUDA kernel over a list of tensors, and
the plain PyTorch versions.

Port of ``apex_tpu/kernels/multi_tensor.py`` (apex's ``amp_C``
extension). The JAX package runs each functor as one Pallas kernel over
the model flattened into a superbuffer; the port keeps apex's own
design, ``multi_tensor_apply.cuh``: ``csrc/multi_tensor.cu`` takes the
tensors where they lie, a table of their addresses and chunks riding in
the kernel's parameters, so a whole model updates in one launch per
dtype group (``launches`` counts every kernel launch).

Ported here:

- kernel 21 (``_scale_kernel``) — :func:`multi_tensor_scale_`: ``out =
  x * scale`` in the out dtype and a found-inf flag, amp's unscale;
- kernel 24 (``_adam_kernel``) — :func:`multi_tensor_adam_`: one Adam /
  AdamW step with bias correction and ``inv_scale``, FusedAdam's update.

The plain versions keep the JAX names and signatures:
:func:`fused_scale`, :func:`fused_adam_step` (flat buffers) and
:func:`adam_tree_step` (per tensor). The list ops' plain versions,
which their wrappers take for CPU tensors, are
:func:`multi_tensor_scale_reference` and
:func:`multi_tensor_adam_reference`. Kernels 22 (axpby), 23 (l2norm)
and 25 (sgd) are not ported yet: :func:`fused_axpby`,
:func:`fused_l2norm` and :func:`fused_sgd_step` raise.

The Adam kernel is the plain version's arithmetic operation for
operation (no FMA contraction), so on the card the two agree bit for
bit; the scalars are fp32 values computed on the host
(:func:`adam_scalars`), as the JAX package's are.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from . import _build, check_launch, kernel_route, launches, stream_handle

__all__ = ["fused_scale", "fused_adam_step", "adam_tree_step",
           "adam_scalars", "multi_tensor_scale_", "multi_tensor_adam_",
           "multi_tensor_scale_reference", "multi_tensor_adam_reference",
           "fused_axpby", "fused_l2norm", "fused_sgd_step"]

_F32 = torch.float32
_BF16 = torch.bfloat16
_DTYPES = {_F32: 0, _BF16: 1}
# the (input, output) and (grad, param) dtype pairs csrc/multi_tensor.cu
# is built for
_SCALE_PAIRS = {(_F32, _F32), (_BF16, _F32), (_BF16, _BF16)}
_ADAM_PAIRS = {(_F32, _F32), (_BF16, _BF16)}


def _f32(x) -> float:
    """``x`` rounded to fp32, as a Python float (exact in a torch scalar
    operand of an fp32 op)."""
    return float(torch.tensor(x, dtype=_F32))


def adam_scalars(*, lr, beta1, beta2, eps, weight_decay, step,
                 bias_correction=True, inv_scale=1.0) -> Dict[str, float]:
    """The Adam step's scalars as fp32 values (``fused_adam_step``'s
    ``scalars`` row): ``1 - beta``, and the bias corrections ``1 -
    beta ** step`` computed in fp32 on the host (1 without bias
    correction)."""
    b1 = torch.tensor(beta1, dtype=_F32)
    b2 = torch.tensor(beta2, dtype=_F32)
    if bias_correction:
        t = torch.tensor(step, dtype=_F32)
        bc1, bc2 = float(1.0 - b1 ** t), float(1.0 - b2 ** t)
    else:
        bc1 = bc2 = 1.0
    return dict(lr=_f32(lr), beta1=float(b1), beta2=float(b2),
                one_minus_beta1=float(1.0 - b1),
                one_minus_beta2=float(1.0 - b2), eps=_f32(eps),
                wd=_f32(weight_decay), bc1=bc1, bc2=bc2,
                inv_scale=_f32(inv_scale))


# ---------------------------------------------------------------- plain
def fused_scale(flat, scale, out_dtype=None):
    """``out = flat * scale`` (fp32 arithmetic) in ``out_dtype``
    (``flat``'s dtype by default), plus ``found_inf`` (a 0-dim bool
    tensor): any inf or NaN in ``flat`` — ``amp_C.multi_tensor_scale``."""
    x32 = flat.float()
    out = (x32 * _f32(scale)).to(out_dtype or flat.dtype)
    return out, torch.logical_not(torch.isfinite(x32).all())


def _adam_elems(p32, m, v, g, s, adam_w_mode):
    """The Adam element update in fp32, ``_adam_kernel``'s operations in
    its order: returns ``(new_p, m, v)``."""
    g32 = g.float() * s["inv_scale"]
    if not adam_w_mode:
        g32 = g32 + s["wd"] * p32              # ADAM_MODE_0: L2 into g
    m2 = s["beta1"] * m + s["one_minus_beta1"] * g32
    v2 = s["beta2"] * v + s["one_minus_beta2"] * g32 * g32
    # divisors as 0-dim tensors on the operands' device: PyTorch's CUDA
    # division by a CPU scalar multiplies by its reciprocal instead, which
    # rounds differently from the kernel's (and the CPU's) true division
    bc1, bc2 = (torch.full((), s[k], dtype=_F32, device=m.device)
                for k in ("bc1", "bc2"))
    upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + s["eps"])
    if adam_w_mode:
        upd = upd + s["wd"] * p32              # ADAM_MODE_1: decoupled
    return p32 - s["lr"] * upd, m2, v2


def fused_adam_step(flat_p, flat_m, flat_v, flat_g, *, lr, beta1, beta2,
                    eps, weight_decay, step, adam_w_mode=True,
                    inv_scale=1.0, bias_correction=True):
    """One whole-model Adam / AdamW step over flat buffers —
    ``amp_C.multi_tensor_adam``: returns ``(new_p in flat_p's dtype, m,
    v)``, ``m``/``v`` fp32. ``step`` is the 1-based step count."""
    s = adam_scalars(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                     weight_decay=weight_decay, step=step,
                     bias_correction=bias_correction, inv_scale=inv_scale)
    new_p, m, v = _adam_elems(flat_p.float(), flat_m, flat_v, flat_g, s,
                              adam_w_mode)
    return new_p.to(flat_p.dtype), m, v


def adam_tree_step(tree_p, tree_m, tree_v, tree_g, *, lr, beta1, beta2,
                   eps, weight_decay, step, adam_w_mode=True,
                   inv_scale=1.0, bias_correction=True):
    """The Adam functor per tensor: lists of params, fp32 ``m``, ``v``
    and grads -> ``(new_p list in each param's dtype, m list, v
    list)``; the same element arithmetic as :func:`fused_adam_step`."""
    s = adam_scalars(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                     weight_decay=weight_decay, step=step,
                     bias_correction=bias_correction, inv_scale=inv_scale)
    out_p, out_m, out_v = [], [], []
    for p, m, v, g in zip(tree_p, tree_m, tree_v, tree_g):
        new_p, m2, v2 = _adam_elems(p.float(), m, v, g, s, adam_w_mode)
        out_p.append(new_p.to(p.dtype))
        out_m.append(m2)
        out_v.append(v2)
    return out_p, out_m, out_v


def _not_ported(kernel: int, what: str):
    raise NotImplementedError(
        f"{what} runs multi-tensor kernel #{kernel} (apex_tpu/kernels/"
        "multi_tensor.py), not ported yet (ROADMAP Queue 2)")


def fused_axpby(flat_x, flat_y, a, b, **_):
    """``a*x + b*y`` with an overflow check — kernel #22, not ported."""
    _not_ported(22, "fused_axpby (amp_C.multi_tensor_axpby)")


def fused_l2norm(flat, **_):
    """The global L2 norm — kernel #23, not ported."""
    _not_ported(23, "fused_l2norm (amp_C.multi_tensor_l2norm)")


def fused_sgd_step(flat_p, flat_buf, flat_g, **_):
    """One SGD / momentum step — kernel #25, not ported."""
    _not_ported(25, "fused_sgd_step (amp_C.multi_tensor_sgd)")


def multi_tensor_scale_reference(noop_flag, tensor_lists, scale) -> None:
    """The plain version of :func:`multi_tensor_scale_`, tensor by tensor
    (:func:`fused_scale`); no host synchronisation."""
    ins, outs = tensor_lists
    flags = []
    for x, o in zip(ins, outs):
        out, found = fused_scale(x, scale, o.dtype)
        o.copy_(out.reshape(o.shape))
        flags.append(found)
    if flags:
        noop_flag.copy_(torch.where(torch.stack(flags).any(),
                                    torch.ones_like(noop_flag), noop_flag))


def multi_tensor_adam_reference(tensor_lists, *, lr, beta1, beta2, eps,
                                weight_decay, step, adam_w_mode=True,
                                bias_correction=True, inv_scale=1.0,
                                apply_delta=False) -> None:
    """The plain version of :func:`multi_tensor_adam_`, in place, tensor
    by tensor (:func:`adam_tree_step`'s element arithmetic)."""
    s = adam_scalars(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                     weight_decay=weight_decay, step=step,
                     bias_correction=bias_correction, inv_scale=inv_scale)
    with torch.no_grad():
        for g, p, m, v in zip(*tensor_lists):
            p32 = p.float()
            new_p, m2, v2 = _adam_elems(p32, m, v, g, s, adam_w_mode)
            if apply_delta:
                p.add_((new_p - p32).to(p.dtype))
            else:
                p.copy_(new_p)
            m.copy_(m2)
            v.copy_(v2)


# --------------------------------------------------------------- kernel
def _lib():
    lib = _build.load("multi_tensor")
    if lib.apex_mt_scale.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.apex_mt_scale.argtypes = [i32, ptr, ptr, ptr, i32, i32,
                                      ctypes.c_float, ptr, ptr,
                                      ctypes.POINTER(i32)]
        lib.apex_mt_scale.restype = i32
        lib.apex_mt_adam.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32,
                                     i32] + [ctypes.c_float] * 10 + [
                                         i32, i32, ptr, ctypes.POINTER(i32)]
        lib.apex_mt_adam.restype = i32
    return lib


def _ptrs(tensors) -> ctypes.c_void_p:
    arr = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _check_lists(name, lists, pairs):
    """Equal-length lists of contiguous tensors on one device, each
    position's sizes equal, its first two dtypes one of ``pairs`` and
    any further ones fp32."""
    n = len(lists[0])
    if any(len(lst) != n for lst in lists):
        raise ValueError(f"{name}: tensor lists of lengths "
                         f"{[len(lst) for lst in lists]}")
    dev = lists[0][0].device
    for ts in zip(*lists):
        if any(not t.is_contiguous() or t.device != dev for t in ts):
            raise ValueError(f"{name}: every tensor must be contiguous "
                             f"on {dev}")
        if any(t.numel() != ts[0].numel() for t in ts):
            raise ValueError(f"{name}: sizes {[t.numel() for t in ts]} "
                             "differ across the lists")
        if (ts[0].dtype, ts[1].dtype) not in pairs or any(
                t.dtype != _F32 for t in ts[2:]):
            raise TypeError(f"{name}: the CUDA kernel takes dtype pairs "
                            f"{sorted((str(a), str(b)) for a, b in pairs)} "
                            f"and fp32 state, got "
                            f"{[str(t.dtype) for t in ts]}")


def _groups(keys: Sequence) -> Dict[tuple, List[int]]:
    """Indices grouped by key, in first-seen order (apex groups the
    tensors of one launch by dtype)."""
    out: Dict[tuple, List[int]] = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return out


def multi_tensor_scale_(noop_flag, tensor_lists, scale) -> None:
    """``amp_C.multi_tensor_scale``: ``tensor_lists = [inputs, outputs]``;
    writes ``outputs[i] = inputs[i] * scale`` (fp32 arithmetic, in each
    output's dtype) and sets ``noop_flag`` (an int32 ``[1]`` tensor) to
    1 when any input holds an inf or a NaN; never clears it. On CUDA one
    kernel launch per (input, output) dtype pair, more only when a list
    outgrows the launch table."""
    ins, outs = tensor_lists
    if not ins:
        return
    scale = _f32(scale)
    if not kernel_route("multi_tensor_scale", noop_flag, *ins, *outs):
        multi_tensor_scale_reference(noop_flag, tensor_lists, scale)
        return
    _check_lists("multi_tensor_scale", [ins, outs], _SCALE_PAIRS)
    if noop_flag.dtype != torch.int32 or noop_flag.device != ins[0].device:
        raise ValueError("multi_tensor_scale: noop_flag must be an int32 "
                         f"tensor on {ins[0].device}")
    lib, stream = _lib(), stream_handle()
    for (din, dout), idx in _groups([(x.dtype, o.dtype)
                                     for x, o in zip(ins, outs)]).items():
        pin, keep_in = _ptrs([ins[i] for i in idx])
        pout, keep_out = _ptrs([outs[i] for i in idx])
        sizes = (ctypes.c_int64 * len(idx))(*[ins[i].numel() for i in idx])
        n_launch = ctypes.c_int(0)
        err = lib.apex_mt_scale(len(idx), pin, pout,
                                ctypes.cast(sizes, ctypes.c_void_p),
                                _DTYPES[din], _DTYPES[dout], scale,
                                noop_flag.data_ptr(), stream,
                                ctypes.byref(n_launch))
        launches["multi_tensor_scale"] += n_launch.value
        check_launch("multi_tensor_scale", err)


def multi_tensor_adam_(tensor_lists, *, lr, beta1, beta2, eps,
                       weight_decay, step, adam_w_mode=True,
                       bias_correction=True, inv_scale=1.0,
                       apply_delta=False) -> None:
    """``amp_C.multi_tensor_adam`` in place: ``tensor_lists = [grads,
    params, exp_avgs, exp_avg_sqs]`` (``m``/``v`` fp32). Each param
    becomes ``new_p`` in its dtype, or, with ``apply_delta``, ``p +
    (new_p - p)`` with the delta rounded to the param's dtype first
    (FusedAdam's update). On CUDA one kernel launch per (grad, param)
    dtype pair, more only when a list outgrows the launch table."""
    gs, ps, ms, vs = tensor_lists
    if not ps:
        return
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, step=step,
              bias_correction=bias_correction, inv_scale=inv_scale)
    if not kernel_route("multi_tensor_adam", *gs, *ps, *ms, *vs):
        multi_tensor_adam_reference(tensor_lists, adam_w_mode=adam_w_mode,
                                    apply_delta=apply_delta, **kw)
        return
    _check_lists("multi_tensor_adam", [gs, ps, ms, vs], _ADAM_PAIRS)
    s = adam_scalars(**kw)
    lib, stream = _lib(), stream_handle()
    for (dg, dp), idx in _groups([(g.dtype, p.dtype)
                                  for g, p in zip(gs, ps)]).items():
        lists = [_ptrs([lst[i] for i in idx]) for lst in (gs, ps, ms, vs)]
        sizes = (ctypes.c_int64 * len(idx))(*[ps[i].numel() for i in idx])
        n_launch = ctypes.c_int(0)
        err = lib.apex_mt_adam(
            len(idx), *[p for p, _ in lists],
            ctypes.cast(sizes, ctypes.c_void_p), _DTYPES[dg], _DTYPES[dp],
            s["lr"], s["beta1"], s["beta2"], s["one_minus_beta1"],
            s["one_minus_beta2"], s["eps"], s["wd"], s["bc1"], s["bc2"],
            s["inv_scale"], int(bool(adam_w_mode)), int(bool(apply_delta)),
            stream, ctypes.byref(n_launch))
        launches["multi_tensor_adam"] += n_launch.value
        check_launch("multi_tensor_adam", err)
