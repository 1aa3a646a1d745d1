"""apex_tpu_torch multi-tensor kernels' plain versions, the list ops,
FusedAdam's two layouts and the scaler's unscale vs apex_tpu, on the CPU.

- ``fused_scale`` and ``fused_adam_step`` against the JAX functions with
  ``interpret=True`` (their Pallas kernels in interpret mode; without it
  JAX takes its jnp path on the CPU), and ``adam_tree_step`` against
  JAX's, on seeded numpy buffers.
- The ``multi_tensor_apply`` list ops over tensors of odd sizes against
  the JAX package's, and through ``multi_tensor_applier``.
- ``FusedAdam`` tree against flat (bitwise, three steps, and through a
  ``state_dict`` round trip), and each layout against JAX's
  ``fused_adam`` of the same layout over three steps.
- ``unscale``'s ``found_inf`` with one inf in the last element of the
  last tensor, and its outputs against JAX's ``unscale``.

Tolerances, with their reasons: a multiply by a power of two is exact, so
the scale outputs are compared bitwise. The Adam step is the same fp32
operations in the same order on both sides except the bias corrections
``1 - beta ** step``, whose fp32 power may differ by an ulp between the
two libraries: parameters at 1e-6 relative plus 1e-7, moments at 1e-6
relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import init_scaler as jax_init_scaler
from apex_tpu.amp.scaler import unscale as jax_unscale
from apex_tpu.kernels import multi_tensor as jax_mt
from apex_tpu import multi_tensor_apply as jax_mta
from apex_tpu.optimizers.fused_adam import fused_adam as jax_fused_adam
from apex_tpu_torch import kernels, multi_tensor_apply as mta
from apex_tpu_torch.amp.scaler import init_scaler, unscale
from apex_tpu_torch.kernels import multi_tensor as mt
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils import flatten, unflatten

SHAPES = [(7, 5), (13,), (3, 2, 4), (1,), (129,)]
ADAM = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _arrays(seed, shapes=SHAPES, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=rtol, atol=atol)


# ------------------------------------------------- the plain versions
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_scale_matches_jax_kernel(dtype):
    flat = np.concatenate([a.ravel() for a in _arrays(0, scale=300.0)])
    flat[-1] = np.inf
    jx = jnp.asarray(flat, dtype)
    want, want_found = jax_mt.fused_scale(jx, 2.0 ** -16, interpret=True)
    got, found = mt.fused_scale(
        torch.from_numpy(flat).to(getattr(torch, dtype)), 2.0 ** -16)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert bool(found) is bool(want_found) is True
    _, found = mt.fused_scale(torch.ones(3), 0.5, torch.float32)
    assert not bool(found)


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_fused_adam_step_matches_jax_kernel(adam_w_mode, bias_correction):
    p, m, g = (np.concatenate([a.ravel() for a in _arrays(s)])
               for s in (1, 2, 3))
    v = np.abs(np.concatenate([a.ravel() for a in _arrays(4)]))
    kw = dict(ADAM, step=3, adam_w_mode=adam_w_mode, inv_scale=0.5,
              bias_correction=bias_correction)
    want = jax_mt.fused_adam_step(*(jnp.asarray(a) for a in (p, m, v, g)),
                                  interpret=True, **kw)
    got = mt.fused_adam_step(*(torch.from_numpy(a) for a in (p, m, v, g)),
                             **kw)
    for a, b in zip(got, want):
        _close(a, b)


def test_adam_tree_step_matches_jax():
    ps, ms, gs = _arrays(5), _arrays(6), _arrays(7)
    vs = [np.abs(a) for a in _arrays(8)]
    kw = dict(ADAM, step=2)
    want = jax_mt.adam_tree_step(*([jnp.asarray(a) for a in x]
                                   for x in (ps, ms, vs, gs)), **kw)
    got = mt.adam_tree_step(*(_t(x) for x in (ps, ms, vs, gs)), **kw)
    for gl, wl in zip(got, want):
        for a, b in zip(gl, wl):
            _close(a, b)


def test_flatten_unflatten_match_jax():
    from apex_tpu.utils.pytree import flatten as jax_flatten

    arrays = _arrays(9)
    flat = flatten(_t(arrays))
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jax_flatten([jnp.asarray(a)
                                              for a in arrays])))
    back = unflatten(flat, _t(arrays))
    for a, b in zip(back, arrays):
        np.testing.assert_array_equal(a.numpy(), b)
    mixed = flatten([torch.ones(2, dtype=torch.bfloat16), torch.ones(3)])
    assert mixed.dtype == torch.float32 and mixed.shape == (5,)


# ----------------------------------------------------- the list ops
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_tensor_scale_list_matches_jax(dtype):
    arrays = _arrays(10, scale=1000.0)
    want, want_found = jax_mta.multi_tensor_scale(
        [jnp.asarray(a, dtype) for a in arrays], 2.0 ** -10, interpret=True)
    tdt = getattr(torch, dtype)
    got, found = mta.multi_tensor_scale([t.to(tdt) for t in _t(arrays)],
                                        2.0 ** -10)
    for a, b in zip(got, want):
        assert a.dtype == tdt and a.shape == b.shape
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    assert found is bool(want_found) is False


def test_multi_tensor_adam_list_matches_jax():
    ps, ms, gs = _arrays(11), _arrays(12), _arrays(13)
    vs = [np.abs(a) for a in _arrays(14)]
    kw = dict(ADAM, step=4)
    want = jax_mta.multi_tensor_adam(
        *([jnp.asarray(a) for a in x] for x in (ps, ms, vs, gs)),
        interpret=True, **kw)
    inputs = [_t(x) for x in (ps, ms, vs, gs)]
    got = mta.multi_tensor_adam(*inputs, **kw)
    for gl, wl in zip(got, want):
        for a, b in zip(gl, wl):
            _close(a, b)
    # the inputs are left as they were
    np.testing.assert_array_equal(inputs[0][0].numpy(), ps[0])


def test_applier_and_what_is_not_ported():
    xs = [t * 3 for t in _t(_arrays(15))]
    outs = [torch.empty_like(x) for x in xs]
    flag = torch.zeros(1, dtype=torch.int32)
    before = dict(kernels.launches)
    mta.multi_tensor_applier(mt.multi_tensor_scale_, flag, [xs, outs], 0.25)
    for x, o in zip(xs, outs):
        torch.testing.assert_close(o, x * 0.25, atol=0, rtol=0)
    assert int(flag) == 0 and dict(kernels.launches) == before
    xs[-1].view(-1)[-1] = float("nan")
    mta.multi_tensor_applier(mt.multi_tensor_scale_, flag, [xs, outs], 0.25)
    assert int(flag) == 1
    assert mta.multi_tensor_applier.available
    for call, k in ((lambda: mta.multi_tensor_axpby(xs, xs, 1.0, 1.0), 22),
                    (lambda: mta.multi_tensor_l2norm(xs), 23),
                    (lambda: mta.multi_tensor_sgd(xs, xs, xs, lr=0.1), 25)):
        with pytest.raises(NotImplementedError, match=f"#{k}"):
            call()


# ------------------------------------------------------- FusedAdam
def _fused_adam_run(layout, steps=3, grads=None, seed=16):
    params = [torch.nn.Parameter(t) for t in _t(_arrays(seed))]
    opt = FusedAdam(params, lr=ADAM["lr"], weight_decay=ADAM["weight_decay"],
                    layout=layout)
    grads = grads or [_arrays(100 + i) for i in range(steps)]
    for g in grads:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        opt.zero_grad()
    return params, opt, grads


def test_fused_adam_tree_and_flat_bitwise():
    tree, opt_t, grads = _fused_adam_run("tree")
    flat, opt_f, _ = _fused_adam_run("flat", grads=grads)
    for a, b in zip(tree, flat):
        assert torch.equal(a, b)
    m_tree = torch.cat([opt_t.state[p]["exp_avg"].reshape(-1)
                        for p in tree])
    assert torch.equal(m_tree, opt_f.flat_state[0]["exp_avg"])
    # a state_dict round trip resumes bitwise, in each layout
    more = [_arrays(200)]
    for layout, params, opt in (("tree", tree, opt_t),
                                ("flat", flat, opt_f)):
        twin_params = [torch.nn.Parameter(p.detach().clone())
                       for p in params]
        twin = FusedAdam(twin_params, lr=ADAM["lr"],
                         weight_decay=ADAM["weight_decay"], layout=layout)
        twin.load_state_dict(opt.state_dict())
        for ps, o in ((params, opt), (twin_params, twin)):
            for p, x in zip(ps, more[0]):
                p.grad = torch.from_numpy(x.copy())
            o.step()
        for a, b in zip(params, twin_params):
            assert torch.equal(a, b)
        assert twin.param_groups[0]["step"] == 4
    with pytest.raises(ValueError, match="layout"):
        opt_f.load_state_dict(opt_t.state_dict())


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_fused_adam_matches_jax(layout):
    params, opt, grads = _fused_adam_run(layout, seed=17)
    tx = jax_fused_adam(ADAM["lr"], weight_decay=ADAM["weight_decay"],
                        layout=layout)
    jp = [jnp.asarray(a) for a in _arrays(17)]
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
    assert int(state.count) == opt.param_groups[0]["step"] == 3
    for a, b in zip(params, jp):
        _close(a, b)
    if layout == "flat":
        _close(opt.flat_state[0]["exp_avg"], state.m)
        _close(opt.flat_state[0]["exp_avg_sq"], state.v)


def test_fused_adam_flat_needs_every_grad():
    params = [torch.nn.Parameter(torch.ones(3)) for _ in range(2)]
    opt = FusedAdam(params, layout="flat")
    params[0].grad = torch.ones(3)
    with pytest.raises(ValueError, match="every"):
        opt.step()


# ------------------------------------------------------- unscale
def test_unscale_found_inf_in_the_last_element():
    arrays = _arrays(18, scale=2.0 ** 12)
    grads = [t.to(torch.bfloat16) for t in _t(arrays)] + [None]
    grads[-2].view(-1)[-1] = float("inf")
    state = init_scaler("dynamic")
    out, found = unscale(grads, state)
    assert found is True and out[-1] is None
    want, jfound = jax_unscale([jnp.asarray(g.float().numpy(), jnp.bfloat16)
                                for g in grads[:-1]],
                               jax_init_scaler("dynamic"))
    assert bool(jfound)
    for a, b in zip(out[:-1], want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    grads[-2].view(-1)[-1] = 1.0
    _, found = unscale(grads, state)
    assert found is False
