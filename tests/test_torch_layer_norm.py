"""apex_tpu_torch LayerNorm vs apex_tpu's, on the CPU.

The same seeded numpy inputs go through ``apex_tpu.kernels.layer_norm``
(its Pallas kernel in interpret mode, H % 128 == 0) and through the
port's wrapper, which takes its plain PyTorch version for CPU tensors.
fp32 is compared at atol = rtol = 1e-5; bf16 after the cast to fp32 at
atol = 1e-2 (one bf16 ulp at |y| ~ 2 is 1.6e-2 / 2).

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels.layer_norm import _ln_fwd as jax_ln_fwd
from apex_tpu.kernels.layer_norm import (
    layer_norm_reference as jax_layer_norm_reference,
    rms_norm_reference as jax_rms_norm_reference)
from apex_tpu.normalization import FusedLayerNorm as JaxFusedLayerNorm
from apex_tpu_torch import kernels
from apex_tpu_torch.kernels.layer_norm import (layer_norm,
                                               layer_norm_reference,
                                               rms_norm, rms_norm_reference)
from apex_tpu_torch.normalization import FusedLayerNorm

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2, 0.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(n, h, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32) * 2.0 + 0.5
    w = (rng.standard_normal(h) * 0.5 + 1.0).astype(np.float32)
    b = (rng.standard_normal(h) * 0.1).astype(np.float32)
    return x, w, b


def _pair(a, jdt, tdt):
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("rms", [False, True])
def test_forward_matches_jax_pallas(dtype, affine, rms):
    jdt, tdt, atol, rtol = DTYPES[dtype]
    x, w, b = _inputs(16, 256)
    jx, tx = _pair(x, jdt, tdt)
    jw, tw = _pair(w, jdt, tdt) if affine else (None, None)
    jb, tb = _pair(b, jdt, tdt) if affine and not rms else (None, None)
    want_y, want_mean, want_rstd = jax.jit(
        jax_ln_fwd, static_argnums=(3, 4, 5))(
            jx, jw, jb, 1e-5, rms, True)
    if rms:
        y, mean, rstd = rms_norm(tx, tw)
    else:
        y, mean, rstd = layer_norm(tx, tw, tb)
    assert y.dtype == tdt and y.shape == tx.shape
    assert mean.dtype == rstd.dtype == torch.float32
    _close(y, want_y, atol, rtol)
    # statistics are fp32 whatever the I/O dtype
    _close(mean, np.asarray(want_mean)[:, 0], 1e-5, 1e-5)
    _close(rstd, np.asarray(want_rstd)[:, 0], 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_references_match_jax_references(dtype):
    jdt, tdt, atol, rtol = DTYPES[dtype]
    x, w, b = _inputs(3 * 5, 128, seed=1)
    x = x.reshape(3, 5, 128)
    jx, tx = _pair(x, jdt, tdt)
    jw, tw = _pair(w, jdt, tdt)
    jb, tb = _pair(b, jdt, tdt)
    _close(layer_norm_reference(tx, tw, tb),
           jax.jit(jax_layer_norm_reference)(
               jx, jw, jb), atol, rtol)
    _close(rms_norm_reference(tx, tw),
           jax.jit(jax_rms_norm_reference)(
               jx, jw), atol, rtol)
    # the public wrapper keeps leading dims, stats over them
    y, mean, rstd = layer_norm(tx, tw, tb)
    assert y.shape == (3, 5, 128) and mean.shape == rstd.shape == (3, 5)


def test_fused_layer_norm_module_matches_jax_module():
    x, w, b = _inputs(2 * 8, 128, seed=2)
    x = x.reshape(2, 8, 128)
    jmod = JaxFusedLayerNorm(normalized_shape=128)
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    want = jax.jit(jmod.apply)(
        {"params": params}, jnp.asarray(x))
    mod = FusedLayerNorm(128)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
        got = mod(torch.from_numpy(x))
    _close(got, want, 1e-5, 1e-5)
    # dtype=None keeps the input dtype (fp32 stats inside)
    with torch.no_grad():
        got16 = mod.to(torch.bfloat16)(torch.from_numpy(x).bfloat16())
    assert got16.dtype == torch.bfloat16


def test_cpu_path_launches_no_kernel():
    kernels.reset_launches()
    x, w, b = _inputs(4, 128)
    layer_norm(torch.from_numpy(x), torch.from_numpy(w),
               torch.from_numpy(b))
    assert kernels.launches["layer_norm"] == 0


# ------------------------------------------------------------- backward
# (x dtype, gamma/beta dtype): the serve path's pairs and amp O2's mixed
# one. dx is compared in its own dtype: fp32 at 1e-5, bf16 at one bf16
# ulp (2^-7 relative, plus 1e-3 absolute where dx crosses 0). dgamma /
# dbeta sum 16 rows in fp32 in another order: fp32 at 1e-4, bf16 (when
# gamma is bf16) at one bf16 ulp.
GRAD_CASES = {"float32": (jnp.float32, torch.float32, jnp.float32,
                          torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16, jnp.bfloat16,
                           torch.bfloat16),
              "bf16_x_fp32_gamma": (jnp.bfloat16, torch.bfloat16,
                                    jnp.float32, torch.float32)}


def _tol(tdt):
    return (1e-3, 2.0 ** -7) if tdt == torch.bfloat16 else (1e-4, 1e-4)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("mem_eff", [False, True])
def test_backward_matches_jax_vjp(case, affine, rms, mem_eff):
    from apex_tpu.kernels.layer_norm import layer_norm as jax_layer_norm
    from apex_tpu.kernels.layer_norm import rms_norm as jax_rms_norm

    jdt, tdt, jpdt, tpdt = GRAD_CASES[case]
    x, w, b = _inputs(16, 256, seed=3)
    dy = np.random.default_rng(4).standard_normal((16, 256)).astype(
        np.float32)
    jx, tx = _pair(x, jdt, tdt)
    jdy, tdy = _pair(dy, jdt, tdt)
    jw, tw = _pair(w, jpdt, tpdt) if affine else (None, None)
    jb, tb = _pair(b, jpdt, tpdt) if affine and not rms else (None, None)

    def jfwd(x_, w_, b_):
        if rms:
            return jax_rms_norm(x_, w_, interpret=True,
                                memory_efficient=mem_eff)
        return jax_layer_norm(x_, w_, b_, interpret=True,
                              memory_efficient=mem_eff)

    want_y, vjp = jax.vjp(jfwd, jx, jw, jb)
    want_dx, want_dw, want_db = vjp(jdy)

    tx.requires_grad_(True)
    for t in (tw, tb):
        if t is not None:
            t.requires_grad_(True)
    if rms:
        y = rms_norm(tx, tw, memory_efficient=mem_eff)[0]
    else:
        y = layer_norm(tx, tw, tb, memory_efficient=mem_eff)[0]
    y.backward(tdy)
    _close(y.detach(), want_y, *_tol(tdt))
    assert tx.grad.dtype == tdt
    _close(tx.grad, want_dx, *_tol(tdt))
    if affine:
        assert tw.grad.dtype == tpdt
        _close(tw.grad, want_dw, *_tol(tpdt))
        if not rms:
            _close(tb.grad, want_db, *_tol(tpdt))


def test_mixed_dtype_forward_matches_jax():
    # amp O2: bf16 x, fp32 gamma/beta, y in bf16
    x, w, b = _inputs(16, 256, seed=5)
    want = jax.jit(jax_ln_fwd, static_argnums=(3, 4, 5))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), 1e-5,
        False, True)[0]
    y = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                   torch.from_numpy(b))[0]
    assert y.dtype == torch.bfloat16
    _close(y, want, 1e-2, 0.0)


def test_fused_norm_modules_backward_and_launch_counts():
    from apex_tpu_torch.normalization import FusedRMSNorm

    x, _, _ = _inputs(2 * 8, 128, seed=6)
    x = torch.from_numpy(x).reshape(2, 8, 128).requires_grad_(True)
    kernels.reset_launches()
    for mod in (FusedLayerNorm(128, memory_efficient=True),
                FusedRMSNorm(128)):
        mod(x).square().sum().backward()
        assert mod.weight.grad.shape == (128,)
    assert FusedRMSNorm(128).bias is None
    # CPU tensors: plain versions only, no kernel counted
    assert kernels.launches["layer_norm"] == 0
    assert kernels.launches["layer_norm_bwd"] == 0
