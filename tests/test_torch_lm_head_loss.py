"""apex_tpu_torch fused LM-head loss vs apex_tpu's, on the CPU.

The same seeded numpy hidden states ``x [48, 64]``, head ``kernel [1000,
64]`` and labels go through ``apex_tpu.kernels.lm_head_loss.
lm_head_xentropy`` and the port's, with ``chunk=256``: four vocab chunks,
the last one ragged (JAX pads it to 256 columns at -inf, the port
computes its 232 real ones). Two labels are out of range (-100 and
1000): both sides give NaN there and no onehot gradient.

- fp32 (compute fp32): losses at 1e-5, dx / dW at 1e-5 — the same
  products, accumulated in two orders;
- bf16 x and kernel with compute bf16 (amp O2): the logits are fp32 on
  both sides (bf16 products, fp32 sums), so losses hold at 1e-4; dx and
  dW are bf16, compared at one bf16 ulp (2^-7 relative) plus 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels.lm_head_loss import (
    lm_head_xent_reference as jax_lm_head_xent_reference,
    lm_head_xentropy as jax_lm_head_xentropy)
from apex_tpu.kernels.xentropy import xent_reference as jax_xent_reference
from apex_tpu_torch.kernels.lm_head_loss import (
    _pick_chunk, lm_head_xent_reference, lm_head_xentropy)
from apex_tpu_torch.kernels.xentropy import xent_reference

N, HID, V, CHUNK = 48, 64, 1000, 256
CASES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-5, 0.0),
         "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-4, 1e-5, 2.0 ** -7)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, HID)).astype(np.float32)
    w = (rng.standard_normal((V, HID)) * 0.2).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[3], labels[7] = -100, V            # out of range: NaN losses
    return x, w, labels


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=rtol, equal_nan=True)


@pytest.mark.parametrize("dtype", sorted(CASES))
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_grads_match_jax(dtype, smoothing):
    jdt, tdt, atol_l, atol_g, rtol_g = CASES[dtype]
    x, w, labels = _inputs()
    g = np.random.default_rng(1).uniform(0.5, 1.5, N).astype(np.float32)

    def jfn(x_, w_):
        return jax_lm_head_xentropy(x_, w_, jnp.asarray(labels),
                                    smoothing=smoothing, chunk=CHUNK,
                                    compute_dtype=jdt)

    want, vjp = jax.vjp(jfn, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want_dx, want_dw = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    loss = lm_head_xentropy(tx, tw, torch.from_numpy(labels),
                            smoothing=smoothing, chunk=CHUNK,
                            compute_dtype=tdt)
    assert loss.dtype == torch.float32 and loss.shape == (N,)
    assert torch.isnan(loss[[3, 7]]).all()
    assert torch.isfinite(loss[[0, 1, 2]]).all()
    _close(loss, want, atol_l, 1e-5)
    loss.backward(torch.from_numpy(g))
    assert tx.grad.dtype == tdt and tw.grad.dtype == tdt
    _close(tx.grad, want_dx, atol_g, rtol_g)
    _close(tw.grad, want_dw, atol_g, rtol_g)
    if smoothing == 0.0:
        # the out-of-range rows carry no gradient
        want_rows = np.asarray(jnp.asarray(want_dx, jnp.float32))[[3, 7]]
        assert not want_rows.any()
        assert not tx.grad[[3, 7]].float().any()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_references_match_jax(smoothing):
    x, w, labels = _inputs(seed=2)
    want = jax_lm_head_xent_reference(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(labels), smoothing)
    got = lm_head_xent_reference(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(labels), smoothing)
    _close(got, want, 1e-5, 1e-5)
    logits = np.random.default_rng(3).standard_normal((N, 40)).astype(
        np.float32)
    lab = np.clip(labels, -1, 40)
    _close(xent_reference(torch.from_numpy(logits), torch.from_numpy(lab),
                          smoothing),
           jax_xent_reference(jnp.asarray(logits), jnp.asarray(lab),
                              smoothing), 1e-6, 1e-6)


def test_fused_matches_its_reference_and_leading_dims():
    x, w, labels = _inputs(seed=4)
    x3 = torch.from_numpy(x).reshape(4, 12, HID)
    lab = torch.from_numpy(labels).reshape(4, 12)
    got = lm_head_xentropy(x3, torch.from_numpy(w), lab, chunk=CHUNK)
    assert got.shape == (4, 12)
    want = lm_head_xent_reference(x3, torch.from_numpy(w), lab)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5,
                               equal_nan=True)


def test_pick_chunk_clamps_as_jax():
    from apex_tpu.kernels.lm_head_loss import _pick_chunk as jax_pick_chunk

    for v, c in ((1000, 256), (50257, 8192), (50257, 128), (100, 8192),
                 (10_000_000, 128), (1000, 300)):
        assert _pick_chunk(v, c) == jax_pick_chunk(v, c), (v, c)


def test_argument_checks():
    x, w = torch.zeros(4, HID), torch.zeros(V, HID)
    lab = torch.zeros(4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="vocab-parallel"):
        lm_head_xentropy(x, w, lab, axis_name="model")
    with pytest.raises(ValueError, match="smoothing"):
        lm_head_xentropy(x, w, lab, smoothing=1.0)
    with pytest.raises(ValueError, match="vocab-major"):
        lm_head_xentropy(x, w.t(), lab)
