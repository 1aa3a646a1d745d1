"""apex_tpu_torch softmax cross-entropy vs apex_tpu's, on the CPU.

The same seeded numpy logits, labels and per-row upstream gradients go
through ``apex_tpu.kernels.xentropy.softmax_cross_entropy_loss`` and the
port's. At N 64 x V 512 the JAX function runs its Pallas kernels in
interpret mode on the CPU backend (V % 128 == 0); at N 24 x V 509 it
takes its jnp reference. Rows 3 and 7 are labelled -100 and V: both
sides give a NaN loss there and no onehot gradient.

Tolerances, with their reasons:

- fp32 logits: losses at 1e-5 absolute (a logsumexp of a few hundred
  terms in two summation orders, |loss| ~ 7); dlogits at 1e-5 relative
  plus 1e-8 (softmax entries ~ 2e-3 times g, the same exp in two
  libraries);
- bf16 logits: the arithmetic is fp32 on both sides, so the losses hold
  at 1e-5; dlogits are bf16, compared at one bf16 ulp (2^-7 relative)
  plus 1e-8: the two sides' fp32 values, an ulp or two apart, may round
  to neighbouring bf16 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels.xentropy import (
    softmax_cross_entropy_loss as jax_softmax_cross_entropy_loss)
from apex_tpu_torch import kernels
from apex_tpu_torch.kernels.xentropy import (
    softmax_cross_entropy_loss, xent_bwd_reference, xent_fwd_reference,
    xent_reference)

SHAPES = {"aligned": (64, 512), "unaligned": (24, 509)}
# (JAX dtype, torch dtype, dlogits rtol)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(n, v, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, v)) * 2.0).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[3], labels[7] = -100, v                # out of range: NaN rows
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return logits, labels, g


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.detach().float().numpy()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_grad_match_jax(shape, dtype, smoothing):
    n, v = SHAPES[shape]
    jdt, tdt, rtol_g = DTYPES[dtype]
    logits, labels, g = _inputs(n, v)

    want, vjp = jax.vjp(
        lambda x: jax_softmax_cross_entropy_loss(x, jnp.asarray(labels),
                                                 smoothing=smoothing),
        jnp.asarray(logits, jdt))
    (want_d,) = vjp(jnp.asarray(g))

    before = dict(kernels.launches)
    x = torch.from_numpy(logits).to(tdt).requires_grad_(True)
    loss = softmax_cross_entropy_loss(x, torch.from_numpy(labels),
                                      smoothing=smoothing)
    assert loss.dtype == torch.float32 and loss.shape == (n,)
    assert torch.isnan(loss[[3, 7]]).all()
    assert torch.isfinite(loss[[0, 1, 2, 4]]).all()
    np.testing.assert_allclose(_np(loss), _np(want), atol=1e-5, rtol=0,
                               equal_nan=True)
    loss.backward(torch.from_numpy(g))
    assert x.grad.dtype == tdt
    np.testing.assert_allclose(_np(x.grad), _np(want_d), atol=1e-8,
                               rtol=rtol_g)
    rows = _np(x.grad)[[3, 7]]
    if smoothing == 0.0:
        # the out-of-range rows carry no gradient at all
        assert not rows.any() and not _np(want_d)[[3, 7]].any()
    else:
        # only the smoothing term, s * (softmax - 1/V), flows there
        assert rows.any()
    # CPU tensors take the plain versions: no kernel launched
    assert dict(kernels.launches) == before


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_plain_forward_and_backward_are_the_reference(smoothing):
    logits, labels, g = _inputs(24, 509, seed=1)
    x = torch.from_numpy(logits).requires_grad_(True)
    lab = torch.from_numpy(labels)
    ref = xent_reference(x, lab, smoothing)
    ref.backward(torch.from_numpy(g))
    loss, lse = xent_fwd_reference(x.detach(), lab, smoothing)
    torch.testing.assert_close(loss, ref.detach(), atol=1e-5, rtol=0,
                               equal_nan=True)
    torch.testing.assert_close(lse, torch.logsumexp(x.detach(), -1))
    d = xent_bwd_reference(x.detach(), lab, lse, torch.from_numpy(g),
                           smoothing)
    torch.testing.assert_close(d, x.grad, atol=1e-8, rtol=1e-5)


def test_leading_dims_and_int64_labels():
    logits, labels, _ = _inputs(24, 509, seed=2)
    x = torch.from_numpy(logits).reshape(4, 6, 509)
    lab = torch.from_numpy(labels).long().reshape(4, 6)
    got = softmax_cross_entropy_loss(x, lab, smoothing=0.1)
    assert got.shape == (4, 6)
    want = xent_reference(x, lab, 0.1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0,
                               equal_nan=True)


def test_no_fallback_off_the_cpu():
    # a tensor on neither the CPU nor a CUDA device: the wrapper raises
    # rather than taking its plain version
    x = torch.empty(4, 16, device="meta")
    lab = torch.zeros(4, dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        softmax_cross_entropy_loss(x, lab)
