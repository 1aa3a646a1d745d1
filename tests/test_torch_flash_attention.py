"""apex_tpu_torch flash attention vs apex_tpu's, on the CPU.

The same seeded numpy q, k, v and dO [B 2, h 2, S 256, d 64] go through
``apex_tpu.kernels.flash_attention.flash_attention`` — its Pallas
kernels in interpret mode (128-row tiles: 2 x 2 per head, the tile
above the diagonal skipped) — and through the port's ``autograd``
function, which takes its plain PyTorch versions for CPU tensors:

- fp32: o and lse at atol 2e-5 (one softmax in two summation orders),
  dq / dk / dv at atol 1e-4 (JAX's own flash test uses 1e-4);
- bf16: outputs compared after the cast to fp32 at one bf16 ulp (2^-7
  relative) plus 1e-5 absolute where a value crosses 0 — both sides
  round the same fp32 math once.

``lse`` is held against ``attn_chunk_fwd``, the chunk API over the
same forward kernel. The CUDA kernels themselves are held against the
plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels.flash_attention import attn_chunk_fwd
from apex_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention)
from apex_tpu.kernels.flash_attention import (
    mha_reference as jax_mha_reference)
from apex_tpu_torch import kernels
from apex_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_bwd_reference, flash_fwd_reference,
    mha_reference)

B, H, S, D = 2, 2, 256, 64
TOL = {"float32": (jnp.float32, torch.float32, 2e-5, 1e-4, 0.0),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-5, 1e-5, 2.0 ** -7)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _arrays(seed, n=4, shape=(B, H, S, D)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_grads_match_jax_pallas(dtype, causal):
    jdt, tdt, atol_o, atol_g, rtol = TOL[dtype]
    q, k, v, do = _arrays(0)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))

    def jfwd(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, causal=causal,
                                   interpret=True)

    want_o, vjp = jax.vjp(jfwd, jq, jk, jv)
    want_dq, want_dk, want_dv = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal)
    assert o.dtype == tdt and o.shape == (B, H, S, D)
    o.backward(torch.from_numpy(do).to(tdt))
    _close(o, want_o, atol_o, rtol)
    for got, want in ((tq.grad, want_dq), (tk.grad, want_dk),
                      (tv.grad, want_dv)):
        assert got.dtype == tdt
        _close(got, want, atol_g, rtol)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_lse_matches_attn_chunk_fwd(dtype):
    jdt, tdt, atol_o, _, rtol = TOL[dtype]
    q, k, v = _arrays(1, n=3, shape=(B * H, S, D))
    scale = D ** -0.5
    want_o, want_lse = attn_chunk_fwd(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), scale=scale, causal=True,
        interpret=True)
    o32, lse = flash_fwd_reference(*(torch.from_numpy(a).to(tdt)
                                     for a in (q, k, v)), scale, True)
    # o leaves attn_chunk_fwd in fp32 after the kernel's bf16 store
    _close(o32.to(tdt), want_o, atol_o, rtol)
    _close(lse, want_lse, 2e-5, 1e-6)


def test_plain_backward_is_the_autograd_gradient():
    # flash_bwd_reference's closed form against autograd through
    # mha_reference, fp32: the same function two ways
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(2, shape=(4, 64,
                                                                   D)))
    scale = D ** -0.5
    o32, lse = flash_fwd_reference(q, k, v, scale, True)
    delta = (do * o32).sum(-1)
    dq, dk, dv = flash_bwd_reference(q, k, v, do, lse, delta, scale, True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = mha_reference(*(t[None] for t in leaves), causal=True,
                        scale=scale)[0]
    out.backward(do)
    for got, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=1e-5, rtol=1e-5)


def test_mha_reference_masks_match_jax():
    q, k, v = _arrays(3, n=3, shape=(2, 2, 16, 8))
    bias = np.random.default_rng(4).standard_normal((2, 1, 16, 16)).astype(
        np.float32)
    seg = np.repeat(np.array([[0, 1], [1, 1]], np.int32), 8, axis=1)
    want = jax_mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True, scale=0.3,
                             segment_ids=jnp.asarray(seg),
                             bias=jnp.asarray(bias))
    got = mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=True, scale=0.3,
                        segment_ids=torch.from_numpy(seg),
                        bias=torch.from_numpy(bias))
    _close(got, want, 2e-6, 1e-6)
    # the CPU dispatch of the public function takes mha_reference there
    got2 = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=True, scale=0.3,
                           segment_ids=torch.from_numpy(seg),
                           bias=torch.from_numpy(bias))
    torch.testing.assert_close(got2, got)


def test_cpu_path_launches_no_kernel():
    kernels.reset_launches()
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _arrays(5, n=3, shape=(1, 2, 64, D)))
    flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None
    assert not any(kernels.launches[n] for n in
                   ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))


def test_argument_checks():
    q = torch.zeros(1, 2, 8, D)
    with pytest.raises(ValueError, match="dropout_rate"):
        flash_attention(q, q, q, dropout_rate=1.5)
    with pytest.raises(NotImplementedError, match="dropout"):
        flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=0)
    with pytest.raises(ValueError, match="alike"):
        flash_attention(q, q[:, :1], q)
