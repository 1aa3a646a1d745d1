"""apex_tpu_torch paged decode / chunk-prefill attention vs apex_tpu's.

The same seeded numpy inputs go through ``apex_tpu``'s
``paged_decode_attention`` / ``paged_prefill_attention`` with
``interpret=True`` (their Pallas kernels, which need page_len % 128 == 0
— hence page_len = 128 here) and through the port's wrappers, which take
their plain PyTorch versions for CPU tensors. Page tables are random,
share pages between rows and carry sentinel (page 0) entries past each
row's extent; lengths include 0, 1 and a full last page; prefill offsets
sit at 0 and at later page boundaries. Tolerance: fp32 atol = 2e-5,
rtol = 1e-5 (two softmax summation orders).

The CUDA kernels themselves are held against the plain versions on the
card, at the serving path's shapes, by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels.decode_attention import gather_pages as jax_gather
from apex_tpu.kernels.decode_attention import (
    paged_decode_attention as jax_paged_decode)
from apex_tpu.kernels.prefill_attention import (
    paged_prefill_attention as jax_paged_prefill)
from apex_tpu_torch import kernels
from apex_tpu_torch.kernels.decode_attention import (
    gather_pages, paged_decode_attention)
from apex_tpu_torch.kernels.prefill_attention import paged_prefill_attention

PAGE_LEN = 128
ATOL, RTOL = 2e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pool(rng, num_pages, heads, d, page_len=PAGE_LEN):
    shape = (num_pages, heads, page_len, d)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _table(rng, extents, max_pages, num_pages):
    """A page table whose row b holds ``extents[b]`` random pages drawn
    WITH replacement from 1..num_pages-1 (rows and positions share
    pages), then sentinel zeros."""
    pt = np.zeros((len(extents), max_pages), np.int32)
    for b, n in enumerate(extents):
        pt[b, :n] = rng.integers(1, num_pages, n)
    return pt


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(0)
    k, _ = _pool(rng, 5, 2, 32, page_len=8)
    pt = _table(rng, [3, 1, 0], 3, 5)
    want = np.asarray(jax.jit(jax_gather)(
        jnp.asarray(k), jnp.asarray(pt)))
    got = gather_pages(*_t(k, pt))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [64, 32])
def test_paged_decode_matches_jax_pallas(d):
    rng = np.random.default_rng(1)
    heads, num_pages, max_pages = 2, 6, 3
    # lengths: 0 (inactive row), 1, mid-page, a full last page
    lengths = np.array([0, 1, 200, max_pages * PAGE_LEN], np.int32)
    extents = [0, 1, 2, max_pages]
    q = rng.standard_normal((4, heads, d)).astype(np.float32)
    k, v = _pool(rng, num_pages, heads, d)
    pt = _table(rng, extents, max_pages, num_pages)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jax.jit(
        functools.partial(jax_paged_decode, scale=scale, interpret=True))(
            *(jnp.asarray(a) for a in (q, k, v, pt, lengths))))
    got = paged_decode_attention(*_t(q, k, v, pt, lengths))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert np.all(got.numpy()[0] == 0.0)       # lengths == 0 -> zeros


@pytest.mark.parametrize("offsets", [(0, 128), (256, 0)])
def test_paged_prefill_matches_jax_pallas(offsets):
    rng = np.random.default_rng(2)
    heads, d, C, num_pages, max_pages = 2, 64, 128, 7, 3
    offsets = np.array(offsets, np.int32)
    extents = [(o + C) // PAGE_LEN for o in offsets]
    q = rng.standard_normal((2, heads, C, d)).astype(np.float32)
    k, v = _pool(rng, num_pages, heads, d)
    pt = _table(rng, extents, max_pages, num_pages)
    want = np.asarray(jax.jit(
        functools.partial(jax_paged_prefill, interpret=True))(
            *(jnp.asarray(a) for a in (q, k, v, pt, offsets))))
    got = paged_prefill_attention(*_t(q, k, v, pt, offsets))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_plain_versions_ignore_pages_past_the_extent():
    """Sentinel entries and pages past a row's length or causal extent
    can hold anything: poisoning them moves no live row's output."""
    rng = np.random.default_rng(3)
    heads, d = 2, 64
    k, v = _pool(rng, 6, heads, d)
    poisoned = k.copy(), v.copy()
    for pool in poisoned:
        pool[[0, 2, 5]] = 1e4          # sentinel, past-the-extent, unused
    q = rng.standard_normal((2, heads, d)).astype(np.float32)
    pt = np.array([[1, 2, 0, 0], [3, 0, 0, 0]], np.int32)
    lengths = np.array([128, 5], np.int32)       # page 2 not reached
    base = paged_decode_attention(*_t(q, k, v, pt, lengths))
    got = paged_decode_attention(*_t(q, *poisoned, pt, lengths))
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    qc = rng.standard_normal((1, heads, PAGE_LEN, d)).astype(np.float32)
    off = np.array([0], np.int32)                # the chunk is page 1
    base = paged_prefill_attention(*_t(qc, k, v, pt[:1], off))
    got = paged_prefill_attention(*_t(qc, *poisoned, pt[:1], off))
    np.testing.assert_array_equal(got.numpy(), base.numpy())


def test_quantized_cache_is_a_later_slice():
    q, k, v = torch.zeros(1, 1, 32), torch.zeros(2, 1, 8, 32), \
        torch.zeros(2, 1, 8, 32)
    pt, ln = torch.zeros(1, 1, dtype=torch.int32), torch.ones(
        1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="kv-quant"):
        paged_decode_attention(q, k, v, pt, ln, k_scale=torch.ones(1),
                               v_scale=torch.ones(1))
    with pytest.raises(NotImplementedError, match="kv-quant"):
        paged_prefill_attention(q[:, :, None], k, v, pt, ln - 1,
                                k_scale=torch.ones(1),
                                v_scale=torch.ones(1))


def test_cpu_path_launches_no_kernel():
    kernels.reset_launches()
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 1, 32)).astype(np.float32)
    k, v = _pool(rng, 2, 1, 32, page_len=8)
    pt, ln = np.ones((1, 1), np.int32), np.array([3], np.int32)
    paged_decode_attention(*_t(q, k, v, pt, ln))
    assert not any(kernels.launches.values())
