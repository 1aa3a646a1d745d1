"""apex_tpu_torch TransformerLM (paged decode / chunk modes) vs apex_tpu's.

A tiny ``create_lm``-shaped JAX model (hidden 64, 2 layers, 2 heads,
vocab 256) is initialised from a seed, its parameters carried into the
port with ``params_from_jax``, and both run the same tokens against the
same paged pools at fp32. With page_len = 16 the JAX model takes its
attention reference path (its Pallas kernels need page_len % 128 == 0;
the kernel tests cover those). Compared: the logits and the updated
pools, at atol = 1e-4 (fp32 through two layers and a 256-way head, in
two frameworks' summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.transformer_lm import TransformerLM as JaxLM
from apex_tpu_torch.models import (TransformerLM, params_from_jax,
                                   params_to_jax)
from apex_tpu_torch.models.transformer_lm import _LM_SIZES, create_lm

VOCAB, HIDDEN, LAYERS, HEADS, MAX_SEQ = 256, 64, 2, 2, 128
PAGE_LEN, NUM_PAGES, MAX_PAGES = 16, 9, 8
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLM(vocab_size=VOCAB, hidden=HIDDEN, num_layers=LAYERS,
                   num_heads=HEADS, max_seq_len=MAX_SEQ)
    params = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, 8), jnp.int32), train=False))(
            jax.random.PRNGKey(0))["params"]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tmodel = TransformerLM(vocab_size=VOCAB, hidden=HIDDEN,
                           num_layers=LAYERS, num_heads=HEADS,
                           max_seq_len=MAX_SEQ)
    tmodel.load_state_dict(params_from_jax(params_np))
    return jmodel, params, tmodel.eval()


def _pools(seed):
    rng = np.random.default_rng(seed)
    shape = (LAYERS, NUM_PAGES, HEADS, PAGE_LEN, HIDDEN // HEADS)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _run_both(models, tokens, k, v, pt, positions):
    jmodel, params, tmodel = models
    # jitted: op-by-op dispatch of the flax model costs seconds here
    jl, (jk, jv) = jax.jit(
        lambda p, t, k, v, pt, pos: jmodel.apply(
            {"params": p}, t, train=False, cache=(k, v, pt),
            positions=pos))(
                params, *(jnp.asarray(a) for a in (
                    tokens, k, v, pt, positions)))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    with torch.no_grad():
        tl, (tk2, tv2) = tmodel(
            torch.from_numpy(tokens), cache=(tk, tv, torch.from_numpy(pt)),
            positions=torch.from_numpy(positions))
    # the port updates the pools in place
    assert tk2 is tk and tv2 is tv
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL,
                               rtol=0)
    return tk.numpy(), tv.numpy()


def test_chunk_mode_matches_jax(models):
    rng = np.random.default_rng(10)
    k, v = _pools(11)
    pt = np.zeros((1, MAX_PAGES), np.int32)
    pt[0, :4] = [3, 7, 1, 5]
    tokens = rng.integers(0, VOCAB, (1, 32)).astype(np.int32)
    # first chunk at 0, then a second chunk attending the first's K/V
    k, v = _run_both(models, tokens, k, v, pt, np.array([0], np.int32))
    tokens2 = rng.integers(0, VOCAB, (1, 32)).astype(np.int32)
    _run_both(models, tokens2, k, v, pt, np.array([32], np.int32))


def test_decode_mode_matches_jax(models):
    rng = np.random.default_rng(12)
    k, v = _pools(13)
    # row 0 live mid-page, row 1 at a page boundary (its write opens a
    # fresh page), row 2 inactive on the sentinel page, row 3 at max_len
    pt = np.zeros((4, MAX_PAGES), np.int32)
    pt[0, :2] = [2, 4]
    pt[1, :3] = [6, 8, 3]
    pt[3, :] = [1, 2, 3, 4, 5, 6, 7, 8]
    positions = np.array([20, 32, 0, MAX_PAGES * PAGE_LEN - 1], np.int32)
    tokens = rng.integers(0, VOCAB, (4, 1)).astype(np.int32)
    _run_both(models, tokens, k, v, pt, positions)


def test_features_only_and_head(models):
    _, _, tmodel = models
    k, v = (torch.from_numpy(a) for a in _pools(14))
    pt = torch.zeros((1, MAX_PAGES), dtype=torch.int32)
    pt[0, :2] = torch.tensor([1, 2])
    tokens = torch.arange(16)[None]
    with torch.no_grad():
        feats = tmodel(tokens, cache=(k.clone(), v.clone(), pt),
                       positions=torch.tensor([0], dtype=torch.int32),
                       features_only=True)
        logits, _ = tmodel(tokens, cache=(k.clone(), v.clone(), pt),
                           positions=torch.tensor([0], dtype=torch.int32))
    assert feats.shape == (1, 16, HIDDEN)
    torch.testing.assert_close(tmodel.head(feats), logits)


def test_no_cache_modes_are_a_later_slice(models):
    # the training forward (no cache) is ported; monolithic prefill
    # (return_kv) and the contiguous cache are the contiguous engine's
    _, _, tmodel = models
    with pytest.raises(NotImplementedError, match="return_kv"):
        tmodel(torch.zeros((1, 4), dtype=torch.long), return_kv=True)
    with pytest.raises(NotImplementedError, match="remat"):
        TransformerLM(vocab_size=VOCAB, hidden=HIDDEN, num_layers=1,
                      num_heads=HEADS, remat=True)
    with pytest.raises(NotImplementedError, match="dropout"):
        TransformerLM(vocab_size=VOCAB, hidden=HIDDEN, num_layers=1,
                      num_heads=HEADS, dropout=0.1)
    k, v = (torch.from_numpy(a) for a in _pools(15))
    with pytest.raises(NotImplementedError, match="paged=False"):
        tmodel(torch.zeros((1, 1), dtype=torch.long), cache=(k, v),
               positions=torch.zeros(1, dtype=torch.int32))


def test_training_forward_matches_jax(models):
    # no cache: causal attention over positions [0, S), the flash
    # attention path (its plain version on the CPU), fp32 at ATOL
    jmodel, params, tmodel = models
    tokens = np.random.default_rng(16).integers(0, VOCAB, (2, 24))
    want = jax.jit(lambda p, t: jmodel.apply({"params": p}, t,
                                             train=True))(
        params, jnp.asarray(tokens, jnp.int32))
    feats = tmodel(torch.from_numpy(tokens), features_only=True)
    logits = tmodel(torch.from_numpy(tokens))
    assert feats.shape == (2, 24, HIDDEN) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    torch.testing.assert_close(tmodel.head(feats), logits)


def test_params_to_jax_inverts_params_from_jax(models):
    _, params, tmodel = models
    tree = params_to_jax(tmodel.state_dict())
    want = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unmapped"):
        params_to_jax(dict(tmodel.state_dict(), extra=torch.zeros(1)))


def test_params_from_jax_shapes(models):
    _, params, tmodel = models
    sd = params_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                           params)})
    assert set(sd) == set(tmodel.state_dict())
    qkv = np.asarray(params["block_0"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(sd["blocks.0.attn.qkv.weight"].numpy(),
                                  qkv.T)


def test_create_lm_sizes_and_seed():
    assert _LM_SIZES["gpt2"] == (768, 12, 12)
    a = create_lm("tiny", vocab_size=64, max_seq_len=32, seed=3)
    b = create_lm("tiny", vocab_size=64, max_seq_len=32, seed=3)
    assert (a.hidden, a.num_layers, a.num_heads) == _LM_SIZES["tiny"]
    for (n, pa), (_, pb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert torch.equal(pa, pb), n
    with pytest.raises(ValueError, match="unknown LM size"):
        create_lm("huge")
