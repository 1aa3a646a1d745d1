"""apex_tpu_torch serving (paged Engine + chunked Scheduler) vs apex_tpu's.

One tiny JAX ``TransformerLM`` (hidden 64, 2 layers, 2 heads, vocab 256)
is carried into the port with ``params_from_jax``. Both packages build
``Engine(policy=O0, slots=2, max_len=128, prefill_len=64, chunk_len=16)``
— page_len 16, so JAX takes its attention reference path (its Pallas
kernels need page_len % 128 == 0) and the port its plain PyTorch path —
and serve the same 5 greedy requests through their ``Scheduler``:
prompts of 5-60 tokens (multi-chunk prompts with partial final chunks)
and more requests than slots (requests queue). The greedy token streams
must be identical, and both pools must drain to zero pages in use.

While the JAX reference serves, ``jnp.asarray`` copies a numpy array
before it takes it. The JAX engine hands its host state (per-slot
lengths, the page table) to its programs through ``jnp.asarray``, which
on the CPU backend (jax 0.9.0) takes a 64-byte-aligned numpy array
without a copy, and bumps the lengths in place right after an
asynchronous dispatch: a program that runs late, as on a busy machine,
reads the bumped lengths and serves wrong tokens. The copy keeps the
reference exact without changing ``apex_tpu``; it is undone after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.policy import resolve_policy as jax_resolve_policy
from apex_tpu.models.transformer_lm import TransformerLM as JaxLM
from apex_tpu.serving import Engine as JaxEngine
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import Scheduler as JaxScheduler
from apex_tpu_torch.amp import resolve_policy
from apex_tpu_torch.models import TransformerLM, params_from_jax
from apex_tpu_torch.serving import (Engine, QueueFull, Request,
                                    RequestStatus, Scheduler,
                                    resolve_page_len, sample_tokens)

VOCAB, HIDDEN, LAYERS, HEADS, MAX_SEQ = 256, 64, 2, 2, 128
GEOM = dict(slots=2, max_len=128, prefill_len=64, chunk_len=16)
PROMPT_LENS = (5, 16, 17, 40, 60)
NEW_TOKENS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, VOCAB, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX reference's streams and drained pool, and the port model
    on its weights."""
    jmodel = JaxLM(vocab_size=VOCAB, hidden=HIDDEN, num_layers=LAYERS,
                   num_heads=HEADS, max_seq_len=MAX_SEQ)
    params = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, 8), jnp.int32), train=False))(
            jax.random.PRNGKey(1))["params"]
    asarray = jnp.asarray

    def asarray_copy(a, *args, **kw):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return asarray(a, *args, **kw)

    # see the module docstring
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", asarray_copy)
        eng = JaxEngine(jmodel, params,
                        policy=jax_resolve_policy("O0", verbose=False),
                        **GEOM)
        reqs = [JaxRequest(prompt=p, max_new_tokens=NEW_TOKENS)
                for p in _prompts()]
        JaxScheduler(eng).run(reqs)
        ref = {"streams": [[int(t) for t in r.output_tokens]
                           for r in reqs], "page_len": eng.page_len}
        eng.reset()
        ref["pages_in_use"] = eng.pool_stats()["pages_in_use"]
    tmodel = TransformerLM(vocab_size=VOCAB, hidden=HIDDEN,
                           num_layers=LAYERS, num_heads=HEADS,
                           max_seq_len=MAX_SEQ)
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return ref, tmodel


@pytest.fixture(scope="module")
def tmodel(jax_run):
    return jax_run[1]


def _engine(tmodel, **kw):
    return Engine(tmodel, policy=resolve_policy("O0", verbose=False),
                  device="cpu", **{**GEOM, **kw})


def test_greedy_streams_match_jax_scheduler(jax_run):
    ref, tmodel = jax_run
    eng = _engine(tmodel)
    assert eng.page_len == ref["page_len"] == 16
    reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in _prompts()]
    done = Scheduler(eng).run(reqs)
    assert len(done) == len(reqs)
    for r, want in zip(reqs, ref["streams"]):
        assert r.status == RequestStatus.FINISHED
        assert r.finish_reason == "max_new_tokens"
        assert r.chunks == -(-len(r.prompt) // GEOM["chunk_len"])
        assert r.output_tokens == want, f"prompt of {len(r.prompt)} tokens"
    assert eng.tokens_generated == len(reqs) * NEW_TOKENS
    eng.reset()
    assert eng.pool_stats()["pages_in_use"] == 0
    assert ref["pages_in_use"] == 0


def test_scheduler_backpressure_eos_and_timeout(tmodel):
    eng = _engine(tmodel)
    sched = Scheduler(eng, max_queue=2)
    sched.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
    sched.submit(Request(prompt=[4, 5], max_new_tokens=4))
    with pytest.raises(QueueFull):
        sched.submit(Request(prompt=[6], max_new_tokens=4))
    with pytest.raises(ValueError, match="prefill_len"):
        sched.submit(Request(prompt=list(range(65)), max_new_tokens=4))
    while sched.pending:
        sched.step()
    first = sched.completed[0].output_tokens[0]
    # the same prompt again with its first token as EOS stops at once
    r = Request(prompt=[1, 2, 3], max_new_tokens=4)
    Scheduler(eng, eos_id=first).run([r])
    assert r.output_tokens == [first] and r.finish_reason == "eos"
    late = Request(prompt=[1, 2], max_new_tokens=4, timeout_s=0.0)
    Scheduler(eng).run([late])
    assert late.status == RequestStatus.EXPIRED
    assert eng.pool_stats()["pages_in_use"] == 0


def test_sampling_greedy_ties_and_top_k():
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [0.0, 5.0, 4.0, -1.0]])
    # temperature 0: argmax, first maximum on ties (as jnp.argmax)
    out = sample_tokens(logits, torch.zeros(2), g)
    assert out.tolist() == [1, 1]
    draws = torch.stack([sample_tokens(logits, torch.ones(2), g, top_k=2)
                         for _ in range(200)])
    assert set(draws[:, 0].tolist()) <= {1, 2}
    assert set(draws[:, 1].tolist()) == {1, 2}


def test_engine_geometry_and_later_slices(tmodel):
    assert resolve_page_len(256) == 128 and resolve_page_len(48) == 48
    assert resolve_page_len(160) == 32            # gcd(128, 160)
    with pytest.raises(ValueError, match="must divide"):
        resolve_page_len(16, 12)
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine(tmodel, max_len=256, prefill_len=64)
    with pytest.raises(ValueError, match="final chunk window"):
        _engine(tmodel, max_len=100, prefill_len=100, chunk_len=48)
    for kw in ({"spec": object()}, {"mesh": object()},
               {"kv_quant": object()}, {"weight_quant": object()},
               {"host_tier": 1}, {"lora": object()}, {"paged": False},
               {"prefix_pool": 2}):
        with pytest.raises(NotImplementedError, match="later slice"):
            _engine(tmodel, **kw)
    eng = _engine(tmodel)
    # the caller's module is copied, not cast in place
    assert eng.model is not tmodel
    assert eng.pages_required(40, 8) == 3         # ceil(48 / 16)
    assert eng.pages_required(5, 100) == 7        # ceil(105 / 16)


def test_engine_scopes_tf32_off_to_its_own_calls(tmodel):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        eng = _engine(tmodel)
        seen = []
        eng.model.register_forward_pre_hook(
            lambda *_: seen.append(torch.backends.cuda.matmul.allow_tf32))
        eng.prefill_chunked(0, [1, 2, 3])
        eng.decode_step([5, 0], [True, False], [0.0, 0.0])
        assert seen == [False, False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
