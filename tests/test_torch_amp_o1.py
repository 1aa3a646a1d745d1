"""apex_tpu_torch amp O1 (the per-op cast engine) vs apex_tpu's, on the CPU.

- The op tables: the port's copies hold the JAX package's names, and
  ``Policy.op_dtype`` gives every name of them the same dtype at every
  opt level, CASTS promotion included.
- ``autocast`` nesting, ``resolve_dtype`` and ``cast_op_inputs``.
- The whole O1 path: a TransformerLM of hidden 256, 2 layers, 4 heads
  (head_dim 64), vocab 1000, S 128, built by the JAX package and carried
  into the port (``params_from_jax``): the forward logits under
  ``autocast(O1)``, then 3 ``make_train_step`` steps with the default
  loss (``softmax_cross_entropy_loss`` on the fp32 logits), AdamW in
  both FusedAdam layouts and the dynamic scaler, against JAX's
  ``make_train_step`` on the same batches.

Tolerances, with their reasons (as in ``test_torch_amp_train.py``): O1
runs the GEMMs, q/k/v and the residual stream in bf16, so a GEMM output
may round one bf16 ulp (2^-8 relative) apart wherever the two sides'
fp32 accumulators differ in the last bits, and those roundings in the
bf16 residual stream reach the fp32 logits through ln_f and the head.
Logits are held to one bf16 ulp of the largest logit (2^-7 max|logit|,
0.041 here; 0.017 measured); losses over three steps to 1e-3 relative
(9e-5 measured); the trained parameters to Adam's sign bound (2 * lr per
step), and all but 1% of them to 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.amp import lists as jax_lists
from apex_tpu.amp.autocast import autocast as jax_autocast
from apex_tpu.kernels.xentropy import (
    softmax_cross_entropy_loss as jax_softmax_cross_entropy_loss)
from apex_tpu.models.transformer_lm import TransformerLM as JaxLM
from apex_tpu.optimizers.fused_adam import fused_adam as jax_fused_adam
from apex_tpu_torch import amp
from apex_tpu_torch.amp import lists
from apex_tpu_torch.examples.lm.main_amp import xent_loss_fn
from apex_tpu_torch.models import (TransformerLM, params_from_jax,
                                   params_to_jax)
from apex_tpu_torch.optimizers import FusedAdam

VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 1000, 256, 2, 4, 128, 2
LR, WD, STEPS = 1e-3, 0.01, 3
_NAMES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float16): torch.float16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _torch_dtype(d):
    return None if d is None else _NAMES[jnp.dtype(d)]


# ------------------------------------------------------- the tables
def test_tables_are_the_jax_packages():
    for name in ("FP16_FUNCS", "FP32_FUNCS", "CASTS", "SEQUENCE_CASTS"):
        assert getattr(lists, name) == getattr(jax_lists, name), name


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2", "O3"])
def test_op_dtype_over_every_table_name(opt_level):
    jp = jax_amp.resolve_policy(opt_level, verbose=False)
    tp = amp.resolve_policy(opt_level, verbose=False)
    names = sorted(jax_lists.FP16_FUNCS | jax_lists.FP32_FUNCS
                   | jax_lists.CASTS | jax_lists.SEQUENCE_CASTS
                   | {"relu", "embedding"})
    for name in names:
        for operands in ((), (jnp.bfloat16, jnp.float32),
                         (jnp.bfloat16, jnp.bfloat16)):
            want = _torch_dtype(jp.op_dtype(name, *operands))
            got = tp.op_dtype(name, *[_NAMES[jnp.dtype(d)]
                                      for d in operands])
            assert got == want, (opt_level, name, operands)
    assert _torch_dtype(jp.compute_dtype) == tp.compute_dtype
    assert _torch_dtype(jp.param_dtype) == tp.param_dtype
    assert _torch_dtype(jp.model_dtype) == tp.model_dtype
    assert bool(jp.wants_master_weights) == tp.master_weights
    assert jp.loss_scale == tp.loss_scale


def test_o1_policy_fields():
    p = amp.resolve_policy("O1", verbose=False)
    assert p.patch_torch_functions and not p.master_weights
    assert p.cast_model_type is None and p.loss_scale == "dynamic"
    assert p.param_dtype == torch.float32
    assert p.compute_dtype == torch.bfloat16 and p.model_dtype is None
    assert "patch_torch_functions" in p.banner()
    with pytest.raises(ValueError, match="letter O"):
        amp.resolve_policy("01", verbose=False)


def test_autocast_nesting_and_resolution():
    o1 = amp.resolve_policy("O1", verbose=False)
    o2 = amp.resolve_policy("O2", verbose=False)
    assert amp.active_policy() is None
    assert amp.resolve_dtype(None, "linear", torch.float16) == torch.float16
    with amp.autocast(o1):
        assert amp.active_policy() is o1
        assert amp.op_compute_dtype("linear") == torch.bfloat16
        assert amp.resolve_dtype(None, "layer_norm") == torch.float32
        assert amp.resolve_dtype(torch.float16, "linear") == torch.float16
        with amp.autocast(o2):
            assert amp.active_policy() is o2
            assert amp.op_compute_dtype("linear") is None
        assert amp.active_policy() is o1
        a = torch.ones(2, dtype=torch.bfloat16)
        b = torch.ones(2)
        i = torch.ones(2, dtype=torch.int64)
        x, y, k = amp.cast_op_inputs("add", a, b, i)
        assert (x.dtype, y.dtype, k.dtype) == (torch.float32,
                                               torch.float32, torch.int64)
        assert amp.cast_op_inputs("matmul", b).dtype == torch.bfloat16
        assert amp.cast_op_inputs("relu", a) is a
    assert amp.active_policy() is None


# ---------------------------------------------------- the O1 path
@pytest.fixture(scope="module")
def jax_weights():
    model = JaxLM(vocab_size=VOCAB, hidden=HIDDEN, num_layers=LAYERS,
                  num_heads=HEADS, max_seq_len=SEQ)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 8), jnp.int32), train=False))(
            jax.random.PRNGKey(0))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_model(policy):
    return JaxLM(vocab_size=VOCAB, hidden=HIDDEN, num_layers=LAYERS,
                 num_heads=HEADS, max_seq_len=SEQ, dtype=policy.model_dtype)


def _port_model(weights):
    model = TransformerLM(vocab_size=VOCAB, hidden=HIDDEN,
                          num_layers=LAYERS, num_heads=HEADS,
                          max_seq_len=SEQ)
    model.load_state_dict(params_from_jax(weights))
    return model


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
            for _ in range(n)]


def test_o1_forward_logits_match_jax(jax_weights):
    jpol = jax_amp.resolve_policy("O1", verbose=False)
    tokens = _batches(1, seed=3)[0][:, :-1]
    with jax_autocast(jpol):
        want = _jax_model(jpol).apply(
            {"params": jax.tree_util.tree_map(jnp.asarray, jax_weights)},
            jnp.asarray(tokens), train=True)
    model = _port_model(jax_weights)
    with torch.no_grad(), amp.autocast(amp.resolve_policy("O1",
                                                          verbose=False)):
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= 2.0 ** -7 * np.abs(np.asarray(want)).max(), \
        diff.max()
    # the same model outside the autocast scope runs fp32: O1 moved it
    with torch.no_grad():
        fp32 = model(torch.from_numpy(tokens).long())
    assert (fp32 - got).abs().max() > 1e-4


def _run_jax(weights, batches, layout):
    policy = jax_amp.resolve_policy("O1", verbose=False)
    model = _jax_model(policy)

    def loss_fn(p, tokens):
        logits = model.apply({"params": p}, tokens[:, :-1], train=True)
        return jax_softmax_cross_entropy_loss(logits, tokens[:, 1:]).mean()

    init_fn, step_fn = jax_amp.make_train_step(
        loss_fn, jax_fused_adam(LR, weight_decay=WD, adam_w_mode=True,
                                layout=layout), policy)
    state = init_fn(jax.tree_util.tree_map(jnp.asarray, weights))
    step = jax.jit(step_fn)
    history = []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        history.append((float(m["loss"]), bool(m["found_inf"]),
                        float(m["loss_scale"])))
    return history, jax.tree_util.tree_map(np.asarray, state.params)


def _run_port(weights, batches, layout):
    policy = amp.resolve_policy("O1", verbose=False)
    model = _port_model(weights)
    opt = FusedAdam(model.parameters(), lr=LR, weight_decay=WD,
                    layout=layout)
    init_fn, step_fn = amp.make_train_step(xent_loss_fn(0.0), opt, policy)
    state = init_fn(model)
    assert state.master_params is None
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    history = []
    for b in batches:
        state, m = step_fn(state, torch.from_numpy(b).long())
        history.append((float(m["loss"]), m["found_inf"], m["loss_scale"]))
    names = [n for n, _ in state.model.named_parameters()]
    return history, params_to_jax(dict(zip(names, state.params)))


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_o1_three_train_steps_match_jax(jax_weights, layout):
    batches = _batches(STEPS)
    want_hist, want = _run_jax(jax_weights, batches, layout)
    got_hist, got = _run_port(jax_weights, batches, layout)
    for (gl, gf, gs), (wl, wf, ws) in zip(got_hist, want_hist):
        assert gf is wf is False
        assert gs == ws
        assert abs(gl - wl) <= 1e-3 * abs(wl), (got_hist, want_hist)
    assert got_hist[-1][0] < got_hist[0][0]
    bound = 2 * LR * STEPS
    total = far = 0
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        diff = np.abs(got_leaves[path] - np.asarray(w, np.float32))
        assert diff.max() <= bound, (jax.tree_util.keystr(path), diff.max())
        total += diff.size
        far += int((diff > 1e-3).sum())
    assert far <= 1e-2 * total, (far, total)
