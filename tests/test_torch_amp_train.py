"""apex_tpu_torch training slice vs apex_tpu's, on the CPU.

- The loss scaler: ``update_scale`` over a fixed sequence of
  ``found_inf`` flags, against the JAX schedule, exactly.
- FusedAdam (per-tensor, AdamW and L2 modes) against ``fused_adam``
  (``layout="tree"``): three steps on seeded params and grads.
- The whole slice: a TransformerLM of hidden 256, 2 layers, 4 heads
  (head_dim 64), vocab 1000, S 128, built by the JAX package and carried
  into the port (``params_from_jax``), trained for 3 ``make_train_step``
  steps with the fused LM-head loss, AdamW and the dynamic scaler, at O0
  and at O2, against JAX's ``make_train_step`` on the same batches.
- An overflow step skips everything but the scaler; ``accum_steps=2``
  against JAX's.

Tolerances, with their reasons:

- fp32 (O0) losses at 1e-5 relative: the same function in two
  frameworks' summation orders.
- Adam's first step moves a parameter by about ``lr * sign(g)``
  whatever ``|g|``, so a gradient element near 0 that the two sides
  round to opposite signs moves the parameter ``lr`` one way on one side
  and the other way on the other: a final parameter may differ by up to
  ``2 * lr`` per step. Every parameter is held to that bound. The key
  third of each ``qkv`` bias lives on it: its exact gradient is 0
  (softmax does not see a shift shared by every key), so what both
  sides step on is rounding noise. The other O0 parameters are held, all
  but one in 10^4, to 1e-5.
- O2 (bf16 activations and gradients, fp32 LayerNorm params and
  masters): a bf16 GEMM output or gradient may round one ulp apart
  (2^-8 relative) wherever the two sides' fp32 accumulators differ in
  the last bits. Across 2 layers and a 1000-way head that moves the loss
  by ~1e-4 over three steps, held at 1e-3 relative; it moves small
  gradients by enough to change Adam's normalised step, so the masters
  are held to the Adam bound, and all but 1% of them to 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.amp.scaler import init_scaler as jax_init_scaler
from apex_tpu.amp.scaler import update_scale as jax_update_scale
from apex_tpu.kernels.lm_head_loss import (
    lm_head_xentropy as jax_lm_head_xentropy)
from apex_tpu.models.transformer_lm import TransformerLM as JaxLM
from apex_tpu.optimizers.fused_adam import fused_adam as jax_fused_adam
from apex_tpu_torch import amp
from apex_tpu_torch.amp.scaler import init_scaler, update_scale
from apex_tpu_torch.examples.lm.main_amp import fused_head_loss_fn
from apex_tpu_torch.models import (TransformerLM, params_from_jax,
                                   params_to_jax)
from apex_tpu_torch.optimizers import FusedAdam

VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 1000, 256, 2, 4, 128, 2
LR, WD, STEPS = 1e-3, 0.01, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------ the scaler
@pytest.mark.parametrize("hysteresis", [1, 2])
def test_update_scale_matches_jax(hysteresis):
    flags = [False, False, True, False, False, False, True, True, True,
             False, False, False, False]
    kw = dict(scale_window=3, hysteresis=hysteresis, min_loss_scale=256.0,
              init_scale=1024.0, max_loss_scale=4096.0)
    js, ts = jax_init_scaler("dynamic", **kw), init_scaler("dynamic", **kw)
    for f in flags:
        js, ts = jax_update_scale(js, jnp.bool_(f)), update_scale(ts, f)
        assert float(js.loss_scale) == float(ts.loss_scale)
        assert (int(js.unskipped), int(js.steps), int(js.overflows),
                int(js.hysteresis_left)) == (
                    ts.unskipped, ts.steps, ts.overflows, ts.hysteresis_left)
    # static scalers count but never move
    js, ts = jax_init_scaler(128.0), init_scaler(128.0)
    for f in flags:
        js, ts = jax_update_scale(js, jnp.bool_(f)), update_scale(ts, f)
    assert float(ts.loss_scale) == float(js.loss_scale) == 128.0
    assert ts.unskipped == int(js.unskipped)


# ------------------------------------------------------------ FusedAdam
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_fused_adam_matches_jax_tree(adam_w_mode, bias_correction):
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (13,), (3, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = jax_fused_adam(LR, weight_decay=WD, adam_w_mode=adam_w_mode,
                        bias_correction=bias_correction)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = FusedAdam(tp, lr=LR, weight_decay=WD, adam_w_mode=adam_w_mode,
                    bias_correction=bias_correction)
    for g in grads:
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        opt.zero_grad()
    assert opt.param_groups[0]["step"] == int(jstate.count) == 3
    for p, want, m, v, wm, wv in zip(tp, jp, [opt.state[p]["exp_avg"]
                                               for p in tp],
                                     [opt.state[p]["exp_avg_sq"]
                                      for p in tp], jstate.m, jstate.v):
        # the same fp32 operations in the same order; pow may differ by
        # an ulp between the two libraries' fp32 power functions
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=1e-6)


def test_fused_adam_refuses_what_is_not_ported():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(p, amsgrad=True)
    with pytest.raises(ValueError, match="layout"):
        FusedAdam(p, layout="superbuffer")
    # the flat layout (kernel #24 over one fp32 superbuffer) is ported
    opt = FusedAdam(p, layout="flat")
    p[0].grad = torch.ones(2)
    opt.step()
    assert opt.layout == "flat" and opt.flat_state[0]["exp_avg"].shape == (2,)


# ------------------------------------------------------- the whole slice
@pytest.fixture(scope="module")
def jax_weights():
    model = JaxLM(vocab_size=VOCAB, hidden=HIDDEN, num_layers=LAYERS,
                  num_heads=HEADS, max_seq_len=SEQ)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 8), jnp.int32), train=False))(
            jax.random.PRNGKey(0))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _batches(n, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (batch, SEQ + 1)).astype(np.int32)
            for _ in range(n)]


def _run_jax(weights, opt_level, batches, accum_steps=1):
    policy = jax_amp.resolve_policy(opt_level, verbose=False)
    model = JaxLM(vocab_size=VOCAB, hidden=HIDDEN, num_layers=LAYERS,
                  num_heads=HEADS, max_seq_len=SEQ,
                  dtype=policy.model_dtype)

    def loss_fn(p, tokens):
        hidden = model.apply({"params": p}, tokens[:, :-1], train=True,
                             features_only=True)
        return jax_lm_head_xentropy(hidden, p["wte"]["embedding"],
                                    tokens[:, 1:],
                                    compute_dtype=policy.compute_dtype
                                    ).mean()

    init_fn, step_fn = jax_amp.make_train_step(
        loss_fn, jax_fused_adam(LR, weight_decay=WD, adam_w_mode=True),
        policy, accum_steps=accum_steps)
    state = init_fn(jax.tree_util.tree_map(jnp.asarray, weights))
    step = jax.jit(step_fn)
    history = []
    for b in batches:
        state, m = step(state, jax_amp.to_microbatches(jnp.asarray(b),
                                                       accum_steps))
        history.append((float(m["loss"]), bool(m["found_inf"]),
                        float(m["loss_scale"])))
    final = state.master_params if state.master_params is not None \
        else state.params
    return history, jax.tree_util.tree_map(np.asarray, final)


def _port(weights, opt_level, accum_steps=1, loss_fn=None):
    policy = amp.resolve_policy(opt_level, verbose=False)
    model = TransformerLM(vocab_size=VOCAB, hidden=HIDDEN,
                          num_layers=LAYERS, num_heads=HEADS,
                          max_seq_len=SEQ)
    model.load_state_dict(params_from_jax(weights))
    opt = FusedAdam(model.parameters(), lr=LR, weight_decay=WD)
    init_fn, step_fn = amp.make_train_step(
        loss_fn or fused_head_loss_fn(0.0, policy.compute_dtype), opt,
        policy, accum_steps=accum_steps)
    return init_fn(model), step_fn


def _run_port(weights, opt_level, batches, accum_steps=1):
    state, step_fn = _port(weights, opt_level, accum_steps)
    history = []
    for b in batches:
        state, m = step_fn(state, amp.to_microbatches(
            torch.from_numpy(b).long(), accum_steps))
        history.append((float(m["loss"]), m["found_inf"], m["loss_scale"]))
    names = [n for n, _ in state.model.named_parameters()]
    final = state.master_params or state.params
    return history, params_to_jax(dict(zip(names, final)))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _check_params(got, want, near_tol, far_share, steps=STEPS):
    """Every parameter within the Adam sign bound (2 * lr per step); all
    but ``far_share`` of them within ``near_tol``, leaving out the key
    third of the ``qkv`` biases, whose exact gradient is 0."""
    bound = 2 * LR * steps
    total = far = 0
    got_leaves = dict(_leaves(got))
    for path, w in _leaves(want):
        key = jax.tree_util.keystr(path)
        diff = np.abs(got_leaves[path] - np.asarray(w, np.float32))
        assert diff.max() <= bound, (key, diff.max())
        if key.endswith("['qkv']['bias']"):
            diff = np.concatenate([diff[:HIDDEN], diff[2 * HIDDEN:]])
        total += diff.size
        far += int((diff > near_tol).sum())
    assert far <= far_share * total, (far, total)


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_three_train_steps_match_jax(jax_weights, opt_level):
    batches = _batches(STEPS)
    want_hist, want_params = _run_jax(jax_weights, opt_level, batches)
    got_hist, got_params = _run_port(jax_weights, opt_level, batches)
    rtol = 1e-5 if opt_level == "O0" else 1e-3
    for (gl, gf, gs), (wl, wf, ws) in zip(got_hist, want_hist):
        assert gf is wf is False
        assert gs == ws
        assert abs(gl - wl) <= rtol * abs(wl), (got_hist, want_hist)
    # the loss moved: three steps on these batches did train
    assert got_hist[-1][0] < got_hist[0][0]
    if opt_level == "O0":
        _check_params(got_params, want_params, 1e-5, 1e-4)
    else:
        _check_params(got_params, want_params, 1e-3, 1e-2)


def test_accum_steps_2_matches_jax(jax_weights):
    batches = _batches(2, seed=1, batch=4)
    want_hist, want_params = _run_jax(jax_weights, "O0", batches,
                                      accum_steps=2)
    got_hist, got_params = _run_port(jax_weights, "O0", batches,
                                     accum_steps=2)
    for (gl, _, gs), (wl, _, ws) in zip(got_hist, want_hist):
        assert gs == ws and abs(gl - wl) <= 1e-5 * abs(wl)
    _check_params(got_params, want_params, 1e-5, 1e-4, steps=2)


def test_overflow_step_skips_all_but_the_scaler(jax_weights):
    # No finite scale overflows these gradients (their largest is ~1e-1,
    # fp32's largest value ~2^128), and the backward seed of a scaled
    # loss is the scale itself. The overflow step multiplies its loss by
    # 2^127 instead: the scaled backward seed, 2^127 * 2^16, is inf.
    boost = {"factor": 1.0}
    head = fused_head_loss_fn(0.0, torch.bfloat16)
    state, step_fn = _port(jax_weights, "O2", loss_fn=lambda m, b: head(
        m, b) * boost["factor"])
    batch = torch.from_numpy(_batches(1, seed=2)[0]).long()
    state, m = step_fn(state, batch)              # one real step first
    assert not m["found_inf"]

    def snapshot():
        opt = state.optimizer
        return ([p.detach().clone() for p in state.params],
                [p.detach().clone() for p in state.master_params],
                [{k: v.clone() for k, v in opt.state[p].items()}
                 for p in state.master_params],
                [g["step"] for g in opt.param_groups])

    before = snapshot()
    boost["factor"] = 2.0 ** 127
    state, m = step_fn(state, batch)
    assert m["found_inf"] and m["loss_scale"] == 2.0 ** 16
    assert float(state.scaler.loss_scale) == 2.0 ** 15
    assert state.scaler.overflows == 1 and state.scaler.unskipped == 0
    after = snapshot()
    for a, b in zip(before[:2], after[:2]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(before[2], after[2])
               for k in x)
    assert before[3] == after[3] == [1]
    boost["factor"] = 1.0                         # and training goes on
    state, m = step_fn(state, batch)
    assert not m["found_inf"] and state.optimizer.param_groups[0][
        "step"] == 2


def test_o2_casts_norms_fp32_and_points_the_optimizer_at_masters(
        jax_weights):
    state, _ = _port(jax_weights, "O2")
    for name, p in state.model.named_parameters():
        want = torch.float32 if "ln" in name else torch.bfloat16
        assert p.dtype == want, name
    opt_params = state.optimizer.param_groups[0]["params"]
    assert all(p.dtype == torch.float32 for p in opt_params)
    assert {id(p) for p in opt_params} == {id(p)
                                          for p in state.master_params}
    # O1 (the autocast engine) is ported: it keeps the model fp32 and
    # steps its own parameters, with no masters
    state, _ = _port(jax_weights, "O1")
    assert state.master_params is None
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
