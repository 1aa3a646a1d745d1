#!/usr/bin/env python3
"""Smoke run of apex_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA device, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. In order, each phase failing
the run with a non-zero exit:

1. **card** — the device's name and power limit (``nvidia-smi``), torch
   and CUDA versions;
2. **build** — every kernel in ``apex_tpu_torch/csrc`` compiled from the
   checkout's sources, one ``nvcc`` per source, all in parallel;
3. **kernels** — each kernel against its plain PyTorch version on the
   card, at the serving path's shapes, bf16 and fp32 (fp32 atol 2e-5;
   bf16, after the cast to fp32, atol 2e-2 for LayerNorm and 2e-3 plus
   one bf16 ulp for attention, a limit that one page read wrong is shown
   to break in every row it reaches), with CUDA-event medians of the
   kernel, its plain version and one PyTorch library call computing the
   same function (``F.layer_norm``, ``F.scaled_dot_product_attention``
   on the gathered K/V; used nowhere in the port), L2 flushed between
   launches, beside the bound: the larger of bytes moved over 3.35 TB/s
   and operations over the peak rate for the input dtype;
4. **serve** — GPT-2-small width (``create_lm("gpt2", vocab 50257,
   max_seq_len 1024)``, all 12 layers, seeded random weights) as bf16 O3
   through ``Engine(slots=8, max_len=1024, prefill_len=512,
   chunk_len=256)`` and the chunked ``Scheduler``: 16 greedy requests
   (prompt lengths from numpy seed 0 in [32, 512], 64 new tokens) plus
   one at temperature 0.8. Every launch count is zeroed just before and
   read just after: each kernel must have launched, exactly as often as
   the calls made (25 LayerNorms per model call, 12 attention launches
   per chunk or decode step);
5. **parity** — the same weights at O0 fp32 on the card and on the CPU
   (plain path), 2 prompts of 300 tokens (two chunks, one partial), 16
   new tokens each: identical greedy streams, per-step max |dlogit| <=
   1e-3;
6. **train kernels** — at the training path's shapes (8192 rows of 768;
   q, k, v [8 x 12, 1024, 64]): LayerNorm forward with bf16 x and fp32
   gamma/beta, LayerNorm backward (fp32, bf16, bf16 x with fp32 gamma,
   and memory_efficient), flash-attention forward, dK/dV and dQ in bf16
   and fp32, each against its plain version (fp32 atol 2e-5; bf16 2e-3 +
   2^-7 |plain|; dgamma/dbeta, sums over 8192 rows, 1e-5 of the column's
   sum of |terms|), each limit shown to fail a wrong kernel (a gamma
   element changed, a causal mask shifted by one), and timed beside its
   bound, its plain version and the PyTorch call (the backward of
   ``F.layer_norm``, ``F.scaled_dot_product_attention(is_causal=True)``
   and its backward, the latter timed eagerly with the forward outside);
7. **loss and optimizer kernels** — at the default-loss training path's
   shapes: softmax cross-entropy forward and backward (kernels 11-12) on
   [8192, 50257] logits in fp32 and bf16, smoothing 0 and 0.1, four rows
   labelled -100 and four labelled V (losses and lse at 2e-4; dlogits at
   1e-6 of g * (softmax + target) plus one ulp of the output dtype; both
   limits shown to fail with every label shifted by one); the
   multi-tensor scale (kernel 21) over GPT-2's 148 gradients in bf16 and
   fp32 with an inf in the last element, outputs bitwise equal to the
   plain version and found_inf set (PyTorch's unscale takes no bf16 on
   CUDA, so only the fp32 case has a library time); multi-tensor Adam (kernel 24) over
   GPT-2's fp32 masters for 3 steps (two fp32 ulps, bitwise reported; a
   step count off by one shown to fail it) and FusedAdam's tree and flat
   layouts bitwise equal; each timed beside its bound, its plain version
   and the PyTorch call (``F.cross_entropy(reduction="none",
   label_smoothing=s)`` and its backward, ``torch.
   _amp_foreach_non_finite_check_and_unscale_``, ``torch._fused_adamw_``;
   used nowhere in the port);
8. **train** — GPT-2 width and depth (``create_lm("gpt2", vocab 50257,
   max_seq_len 1024)``), B 8 x S 1024 on one batch drawn with numpy seed
   0, AdamW (lr 3e-4, weight decay 0.01) and the dynamic scaler, on three
   paths (``TRAIN_PATHS``): amp O2 with the fused LM-head loss (chunk
   8192) and the tree layout, 12 steps; O2 with the default loss
   (``softmax_cross_entropy_loss`` on the fp32 logits), tree, 12 steps;
   O1 with the default loss and the flat layout, 6 steps. Each path is
   driven with every launch count zeroed just before it and read just
   after: every loss finite, the last 0.5 nats below the first, and the
   exact launches per step of every kernel (25 LayerNorm forwards and
   backwards, 12 flash forwards, dK/dV and dQ, one xentropy forward and
   backward on the default loss, two unscale launches under O2 and one
   under O1, one Adam launch). One more step of each O2 path under
   ``torch.profiler`` (device time by kernel group and the idle share,
   reported, not gated), one overflow step on the fused-head path
   (found_inf, the scale halved, parameters, masters and Adam state
   bitwise unchanged), and the layout check: tree and flat FusedAdam
   train the same weights at O2 for 3 steps to bitwise-equal masters;
9. **train parity** — the same weights at O0 fp32, card vs CPU, full
   width and depth, B 2 x S 256, 3 steps, once with the fused head and
   the tree layout and once with the default loss and the flat layout:
   losses within 1e-4 relative, step-1 gradients within the limit of
   ``_grad_limit``, parameters within Adam's sign bound.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"torch.bfloat16": 989e12,     # dense tensor-core bf16
            "torch.float32": 67e12}       # fp32 outside the tensor cores
LN_OPS_PER_ELEM = 8
# (atol, rtol) of |kernel - plain| <= atol + rtol * |plain|, after the cast
# to fp32. LayerNorm's |y| is O(1). An attention output is a softmax mean
# of up to 1024 V rows, as small as ~0.02: bf16 is held to 2e-3 plus one
# bf16 ulp of the value (2^-7 relative), and every check also shows that
# one page read wrong fails it (_wrong_page_check)
TOL = {"layer_norm": {"torch.float32": (2e-5, 0.0),
                      "torch.bfloat16": (2e-2, 0.0)},
       "attention": {"torch.float32": (2e-5, 0.0),
                     "torch.bfloat16": (2e-3, 2.0 ** -7)}}

# the training path's checks (train kernels phase): fp32 atol 2e-5; bf16
# 2e-3 + one bf16 ulp of the value, as the attention checks above
TRAIN_TOL = {"torch.float32": (2e-5, 0.0),
             "torch.bfloat16": (2e-3, 2.0 ** -7)}
LN_BWD_OPS_PER_ELEM = 13
SUM_RTOL = 1e-5         # dgamma/dbeta: of the column's sum of |terms|
REACH = 8               # a wrong input must fail every row it forms 1/8 of

# xentropy (kernels 11-12): losses and lse (|loss| ~ 13 at these logits)
# at 2e-4 absolute — two fp32 summation orders of 50,257 exponentials
# differ by ~sqrt(n) * 2^-24 of the sum, ~1e-6 of lse typically and
# ~1.3e-5 of it at worst; dlogits at 1e-6 of g * (softmax + target)
# (eight fp32 ulps: one exp from the same lse in two implementations)
# plus one ulp of the output dtype. A few rows at each end of the batch
# are labelled -100 and V.
XENT_LOSS_ATOL = 2e-4
XENT_GRAD_RTOL = 1e-6
XENT_BAD_ROWS = 4
XENT_OPS_PER_ELEM = 6
# Adam (kernel 24): the same fp32 operations in the same order as its
# plain version (no FMA contraction), so bitwise is expected; held to
# two fp32 ulps of the value (plus the smallest normal fp32, a floor for
# exact zeros), and a step count off by one must fail it
# in at least 99.9% of the parameters
ADAM_RTOL = 2.0 ** -22
ADAM_WRONG_SHARE = 0.999
ADAM_OPS_PER_ELEM = 15
GPT2 = dict(size="gpt2", vocab_size=50257, max_seq_len=1024)
TRAIN = dict(batch=8, seq=1024, steps=12, o1_steps=6, lr=3e-4,
             weight_decay=0.01, chunk=8192, min_drop=0.5)
TRAIN_PARITY = dict(batch=2, seq=256, steps=3)
TRAIN_ROWS, HIDDEN, HEADS, HEAD_DIM = 8192, 768, 12, 64
SERVE = dict(slots=8, max_len=1024, prefill_len=512, chunk_len=256)
LN_PER_CALL = 25                          # 2 per block x 12 + ln_f
ATTN_PER_CALL = 12                        # one per block
PAGES = 65                                # the serve engine's pool: 8 x 8 + 1


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phases
def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")


def phase_build():
    from apex_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc)")
    for name, (secs, out) in sorted(built.items()):
        log(f"  {name}.cu: {secs:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")


class Timer:
    """Device time of one call: ``fn`` is captured once into a CUDA graph
    (so host-side Python and launch overhead stay off the clock) and
    each replay is bracketed by CUDA events, the L2 cache flushed first
    (a 64 MiB write, over the H100's 50 MB L2) as a serving step finds
    the layer's pool pages cold. Returns the median over ``reps``."""

    def __init__(self, torch, reps: int = 25):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            graph.replay()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def eager(self, fn) -> float:
        """Median device time of ``fn`` launched eagerly between CUDA
        events, L2 flushed first: for a call a graph cannot capture (an
        autograd backward, whose kernels run on the forward's stream).
        Host-side launch gaps count, so it reads high for short calls."""
        torch = self.torch
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _bound(bytes_moved: float, ops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _uniform(torch, rng, shape, dtype, lo=-1.0, hi=1.0):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
        np.float32)).to("cuda", dtype)


def _excess(got, want, tol):
    """|got - want| over what ``tol`` = (atol, rtol) allows, per element:
    above 1 fails."""
    atol, rtol = tol
    want = want.float()
    return (got.float() - want).abs() / (atol + rtol * want.abs())


def _check(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    excess = _excess(got, want, tol).max().item()
    log(f"  {name}: max|kernel - plain| = {err:.3g} (atol {tol[0]}, rtol "
        f"{tol[1]:.3g}; {excess:.3g} of the allowance)")
    if not excess <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max error {err}, {excess:.3g}x "
                             f"the tolerance {tol}")
    return err


def _page_share(n, j, page_len):
    """Rows that take at least an eighth of the ``n`` positions they
    attend (positions ``[0, n)``) from page slot ``j``: where one page
    read wrong moves the output most weakly, a full page of 1024."""
    return (n - j * page_len).clamp(0, page_len) * 8 >= n


def _wrong_page_check(name, plain, pt, want, reaches, per_row, tol):
    """The tolerance must see one page read wrong: the plain version
    through a table whose slot j names another page has to fail the check
    in EVERY row that takes an eighth of its positions or more from slot
    j, for j the first slot and the last in use. ``plain(table)`` ->
    output; ``reaches(j)`` -> bool per row; ``per_row(excess)`` -> each
    row's worst excess."""
    used = [j for j in range(pt.shape[1]) if bool(reaches(j).any())]
    worst = float("inf")
    for j in sorted({used[0], used[-1]}):
        bad = pt.clone()
        bad[:, j] = bad[:, j] % (PAGES - 1) + 1     # another non-sentinel page
        rows = reaches(j)
        worst = min(worst, per_row(_excess(plain(bad), want, tol))[rows]
                    .min().item())
    log(f"  {name}: one wrong page -> least row excess {worst:.3g} (> 1 "
        f"needed)")
    if not worst > 1.0:
        raise AssertionError(f"{name}: the tolerance {tol} would pass a "
                             f"kernel that reads one wrong page")


def _ln_case(torch, timer, rows, dtype, rng):
    import torch.nn.functional as F
    from apex_tpu_torch.kernels.layer_norm import (layer_norm,
                                                   layer_norm_reference)

    H = 768
    # uniform inputs keep |y| < 4, where one bf16 ulp is below the atol
    x = _uniform(torch, rng, (rows, H), dtype)
    w = _uniform(torch, rng, (H,), dtype, 0.5, 1.5)
    b = _uniform(torch, rng, (H,), dtype, -0.1, 0.1)
    y = layer_norm(x, w, b)[0]
    torch.cuda.synchronize()
    err = _check(f"layer_norm rows={rows} {dtype}", y,
                 layer_norm_reference(x, w, b), TOL["layer_norm"][str(dtype)])
    isz = x.element_size()
    bytes_moved = 2 * rows * H * isz + 2 * H * isz + 2 * rows * 4
    bound, by = _bound(bytes_moved, LN_OPS_PER_ELEM * rows * H, dtype)
    return dict(
        err=err, bound=bound, by=by,
        ms=timer(lambda: layer_norm(x, w, b)),
        plain=timer(lambda: layer_norm_reference(x, w, b)),
        library=timer(lambda: F.layer_norm(x, (H,), w, b, 1e-5)))


def _pool_case(torch, rng, dtype, B):
    heads, d, page_len, max_pages = 12, 64, 128, 8
    num_pages = PAGES
    shape = (num_pages, heads, page_len, d)
    k = _uniform(torch, rng, shape, dtype)
    v = _uniform(torch, rng, shape, dtype)
    pt = torch.from_numpy(np.stack([
        rng.permutation(np.arange(1, num_pages))[:max_pages]
        for _ in range(B)]).astype(np.int32)).cuda()
    return k, v, pt, heads, d, page_len


def _decode_case(torch, timer, dtype, rng):
    import torch.nn.functional as F
    from apex_tpu_torch.kernels.decode_attention import (
        gather_pages, paged_decode_attention,
        paged_decode_attention_reference)

    B = 8
    k, v, pt, heads, d, page_len = _pool_case(torch, rng, dtype, B)
    lens_np = np.array([1, 77, 128, 129, 500, 640, 1000, 1024], np.int32)
    lengths = torch.from_numpy(lens_np).cuda()
    q = _uniform(torch, rng, (B, heads, d), dtype)
    scale = d ** -0.5
    out = paged_decode_attention(q, k, v, pt, lengths)
    torch.cuda.synchronize()
    tol = TOL["attention"][str(dtype)]
    label = f"paged_decode B={B} lengths 1..1024 {dtype}"
    want = paged_decode_attention_reference(q, k, v, pt, lengths,
                                            scale=scale)
    err = _check(label, out, want, tol)
    _wrong_page_check(
        label, lambda table: paged_decode_attention_reference(
            q, k, v, table, lengths, scale=scale), pt, want,
        lambda j: _page_share(lengths, j, page_len),
        lambda ex: ex.amax(dim=(1, 2)), tol)
    isz = q.element_size()
    kv_pos = int(lens_np.sum())
    pages_read = int(sum(-(-n // page_len) for n in lens_np))
    bytes_moved = (2 * q.numel() * isz + 2 * kv_pos * heads * d * isz
                   + 4 * pages_read + 4 * B)
    bound, by = _bound(bytes_moved, 4 * kv_pos * heads * d, dtype)
    kg, vg = gather_pages(k, pt), gather_pages(v, pt)
    mask = (torch.arange(kg.shape[2], device="cuda")[None, None, None, :]
            < lengths[:, None, None, None])
    q4 = q[:, :, None]
    return dict(
        err=err, bound=bound, by=by,
        ms=timer(lambda: paged_decode_attention(q, k, v, pt, lengths)),
        plain=timer(lambda: paged_decode_attention_reference(
            q, k, v, pt, lengths, scale=scale)),
        library=timer(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask)))


def _prefill_case(torch, timer, dtype, offset, rng):
    import torch.nn.functional as F
    from apex_tpu_torch.kernels.decode_attention import gather_pages
    from apex_tpu_torch.kernels.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_reference)

    C = 256
    k, v, pt, heads, d, page_len = _pool_case(torch, rng, dtype, 1)
    off = torch.tensor([offset], dtype=torch.int32, device="cuda")
    q = _uniform(torch, rng, (1, heads, C, d), dtype)
    scale = d ** -0.5
    out = paged_prefill_attention(q, k, v, pt, off)
    torch.cuda.synchronize()
    tol = TOL["attention"][str(dtype)]
    label = f"paged_prefill C={C} offset={offset} {dtype}"
    want = paged_prefill_attention_reference(q, k, v, pt, off, scale=scale)
    err = _check(label, out, want, tol)
    n_attended = offset + 1 + torch.arange(C, device="cuda")   # query i's
    _wrong_page_check(
        label, lambda table: paged_prefill_attention_reference(
            q, k, v, table, off, scale=scale), pt, want,
        lambda j: _page_share(n_attended, j, page_len),
        lambda ex: ex[0].amax(dim=(0, 2)), tol)
    isz = q.element_size()
    attended = C * offset + C * (C + 1) // 2      # sum_i (offset + i + 1)
    pages_read = -(-(offset + C) // page_len)
    bytes_moved = (2 * q.numel() * isz
                   + 2 * (offset + C) * heads * d * isz
                   + 4 * pages_read + 4)
    bound, by = _bound(bytes_moved, 4 * attended * heads * d, dtype)
    kg, vg = gather_pages(k, pt), gather_pages(v, pt)
    L = kg.shape[2]
    mask = (torch.arange(L, device="cuda")[None, :]
            <= offset + torch.arange(C, device="cuda")[:, None])
    return dict(
        err=err, bound=bound, by=by,
        ms=timer(lambda: paged_prefill_attention(q, k, v, pt, off)),
        plain=timer(lambda: paged_prefill_attention_reference(
            q, k, v, pt, off, scale=scale)),
        library=timer(lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask[None, None])))


def _log_times(label, r):
    lib = "n/a" if r["library"] is None else f"{r['library']:.4f} ms"
    log(f"  {label}: kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms,"
        f" library {lib}, bound {r['bound']:.4f} ms ({r['by']})")


def phase_kernels(torch):
    timer = Timer(torch)
    rng = np.random.default_rng(0)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (8, 256):
            r = _ln_case(torch, timer, rows, dtype, rng)
            _log_times(f"layer_norm rows={rows} {dtype}", r)
            results[("layer_norm", rows, str(dtype))] = r
        r = _decode_case(torch, timer, dtype, rng)
        _log_times(f"paged_decode B=8 {dtype}", r)
        results[("paged_decode_attention", 8, str(dtype))] = r
        for offset in (0, 256, 768):
            r = _prefill_case(torch, timer, dtype, offset, rng)
            _log_times(f"paged_prefill offset={offset} {dtype}", r)
            results[("paged_prefill_attention", offset, str(dtype))] = r
    return results


# ------------------------------------------------------ train kernels
def _check_sums(name, got, want, abs_terms, dtype):
    """dgamma / dbeta: column sums over all rows. Two fp32 summation
    orders of n terms differ by about sqrt(n) * 2^-24 of the sum of
    |terms| (5.4e-6 at n = 8192); held at 1e-5 of it, plus one bf16 ulp
    of the value when the result is bf16."""
    allow = SUM_RTOL * abs_terms
    if dtype == "torch.bfloat16":
        allow = allow + 2.0 ** -7 * want.float().abs()
    diff = (got.float() - want.float()).abs()
    excess = (diff / allow).max().item()
    log(f"  {name}: max|kernel - plain| = {diff.max().item():.3g} "
        f"({excess:.3g} of the allowance)")
    if not excess <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {excess:.3g}x the allowance")


def _wrong_rows_check(name, wrong, want, reached, tol, per_row):
    """The tolerance must see a wrong kernel: the plain version fed a
    wrong input (``wrong``) must fail the check in EVERY row ``reached``
    marks. ``per_row(excess)`` -> each row's worst excess."""
    worst = per_row(_excess(wrong, want, tol))[reached].min().item()
    log(f"  {name}: least row excess {worst:.3g} over "
        f"{int(reached.sum())} rows (> 1 needed)")
    if not worst > 1.0:
        raise AssertionError(f"{name}: the tolerance {tol} would pass a "
                             f"kernel that computes {name}")


def _ln_train_case(torch, timer, rng, xdt, pdt, mem_eff, forward):
    """LayerNorm at the training shape: the backward (and, for the O2
    dtype pair, the forward) against the plain versions; times."""
    from apex_tpu_torch.kernels.layer_norm import (
        _ln_bwd_kernel, _ln_kernel, _ln_plain, layer_norm_bwd_reference)

    n, h = TRAIN_ROWS, HIDDEN
    x = _uniform(torch, rng, (n, h), xdt)
    dy = _uniform(torch, rng, (n, h), xdt)
    w = _uniform(torch, rng, (h,), pdt, 0.5, 1.5)
    b = _uniform(torch, rng, (h,), pdt, -0.1, 0.1)
    col = h // 3
    w_bad = w.clone()
    w_bad[col] += 1.0                   # one gamma element changed
    tol = TRAIN_TOL[str(xdt)]
    tag = f"{xdt} x, {pdt} gamma" + (", memory_efficient" if mem_eff
                                     else "")
    # PyTorch's LayerNorm takes gamma in x's dtype only (on CUDA): with
    # bf16 x and fp32 gamma there is no one library call to time
    same = xdt == pdt
    out = {}
    y_ref, mean, rstd = _ln_plain(x, w, b, 1e-5, False)
    if forward:
        y = _ln_kernel(x, w, b, 1e-5, False)[0]
        torch.cuda.synchronize()
        label = f"layer_norm fwd rows={n} {tag}"
        err = _check(label, y, y_ref, tol)
        xhat = (x.float() - mean[:, None]) * rstd[:, None]
        _wrong_rows_check(label + " (gamma changed)",
                          _ln_plain(x, w_bad, b, 1e-5, False)[0], y_ref,
                          xhat[:, col].abs() >= 1.0 / 8, tol,
                          lambda ex: ex.amax(-1))
        isz, psz = x.element_size(), w.element_size()
        bound, by = _bound(2 * n * h * isz + 2 * h * psz + 2 * n * 4,
                           LN_OPS_PER_ELEM * n * h, xdt)
        out["fwd"] = dict(
            err=err, bound=bound, by=by,
            ms=timer(lambda: _ln_kernel(x, w, b, 1e-5, False)),
            plain=timer(lambda: _ln_plain(x, w, b, 1e-5, False)),
            library=timer(lambda: torch.ops.aten.native_layer_norm(
                x, [h], w, b, 1e-5)) if same else None)
    src = y_ref if mem_eff else x
    args = (dy, src, w, b, mean, rstd, False, mem_eff)
    dx, dg, db = _ln_bwd_kernel(*args)
    dx2, dg2, db2 = _ln_bwd_kernel(*args)
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(dg, dg2)
            and torch.equal(db, db2)):
        raise AssertionError("layer_norm backward: two runs on the same "
                             "inputs differ (the reduction must be "
                             "deterministic)")
    want = layer_norm_bwd_reference(*args)
    label = f"layer_norm bwd rows={n} {tag}"
    err = _check(label + " dx", dx, want[0], tol)
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    dy32 = dy.float()
    _check_sums(label + " dgamma", dg, want[1],
                (dy32 * xhat).abs().sum(0), str(pdt))
    _check_sums(label + " dbeta", db, want[2], dy32.abs().sum(0), str(pdt))
    _wrong_rows_check(label + " dx (gamma changed)",
                      layer_norm_bwd_reference(dy, src, w_bad, b, mean,
                                               rstd, False, mem_eff)[0],
                      want[0], dy32[:, col].abs() >= 1.0 / 8, tol,
                      lambda ex: ex.amax(-1))
    isz, psz = x.element_size(), w.element_size()
    bytes_moved = (3 * n * h * isz + (2 if mem_eff else 1) * h * psz
                   + 2 * n * 4 + 2 * h * psz)
    bound, by = _bound(bytes_moved, LN_BWD_OPS_PER_ELEM * n * h, xdt)
    library = None
    if same:
        # the library backward reads its own forward's saved statistics
        _, m2, r2 = torch.ops.aten.native_layer_norm(x, [h], w, b, 1e-5)
        library = timer(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [h], m2, r2, w, b, [True, True, True]))
    out["bwd"] = dict(
        err=err, bound=bound, by=by, ms=timer(lambda: _ln_bwd_kernel(*args)),
        plain=timer(lambda: layer_norm_bwd_reference(*args)),
        library=library)
    return tag, out


def _shifted_attention(torch, q3, k3, v3, do3, scale):
    """The plain forward and backward with the causal mask shifted by one
    (query row i also attends position i + 1): what a kernel off by one
    position on the diagonal would compute. Returns ``(o, dq, dk, dv)``."""
    from apex_tpu_torch.kernels.flash_attention import _NEG_INF

    q, k, v, do = q3.float(), k3.float(), v3.float(), do3.float()
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                      device=s.device).tril(1)
    p = torch.softmax(torch.where(keep, s, torch.full_like(s, _NEG_INF)),
                      -1)
    o = torch.einsum("bqk,bkd->bqd", p, v)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = p * (dp - (do * o).sum(-1)[..., None]) * scale
    return (o, torch.einsum("bqk,bkd->bqd", ds, k),
            torch.einsum("bqk,bqd->bkd", ds, q),
            torch.einsum("bqk,bqd->bkd", p, do))


def _flash_train_case(torch, timer, rng, dtype):
    """Flash forward, dK/dV and dQ at the training shape, against the
    plain versions, with a shifted-mask wrong kernel; times."""
    import torch.nn.functional as F
    from apex_tpu_torch.kernels.flash_attention import (
        flash_bwd_dkdv_kernel, flash_bwd_dq_kernel, flash_bwd_reference,
        flash_fwd_kernel, flash_fwd_reference)

    B, S, d = TRAIN["batch"], TRAIN["seq"], HEAD_DIM
    bh = B * HEADS
    scale = d ** -0.5
    q, k, v, do = (_uniform(torch, rng, (bh, S, d), dtype)
                   for _ in range(4))
    tol = TRAIN_TOL[str(dtype)]
    o, lse = flash_fwd_kernel(q, k, v, scale, True)
    o_ref, lse_ref = flash_fwd_reference(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    bargs = (q, k, v, do, lse, delta, scale, True)
    dk, dv = flash_bwd_dkdv_kernel(*bargs)
    dq = flash_bwd_dq_kernel(*bargs)
    torch.cuda.synchronize()
    dq_ref, dk_ref, dv_ref = flash_bwd_reference(q, k, v, do, lse_ref,
                                                 delta, scale, True)
    o_ref = o_ref.to(dtype)
    label = f"flash bh={bh} S={S} d={d} causal {dtype}"
    errs = {"fwd": max(_check(label + " o", o, o_ref, tol),
                       _check(label + " lse", lse, lse_ref,
                              TRAIN_TOL["torch.float32"]))}
    errs["dkdv"] = max(_check(label + " dk", dk, dk_ref.to(dtype), tol),
                       _check(label + " dv", dv, dv_ref.to(dtype), tol))
    errs["dq"] = _check(label + " dq", dq, dq_ref.to(dtype), tol)
    # rows the shift reaches: query row i gains position i + 1, one of
    # its i + 2 (o, dq); key row j gains query row j - 1, one of the
    # positions row j - 1 attends (dk, dv); reached where that is at
    # least 1/REACH of them. Among those, the rows the shift moves by
    # more than twice the tolerance's absolute floor must all fail: a
    # smaller move is below what the limit resolves by design.
    pos = torch.arange(S, device="cuda")
    near = {"q": (pos + 2 <= REACH)[None].expand(bh, S),
            "k": ((pos >= 1) & (pos + 1 <= REACH))[None].expand(bh, S)}
    wrong = _shifted_attention(torch, q, k, v, do, scale)
    for name, side, w, want in zip(("o", "dq", "dk", "dv"), "qqkk", wrong,
                                   (o_ref, dq_ref, dk_ref, dv_ref)):
        w, want = w.to(dtype), want.to(dtype)
        moved = (w.float() - want.float()).abs().amax(-1) > 2 * tol[0]
        _wrong_rows_check(
            f"{label} {name} (mask shifted; {int(near[side].sum())} rows "
            f"reached)", w, want, near[side] & moved, tol,
            lambda ex: ex.amax(-1))
    isz = q.element_size()
    pairs = bh * S * (S + 1) // 2                 # attended (i, j), causal
    elems = bh * S * d
    bounds = {
        "fwd": _bound(4 * elems * isz + bh * S * 4, 4 * d * pairs, dtype),
        "dkdv": _bound(6 * elems * isz + 2 * bh * S * 4, 8 * d * pairs,
                       dtype),
        "dq": _bound(5 * elems * isz + 2 * bh * S * 4, 6 * d * pairs,
                     dtype)}
    q4, k4, v4 = (t.view(B, HEADS, S, d).detach().requires_grad_(True)
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(B, HEADS, S, d)
    lib_bwd = timer.eager(lambda: torch.autograd.grad(
        lib_out, (q4, k4, v4), do4, retain_graph=True))
    plain_bwd = timer(lambda: flash_bwd_reference(q, k, v, do, lse_ref,
                                                  delta, scale, True))
    with torch.no_grad():
        times = {
            "fwd": dict(
                ms=timer(lambda: flash_fwd_kernel(q, k, v, scale, True)),
                plain=timer(lambda: flash_fwd_reference(q, k, v, scale,
                                                        True)),
                library=timer(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True))),
            "dkdv": dict(ms=timer(lambda: flash_bwd_dkdv_kernel(*bargs)),
                         plain=plain_bwd, library=lib_bwd),
            "dq": dict(ms=timer(lambda: flash_bwd_dq_kernel(*bargs)),
                       plain=plain_bwd, library=lib_bwd)}
    return {part: dict(err=errs[part], bound=bounds[part][0],
                       by=bounds[part][1], **times[part])
            for part in ("fwd", "dkdv", "dq")}


def phase_train_kernels(torch):
    """Every kernel of the training path at its shapes, bf16 and fp32."""
    timer = Timer(torch)
    rng = np.random.default_rng(1)
    results = {}
    f32, bf16 = torch.float32, torch.bfloat16
    for xdt, pdt, mem_eff in ((bf16, f32, False), (bf16, f32, True),
                              (bf16, bf16, False), (f32, f32, False)):
        forward = (xdt, pdt, mem_eff) == (bf16, f32, False)
        tag, r = _ln_train_case(torch, timer, rng, xdt, pdt, mem_eff,
                                forward)
        for part, rr in r.items():
            _log_times(f"layer_norm {part} {tag}", rr)
            results[(f"layer_norm_{part}", tag)] = rr
    for dtype in (bf16, f32):
        r = _flash_train_case(torch, timer, rng, dtype)
        for part, rr in r.items():
            _log_times(f"flash {part} {dtype}", rr)
            results[(f"flash_{part}", str(dtype))] = rr
    return results


# ------------------------------------------------ xentropy, multi-tensor
def _xent_case(torch, timer, dtype, smoothing, seed):
    """Kernels 11 and 12 at the LM's [8192, 50257] logits against their
    plain versions, with a few rows labelled -100 and V; each limit shown
    to fail with every label shifted by one; times."""
    import torch.nn.functional as F
    from apex_tpu_torch.kernels.xentropy import (
        xent_bwd_kernel, xent_bwd_reference, xent_fwd_kernel,
        xent_fwd_reference)

    n, v = TRAIN_ROWS, GPT2["vocab_size"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = (torch.randn(n, v, generator=gen, device="cuda") * 2.0).to(
        dtype)
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
    labels[:XENT_BAD_ROWS] = -100
    labels[XENT_BAD_ROWS:2 * XENT_BAD_ROWS] = v
    valid = (labels >= 0) & (labels < v)
    g = torch.rand(n, generator=gen, device="cuda") + 0.5
    shifted = torch.where(valid, (labels + 1) % v, labels)
    label = f"xent N={n} V={v} {dtype} smoothing={smoothing}"

    loss, lse = xent_fwd_kernel(logits, labels, smoothing)
    d = xent_bwd_kernel(logits, labels, lse, g, smoothing)
    torch.cuda.synchronize()
    loss_p, lse_p = xent_fwd_reference(logits, labels, smoothing)
    if not (torch.equal(torch.isnan(loss), ~valid)
            and torch.equal(torch.isnan(loss_p), ~valid)
            and bool(torch.isfinite(lse).all())):
        raise AssertionError(f"{label}: the NaN losses must be exactly the "
                             "rows labelled out of range, lse finite")
    tol = (XENT_LOSS_ATOL, 0.0)
    err = max(_check(label + " loss", loss[valid], loss_p[valid], tol),
              _check(label + " lse", lse, lse_p, tol))
    wrong = xent_fwd_reference(logits, shifted, smoothing)[0]
    moved = valid & ((wrong - loss_p).abs() > 2 * XENT_LOSS_ATOL)
    _wrong_rows_check(f"{label} loss (labels shifted by one)",
                      wrong[:, None], loss_p[:, None], moved, tol,
                      lambda ex: ex[:, 0])
    # dlogits: each element is g * (softmax - target), good to a few fp32
    # ulps of g * (softmax + target) (one exp, from the same lse, in two
    # implementations), plus one ulp of the output dtype for the rounding
    want = xent_bwd_reference(logits, labels, lse, g, smoothing)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    terms = torch.exp(logits.float() - lse[:, None]) + smoothing / v
    terms.scatter_add_(1, torch.where(valid, labels, 0)[:, None],
                       valid[:, None].float())
    terms.mul_(g[:, None])

    def excess(got):
        return ((got.float() - want.float()).abs()
                / (XENT_GRAD_RTOL * terms + ulp * want.float().abs()))

    ex = excess(d).max().item()
    err_d = (d.float() - want.float()).abs().max().item()
    log(f"  {label} dlogits: max|kernel - plain| = {err_d:.3g} ({ex:.3g} "
        f"of the allowance)")
    if not ex <= 1.0:
        raise AssertionError(f"{label} dlogits: kernel disagrees with its "
                             f"plain version, {ex:.3g}x the allowance")
    least = excess(xent_bwd_reference(logits, shifted, lse, g, smoothing)
                   ).amax(-1)[valid].min().item()
    log(f"  {label} dlogits (labels shifted by one): least row excess "
        f"{least:.3g} over {int(valid.sum())} rows (> 1 needed)")
    if not least > 1.0:
        raise AssertionError(f"{label}: the dlogits limit would pass "
                             "shifted labels")
    del terms, want
    isz = logits.element_size()
    ok = labels.clamp(0, v - 1)           # the library call checks labels
    lib_in = logits.detach().requires_grad_(True)
    lib_out = F.cross_entropy(lib_in, ok, reduction="none",
                              label_smoothing=smoothing)
    with torch.no_grad():
        fwd = dict(
            err=err, ms=timer(lambda: xent_fwd_kernel(logits, labels,
                                                      smoothing)),
            plain=timer(lambda: xent_fwd_reference(logits, labels,
                                                   smoothing)),
            library=timer(lambda: F.cross_entropy(
                logits, ok, reduction="none", label_smoothing=smoothing)))
        bwd = dict(
            err=err_d, ms=timer(lambda: xent_bwd_kernel(
                logits, labels, lse, g, smoothing)),
            plain=timer(lambda: xent_bwd_reference(logits, labels, lse, g,
                                                   smoothing)))
    bwd["library"] = timer.eager(lambda: torch.autograd.grad(
        lib_out, lib_in, g, retain_graph=True))
    fwd["bound"], fwd["by"] = _bound(n * v * isz + n * 8 + 2 * n * 4,
                                     XENT_OPS_PER_ELEM * n * v, dtype)
    bwd["bound"], bwd["by"] = _bound(2 * n * v * isz + n * (8 + 4 + 4),
                                     XENT_OPS_PER_ELEM * n * v, dtype)
    return {"xent_fwd": fwd, "xent_bwd": bwd}


def _mt_scale_case(torch, timer, shapes, dtype):
    """Kernel 21 over GPT-2's gradient list (148 tensors) in ``dtype``
    with fp32 outputs and an inf in the last element of the last tensor:
    the outputs bitwise equal to the plain version's (a multiply by
    2^-16 is exact) and found_inf set; times."""
    from apex_tpu_torch import kernels
    from apex_tpu_torch.kernels.multi_tensor import (
        multi_tensor_scale_, multi_tensor_scale_reference)

    gen = torch.Generator(device="cuda").manual_seed(7)
    ins = [(torch.randn(s, generator=gen, device="cuda") * 2.0 ** 12).to(
        dtype) for s in shapes]
    ins[-1].view(-1)[-1] = float("inf")
    outs = [torch.empty(s, device="cuda") for s in shapes]
    want = [torch.empty(s, device="cuda") for s in shapes]
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    flag_p = torch.zeros_like(flag)
    inv = 2.0 ** -16
    before = kernels.launches["multi_tensor_scale"]
    multi_tensor_scale_(flag, [ins, outs], inv)
    launched = kernels.launches["multi_tensor_scale"] - before
    multi_tensor_scale_reference(flag_p, [ins, want], inv)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(outs, want))
    elems = sum(t.numel() for t in ins)
    label = (f"multi_tensor_scale {len(ins)} tensors, {elems} elements, "
             f"{dtype} -> fp32")
    log(f"  {label}: {launched} launch(es); outputs bitwise equal to the "
        f"plain version {same}; found_inf {int(flag.item())} (plain "
        f"{int(flag_p.item())})")
    if not (same and int(flag.item()) == 1 == int(flag_p.item())):
        raise AssertionError(f"{label}: the outputs must equal the plain "
                             "version's bitwise and found_inf be set")
    library = None
    if dtype == torch.float32:
        # PyTorch's unscale (in place, in the input dtype) takes no bf16
        # on CUDA: the bf16 case has no one library call to time
        lib = [t.clone() for t in ins]
        lib[-1].view(-1)[-1] = 1.0
        found = torch.zeros(1, device="cuda")
        inv_t = torch.full((1,), inv, device="cuda")
        library = timer(
            lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                lib, found, inv_t))
    bound, by = _bound(elems * (ins[0].element_size() + 4) + 4, 2 * elems,
                       dtype)
    return dict(err=0.0, bound=bound, by=by, launches_per_call=launched,
                ms=timer(lambda: multi_tensor_scale_(flag, [ins, outs],
                                                     inv)),
                plain=timer(lambda: multi_tensor_scale_reference(
                    flag, [ins, outs], inv)),
                library=library)


def _mt_adam_case(torch, timer, shapes):
    """Kernel 24 over GPT-2's fp32 masters for 3 steps against the plain
    version (held to ADAM_RTOL; the same fp32 operations, so bitwise is
    expected and reported), the limit shown to fail with the step count
    off by one, and FusedAdam's tree and flat layouts bitwise equal over
    the same 3 steps; times."""
    from apex_tpu_torch import kernels
    from apex_tpu_torch.kernels.multi_tensor import (
        multi_tensor_adam_, multi_tensor_adam_reference)
    from apex_tpu_torch.optimizers import FusedAdam

    gen = torch.Generator(device="cuda").manual_seed(8)
    p0 = [torch.randn(s, generator=gen, device="cuda") * 0.02
          for s in shapes]
    grads = [[torch.randn(s, generator=gen, device="cuda") * 1e-3
              for s in shapes] for _ in range(3)]
    kw = dict(lr=TRAIN["lr"], beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=TRAIN["weight_decay"], adam_w_mode=True,
              apply_delta=True)
    elems = sum(t.numel() for t in p0)

    def run(fn, first_step):
        p = [t.clone() for t in p0]
        m = [torch.zeros_like(t) for t in p0]
        v = [torch.zeros_like(t) for t in p0]
        for i, g in enumerate(grads):
            fn([g, p, m, v], step=first_step + i, **kw)
        return p, m, v

    before = kernels.launches["multi_tensor_adam"]
    got = run(multi_tensor_adam_, 1)
    launched = (kernels.launches["multi_tensor_adam"] - before) // 3
    want = run(multi_tensor_adam_reference, 1)
    torch.cuda.synchronize()
    label = f"multi_tensor_adam {len(p0)} tensors, {elems} fp32, 3 steps"
    tol = (2.0 ** -126, ADAM_RTOL)
    errs, bitwise = [], True
    for name, a, b in zip(("p", "m", "v"), got, want):
        errs.append(_check(f"{label} {name}",
                           torch.cat([t.reshape(-1) for t in a]),
                           torch.cat([t.reshape(-1) for t in b]), tol))
        bitwise = bitwise and all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"  {label}: {launched} launch(es) per step; bitwise equal to the "
        f"plain version: {bitwise}")
    del want
    wrong = run(multi_tensor_adam_reference, 2)[0]
    share = sum(int((_excess(x, y, tol) > 1.0).sum())
                for x, y in zip(wrong, got[0])) / elems
    log(f"  {label} (step count off by one): {100 * share:.4f}% of the "
        f"parameters fail the limit (>= {100 * ADAM_WRONG_SHARE}% needed)")
    if not share >= ADAM_WRONG_SHARE:
        raise AssertionError(f"{label}: the limit would pass a step count "
                             "off by one")
    del wrong
    layouts = {}
    for layout in ("tree", "flat"):
        params = [torch.nn.Parameter(t.clone()) for t in p0]
        opt = FusedAdam(params, lr=kw["lr"],
                        weight_decay=kw["weight_decay"], layout=layout)
        for g in grads:
            for p, x in zip(params, g):
                p.grad = x
            opt.step()
        layouts[layout] = params
        del opt
    same = all(torch.equal(a, b) for a, b in zip(layouts["tree"],
                                                 layouts["flat"]))
    same_kernel = all(torch.equal(a, b) for a, b in zip(layouts["tree"],
                                                        got[0]))
    log(f"  FusedAdam tree vs flat over 3 steps: bitwise {same} (tree vs "
        f"the kernel run above: {same_kernel})")
    if not same:
        raise AssertionError("FusedAdam: the tree and flat layouts differ")
    del layouts
    p, m, v = got
    lib_p, lib_m, lib_v = ([t.clone() for t in ts] for ts in got)
    steps = [torch.ones((), device="cuda") for _ in p]
    bound, by = _bound(28 * elems, ADAM_OPS_PER_ELEM * elems, torch.float32)
    step_kw = dict(kw, step=4)
    return dict(err=max(errs), bound=bound, by=by,
                launches_per_call=launched,
                ms=timer(lambda: multi_tensor_adam_([grads[0], p, m, v],
                                                    **step_kw)),
                plain=timer(lambda: multi_tensor_adam_reference(
                    [grads[0], p, m, v], **step_kw)),
                library=timer(lambda: torch._fused_adamw_(
                    lib_p, grads[0], lib_m, lib_v, [], steps, lr=kw["lr"],
                    beta1=0.9, beta2=0.999,
                    weight_decay=kw["weight_decay"], eps=1e-8,
                    amsgrad=False, maximize=False)))


def phase_loss_optimizer_kernels(torch, model):
    """Kernels 11, 12, 21 and 24 at the default-loss training path's
    shapes: the xentropy pair on [8192, 50257] logits in fp32 and bf16,
    smoothing 0 and 0.1; the scale over GPT-2's gradients in bf16 and
    fp32; Adam over its fp32 masters."""
    timer = Timer(torch)
    results = {}
    shapes = [tuple(p.shape) for p in model.parameters()]
    cases = [(dt, s) for dt in (torch.float32, torch.bfloat16)
             for s in (0.0, 0.1)]
    for i, (dtype, smoothing) in enumerate(cases):
        r = _xent_case(torch, timer, dtype, smoothing, seed=20 + i)
        for name, rr in r.items():
            _log_times(f"{name} {dtype} smoothing={smoothing}", rr)
            results[(name, str(dtype), smoothing)] = rr
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        r = _mt_scale_case(torch, timer, shapes, dtype)
        _log_times(f"multi_tensor_scale {dtype}", r)
        results[("multi_tensor_scale", str(dtype))] = r
        torch.cuda.empty_cache()
    r = _mt_adam_case(torch, timer, shapes)
    _log_times("multi_tensor_adam fp32", r)
    results[("multi_tensor_adam", "torch.float32")] = r
    torch.cuda.empty_cache()
    return results


def _serve_requests(rng, vocab, n, new_tokens, max_prompt,
                    temperature=0.0):
    from apex_tpu_torch.serving import Request

    lens = rng.integers(32, max_prompt + 1, n)
    return [Request(prompt=rng.integers(0, vocab, int(m)).tolist(),
                    max_new_tokens=new_tokens, temperature=temperature)
            for m in lens]


def phase_serve(torch, model, engine_kw, n_requests=16, new_tokens=64):
    """GPT-2 width, bf16 O3, through the public Engine + Scheduler.
    Returns (metrics, launch counts)."""
    from apex_tpu_torch import kernels
    from apex_tpu_torch.serving import RequestStatus, Scheduler
    from apex_tpu_torch.serving import Engine

    eng = Engine(model, device="cuda", **engine_kw)
    sched = Scheduler(eng)
    rng = np.random.default_rng(0)
    reqs = _serve_requests(rng, model.vocab_size, n_requests, new_tokens,
                           eng.prefill_len)
    reqs += _serve_requests(rng, model.vocab_size, 1, new_tokens,
                            eng.prefill_len, temperature=0.8)
    # warm-up (first-call library initialisation), outside the counts
    sched.run(_serve_requests(np.random.default_rng(1), model.vocab_size,
                              1, 4, eng.prefill_len))
    steps0, decode_s0 = eng.decode_steps, eng.decode_s
    tok0 = eng.tokens_generated
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: int(kernels.launches[k]) for k in
              ("layer_norm", "paged_decode_attention",
               "paged_prefill_attention")}
    chunks = sum(r.chunks for r in reqs)
    steps = eng.decode_steps - steps0
    for r in reqs:
        if r.status != RequestStatus.FINISHED \
                or len(r.output_tokens) != new_tokens:
            raise AssertionError(f"request {r.uid}: {r.status} "
                                 f"{r.finish_reason} "
                                 f"{len(r.output_tokens)} tokens")
        if not all(0 <= t < model.vocab_size for t in r.output_tokens):
            raise AssertionError(f"request {r.uid}: token out of range")
    if eng.pool_stats()["pages_in_use"] != 0:
        raise AssertionError("pages still in use after the run")
    want = {"layer_norm": LN_PER_CALL * (chunks + steps),
            "paged_decode_attention": ATTN_PER_CALL * steps,
            "paged_prefill_attention": ATTN_PER_CALL * chunks}
    if counts != want or not all(counts.values()):
        raise AssertionError(f"launch counts {counts}, expected {want} "
                             f"from {chunks} chunks and {steps} decode "
                             f"steps")
    ttft = sorted(r.ttft_s for r in reqs)
    metrics = dict(
        requests=len(reqs), tokens=eng.tokens_generated - tok0,
        wall_s=wall, tokens_per_s=(eng.tokens_generated - tok0) / wall,
        ttft_p50_ms=1e3 * statistics.median(ttft),
        decode_step_ms=1e3 * (eng.decode_s - decode_s0) / steps,
        chunks=chunks, decode_steps=steps)
    log("serve: " + json.dumps(metrics))
    log("serve launches: " + json.dumps(counts))
    return metrics, counts


def _greedy_trace(eng, prompts, new_tokens):
    """Greedy streams and the fp32 logits rows each step sampled from."""
    streams = [[] for _ in prompts]
    rows = []
    for slot, p in enumerate(prompts):
        streams[slot].append(eng.prefill_chunked(slot, p))
        rows.append(eng.last_logits[0].cpu())
    n = len(prompts)
    for _ in range(new_tokens - 1):
        toks = eng.decode_step([s[-1] for s in streams], [True] * n,
                               [0.0] * n)
        rows.append(eng.last_logits.cpu())
        for slot in range(n):
            streams[slot].append(int(toks[slot]))
    return streams, rows


def phase_parity(torch, model, engine_kw, prompt_len=300, new_tokens=16):
    from apex_tpu_torch.amp import resolve_policy
    from apex_tpu_torch.serving import Engine

    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.vocab_size, prompt_len).tolist()
               for _ in range(2)]
    kw = dict(engine_kw, slots=2,
              policy=resolve_policy("O0", verbose=False))
    dev_streams, dev_rows = _greedy_trace(Engine(model, device="cuda", **kw),
                                          prompts, new_tokens)
    cpu_streams, cpu_rows = _greedy_trace(Engine(model, device="cpu", **kw),
                                          prompts, new_tokens)
    dl = [float((a - b).abs().max()) for a, b in zip(dev_rows, cpu_rows)]
    log(f"parity: cuda vs cpu streams {dev_streams} / {cpu_streams}")
    log(f"parity: per-step max|dlogit| {['%.2e' % x for x in dl]}")
    if dev_streams != cpu_streams:
        raise AssertionError("greedy streams differ between the card and "
                             "the CPU")
    if max(dl) > 1e-3:
        raise AssertionError(f"max |dlogit| {max(dl)} > 1e-3")
    return max(dl)


# ---------------------------------------------------------------- train
_TRAIN_BASE = {"layer_norm": LN_PER_CALL, "layer_norm_bwd": LN_PER_CALL,
               "flash_fwd": ATTN_PER_CALL, "flash_bwd_dkdv": ATTN_PER_CALL,
               "flash_bwd_dq": ATTN_PER_CALL, "paged_decode_attention": 0,
               "paged_prefill_attention": 0, "multi_tensor_adam": 1}
#: the training paths chip_smoke drives, and each one's exact kernel
#: launches per step. Under O2 the gradients come in two dtypes (bf16,
#: and fp32 for the 50 LayerNorm tensors), so the unscale is two launches
#: of kernel 21; under O1 every gradient is fp32. All 148 fp32 masters (or
#: the flat layout's one superbuffer, ~1900 chunks of 65536) fit one launch
#: table of kernel 24.
TRAIN_PATHS = {
    "train_fused_head": dict(opt_level="O2", loss="fused_head",
                             layout="tree", steps=TRAIN["steps"],
                             per_step=dict(_TRAIN_BASE, xent_fwd=0,
                                           xent_bwd=0,
                                           multi_tensor_scale=2)),
    "train_xent": dict(opt_level="O2", loss="xent", layout="tree",
                       steps=TRAIN["steps"],
                       per_step=dict(_TRAIN_BASE, xent_fwd=1, xent_bwd=1,
                                     multi_tensor_scale=2)),
    "train_o1_flat": dict(opt_level="O1", loss="xent", layout="flat",
                          steps=TRAIN["o1_steps"],
                          per_step=dict(_TRAIN_BASE, xent_fwd=1,
                                        xent_bwd=1, multi_tensor_scale=1)),
}


def _train_tokens(torch, vocab, batch, seq, seed):
    """One [batch, seq + 1] batch from the recipe's Zipf-ish unigram
    (token rank r drawn with weight 1/(r + 10)), numpy seed ``seed``."""
    w = 1.0 / (np.arange(vocab) + 10.0)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice(vocab, size=(batch, seq + 1),
                                       p=w / w.sum()).astype(np.int64))


def _train_setup(torch, model, device, opt_level, loss="xent",
                 layout="tree"):
    """The recipe's training step (examples/lm/main_amp.py) for a copy of
    ``model`` on ``device``: FusedAdam (AdamW) in ``layout`` and the
    default loss (``xent``) or the fused head (``fused_head``), whose
    value a returned ``boost`` dict can multiply."""
    import copy

    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.lm.main_amp import (fused_head_loss_fn,
                                                     xent_loss_fn)
    from apex_tpu_torch.optimizers import FusedAdam

    policy = amp.resolve_policy(opt_level, verbose=False)
    model = copy.deepcopy(model).to(device)
    opt = FusedAdam(model.parameters(), lr=TRAIN["lr"],
                    weight_decay=TRAIN["weight_decay"], adam_w_mode=True,
                    layout=layout)
    if loss == "fused_head":
        head = fused_head_loss_fn(0.0, policy.model_dtype or torch.float32)
    else:
        head = xent_loss_fn(0.0)
    boost = {"factor": 1.0}

    def loss_fn(m, tokens):
        return head(m, tokens) * boost["factor"]

    init_fn, step_fn = amp.make_train_step(loss_fn, opt, policy)
    return init_fn(model), step_fn, boost, head


def phase_train(torch, model, path):
    """One training path of TRAIN_PATHS at GPT-2 width and depth through
    make_train_step, on one fixed batch: every loss finite, the last
    ``min_drop`` nats below the first, the exact launches per step.
    Returns (setup, metrics, launch counts)."""
    from apex_tpu_torch import kernels

    cfg = TRAIN_PATHS[path]
    per_step_want = cfg["per_step"]
    state, step_fn, boost, _ = _train_setup(
        torch, model, "cuda", cfg["opt_level"], cfg["loss"], cfg["layout"])
    B, S, steps = TRAIN["batch"], TRAIN["seq"], cfg["steps"]
    tokens = _train_tokens(torch, model.vocab_size, B, S, 0).cuda()
    losses, times, found, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for _ in range(steps):
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        state, m = step_fn(state, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        found.append(bool(m["found_inf"]))
        per_step.append({k: kernels.launches[k] - before.get(k, 0)
                         for k in per_step_want})
    counts = {k: int(kernels.launches[k]) for k in per_step_want}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times)
    metrics = dict(path=path, opt_level=cfg["opt_level"], loss=cfg["loss"],
                   layout=cfg["layout"], steps=steps, tokens_per_step=B * S,
                   step_ms_median=1e3 * step_s,
                   step_ms=[1e3 * t for t in times],
                   tokens_per_s=B * S / step_s,
                   max_memory_allocated_gib=peak / 2 ** 30,
                   losses=losses, overflow_steps=sum(found),
                   loss_scale=float(state.scaler.loss_scale))
    log(f"{path}: " + json.dumps(metrics))
    log(f"{path} launches: " + json.dumps(counts))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{path}: non-finite loss in {losses}")
    if not losses[-1] <= losses[0] - TRAIN["min_drop"]:
        raise AssertionError(f"{path}: loss {losses[0]:.4f} -> "
                             f"{losses[-1]:.4f}, less than "
                             f"{TRAIN['min_drop']} nats down")
    for i, c in enumerate(per_step):
        if c != per_step_want:
            raise AssertionError(f"{path} step {i}: launches {c}, expected "
                                 f"{per_step_want}")
    return (state, step_fn, boost, tokens), metrics, counts


def phase_layout_check(torch, model, steps=3):
    """FusedAdam's tree and flat layouts, each training a copy of the
    same weights at O2 with the default loss for ``steps`` steps on the
    same batch: losses, masters and model parameters bitwise equal."""
    B, S = TRAIN["batch"], TRAIN["seq"]
    tokens = _train_tokens(torch, model.vocab_size, B, S, 0).cuda()
    runs = {}
    for layout in ("tree", "flat"):
        state, step_fn, _, _ = _train_setup(torch, model, "cuda", "O2",
                                            "xent", layout)
        losses = []
        for _ in range(steps):
            state, m = step_fn(state, tokens)
            losses.append(float(m["loss"]))
        runs[layout] = (losses, state.master_params, state.params)
        del state, step_fn
    (lt, mt, pt), (lf, mf, pf) = runs["tree"], runs["flat"]
    same = (lt == lf and all(torch.equal(a, b) for a, b in zip(mt, mf))
            and all(torch.equal(a, b) for a, b in zip(pt, pf)))
    log(f"layout check: O2 tree vs flat after {steps} steps: losses {lt} / "
        f"{lf}; masters and parameters bitwise equal {same}")
    if not same:
        raise AssertionError("tree and flat FusedAdam layouts trained "
                             "different weights")
    return same


def _kernel_group(name: str) -> str:
    """The part of a train step a device kernel belongs to, by name."""
    n = name.lower()
    if "xent_" in n:
        return "xentropy (ours)"
    if "multi_tensor" in n:
        return "multi-tensor (ours)"
    if "flash_" in n:
        return "flash attention (ours)"
    if n.startswith("void ln_") or "ln_fwd" in n or "ln_bwd" in n:
        return "LayerNorm (ours)"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "nvjet" in n:
        fp32 = any(t in n for t in ("sgemm", "f32f32", "_tf32", "fp32"))
        return "GEMM fp32 (LM head)" if fp32 else "GEMM bf16"
    return "other (elementwise, reductions, copies)"


def _profile_step(torch, setup, path):
    """Device time of one more train step by kernel group, from a
    ``torch.profiler`` trace, beside the step's host wall time: where a
    step goes and the device's idle share. Reads nothing into any
    check; a profiler that sees no device time is reported as such."""
    from torch.profiler import ProfilerActivity, profile

    state, step_fn, _, tokens = setup
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, tokens)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups, names = {}, []
    events = prof.key_averages()

    def on_device(e):
        return "CUDA" in str(getattr(e, "device_type", ""))

    # device kernels only: host ops carry their kernels' time too, and a
    # range a host annotation (``Optimizer.step#FusedAdam.step``) mirrors
    # onto the device spans kernels counted on their own
    host_keys = {e.key for e in events if not on_device(e)}
    for e in events:
        if not on_device(e) or e.key in host_keys:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us <= 0:
            continue
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        names.append((us / 1e3, e.count, e.key[:70]))
    busy = sum(groups.values())
    out = dict(wall_ms=wall_ms, device_busy_ms=busy,
               idle_share=1.0 - busy / wall_ms if busy else None,
               by_group_ms=dict(sorted(groups.items(),
                                       key=lambda kv: -kv[1])))
    log(f"{path} profile (one step): " + json.dumps(out))
    for ms, count, key in sorted(names, reverse=True)[:12]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {key}")
    if not busy:
        log("  the profiler recorded no device time")
    return out


def phase_overflow(torch, setup):
    """One step whose scaled backward overflows: found_inf, the scale
    halved, and parameters, masters and Adam state (its step count
    included) bitwise unchanged. No finite scale overflows bf16 or fp32
    gradients of this size (their largest is far below 2^128 / 2^16),
    and a scaled loss's backward seed is the scale itself; the step
    multiplies its loss by 2^127, so the seed, 2^127 * 2^16, is inf."""
    state, step_fn, boost, tokens = setup
    opt = state.optimizer

    def snapshot():
        return ([p.detach().clone() for p in state.params],
                [p.detach().clone() for p in state.master_params],
                [t.clone() for p in state.master_params
                 for t in opt.state[p].values()],
                [g["step"] for g in opt.param_groups])

    before = snapshot()
    scale = float(state.scaler.loss_scale)
    boost["factor"] = 2.0 ** 127
    state, m = step_fn(state, tokens)
    boost["factor"] = 1.0
    torch.cuda.synchronize()
    after = snapshot()
    same = all(torch.equal(a, b) for x, y in zip(before[:3], after[:3])
               for a, b in zip(x, y)) and before[3] == after[3]
    new_scale = float(state.scaler.loss_scale)
    log(f"overflow: found_inf {m['found_inf']}, scale {scale:g} -> "
        f"{new_scale:g}, params/masters/Adam state unchanged {same}, "
        f"Adam step {after[3]}")
    if not (m["found_inf"] and new_scale == scale / 2 and same):
        raise AssertionError("overflow step: expected found_inf, a halved "
                             "scale and every parameter, master and Adam "
                             "state bitwise unchanged")


def _grad_limit(g):
    """Step-1 gradients, card vs CPU, O0 fp32: a sum of n fp32 terms in
    another order moves by about sqrt(n) * 2^-24 of the sum of |terms|
    (1.3e-5 of it for the head's 50257-way sums, less elsewhere); through
    12 layers forward and back, and where terms cancel, a gradient
    element's error is measured against its tensor's scale. Limit: 1e-4
    of the tensor's largest |g|."""
    return 1e-4 * g.abs().max()


def phase_train_parity(torch, model, loss, layout):
    """The same weights at O0 fp32, card vs CPU (plain path), full width
    and depth, B 2 x S 256, 3 steps, with ``loss`` and FusedAdam's
    ``layout``; TF32 off only inside these calls."""
    B, S, steps = (TRAIN_PARITY[k] for k in ("batch", "seq", "steps"))
    tokens = _train_tokens(torch, model.vocab_size, B, S, 1)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    runs = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for dev in ("cuda", "cpu"):
            state, step_fn, _, head = _train_setup(torch, model, dev, "O0",
                                                   loss, layout)
            batch = tokens.to(dev)
            head(state.model, batch).backward()
            names = [n for n, _ in state.model.named_parameters()]
            grads = {n: p.grad.detach().cpu() for n, p in
                     zip(names, state.params)}
            for p in state.params:
                p.grad = None
            losses = []
            for _ in range(steps):
                state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))
            runs[dev] = (losses, grads, {n: p.detach().cpu() for n, p in
                                         zip(names, state.params)})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
    (l_dev, g_dev, p_dev), (l_cpu, g_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu)]
    g_ratio = max(float((g_dev[n] - g_cpu[n]).abs().max()
                        / _grad_limit(g_cpu[n])) for n in g_cpu)
    bound = 2 * TRAIN["lr"] * steps
    p_diff = max(float((p_dev[n] - p_cpu[n]).abs().max()) for n in p_cpu)
    near = sum(int(((p_dev[n] - p_cpu[n]).abs() <= 1e-6).sum())
               for n in p_cpu) / sum(t.numel() for t in p_cpu.values())
    log(f"train parity ({loss}, {layout}): losses cuda {l_dev} cpu {l_cpu} "
        f"(relative "
        f"{['%.2e' % x for x in rel]}); step-1 grads at {g_ratio:.3g} of "
        f"the limit; params max |d| {p_diff:.3g} (Adam bound {bound:g}), "
        f"{100 * near:.4f}% within 1e-6")
    if max(rel) > 1e-4:
        raise AssertionError(f"train parity: losses differ by {max(rel)} "
                             f"relative > 1e-4")
    if not g_ratio <= 1.0:
        raise AssertionError(f"train parity: step-1 gradients at "
                             f"{g_ratio:.3g}x their limit")
    if not p_diff <= bound:
        raise AssertionError(f"train parity: parameters {p_diff} apart, "
                             f"beyond Adam's sign bound {bound}")
    return dict(loss_rel=max(rel), grad_limit_share=g_ratio,
                param_max_diff=p_diff)


def _kernel_line(results, train_results, lo_results, counts_by_path):
    """The eleven ported kernels, each at its main path's shape: bf16
    for the serve and O2 train kernels, fp32 logits for the xentropy pair
    (the tied head's output) and masters for Adam; launches are the
    counts of the paths each ran on, read from each path's own run."""
    info = {
        "layer_norm": ("layer_norm.cu", "layer_norm.py:174",
                       "rows=8 (decode) H=768 bf16"),
        "paged_decode_attention": (
            "paged_attention.cu", "decode_attention.py:423",
            "B=8 h=12 d=64 page_len=128 lengths 1..1024 bf16"),
        "paged_prefill_attention": (
            "paged_attention.cu", "prefill_attention.py:413",
            "B=1 C=256 offset=256 h=12 d=64 page_len=128 bf16"),
        "layer_norm_bwd": ("layer_norm.cu", "layer_norm.py:221",
                           "rows=8192 H=768 bf16 x, fp32 gamma"),
        "flash_fwd": ("flash_attention.cu", "flash_attention.py:548",
                      "bh=96 S=1024 d=64 causal bf16"),
        "flash_bwd_dkdv": ("flash_attention.cu", "flash_attention.py:615",
                           "bh=96 S=1024 d=64 causal bf16"),
        "flash_bwd_dq": ("flash_attention.cu", "flash_attention.py:653",
                         "bh=96 S=1024 d=64 causal bf16"),
        "xent_fwd": ("xentropy.cu", "xentropy.py:132",
                     "N=8192 V=50257 fp32 logits, smoothing 0"),
        "xent_bwd": ("xentropy.cu", "xentropy.py:161",
                     "N=8192 V=50257 fp32 logits, smoothing 0"),
        "multi_tensor_scale": (
            "multi_tensor.cu", "multi_tensor.py:95",
            "GPT-2's 148 gradients, 124.44M, bf16 -> fp32"),
        "multi_tensor_adam": (
            "multi_tensor.cu", "multi_tensor.py:265",
            "GPT-2's 148 fp32 masters, 124.44M, fp32 grads"),
    }
    o2 = "torch.bfloat16 x, torch.float32 gamma"
    bf16, f32 = "torch.bfloat16", "torch.float32"
    rows = {"layer_norm": results[("layer_norm", 8, bf16)],
            "paged_decode_attention": results[("paged_decode_attention", 8,
                                               bf16)],
            "paged_prefill_attention": results[("paged_prefill_attention",
                                                256, bf16)],
            "layer_norm_bwd": train_results[("layer_norm_bwd", o2)]}
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        rows[name] = train_results[(name.replace("_bwd", ""), bf16)]
    for name in ("xent_fwd", "xent_bwd"):
        rows[name] = lo_results[(name, f32, 0.0)]
    rows["multi_tensor_scale"] = lo_results[("multi_tensor_scale", bf16)]
    rows["multi_tensor_adam"] = lo_results[("multi_tensor_adam", f32)]
    out = []
    for name, r in rows.items():
        src, replaces, shape = info[name]
        by_path = {path: c.get(name, 0) for path, c in counts_by_path.items()}
        entry = {"name": name, "route": "cuda",
                 "source": f"apex_tpu_torch/csrc/{src}",
                 "replaces": f"apex_tpu/kernels/{replaces}",
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path, "max_abs_err": r["err"],
                 "ms": r["ms"], "plain_ms": r["plain"],
                 "bound_ms": r["bound"], "bound_by": r["by"],
                 "library_ms": r["library"], "shape": shape}
        if name == "layer_norm":
            t = train_results[("layer_norm_fwd", o2)]
            entry["train_shape"] = {
                "shape": "rows=8192 H=768 bf16 x, fp32 gamma",
                "max_abs_err": t["err"], "ms": t["ms"],
                "plain_ms": t["plain"], "bound_ms": t["bound"],
                "bound_by": t["by"], "library_ms": t["library"]}
        if name == "layer_norm_bwd":
            entry["library_ms_bf16_gamma"] = train_results[(
                "layer_norm_bwd", "torch.bfloat16 x, torch.bfloat16 gamma")
            ]["library"]
        if name.startswith("flash_bwd"):
            entry["library_computes"] = "dq, dk and dv together"
        if name.startswith("xent_"):
            entry["other_cases"] = {
                f"{dt} smoothing={sm}": {
                    k: lo_results[(name, dt, sm)][k]
                    for k in ("err", "ms", "plain", "bound", "library")}
                for dt in (f32, bf16) for sm in (0.0, 0.1)
                if (dt, sm) != (f32, 0.0)}
        if name == "multi_tensor_scale":
            fp = lo_results[("multi_tensor_scale", f32)]
            entry["fp32_in"] = {k: fp[k] for k in ("ms", "plain", "bound",
                                                   "library")}
        if name.startswith("multi_tensor"):
            entry["launches_per_call"] = r["launches_per_call"]
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; this smoke "
              "run needs one GPU", file=sys.stderr)
        return 1
    if not (ROOT / "apex_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no apex_tpu_torch sources beside {__file__}; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 2
    # the checkout's package, whatever else is installed
    sys.path.insert(0, str(ROOT))
    from apex_tpu_torch.models import create_lm

    t_start = time.perf_counter()
    phase_card(torch)
    phase_build()
    results = phase_kernels(torch)
    train_results = phase_train_kernels(torch)
    model = create_lm(**GPT2)
    lo_results = phase_loss_optimizer_kernels(torch, model)
    log(f"kernels done at {time.perf_counter() - t_start:.1f} s")
    _, serve_counts = phase_serve(torch, model, SERVE)
    phase_parity(torch, model, dict(max_len=1024, prefill_len=512,
                                    chunk_len=256))
    log(f"serve done at {time.perf_counter() - t_start:.1f} s")
    counts_by_path = {"serve": serve_counts}
    for path in TRAIN_PATHS:
        setup, _, counts_by_path[path] = phase_train(torch, model, path)
        if path != "train_o1_flat":
            _profile_step(torch, setup, path)
        if path == "train_fused_head":
            phase_overflow(torch, setup)
        del setup
        torch.cuda.empty_cache()
    phase_layout_check(torch, model)
    log(f"train done at {time.perf_counter() - t_start:.1f} s")
    phase_train_parity(torch, model, "fused_head", "tree")
    phase_train_parity(torch, model, "xent", "flat")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(_kernel_line(results, train_results, lo_results,
                                  counts_by_path)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
