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
   1e-3.

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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

GPT2 = dict(size="gpt2", vocab_size=50257, max_seq_len=1024)
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
    log(f"  {label}: kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms,"
        f" library {r['library']:.4f} ms, bound {r['bound']:.4f} ms "
        f"({r['by']})")


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


def _kernel_line(results, counts):
    main = {"layer_norm": (8, "torch.bfloat16"),
            "paged_decode_attention": (8, "torch.bfloat16"),
            "paged_prefill_attention": (256, "torch.bfloat16")}
    info = {
        "layer_norm": ("apex_tpu_torch/csrc/layer_norm.cu",
                       "apex_tpu/kernels/layer_norm.py:174",
                       "rows=8 (decode) H=768 bf16"),
        "paged_decode_attention": (
            "apex_tpu_torch/csrc/paged_attention.cu",
            "apex_tpu/kernels/decode_attention.py:423",
            "B=8 h=12 d=64 page_len=128 lengths 1..1024 bf16"),
        "paged_prefill_attention": (
            "apex_tpu_torch/csrc/paged_attention.cu",
            "apex_tpu/kernels/prefill_attention.py:413",
            "B=1 C=256 offset=256 h=12 d=64 page_len=128 bf16"),
    }
    out = []
    for name, key in main.items():
        r = results[(name,) + key]
        src, replaces, shape = info[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[name],
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain"], "bound_ms": r["bound"],
                    "bound_by": r["by"], "library_ms": r["library"],
                    "shape": shape})
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
    model = create_lm(**GPT2)
    _, counts = phase_serve(torch, model, SERVE)
    phase_parity(torch, model, dict(max_len=1024, prefill_len=512,
                                    chunk_len=256))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(_kernel_line(results, counts)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
