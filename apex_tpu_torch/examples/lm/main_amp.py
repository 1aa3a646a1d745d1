"""Transformer-LM training recipe: amp (O2 by default, or O0 / O1 / O3),
dynamic loss scaling, FusedAdam (AdamW) and the fused softmax
cross-entropy, on one GPU.

The port of ``examples/lm/main_amp.py``'s single-chip ``main()``::

    python -m apex_tpu_torch.examples.lm.main_amp --size gpt2 \\
        --vocab-size 50257 -b 8 --seq-len 1024 --iters 20

It trains ``create_lm(size)`` on synthetic Zipf-ish tokens (or random
windows of a pre-tokenized ``--data`` .npy stream) through
:func:`apex_tpu_torch.amp.make_train_step`. The default loss is
``softmax_cross_entropy_loss`` on the model's fp32 logits (xentropy
kernels #11 and #12); ``--fused-head`` fuses the tied head into the loss
instead, so the ``[B, S, V]`` logits are never held whole.
``--opt-layout`` picks FusedAdam's per-tensor (``tree``, the default) or
superbuffer (``flat``) state; both step through multi-tensor kernel #24,
and the scaler's unscale runs kernel #21. Every LayerNorm and attention
call runs on the port's CUDA kernels, forward and backward. ``--device``
defaults to the GPU and raises when torch sees none; ``--device cpu``
runs the plain PyTorch versions (small sizes only).

The parallel tiers (data, tensor, pipeline, sequence parallel,
``--vocab-parallel``, ZeRO, ``--partitioning``), telemetry, checkpoints,
profiling, ``--remat``, ``--generate`` and the other flags of the JAX
recipe are later slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch.kernels.lm_head_loss import lm_head_xentropy
from apex_tpu_torch.kernels.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.models import create_lm
from apex_tpu_torch.optimizers import FusedAdam


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="apex_tpu_torch transformer LM recipe")
    p.add_argument("--data", default=None,
                   help="pre-tokenized int .npy stream (else synthetic)")
    p.add_argument("--size", default="small",
                   choices=["tiny", "small", "medium", "gpt2"])
    p.add_argument("--vocab-size", type=int, default=32768)
    p.add_argument("-b", "--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--opt-level", default="O2")
    p.add_argument("--loss-scale", default="dynamic")
    p.add_argument("--smoothing", type=float, default=0.0,
                   help="label smoothing")
    p.add_argument("--fused-head", action="store_true",
                   help="fuse the tied LM head into the loss "
                        "(kernels/lm_head_loss.py): the [B, S, V] logits "
                        "are never held whole")
    p.add_argument("--opt-layout", default="tree", choices=["tree", "flat"],
                   help="FusedAdam state layout: per-tensor 'tree' "
                        "(default) or the 'flat' fp32 superbuffer "
                        "(bitwise-identical)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--accum-steps", type=int, default=1, metavar="N",
                   help="microbatch gradient accumulation: N microbatches "
                        "of batch-size/N, one unscale + optimizer + scaler "
                        "update per step")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The device the run asked for: a CUDA one unless ``cpu`` is named;
    raises when torch sees no GPU rather than running on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible to torch: this recipe trains on the "
            "GPU; pass --device cpu to run the plain PyTorch versions")
    return dev


def synthetic_tokens(gen: torch.Generator, batch: int, seq_len: int,
                     vocab: int) -> torch.Tensor:
    """Zipf-ish unigram stream ``[batch, seq_len + 1]``: token ranks
    follow 1/(r+10), drawn from ``gen``."""
    probs = 1.0 / (torch.arange(vocab, dtype=torch.float64) + 10.0)
    return torch.multinomial(probs, batch * (seq_len + 1), replacement=True,
                             generator=gen).reshape(batch, seq_len + 1)


def load_token_stream(path, vocab_size: int, seq_len: int) -> np.ndarray:
    """A flat integer token stream from ``path``, checked: out-of-vocab
    ids are refused here, not found later as a wrong gather."""
    data = np.load(path)
    if not isinstance(data, np.ndarray) or data.ndim != 1:
        raise SystemExit(f"--data {path!r} must be a flat .npy token stream")
    if not np.issubdtype(data.dtype, np.integer):
        raise SystemExit(f"--data {path!r} holds {data.dtype} values; token "
                         "streams must be integers")
    if len(data) < seq_len + 2:
        raise SystemExit(f"--data holds {len(data)} tokens; need at least "
                         f"seq_len+2 = {seq_len + 2}")
    lo, hi = int(data.min()), int(data.max())
    if lo < 0 or hi >= vocab_size:
        raise SystemExit(f"--data token ids span [{lo}, {hi}]; "
                         f"--vocab-size is {vocab_size}")
    return data


def data_batch(data: np.ndarray, rng: np.random.Generator, batch: int,
               seq_len: int) -> torch.Tensor:
    """Random ``[batch, seq_len + 1]`` windows of the stream."""
    idx = rng.integers(0, len(data) - seq_len, batch)
    return torch.from_numpy(np.stack([data[i:i + seq_len + 1]
                                      for i in idx]).astype(np.int64))


def xent_loss_fn(smoothing: float):
    """``loss_fn(model, tokens)``: the mean softmax cross-entropy of the
    model's logits for ``tokens[:, :-1]`` against ``tokens[:, 1:]`` —
    the recipe's default loss."""

    def loss_fn(model, tokens):
        logits = model(tokens[:, :-1])
        return softmax_cross_entropy_loss(logits, tokens[:, 1:],
                                          smoothing=smoothing).mean()

    return loss_fn


def fused_head_loss_fn(smoothing: float, head_dtype: torch.dtype):
    """``loss_fn(model, tokens)``: the mean fused-head cross-entropy of
    ``tokens[:, 1:]`` given ``tokens[:, :-1]``, the head GEMMs in
    ``head_dtype``."""

    def loss_fn(model, tokens):
        hidden = model(tokens[:, :-1], features_only=True)
        losses = lm_head_xentropy(hidden, model.wte.weight, tokens[:, 1:],
                                  smoothing=smoothing,
                                  compute_dtype=head_dtype)
        return losses.mean()

    return loss_fn


def main(argv=None):
    args = parse_args(argv)
    if args.iters < 1:
        raise SystemExit("--iters must be >= 1")
    if args.accum_steps < 1:
        raise SystemExit("--accum-steps must be >= 1")
    if args.batch_size % args.accum_steps:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                         f"--accum-steps {args.accum_steps}")
    device = resolve_device(args.device)
    policy = amp.resolve_policy(opt_level=args.opt_level,
                                loss_scale=args.loss_scale, verbose=False)
    print(policy.banner())

    model = create_lm(args.size, vocab_size=args.vocab_size,
                      max_seq_len=args.seq_len, seed=args.seed).to(device)
    optimizer = FusedAdam(model.parameters(), lr=args.lr,
                          weight_decay=args.weight_decay, adam_w_mode=True,
                          layout=args.opt_layout)
    if args.fused_head:
        # the head GEMMs' dtype: the policy's blanket dtype, fp32 under O1
        # (as the JAX recipe resolves "linear" outside the autocast scope)
        loss_fn = fused_head_loss_fn(args.smoothing,
                                     policy.model_dtype or torch.float32)
    else:
        loss_fn = xent_loss_fn(args.smoothing)
    init_fn, step_fn = amp.make_train_step(loss_fn, optimizer, policy,
                                           accum_steps=args.accum_steps)
    state = init_fn(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"=> LM {args.size}, params: {n_params:,}, device {device}")

    data = None
    if args.data:
        data = load_token_stream(args.data, args.vocab_size, args.seq_len)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    t0, toks, metrics, loss_history = None, 0, None, []
    for it in range(args.iters):
        if data is not None:
            batch = data_batch(data, rng, args.batch_size, args.seq_len)
        else:
            batch = synthetic_tokens(gen, args.batch_size, args.seq_len,
                                     args.vocab_size)
        batch = amp.to_microbatches(batch.to(device), args.accum_steps)
        state, metrics = step_fn(state, batch)
        loss_history.append(metrics["loss"])
        if it == 4:
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0, toks = time.perf_counter(), 0
        toks += args.batch_size * args.seq_len
        if it % 10 == 0 or it == args.iters - 1:
            print(f"[{it}/{args.iters}] loss {float(metrics['loss']):.4f} "
                  f"loss_scale {metrics['loss_scale']:g}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    if t0 is not None and args.iters > 5:
        dt = time.perf_counter() - t0
        print(f"throughput: "
              f"{(toks - args.batch_size * args.seq_len) / dt:,.0f} "
              f"tokens/s on {device}")
    metrics = dict(metrics)
    metrics["final_state"] = state
    metrics["loss_history"] = [float(x) for x in loss_history]
    return metrics


if __name__ == "__main__":
    main()
