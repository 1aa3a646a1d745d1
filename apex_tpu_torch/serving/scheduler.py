"""Continuous-batching scheduler: requests in, token streams out.

Port of the synchronous chunked path of ``apex_tpu/serving/scheduler.py``.
The engine's decode step is a steady heartbeat, and requests move through
its slots between beats. One :meth:`Scheduler.step`:

1. **expire** — queued or running requests past their deadline finish
   with status ``EXPIRED`` (their slot and pages free immediately);
2. **admit** — while a slot is free and the queue is not empty, the
   oldest request's worst-case page demand is reserved
   (:meth:`Engine.try_reserve_slot`) and it enters the slot as
   *prefilling*; when the pool cannot cover it, it stays queued (FIFO
   holds);
3. **chunk prefill** — at most ``chunk_budget`` chunk-prefill calls
   across the prefilling slots, round-robin. The final chunk samples the
   request's first token (the TTFT mark). While nothing is decoding
   there is nothing to stall, so a cold queue ingests chunk after chunk;
4. **decode** — one fixed-shape decode step over every running slot,
   each token through the finish checks (EOS, token budget, ``max_len``).

Backpressure: the queue is bounded (``max_queue``) and :meth:`submit`
raises :class:`QueueFull`, with a ``retry_after_s`` hint from the
measured decode-step time once there is one.

A sampled row whose logits are not all finite (the engine's guard) ends
its request with status ``FAILED``. Retries with backoff, the fault plan,
the watchdog, telemetry, tracing, prefix retention, speculative decoding,
the dispatch-ahead heartbeat, SLO classes and replica roles belong to
later slices.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import itertools
import time
from typing import List, Optional, Sequence

import numpy as np

from apex_tpu_torch.log_util import get_logger

__all__ = ["Request", "RequestStatus", "QueueFull", "Scheduler"]

_logger = get_logger("serving")

_uid = itertools.count()


class RequestStatus(str, enum.Enum):
    """A request's lifecycle state; ``FINISHED``, ``EXPIRED`` and
    ``FAILED`` are terminal."""

    NEW = "new"
    QUEUED = "queued"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"
    EXPIRED = "expired"
    FAILED = "failed"

    def __str__(self) -> str:
        return self.value

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.FINISHED, RequestStatus.EXPIRED,
                        RequestStatus.FAILED)


class QueueFull(RuntimeError):
    """:meth:`Scheduler.submit` at capacity — shed or retry later.
    ``retry_after_s`` estimates when a queue position frees (None before
    any decode step was measured)."""

    def __init__(self, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class Request:
    """One generation request and, after serving, its outcome.

    Inputs: ``prompt`` (token ids), ``max_new_tokens``, ``temperature``
    (0 = greedy), optional ``timeout_s`` (else the scheduler default).
    Outputs: ``output_tokens``, ``status``, ``finish_reason`` (``"eos"``
    / ``"max_new_tokens"`` / ``"max_len"`` / ``"timeout"`` /
    ``"fault"``), ``ttft_s`` = ``queue_wait_s`` (submit → admission) +
    prefill, ``prefill_s`` (summed chunk time), ``chunks``,
    ``latency_s`` and ``error``."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    timeout_s: Optional[float] = None
    uid: int = dataclasses.field(default_factory=lambda: next(_uid))

    output_tokens: List[int] = dataclasses.field(default_factory=list)
    status: RequestStatus = RequestStatus.NEW
    finish_reason: Optional[str] = None
    ttft_s: Optional[float] = None
    queue_wait_s: Optional[float] = None
    prefill_s: float = 0.0
    chunks: int = 0
    latency_s: Optional[float] = None
    error: Optional[str] = None
    _t_submit: Optional[float] = dataclasses.field(default=None,
                                                   repr=False)
    _prefill_pos: int = dataclasses.field(default=0, repr=False)


class Scheduler:
    """Continuous-batching front of an
    :class:`~apex_tpu_torch.serving.Engine` (see the module docstring)."""

    def __init__(self, engine, *, max_queue: int = 64,
                 default_timeout_s: Optional[float] = None,
                 eos_id: Optional[int] = None, chunk_budget: int = 1):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if chunk_budget < 1:
            raise ValueError("chunk_budget must be >= 1")
        self.engine = engine
        self.max_queue = int(max_queue)
        self.default_timeout_s = default_timeout_s
        self.eos_id = eos_id
        self.chunk_budget = int(chunk_budget)
        self._queue: collections.deque = collections.deque()
        self._running: List[Optional[Request]] = [None] * engine.slots
        self._last_tokens = np.zeros(engine.slots, np.int64)
        self._temps = np.zeros(engine.slots, np.float32)
        self._pf_rr = 0           # round-robin start for chunk budgeting
        self.completed: List[Request] = []
        self._step_s_ema: Optional[float] = None

    # ------------------------------------------------------------ ingestion
    def submit(self, request: Request) -> Request:
        """Queue ``request``; raises :class:`QueueFull` at capacity and
        ``ValueError`` for prompts the engine can never serve."""
        n = len(request.prompt)
        if not 0 < n <= self.engine.prefill_len:
            raise ValueError(
                f"prompt length {n} not in (0, prefill_len="
                f"{self.engine.prefill_len}]")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(self._queue) >= self.max_queue:
            hint = self._retry_after_hint()
            suffix = f" (retry_after_s~{hint:.3f})" if hint else ""
            raise QueueFull(
                f"request queue at capacity ({self.max_queue}); retry "
                f"after a step() or shed load{suffix}",
                retry_after_s=hint)
        request.status = RequestStatus.QUEUED
        if request._t_submit is None:
            request._t_submit = time.perf_counter()
        self._queue.append(request)
        return request

    def _retry_after_hint(self) -> Optional[float]:
        """Decode-step EMA × the fewest tokens any running request still
        needs (None before the first measured decode step)."""
        if self._step_s_ema is None:
            return None
        remaining = [max(1, r.max_new_tokens - len(r.output_tokens))
                     for r in self._running if r is not None]
        return round((min(remaining) if remaining else 1)
                     * self._step_s_ema, 6)

    # ----------------------------------------------------------- lifecycle
    def _free_slot(self, slot: int) -> None:
        self._running[slot] = None
        self._temps[slot] = 0.0
        self.engine.release_slot(slot)

    def _finish(self, request: Request, reason: str,
                slot: Optional[int] = None,
                status: Optional[RequestStatus] = None) -> None:
        request.finish_reason = reason
        if status is None:
            status = RequestStatus.EXPIRED if reason == "timeout" \
                else RequestStatus.FINISHED
        request.status = status
        if request._t_submit is not None:
            request.latency_s = time.perf_counter() - request._t_submit
        if slot is not None:
            self._free_slot(slot)
        self.completed.append(request)

    def _fail_nonfinite(self, request: Request, slot: int,
                        where: str) -> None:
        request.error = f"non-finite {where} logits"
        _logger.warning("request %d FAILED: %s", request.uid,
                        request.error)
        self._finish(request, "fault", slot, status=RequestStatus.FAILED)

    def _deadline(self, request: Request) -> Optional[float]:
        t = request.timeout_s if request.timeout_s is not None \
            else self.default_timeout_s
        if t is None or request._t_submit is None:
            return None
        return request._t_submit + t

    def _expire(self, now: float) -> None:
        for r in [r for r in self._queue
                  if (d := self._deadline(r)) is not None and now > d]:
            self._queue.remove(r)
            self._finish(r, "timeout")
        for slot, r in enumerate(self._running):
            if r is None:
                continue
            d = self._deadline(r)
            if d is not None and now > d:
                self._finish(r, "timeout", slot)

    # ------------------------------------------------------------ admission
    def _admit(self) -> None:
        for slot in range(self.engine.slots):
            if self._running[slot] is not None or not self._queue:
                continue
            r = self._queue[0]
            need = self.engine.pages_required(len(r.prompt),
                                              r.max_new_tokens)
            if not self.engine.try_reserve_slot(slot, need):
                # pool exhausted for the head request: stop admitting
                # (FIFO — later, smaller requests must not starve it)
                break
            self._queue.popleft()
            r.queue_wait_s = time.perf_counter() - r._t_submit
            r.status = RequestStatus.PREFILLING
            r._prefill_pos = 0
            self._running[slot] = r
            self._temps[slot] = r.temperature

    def _prefill_tick(self) -> int:
        """At most ``chunk_budget`` chunk-prefill calls across the
        prefilling slots, round-robin from a rotating start. Returns the
        number of chunks run."""
        ran = 0
        slots = self.engine.slots
        start = self._pf_rr
        for i in range(slots):
            if ran >= self.chunk_budget:
                break
            slot = (start + i) % slots
            r = self._running[slot]
            if r is None or r.status != RequestStatus.PREFILLING:
                continue
            lo = r._prefill_pos
            hi = min(lo + self.engine.chunk_len, len(r.prompt))
            final = hi == len(r.prompt)
            t0 = time.perf_counter()
            token = self.engine.prefill_chunk(
                slot, list(r.prompt[lo:hi]), lo, r.temperature,
                final=final)
            r.prefill_s += time.perf_counter() - t0
            r._prefill_pos = hi
            r.chunks += 1
            ran += 1
            # resume AFTER the slot served, so slots separated by gaps
            # ingest at the same rate
            self._pf_rr = (slot + 1) % slots
            if not self.engine.last_chunk_finite:
                self._fail_nonfinite(r, slot, "chunk-prefill")
                continue
            if final:
                self._complete_prompt(r, slot, token)
        return ran

    def _complete_prompt(self, r: Request, slot: int, token: int) -> None:
        r.ttft_s = time.perf_counter() - r._t_submit
        r.output_tokens.append(token)
        if self.eos_id is not None and token == self.eos_id:
            self._finish(r, "eos", slot)
        elif len(r.output_tokens) >= r.max_new_tokens:
            self._finish(r, "max_new_tokens", slot)
        elif len(r.prompt) >= self.engine.max_len:
            # cache already full: a decode step would overwrite the last
            # prompt position's K/V
            self._finish(r, "max_len", slot)
        else:
            r.status = RequestStatus.RUNNING
            self._last_tokens[slot] = token

    # ------------------------------------------------------------ heartbeat
    def step(self) -> bool:
        """One beat: expire → admit → chunk prefill → decode. Returns
        True when any forward progress was made."""
        self._expire(time.perf_counter())
        self._admit()
        chunks = self._prefill_tick()
        while chunks and not any(r is not None
                                 and r.status == RequestStatus.RUNNING
                                 for r in self._running):
            more = self._prefill_tick()
            if not more:
                break
            chunks += more
        active = np.array([r is not None and r.status == RequestStatus.RUNNING
                           for r in self._running])
        if not active.any():
            return chunks > 0
        t0 = time.perf_counter()
        tokens = self.engine.decode_step(self._last_tokens, active,
                                         self._temps)
        dt = time.perf_counter() - t0
        self._step_s_ema = dt if self._step_s_ema is None \
            else 0.8 * self._step_s_ema + 0.2 * dt
        finite = self.engine.last_decode_finite
        lengths = self.engine.lengths()
        for slot, r in enumerate(self._running):
            if not active[slot]:
                continue
            if not finite[slot]:
                self._fail_nonfinite(r, slot, "decode")
                continue
            token = int(tokens[slot])
            r.output_tokens.append(token)
            self._last_tokens[slot] = token
            if self.eos_id is not None and token == self.eos_id:
                self._finish(r, "eos", slot)
            elif len(r.output_tokens) >= r.max_new_tokens:
                self._finish(r, "max_new_tokens", slot)
            elif int(lengths[slot]) >= self.engine.max_len:
                self._finish(r, "max_len", slot)
        return True

    @property
    def pending(self) -> int:
        """Queued + running requests."""
        return len(self._queue) + sum(r is not None for r in self._running)

    def run(self, requests: Sequence[Request] = (),
            max_steps: int = 100000) -> List[Request]:
        """Submit ``requests`` (stepping through :class:`QueueFull`
        backpressure) and step until every request finishes. Returns
        them in completion order."""
        t0 = time.perf_counter()
        tok0 = self.engine.tokens_generated
        done0 = len(self.completed)
        for r in requests:
            while True:
                try:
                    self.submit(r)
                    break
                except QueueFull:
                    if not self.step() and not self._queue:
                        raise
        steps = 0
        while self.pending and steps < max_steps:
            self.step()
            steps += 1
        dt = time.perf_counter() - t0
        toks = self.engine.tokens_generated - tok0
        _logger.info("served %d request(s): %d tokens in %.3fs "
                     "(%.1f tok/s)", len(self.completed) - done0, toks,
                     dt, toks / dt if dt > 0 else float("inf"))
        return self.completed[done0:]
