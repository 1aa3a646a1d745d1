"""apex_tpu_torch.serving — the paged engine and the chunked scheduler.

Port of the single-device serving path of ``apex_tpu.serving``:
:class:`Engine` (paged KV pool, chunk prefill + decode through the CUDA
attention kernels), :class:`Scheduler` (continuous batching with chunked
prefill), :class:`PagedKVCache` / :class:`PagePool` (the pool and its
host allocator) and the request types.
"""

from .engine import Engine, resolve_page_len, sample_tokens  # noqa: F401
from .kv_cache import PagedKVCache, PagePool  # noqa: F401
from .scheduler import (  # noqa: F401
    QueueFull, Request, RequestStatus, Scheduler)

__all__ = ["Engine", "PagedKVCache", "PagePool", "QueueFull", "Request",
           "RequestStatus", "Scheduler", "resolve_page_len",
           "sample_tokens"]
