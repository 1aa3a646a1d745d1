"""The paged KV pool and its host-side page allocator.

Port of ``apex_tpu/serving/kv_cache.py``'s paged half:

- :class:`PagedKVCache` — K and V pools ``[layers, num_pages, heads,
  page_len, head_dim]`` on the device. Lengths and page tables are host
  state (the engine's :class:`PagePool` plus numpy tables handed to every
  call). The model writes into the pools in place.
- :class:`PagePool` — host numpy bookkeeping: a free list, per-page
  refcounts and a reservation ledger, so an admitted request can always
  grow to its token budget.

Page 0 is the **sentinel** page: never allocated, it absorbs the
fixed-shape decode step's writes for inactive slots (their page-table
rows point at it), so a dead slot's discarded write never lands on a live
request's page. The contiguous ``KVCache`` belongs to the ``paged=False``
engine, a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

import numpy as np
import torch

__all__ = ["PagedKVCache", "PagePool"]


@dataclasses.dataclass
class PagedKVCache:
    """The paged pool's two device tensors (see the module docstring)."""

    k: torch.Tensor       # [layers, num_pages, heads, page_len, head_dim]
    v: torch.Tensor       # [layers, num_pages, heads, page_len, head_dim]

    def nbytes(self) -> int:
        """Device bytes held by the pool (K and V)."""
        return 2 * self.k.numel() * self.k.element_size()

    @classmethod
    def create(cls, *, layers: int, num_pages: int, heads: int,
               page_len: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> "PagedKVCache":
        """A zeroed pool. ``num_pages`` INCLUDES the page-0 sentinel, so
        the usable capacity is ``(num_pages - 1) * page_len`` positions.
        ``device=None`` means the GPU, as the JAX pool lives on the
        accelerator: it raises when torch sees no CUDA device (pass
        ``device="cpu"`` for a pool on the CPU)."""
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "sentinel/garbage page)")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "PagedKVCache.create(device=None) allocates on the GPU "
                    "and torch sees no CUDA device; pass device='cpu' for "
                    "a pool on the CPU")
            device = "cuda"
        shape = (layers, num_pages, heads, page_len, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


class PagePool:
    """Host-side page allocator for a :class:`PagedKVCache`: a LIFO free
    list of page ids (never the sentinel 0), per-page refcounts (a page
    returns to the free list at refcount 0; prefix sharing, which raises
    a count above 1, comes with the prefix-cache slice) and a reservation
    ledger — :meth:`reserve` sets capacity aside without naming pages,
    and :meth:`alloc` draws it down."""

    def __init__(self, num_pages: int, page_len: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "sentinel/garbage page)")
        if page_len < 1:
            raise ValueError("page_len must be >= 1")
        self.num_pages = int(num_pages)
        self.page_len = int(page_len)
        self.refcount = np.zeros(self.num_pages, np.int32)
        # ids descend so a fresh pool allocates low pages first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self.reserved_total = 0

    @property
    def free_pages(self) -> int:
        """Pages on the free list (ignores reservations)."""
        return len(self._free)

    @property
    def available(self) -> int:
        """Pages an admission may still reserve: free minus promised."""
        return max(0, len(self._free) - self.reserved_total)

    @property
    def pages_in_use(self) -> int:
        """Allocatable pages currently referenced (excludes sentinel)."""
        return self.num_pages - 1 - len(self._free)

    def pages_for(self, positions: int) -> int:
        """Pages covering ``positions`` logical positions."""
        return -(-int(positions) // self.page_len)

    def reserve(self, n: int) -> bool:
        """Promise ``n`` pages to a future caller; False (no change) when
        the pool cannot cover it on top of existing promises."""
        n = int(n)
        if n < 0:
            raise ValueError("reserve expects n >= 0")
        if n > self.available:
            return False
        self.reserved_total += n
        return True

    def unreserve(self, n: int) -> None:
        """Return unused reservation."""
        self.reserved_total = max(0, self.reserved_total - int(n))

    def alloc(self, *, reserved: bool = False):
        """One page off the free list (refcount -> 1), or None when the
        list is empty. ``reserved=True`` draws down the ledger."""
        if not self._free:
            return None
        page = self._free.pop()
        self.refcount[page] = 1
        if reserved:
            self.reserved_total = max(0, self.reserved_total - 1)
        return page

    def release(self, pages: Iterable[int]) -> None:
        """One fewer reader per page; refcount 0 returns it to the free
        list."""
        for p in pages:
            p = int(p)
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} out of range (1, "
                                 f"{self.num_pages})")
            if self.refcount[p] <= 0:
                raise ValueError(f"page {p} already free")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)

    def fragmentation(self, lengths: Sequence[int],
                      pages_per_slot: Sequence[int]) -> float:
        """Fraction of allocated slot positions holding no valid token."""
        alloc = int(np.sum(np.asarray(pages_per_slot, np.int64))) \
            * self.page_len
        if alloc == 0:
            return 0.0
        used = int(np.sum(np.asarray(lengths, np.int64)))
        return max(0.0, 1.0 - used / alloc)

    def stats(self) -> dict:
        """Snapshot for telemetry."""
        return {
            "num_pages": self.num_pages,
            "page_len": self.page_len,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.free_pages,
            "pages_reserved": self.reserved_total,
        }
