"""Block-pool KV-cache page allocator — AK primitives as the hot ops
(counterpart of ``repro/launch/paging.py``).

The paged serving engine (launch/engine.py ``paged=True``) stores K/V in a
pool of ``num_pages`` fixed-size pages; this module owns the HOST-side
bookkeeping: which pages are free, who holds how many references to each,
and which prompt prefixes are resident where. Per the paper's thesis (and
Pilliat's arbitrary-types primitives paper), the
allocator's hot operations are compositions of the registered AK suite
rather than bespoke loops:

  free-page search  — inclusive ``accumulate``(+) over the free mask, then
                      ``searchsortedfirst`` of 1..k into the running count:
                      the k-th free page is the first index where the
                      prefix sum reaches k (the classic stream-compaction
                      identity, two registry calls, no host scan);
  occupancy         — ``bincount`` of the clipped refcounts: bin 0 is the
                      free-page count, bins 1+ the sharing histogram;
  defrag ordering   — ``merge_sort_by_key`` on ``id + P * is_free``:
                      allocated pages first (ascending id — stable for
                      resident data), free pages after; the payload is the
                      permutation the engine applies to the device pool.

COPY-ON-WRITE prefix sharing: at admission the engine hashes each prompt
page by its exact token chain ``tuple(prompt[: end])`` (collision-free by
construction — the key IS the content that determines the page's K/V, since
K/V at position p depends only on tokens [0, p] under causal masking and
absolute RoPE). A hit shares the resident page (``share`` bumps the
refcount) instead of recomputing + rewriting it; the first decode WRITE
into a shared page forks it (``fork``: allocate a private copy, drop one
reference) so co-owners never observe the write. A shared page is
therefore never freed while shared: ``release`` only frees at refcount 0,
and ``fork`` by construction leaves the donor's refcount >= 1.

Page ids handed to the device are ints in [0, num_pages); ``num_pages``
itself is the DON'T-WRITE sentinel the model's paged scatter drops
(models/layers.py) — the pool never allocates it.
"""
from __future__ import annotations

import operator

import numpy as np
import torch

from repro_torch import core as ak
from repro_torch.runtime import faults, telemetry


class PageExhausted(RuntimeError):
    """The pool cannot back an allocation right now. Deliberately a
    RuntimeError subclass so pre-existing callers that catch/match the
    historical ``RuntimeError("page pool exhausted: ...")`` keep working —
    but the engine's preemption path catches THIS type specifically and
    turns it into an eviction instead of a crash."""


class PagePool:
    """Refcounted free-list over ``num_pages`` KV pages + prefix index."""

    def __init__(self, num_pages: int, page_size: int, device="cuda"):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        #: where the hot ops run (the engine's device): the refcounts are
        #: host bookkeeping, copied over for each AK call
        self.device = torch.device(device)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros((self.num_pages,), np.int32)
        self._index: dict = {}   # chain key -> page id
        self._keys: dict = {}    # page id -> chain key
        self.allocs_total = 0    # cumulative pages handed out (stats)

    # -- free-list queries -------------------------------------------------
    def free_count(self) -> int:
        return int(np.count_nonzero(self.refcount == 0))

    def allocated_count(self) -> int:
        return self.num_pages - self.free_count()

    # -- allocation (AK: accumulate + searchsortedfirst) -------------------
    def alloc(self, count: int = 1) -> list[int]:
        """Claim the first ``count`` free pages (refcount 0 -> 1)."""
        if count <= 0:
            return []
        # fault-injection site: fires BEFORE the free-list is consulted,
        # so an injected PageExhausted exercises the engine's preemption
        # path even when pages are actually free (runtime/faults.py)
        faults.check("pool.alloc")
        with telemetry.span("pool.alloc", cat="alloc", count=count):
            if self.free_count() < count:
                raise PageExhausted(
                    f"page pool exhausted: wanted {count} pages, "
                    f"{self.free_count()}/{self.num_pages} free"
                )
            free = torch.as_tensor(self.refcount == 0, dtype=torch.int32,
                                   device=self.device)
            running = ak.accumulate(operator.add, free, init=0)
            ids = ak.searchsortedfirst(running, torch.arange(
                1, count + 1, dtype=running.dtype, device=self.device,
            )).cpu().numpy()
            self.refcount[ids] = 1
            self.allocs_total += count
            return [int(i) for i in ids]

    # -- sharing / copy-on-write ------------------------------------------
    def share(self, pid: int) -> int:
        """Add a reference to an allocated page (a prefix-cache hit)."""
        if self.refcount[pid] <= 0:
            raise ValueError(f"share of free page {pid}")
        self.refcount[pid] += 1
        return pid

    def fork(self, pid: int) -> int:
        """Copy-on-write split: allocate a private page for one of the
        co-owners of ``pid`` and drop their reference to the original.
        The caller copies the device bytes; the donor keeps its key and
        its other owners (refcount stays >= 1 — a shared page is never
        freed by forking)."""
        if self.refcount[pid] <= 1:
            raise ValueError(
                f"fork of page {pid} with refcount {int(self.refcount[pid])}"
                " (only shared pages fork)"
            )
        new = self.alloc(1)[0]
        self.refcount[pid] -= 1
        return new

    def release(self, pid: int) -> None:
        """Drop one reference; frees the page (and evicts its prefix-index
        entry) only when the last owner lets go."""
        if self.refcount[pid] <= 0:
            raise ValueError(f"release of free page {pid}")
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            key = self._keys.pop(pid, None)
            if key is not None:
                self._index.pop(key, None)

    # -- prefix index ------------------------------------------------------
    def lookup(self, key) -> int | None:
        """Resident page holding this exact token chain, if any."""
        return self._index.get(key)

    def register_key(self, pid: int, key) -> None:
        if self.refcount[pid] <= 0:
            raise ValueError(f"keying free page {pid}")
        self._index[key] = pid
        self._keys[pid] = key

    # -- occupancy (AK: bincount) -----------------------------------------
    def occupancy(self, max_share: int = 8) -> tuple[float, np.ndarray]:
        """(allocated fraction, refcount histogram). Bin 0 counts free
        pages, bin i pages with i owners, the last bin >= max_share."""
        with telemetry.span("pool.occupancy", cat="alloc"):
            hist = ak.bincount(
                torch.as_tensor(np.minimum(self.refcount, max_share),
                                dtype=torch.int32, device=self.device),
                max_share + 1,
            ).cpu().numpy()
            return 1.0 - float(hist[0]) / self.num_pages, hist

    # -- defragmentation (AK: merge_sort_by_key) ---------------------------
    def defrag_order(self) -> np.ndarray:
        """Permutation ``perm`` (new position -> old page id) that compacts
        the pool: allocated pages first in ascending id order, free pages
        after. The engine gathers the device pool with it (``pool[perm]``)
        and remaps block tables with the inverse; ``apply_perm`` then
        relabels the host state to match."""
        with telemetry.span("pool.defrag_order", cat="alloc"):
            ids = torch.arange(self.num_pages, dtype=torch.int32,
                               device=self.device)
            held = torch.as_tensor(self.refcount > 0, device=self.device)
            keys = torch.where(held, ids, ids + self.num_pages)
            _, perm = ak.merge_sort_by_key(keys, ids)
            return perm.cpu().numpy()

    def apply_perm(self, perm: np.ndarray) -> np.ndarray:
        """Relabel host state after the device gather; returns the inverse
        map (old id -> new id) for block-table rewrites."""
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.num_pages, dtype=perm.dtype)
        self.refcount = self.refcount[perm]
        self._index = {k: int(inv[p]) for k, p in self._index.items()}
        self._keys = {int(inv[p]): k for p, k in self._keys.items()}
        return inv

    # -- invariants --------------------------------------------------------
    def assert_conservation(self, held_refs: int | None = None) -> None:
        """allocated + free == pool, refcounts non-negative, prefix index
        consistent; with ``held_refs`` (the engine's count of references it
        is holding) also checks no reference leaked."""
        free = self.free_count()
        allocated = self.allocated_count()
        assert allocated + free == self.num_pages, (
            f"page leak: {allocated} allocated + {free} free != "
            f"{self.num_pages}"
        )
        assert (self.refcount >= 0).all(), "negative refcount"
        for key, pid in self._index.items():
            assert self.refcount[pid] > 0, f"index points at free page {pid}"
            assert self._keys.get(pid) == key, f"index/keys disagree on {pid}"
        if held_refs is not None:
            total = int(self.refcount.sum())
            assert total == held_refs, (
                f"refcount conservation: pool holds {total} references, "
                f"engine holds {held_refs}"
            )
