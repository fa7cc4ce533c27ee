"""Paged KV-cache gather (counterpart of ``repro/kernels/page_kernel.py``).

The serving engine's paged cache keeps K/V in a shared pool of
fixed-size pages ``(P, page_size, *tail)``; a request's logical sequence
is a block-table row ``(T,)`` of page ids. Attention reads the logical
view ``(B, T * page_size, *tail)``: a gather of whole pages. K and V
share one table, so both gathers also take a pair of pools of one
geometry and return a pair: one launch for a layer's K and V.

Replaces the TPU kernel ``page_gather_blocks`` (``_gather_body``), whose
indirection lived in a scalar-prefetch ``index_map``. The CUDA kernel
(``csrc/page.cu``) gives one CTA to each (b, t) slot of each pool: it
reads the page id itself and copies the page with 16-byte loads, several
in flight a thread before its stores. The work is pure data movement, so
the bound is bytes: one read of every gathered page and one write of the
output. Kernel and plain version agree bitwise. A decode step's page
gather moves ~10 MB in a few microseconds, so its host path is kept to
one allocation and one ctypes call with plain-int arguments.

Table entries must lie in [0, P): the plain version raises on others, and
the kernel writes zeros for them instead of reading out of bounds. The
engine clamps its unbacked sentinel before every call.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C

_SIGNATURES = {
    "ak_page_gather": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p,
    ],
}

#: Pools one launch gathers at most: a layer's K and V.
MAX_POOLS = 2


def _pools(pages) -> tuple:
    """``pages`` as a tuple of pools; a tuple's pools must share their
    shape and dtype (one page geometry)."""
    if isinstance(pages, torch.Tensor):
        return (pages,)
    pools = tuple(pages)
    if not 1 <= len(pools) <= MAX_POOLS:
        raise ValueError(f"page_gather takes 1 to {MAX_POOLS} pools, got "
                         f"{len(pools)}")
    first = pools[0]
    for p in pools[1:]:
        if p.shape != first.shape or p.dtype != first.dtype:
            raise ValueError(
                f"pools of one gather share one page geometry, got "
                f"{first.dtype}{tuple(first.shape)} and "
                f"{p.dtype}{tuple(p.shape)}")
    return pools


def _gather_one(pages: torch.Tensor, block_table: torch.Tensor):
    B, T = block_table.shape
    g = pages[block_table.long()]
    return g.reshape(B, T * pages.shape[1], *pages.shape[2:])


def page_gather_ref(pages, block_table: torch.Tensor):
    """Plain version: pages (P, ps, *tail), block_table (B, T) int ->
    (B, T * ps, *tail), i.e. ``pages[block_table]`` reshaped; for a tuple
    of pools of one geometry, the tuple of their gathers."""
    pools = _pools(pages)
    if isinstance(pages, torch.Tensor):
        return _gather_one(pages, block_table)
    return tuple(_gather_one(p, block_table) for p in pools)


def _launch(pools: tuple, table: torch.Tensor, out: torch.Tensor) -> None:
    """One launch gathering every pool of ``pools`` (contiguous, on the
    card) through the contiguous int32 ``table`` into ``out``
    (len(pools), B, T * ps, *tail)."""
    first = pools[0]
    lib = _build.library("page", _SIGNATURES)
    err = lib.ak_page_gather(
        first.data_ptr(), pools[-1].data_ptr(), len(pools),
        table.data_ptr(), out.data_ptr(), first.shape[0], table.numel(),
        math.prod(first.shape[1:]) * first.element_size(),
        _build.stream_handle(first.device))
    _build.check(lib, err, "page gather kernel")
    C.count_launch("page_gather")


def page_gather_blocks(pages, block_table: torch.Tensor):
    """Gather whole pages through the block table: the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU.
    ``pages`` is one pool or a tuple of pools of one geometry (a layer's
    K and V), gathered in one launch and returned as a tuple."""
    if block_table.dim() != 2 or block_table.dtype != torch.int32:
        raise TypeError(f"block table must be (B, T) int32, got "
                        f"{block_table.dtype}{tuple(block_table.shape)}")
    pools = _pools(pages)
    if not C.require_cuda_or_cpu(*pools, block_table):
        return page_gather_ref(pages, block_table)
    if not all(p.is_contiguous() for p in pools):
        raise ValueError("page_gather takes contiguous page pools")
    first = pools[0]
    B, T = block_table.shape
    shape = (B, T * first.shape[1], *first.shape[2:])
    single = isinstance(pages, torch.Tensor)
    out = torch.empty(shape if single else (len(pools), *shape),
                      dtype=first.dtype, device=first.device)
    if out.numel():
        _launch(pools, block_table.contiguous(), out)
    return out if single else out.unbind(0)
