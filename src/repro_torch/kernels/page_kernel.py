"""Paged KV-cache gather (counterpart of ``repro/kernels/page_kernel.py``).

The serving engine's paged cache keeps K/V in a shared pool of
fixed-size pages ``(P, page_size, *tail)``; a request's logical sequence
is a block-table row ``(T,)`` of page ids. Attention reads the logical
view ``(B, T * page_size, *tail)``: a gather of whole pages.

Replaces the TPU kernel ``page_gather_blocks`` (``_gather_body``), whose
indirection lived in a scalar-prefetch ``index_map``. The CUDA kernel
(``csrc/page.cu``) gives one CTA to each (b, t) slot: it reads the page id
itself and copies the page with 16-byte loads and stores. The work is pure
data movement, so the bound is bytes: one read of every gathered page and
one write of the output. Kernel and plain version agree bitwise.

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
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ],
}


def page_gather_ref(pages: torch.Tensor, block_table: torch.Tensor):
    """Plain version: pages (P, ps, *tail), block_table (B, T) int ->
    (B, T * ps, *tail), i.e. ``pages[block_table]`` reshaped."""
    B, T = block_table.shape
    g = pages[block_table.long()]
    return g.reshape(B, T * pages.shape[1], *pages.shape[2:])


def page_gather_blocks(pages: torch.Tensor, block_table: torch.Tensor):
    """Gather whole pages through the block table: the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU."""
    if block_table.dim() != 2 or block_table.dtype != torch.int32:
        raise TypeError(f"block table must be (B, T) int32, got "
                        f"{block_table.dtype}{tuple(block_table.shape)}")
    if not C.require_cuda_or_cpu(pages, block_table):
        return page_gather_ref(pages, block_table)
    if not pages.is_contiguous():
        raise ValueError("page_gather takes a contiguous page pool")
    B, T = block_table.shape
    P, ps = pages.shape[0], pages.shape[1]
    out = torch.empty((B, T * ps, *pages.shape[2:]), dtype=pages.dtype,
                      device=pages.device)
    page_bytes = ps * math.prod(pages.shape[2:]) * pages.element_size()
    if out.numel() == 0:
        return out
    table = block_table.contiguous()
    lib = _build.library("page", _SIGNATURES)
    err = lib.ak_page_gather(
        ctypes.c_void_p(pages.data_ptr()), ctypes.c_void_p(table.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), P, B * T, page_bytes,
        _build.stream_handle(pages.device),
    )
    _build.check(lib, err, "page gather kernel")
    C.count_launch("page_gather")
    return out
