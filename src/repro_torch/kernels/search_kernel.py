"""``searchsortedfirst`` / ``searchsortedlast``: one binary search per
query (counterpart of ``repro/kernels/search_kernel.py``).

Replaces the TPU kernel ``searchsorted_blocks`` (``_search_body``), which
counted #{h < q} / #{h <= q} with tiled compare matrices because its
vector unit has no per-lane gather. The CUDA kernel (``csrc/search.cu``)
is AK's own form: one thread per query, a binary search over the sorted
haystack. SIHSort asks for a handful of queries at a time, so a call is
bound by launch latency and log2(n) dependent loads, not by bytes. The
plain version is ``torch.searchsorted``; on a sorted NaN-free haystack
both give the reference's counts, duplicates and type-max keys included.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels import ref

_SIGNATURES = {
    "ak_searchsorted": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ],
}


def searchsorted_plain(hay, queries, *, side: str = "left"):
    """The plain PyTorch version, on any device."""
    return ref.searchsorted_ref(hay, queries, side=side)


def searchsorted_blocks(hay: torch.Tensor, queries: torch.Tensor, *,
                        side: str = "left"):
    """0-based int32 insertion indices of ``queries`` into sorted ``hay``:
    side='left' is searchsortedfirst, side='right' searchsortedlast."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if hay.dtype != queries.dtype:
        raise TypeError(
            f"haystack {hay.dtype} and queries {queries.dtype} differ"
        )
    if not C.require_cuda_or_cpu(hay, queries):
        return searchsorted_plain(hay, queries, side=side)
    code = _build.dtype_code(hay.dtype, "searchsorted")
    h = hay.reshape(-1).contiguous()
    q = queries.reshape(-1).contiguous()
    out = torch.empty(q.numel(), dtype=torch.int32, device=hay.device)
    if q.numel() == 0:
        return out.reshape(queries.shape)
    lib = _build.library("search", _SIGNATURES)
    err = lib.ak_searchsorted(
        ctypes.c_void_p(h.data_ptr()), h.numel(),
        ctypes.c_void_p(q.data_ptr()), q.numel(), code,
        int(side == "right"), ctypes.c_void_p(out.data_ptr()),
        _build.stream_handle(hay.device),
    )
    _build.check(lib, err, "search kernel")
    C.count_launch("searchsorted")
    return out.reshape(queries.shape)
