"""``searchsortedfirst`` / ``searchsortedlast``: a 32-ary search of one
warp per query (counterpart of ``repro/kernels/search_kernel.py``).

Replaces the TPU kernel ``searchsorted_blocks`` (``_search_body``), which
counted #{h < q} / #{h <= q} with tiled compare matrices because its
vector unit has no per-lane gather. The CUDA kernel (``csrc/search.cu``)
searches the sorted haystack instead. SIHSort asks for a handful of
queries at a time into a shard far larger than L2, so a call is bound by
launch latency and the round trips of dependent loads, not by bytes: a
warp per query probes 32 positions a round (independent loads, one round
trip), which takes 2^26 keys in 6 rounds where a binary search makes 26
dependent loads. From :data:`THREAD_QUERIES_FROM` queries on, one thread
per query (a binary search) does less work in all and the card is full.
The plain version is ``torch.searchsorted``; on a sorted NaN-free
haystack both give the reference's counts, duplicates and type-max keys
included.
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
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
}

#: Query count from which one thread per query replaces one warp per
#: query. ``benchmarks_torch/launch_path.py``'s sweep of the device time
#: per launch into a 2^26-key float32 shard (H100 80GB HBM3, 700 W): a
#: warp each 7.4, 9.4 and 11.1 us at 4096, 6144 and 8192 queries, a
#: thread each 9.4, 9.4-9.5 and 9.5 us; they meet at 6144.
THREAD_QUERIES_FROM = 6144


def searchsorted_plain(hay, queries, *, side: str = "left"):
    """The plain PyTorch version, on any device."""
    return ref.searchsorted_ref(hay, queries, side=side)


def _launch(h: torch.Tensor, q: torch.Tensor, out: torch.Tensor,
            right: bool, warp: bool) -> None:
    """One launch over contiguous CUDA ``h`` and ``q`` into int32 ``out``:
    a warp per query (``warp``) or a thread per query."""
    lib = _build.library("search", _SIGNATURES)
    err = lib.ak_searchsorted(
        h.data_ptr(), h.numel(), q.data_ptr(), q.numel(),
        _build.dtype_code(h.dtype, "searchsorted"), right, warp,
        out.data_ptr(), _build.stream_handle(h.device))
    _build.check(lib, err, "search kernel")
    C.count_launch("searchsorted")


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
    out = queries.new_empty(queries.shape, dtype=torch.int32)
    nq = out.numel()
    if nq:
        _launch(_flat(hay), _flat(queries), out, side == "right",
                nq < THREAD_QUERIES_FROM)
    return out


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous 1-D tensor (itself when it is one)."""
    if t.dim() == 1 and t.is_contiguous():
        return t
    return t.reshape(-1).contiguous()
