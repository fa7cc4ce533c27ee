"""Fused min/max + fixed-bin histogram: the SIHSort sampling kernel
(counterpart of ``repro/kernels/hist_kernel.py``).

Replaces the TPU kernel ``minmax_histogram_blocks`` (``_hist_body``),
which binned by one-hot compare matrices for want of atomics. The CUDA
kernel (``csrc/hist.cu``) bins with shared-memory int atomics per CTA,
merges the CTA histograms with global ``atomicAdd`` and reduces min/max in
two levels (per CTA, then the last CTA to finish). It is bound by one read
of the input from device memory. Binning is bitwise the reference's; see
``ref.histogram_bins`` for the plain version of the formula.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels import ref

_MAX_BINS = 1024
# CTAs per launch: four per SM of an H100 at most; a grid-stride loop
# covers the rest.
_MAX_GRID = 4 * 132
_ELEMS_PER_THREAD = 8

_SIGNATURES = {
    "ak_minmax_histogram": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ],
    "ak_minmax_histogram_threads": [],
}


def _as_f32(v) -> float:
    """A host float32 value (a 0-d tensor is read back)."""
    if isinstance(v, torch.Tensor):
        v = v.item()
    return float(np.float32(v))


def minmax_histogram_plain(x: torch.Tensor, nbins: int, lo, hi):
    """The plain PyTorch version: the reference's formula plus
    ``scatter_add``, on any device."""
    return ref.minmax_histogram_ref(x, nbins, _as_f32(lo), _as_f32(hi))


def minmax_histogram_blocks(x: torch.Tensor, nbins: int, lo, hi):
    """One-pass (histogram[nbins] int32, min, max) of ``x`` over [lo, hi).
    Values outside the range clip into the edge bins."""
    if not 1 <= nbins <= _MAX_BINS:
        raise ValueError(f"nbins {nbins} not in [1, {_MAX_BINS}]")
    if not C.require_cuda_or_cpu(x):
        return minmax_histogram_plain(x, nbins, lo, hi)
    code = _build.dtype_code(x.dtype, "minmax_histogram")
    flat = x.reshape(-1).contiguous()
    n = flat.numel()
    lib = _build.library("hist", _SIGNATURES)
    threads = lib.ak_minmax_histogram_threads()
    grid = max(1, min(C.ceil_div(n, threads * _ELEMS_PER_THREAD), _MAX_GRID))
    hist_ticket = torch.zeros(nbins + 1, dtype=torch.int32, device=x.device)
    bits = torch.int32 if x.element_size() == 4 else torch.int16
    partials = torch.empty(2 * grid, dtype=bits, device=x.device)
    out = torch.empty(2, dtype=x.dtype, device=x.device)
    err = lib.ak_minmax_histogram(
        flat.data_ptr(), code, n, nbins, _as_f32(lo), _as_f32(hi),
        hist_ticket.data_ptr(), hist_ticket[nbins:].data_ptr(),
        partials.data_ptr(), grid, out.data_ptr(),
        _build.stream_handle(x.device),
    )
    _build.check(lib, err, "min/max histogram kernel")
    C.count_launch("minmax_histogram")
    return hist_ticket[:nbins], out[0], out[1]
