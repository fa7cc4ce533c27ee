"""Public wrappers over the CUDA kernels: registry delegates (counterpart
of ``repro/kernels/ops.py``).

Every function delegates into ``repro_torch.core.registry`` with
``backend="cuda"`` and ``switch_below=0`` pinned: callers of this module
asked for the kernels by name, so an ambient tuning scope must not demote
them to the portable path, and an op or body outside the kernels'
catalogue raises ``TypeError``. On CPU tensors the kernels' plain versions
run. These are what the kernel-vs-portable sweeps compare; every function
has a same-signature oracle in ``repro_torch.kernels.ref``.
"""
from __future__ import annotations

from repro_torch.core import registry


def map_elementwise(f, *arrays, out_dtype=None):
    """foreachindex: a catalogue body over same-shaped arrays."""
    return registry.call("map", *arrays, f=f, out_dtype=out_dtype,
                         switch_below=0, backend="cuda")


def mapreduce(f, op, *arrays, unit, out_dtype=None):
    return registry.call("mapreduce", *arrays, f=f, op=op, init=unit,
                         out_dtype=out_dtype, switch_below=0, backend="cuda")


def accumulate(op, x, *, unit, exclusive=False):
    return registry.call("accumulate", x, op=op, init=unit,
                         inclusive=not exclusive, switch_below=0,
                         backend="cuda")


def sort(keys, *, descending=False):
    return registry.call("sort", keys, descending=descending,
                         switch_below=0, backend="cuda")


def sort_kv(keys, vals, *, tie_break=False):
    return registry.call("sort_kv", keys, vals, tie_break=tie_break,
                         switch_below=0, backend="cuda")


def argsort(keys):
    """Index permutation sorting ``keys`` (AK ``sortperm``), stable."""
    return registry.call("argsort", keys, switch_below=0, backend="cuda")


def sort_batched(keys, *, descending=False):
    """Last-axis sort of (..., n): every row in one network launch set."""
    return registry.call("sort_batched", keys, descending=descending,
                         switch_below=0, backend="cuda")


def argsort_batched(keys):
    """Stable last-axis argsort of (..., n)."""
    return registry.call("argsort_batched", keys, switch_below=0,
                         backend="cuda")


def topk(x, k):
    """Descending top-k (values, indices) along the last axis, sort-derived."""
    return registry.call("topk", x, k=k, switch_below=0, backend="cuda")


def nucleus_mask(x, *, top_p):
    """Fused top-p keep mask along the last axis (serve-sampler hot path)."""
    return registry.call("nucleus_mask", x, top_p=float(top_p),
                         switch_below=0, backend="cuda")


def searchsorted(hay, queries, *, side="left"):
    return registry.call("searchsorted", hay, queries, side=side,
                         switch_below=0, backend="cuda")


def minmax_histogram(x, nbins, lo, hi):
    return registry.call("minmax_histogram", x, lo, hi, nbins=nbins,
                         switch_below=0, backend="cuda")
