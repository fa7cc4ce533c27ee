"""The AK.jl primitive suite, part 2: sorting (counterpart of
``repro/core/sort.py``).

``merge_sort`` / ``merge_sort_by_key`` / ``sortperm`` /
``sortperm_lowmem``, the k-way
``merge`` / ``merge_kv`` of the paper's §II-B, ``segmented_sort``, and
the batched last-axis forms the serve sampler uses (``merge_sort_batched``,
``sortperm_batched``, ``topk``, ``nucleus_mask``). The GPU specialisation is
the bitonic network of ``kernels/sort_kernel.py``; the portable path is
``torch.sort``. Both sides are registered once in
``repro_torch.core.registry``; these wrappers adapt the public signatures.
"""
from __future__ import annotations

import torch

from repro_torch.core import registry

_sort = registry.get("sort")
_sort_kv = registry.get("sort_kv")
_merge = registry.get("merge")
_merge_kv = registry.get("merge_kv")
_argsort = registry.get("argsort")
_segmented_sort = registry.get("segmented_sort")
_sort_batched = registry.get("sort_batched")
_argsort_batched = registry.get("argsort_batched")
_topk = registry.get("topk")
_nucleus_mask = registry.get("nucleus_mask")


def merge_sort(x, *, descending: bool = False, backend: str | None = None):
    """Sort a 1-D tensor (AK ``merge_sort``; allocating form)."""
    return _sort(x, descending=descending, backend=backend)


def merge_sort_by_key(keys, vals, *, backend: str | None = None):
    """Sort (keys, payload) kept in separate tensors (AK
    ``merge_sort_by_key``). Equal-key payload order is unspecified, as in
    a non-stable parallel sort."""
    return _sort_kv(keys, vals, backend=backend)


def sortperm(x, *, backend: str | None = None):
    """Stable int32 index permutation that sorts ``x`` (AK ``sortperm``):
    a by-key sort of (x, iota) with (key, index) lexicographic ties."""
    return _argsort(x, backend=backend)


def sortperm_lowmem(x, *, backend: str | None = None):
    """AK ``sortperm_lowmem``: the permutation of ``sortperm`` with one
    n-element temporary instead of two. The index rides in the low bits
    of a widened key, ``(bits << 32) | index`` as int64, sorted key-only
    and unpacked. ``bits`` is a signed-order int32 image of the key: an
    int32 key itself; for float32 the IEEE bits with the magnitude bits of
    negative keys flipped (the reference's unsigned map with the sign bit
    flipped back, so the int64 comparison is signed). Keys of other dtypes
    take ``sortperm``. Equal to ``sortperm`` on NaN-free keys without
    mixed signed zeros (the widened key orders -0.0 before 0.0)."""
    n = x.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=x.device)
    if x.dtype == torch.float32:
        bits = x.view(torch.int32)
        bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    elif x.dtype == torch.int32:
        bits = x
    else:
        return sortperm(x, backend=backend)
    wide = (bits.to(torch.int64) << 32) | torch.arange(
        n, dtype=torch.int64, device=x.device)
    swide = merge_sort(wide, backend=backend)
    return (swide & 0xFFFFFFFF).to(torch.int32)


def merge(x, nruns: int, *, counts=None, backend: str | None = None):
    """Merge ``nruns`` consecutive pre-sorted ascending runs of 1-D ``x``
    into one sorted tensor of the same length. ``counts`` (optional,
    (nruns,) ints) marks each run's valid prefix; slots past it are masked
    to type-max and sort to the global tail. This is SIHSort's finish."""
    if counts is None:
        return _merge(x, nruns=nruns, backend=backend)
    return _merge(x, counts, nruns=nruns, backend=backend)


def merge_kv(keys, vals, nruns: int, *, counts=None,
             tie_break: bool = False, backend: str | None = None):
    """Key/value k-way merge of pre-sorted runs; pairs survive intact.
    ``tie_break=True`` requires (key, value)-lexicographically sorted runs
    and yields the stable lexicographic merge."""
    if counts is None:
        return _merge_kv(keys, vals, nruns=nruns, tie_break=tie_break,
                         backend=backend)
    return _merge_kv(keys, vals, counts, nruns=nruns, tie_break=tie_break,
                     backend=backend)


def segmented_sort(values, offsets, *, vals=None,
                   backend: str | None = None):
    """Sort each CSR segment of 1-D ``values`` ascending (``offsets`` of
    length S + 1, empty segments legal). With ``vals`` (a same-length
    payload) returns ``(sorted_values, payload)``, equal values keeping
    their original order; without, the sorted values. On the card: the
    bitonic kv network with the segment ids as keys."""
    if vals is None:
        return _segmented_sort(values, offsets, backend=backend)
    return _segmented_sort(values, offsets, vals, backend=backend)


def merge_sort_batched(x, *, descending: bool = False,
                       backend: str | None = None):
    """Sort (..., n) along its last axis: on the card every row goes
    through one bitonic launch set (the batch is a grid dimension, not a
    loop of 1-D sorts)."""
    return _sort_batched(x, descending=descending, backend=backend)


def sortperm_batched(x, *, backend: str | None = None):
    """Stable int32 index permutation along the last axis of (..., n)."""
    return _argsort_batched(x, backend=backend)


def topk(x, k: int, *, backend: str | None = None):
    """Top-k (values, int32 indices) along the last axis, descending, equal
    values by ascending index (``lax.top_k``'s order). On the card it is
    derived from the batched network, as AK would compose it."""
    return _topk(x, k=k, backend=backend)


def nucleus_mask(x, *, top_p: float, backend: str | None = None):
    """Nucleus (top-p) keep mask along the last axis of logits: the
    smallest descending-probability prefix whose inclusive softmax mass
    reaches ``top_p`` (ties at the cut by ascending index). One registry
    call: on the card the batched descending sortperm and one mask launch
    (kernels/nucleus_kernel.py). ``top_p`` is a host float."""
    return _nucleus_mask(x, top_p=float(top_p), backend=backend)
