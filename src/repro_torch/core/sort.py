"""The AK.jl primitive suite, part 2: sorting (counterpart of
``repro/core/sort.py``).

``merge_sort`` / ``merge_sort_by_key`` / ``sortperm``, the k-way
``merge`` / ``merge_kv`` of the paper's §II-B, and ``segmented_sort``. The GPU specialisation is
the bitonic network of ``kernels/sort_kernel.py``; the portable path is
``torch.sort``. Both sides are registered once in
``repro_torch.core.registry``; these wrappers adapt the public signatures.
"""
from __future__ import annotations

from repro_torch.core import registry

_sort = registry.get("sort")
_sort_kv = registry.get("sort_kv")
_merge = registry.get("merge")
_merge_kv = registry.get("merge_kv")
_argsort = registry.get("argsort")
_segmented_sort = registry.get("segmented_sort")


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
