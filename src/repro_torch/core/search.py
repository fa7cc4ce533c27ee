"""The AK.jl primitive suite, part 3: binary search (counterpart of
``repro/core/search.py``).

``searchsortedfirst`` / ``searchsortedlast``: the partition step of
``core.distributed.sihsort``. Convention: 0-based insertion index
(``torch.searchsorted`` semantics), returned as int32.
"""
from __future__ import annotations

from repro_torch.core import registry

_searchsorted = registry.get("searchsorted")


def searchsortedfirst(hay, queries, *, backend: str | None = None):
    """First index where each query could insert keeping ``hay`` sorted."""
    return _searchsorted(hay, queries, side="left", backend=backend)


def searchsortedlast(hay, queries, *, backend: str | None = None):
    """Last such index (insertion after the run of equal keys)."""
    return _searchsorted(hay, queries, side="right", backend=backend)
