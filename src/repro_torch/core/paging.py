"""Paged-memory primitive: block-table page gather (counterpart of
``repro/core/paging.py``).

A data-movement building block registered once and dispatched per
backend, like the paper's primitives. The serving engine's paged KV cache
(``launch/paging.py``) reads K/V through it; the allocator around it is
composed from the suite (``searchsortedfirst``, ``bincount``,
``accumulate``).
"""
from __future__ import annotations

from repro_torch.core import registry

_page_gather = registry.get("page_gather")


def page_gather(pages, block_table, *, backend: str | None = None):
    """Gather pages (P, page_size, ...) through ``block_table`` (B, T)
    int32 into the logical per-sequence view (B, T * page_size, ...).
    Table entries must be valid page ids in [0, P). ``pages`` may also be
    a tuple of two pools of one geometry (a layer's K and V, which share
    the table); the result is then a tuple of two views, gathered by one
    kernel launch on the card."""
    return _page_gather(pages, block_table, backend=backend)
