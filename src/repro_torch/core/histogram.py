"""Fixed-range histogram + fused min/max: SIHSort's sampling primitive
(counterpart of ``repro/core/histogram.py``), and ``bincount``."""
from __future__ import annotations

from repro_torch.core import registry

_minmax_histogram = registry.get("minmax_histogram")
_bincount = registry.get("bincount")


def minmax_histogram(x, nbins: int, lo, hi, *, backend: str | None = None):
    """(int32 histogram over [lo, hi) with edge clipping, min(x), max(x))
    in one pass. ``x`` may be any shape; flattened."""
    return _minmax_histogram(x, lo, hi, nbins=nbins, backend=backend)


def bincount(ids, nbins: int, *, backend: str | None = None):
    """int32 counts of integer ids in [0, nbins); others are dropped."""
    return _bincount(ids, nbins=nbins, backend=backend)
