"""Plain PyTorch oracles of the sort-path kernels (counterpart of
``repro/kernels/ref.py``): the portable ``torch`` backend of the registry.

Indices come back as ``int32``, as the reference returns them; torch's
own index type would make them ``int64``.
"""
from __future__ import annotations

import numpy as np
import torch


def sort_ref(keys: torch.Tensor, *, descending: bool = False) -> torch.Tensor:
    out = torch.sort(keys, stable=True).values
    return torch.flip(out, (0,)) if descending else out


def lexsort_perm(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Permutation sorting (keys, vals) lexicographically (numpy's
    ``lexsort((vals, keys))``): a stable sort by the minor key, then a
    stable sort by the major key."""
    minor = torch.sort(vals, stable=True).indices
    major = torch.sort(keys[minor], stable=True).indices
    return minor[major]


def sort_kv_ref(keys, vals, *, tie_break: bool = False):
    if tie_break:
        order = lexsort_perm(keys, vals)
    else:
        order = torch.sort(keys, stable=True).indices
    return keys[order], vals[order]


def argsort_ref(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).indices.to(torch.int32)


def searchsorted_ref(hay, queries, *, side: str = "left") -> torch.Tensor:
    return torch.searchsorted(hay, queries, right=side == "right").to(
        torch.int32
    )


def bin_width(nbins: int, lo, hi) -> np.float32:
    """``max((hi - lo) / nbins, 1e-30)`` in float32, one IEEE operation at
    a time as the reference computes it."""
    lo, hi = np.float32(lo), np.float32(hi)
    return np.maximum((hi - lo) / np.float32(nbins), np.float32(1e-30))


def histogram_bins(x: torch.Tensor, nbins: int, lo, hi) -> torch.Tensor:
    """Bin index of every element: ``clip(int((float(x) - lo) / width),
    0, nbins - 1)``, bitwise the reference's binning.

    Every operand is a full-size tensor: torch turns a division by a
    0-d scalar into a multiplication by its reciprocal, which rounds
    differently. The clip happens before the float -> int conversion
    (same result, and no out-of-range conversion); NaN bins to 0 as in
    the reference's saturating conversion."""
    xf = x.reshape(-1).to(torch.float32)
    lo_t = torch.tensor([np.float32(lo)], device=x.device).expand_as(xf)
    w_t = torch.tensor([bin_width(nbins, lo, hi)],
                       device=x.device).expand_as(xf)
    q = torch.nan_to_num((xf - lo_t) / w_t, nan=0.0)
    return q.clamp(0, nbins - 1).to(torch.int32)


def minmax_histogram_ref(x: torch.Tensor, nbins: int, lo, hi):
    b = histogram_bins(x, nbins, lo, hi)
    hist = torch.zeros(nbins, dtype=torch.int32, device=x.device)
    hist.scatter_add_(0, b.long(), torch.ones_like(b))
    flat = x.reshape(-1)
    return hist, flat.min(), flat.max()
