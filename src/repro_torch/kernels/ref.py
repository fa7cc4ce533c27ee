"""Plain PyTorch oracles of the kernels (counterpart of
``repro/kernels/ref.py``): the portable ``torch`` backend of the registry,
and the plain versions the kernel wrappers run on CPU tensors.

Indices come back as ``int32``, as the reference returns them; torch's
own index type would make them ``int64``.

``init`` (``unit``) of a reduce or scan is meant to be the identity of
``op``, as in AK.jl, and for an identity the result is the reference's.
For any other value the port folds it in exactly once, at the front:
``reduce = op(init, x0, x1, ...)`` and ``scan[i] = op(init, x0 .. xi)``
(Julia Base's meaning), where the reference's two backends disagree with
each other. ``op`` may be any elementwise binary torch callable here; the
kernels take only the catalogue of ``common.OPS``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import common as C


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a reduce or scan accumulates in: float32 for bfloat16
    (as the kernels do), the dtype itself otherwise."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def map_ref(f, *arrays, out_dtype=None) -> torch.Tensor:
    """``f(*arrays)`` as a new tensor of ``out_dtype`` (default: the
    first operand's dtype)."""
    out = f(*arrays)
    out = out.to(out_dtype or arrays[0].dtype)
    if any(out is a for a in arrays):
        out = out.clone()
    return out


def fold_ref(op, flat: torch.Tensor) -> torch.Tensor:
    """Fold a non-empty 1-D tensor under ``op`` by a pairwise tree of
    whole-tensor ops (left to right within each pair; an odd tail element
    is carried along), a 0-d result."""
    while flat.shape[0] > 1:
        m = flat.shape[0] // 2 * 2
        pairs = op(flat[0:m:2], flat[1:m:2])
        flat = torch.cat([pairs, flat[m:]]) if m < flat.shape[0] else pairs
    return flat.reshape(())


def reduce_ref(f, op, *arrays, unit, out_dtype=None) -> torch.Tensor:
    """``mapreduce``: ``op(unit, fold_op(f(*arrays)))`` as a 0-d tensor of
    ``out_dtype`` (default: the first operand's dtype)."""
    out_dtype = out_dtype or arrays[0].dtype
    flat = f(*arrays).to(out_dtype).reshape(-1)
    acc = acc_dtype(out_dtype)
    init = torch.tensor(unit, dtype=out_dtype, device=flat.device).to(acc)
    if flat.numel() == 0:
        return init.to(out_dtype)
    total = fold_ref(op, flat.to(acc))
    return op(init, total).to(out_dtype)


_CUMULATIVE = {
    "add": lambda x: torch.cumsum(x, 0, dtype=x.dtype),
    "mul": lambda x: torch.cumprod(x, 0, dtype=x.dtype),
    "min": lambda x: torch.cummin(x, 0).values,
    "max": lambda x: torch.cummax(x, 0).values,
}


def hillis_steele(op, x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along dim 0 under any associative ``op``:
    ``out[i] = op(out[i - s], out[i])`` for s = 1, 2, 4, ..."""
    shift = 1
    while shift < x.shape[0]:
        x = torch.cat([x[:shift], op(x[:-shift], x[shift:])])
        shift *= 2
    return x


def scan_ref(op, x, *, unit, exclusive: bool = False) -> torch.Tensor:
    """``accumulate``: inclusive ``out[i] = op(unit, x0 .. xi)``, or the
    exclusive scan (``out[0] = unit``), flat, in ``x``'s shape and dtype.
    Catalogued ops use torch's cumulative functions, any other op a
    Hillis-Steele tree."""
    flat = x.reshape(-1)
    acc = acc_dtype(x.dtype)
    init = torch.tensor(unit, dtype=x.dtype, device=x.device).to(acc)
    if flat.numel() == 0:
        return x.clone()
    cat = C.catalogued_op(op)
    flat = flat.to(acc)
    if cat is not None and cat.name in _CUMULATIVE:
        incl = _CUMULATIVE[cat.name](flat)
    else:
        incl = hillis_steele(op, flat)
    incl = op(init, incl)
    if exclusive:
        incl = torch.cat([init.reshape(1), incl[:-1]])
    return incl.to(x.dtype).reshape(x.shape)


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
