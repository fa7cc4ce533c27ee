"""Nucleus (top-p) keep mask: the serve sampler's hot path (counterpart of
``repro/kernels/nucleus_kernel.py``).

Replaces the TPU kernel ``nucleus_mask_blocks`` (``_nucleus_body`` ->
``_mask_from_sorted``). As there, the kernel path is the batched bitonic
network of ``sort_kernel`` (descending and stable: ``-x`` ascending with
an index payload and the index tie-break, every row in one launch set),
then ONE launch of the hand-written mask kernel (``csrc/nucleus.cu``):
softmax over the descending row, inclusive prefix sum, cut = #{cum <
top_p}, keep ranks <= cut, scattered back through the permutation. One CTA
streams each row, which at vocabulary width (2^17 padded keys and ranks,
1 MiB) does not fit in shared memory; the source says how.

Semantics (the reference's): tokens ranked by (logit desc, index asc), the
mask keeps ranks ``0..cut`` where ``cut`` is the first rank whose inclusive
cumulative softmax mass reaches ``top_p``; ``-0.0`` is folded into
``+0.0`` first, so the network and ``torch.sort`` rank identically. NaN
logits are unsupported, as in every sampler.

The kernel sums in another order than ``torch.cumsum``, so kernel and
plain version agree on the mask except at ranks whose cum lies within
rounding of ``top_p``; everything else is exact.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels import sort_kernel as SK

_SIGNATURES = {
    "ak_nucleus_mask": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ],
}


def _canon(lg: torch.Tensor) -> torch.Tensor:
    """float32 with -0.0 folded into +0.0 (x + 0.0 is exact elsewhere)."""
    return lg.to(torch.float32) + 0.0


def mask_from_sorted(s, perm, *, n: int, top_p: float) -> torch.Tensor:
    """Keep mask (R, n) from descending rows ``s`` (R, row >= n; lanes
    >= n are padding) and their original columns ``perm``: the plain
    version of the mask kernel, and the reference's expression."""
    lane = torch.arange(s.shape[1], device=s.device)
    valid = lane < n
    m = s.max(dim=1, keepdim=True).values
    e = torch.where(valid, torch.exp(s - m), torch.zeros((), device=s.device))
    probs = e / e.sum(dim=1, keepdim=True)
    cum = torch.cumsum(probs, dim=1)
    cut = (valid & (cum < top_p)).sum(dim=1, keepdim=True)
    keep_sorted = valid & (lane <= cut)
    # padded lanes scatter into a ghost column n, then dropped
    col = torch.where(valid, perm.long(), torch.full((), n, device=s.device))
    out = torch.zeros((s.shape[0], n + 1), dtype=torch.bool, device=s.device)
    out.scatter_(1, col, keep_sorted)
    return out[:, :n]


def nucleus_mask_ref(lg: torch.Tensor, *, top_p: float) -> torch.Tensor:
    """Plain version: ``torch.argsort(stable=True)`` of ``-x`` and the mask
    expression. ``lg`` (..., V) of any float dtype -> bool (..., V)."""
    n = lg.shape[-1]
    flat = _canon(lg).reshape(-1, n)
    order = torch.argsort(-flat, dim=1, stable=True)
    s = torch.gather(flat, 1, order)
    return mask_from_sorted(s, order, n=n, top_p=top_p).reshape(lg.shape)


def mask_kernel(neg, perm, *, n: int, top_p: float,
                cuda: bool) -> torch.Tensor:
    """The mask launch over rows sorted by the network: ``neg`` (R, row)
    float32 ascending = the negated descending row, ``perm`` (R, row)
    int32. ``cuda=False`` runs the plain version."""
    if not cuda:
        return mask_from_sorted(-neg, perm, n=n, top_p=top_p)
    if neg.dtype != torch.float32 or perm.dtype != torch.int32:
        raise TypeError(f"nucleus mask takes float32 keys and int32 ranks, "
                        f"got {neg.dtype} and {perm.dtype}")
    if neg.shape != perm.shape or neg.dim() != 2 or neg.shape[1] < n:
        raise ValueError(f"bad sorted rows {tuple(neg.shape)} / "
                         f"{tuple(perm.shape)} for n={n}")
    neg, perm = neg.contiguous(), perm.contiguous()
    rows, row = neg.shape
    keep = torch.empty((rows, n), dtype=torch.bool, device=neg.device)
    lib = _build.library("nucleus", _SIGNATURES)
    err = lib.ak_nucleus_mask(
        neg.data_ptr(), perm.data_ptr(), keep.data_ptr(), rows, n, row,
        float(top_p),
        _build.stream_handle(neg.device),
    )
    _build.check(lib, err, "nucleus mask kernel")
    C.count_launch("nucleus_mask")
    return keep


def sorted_rows(lg: torch.Tensor, *, cuda: bool):
    """The batched network's descending stable order of every row of
    ``lg`` (..., V): (negated keys ascending, int32 columns), both (R,
    total) with the padding at the end of each row."""
    n = lg.shape[-1]
    flat = _canon(lg).reshape(-1, n)
    iota = torch.arange(n, dtype=torch.int32, device=lg.device)
    return SK.sort_padded(-flat, iota.expand(flat.shape[0], n), True, cuda)


def nucleus_mask_blocks(lg: torch.Tensor, *, top_p: float) -> torch.Tensor:
    """Kernel path: the batched bitonic sortperm (descending, stable) and
    one mask launch for the whole batch. CPU tensors run the plain versions
    of the same two steps."""
    n = lg.shape[-1]
    if lg.numel() == 0:
        return torch.zeros(lg.shape, dtype=torch.bool, device=lg.device)
    cuda = C.require_cuda_or_cpu(lg)
    neg, perm = sorted_rows(lg, cuda=cuda)
    keep = mask_kernel(neg, perm, n=n, top_p=top_p, cuda=cuda)
    return keep.reshape(lg.shape)


def nucleus_launches(n: int) -> int:
    """Closed-form launches of one ``nucleus_mask_blocks`` call, whatever
    the number of rows: the network's, plus the mask."""
    return SK.cross_launches(n) + 1
