"""A numpy model of the schedule of the port's nucleus mask kernel
(``src/repro_torch/kernels/csrc/nucleus.cu``): one cluster of ``cc`` CTAs a
row, on float32 values. Imports numpy alone.

Per row (the kernel's steps): m = -neg[0]; CTA c owns lanes and mask
columns [c * slice, (c + 1) * slice) of [0, n) (``geometry``); it zeroes
its columns, reads its lanes in tiles of ``threads * RUN`` (thread t holds
RUN consecutive lanes), takes e = exp(-neg - m) (0 past its slice), scans
each thread's run in order and the runs' totals across the block (warp
Hillis-Steele scans, then the warps' totals the same way), and sums its
tile totals in order into E_c. z folds E_0 .. E_{cc-1} in rank order;
carry_c is the same fold's prefix before E_c. A lane's cum is (carry +
(thread offset + run)) / z, the carry growing by each tile's total; a CTA
(or a later tile) whose carry / z >= top_p counts nothing (the early-out;
``early_out=False`` counts every lane instead). cut is the sum of the
counts, and keep[perm[l]] is set for l <= cut, the CTAs splitting those
ranks evenly (in shares of a multiple of RUN).

``np.exp`` is not CUDA's ``expf``, so the model is held to the plain
version and to the JAX package away from the cut, not to the kernel
bitwise.
"""
from __future__ import annotations

import numpy as np

RUN = 16
MAX_THREADS = 1024


def geometry(n: int, cc: int) -> tuple[int, int]:
    """(lanes a CTA, threads a CTA) as the kernel's host code picks them:
    the slice a multiple of 16, the threads a multiple of 32 covering one
    tile if they can."""
    per = -(-n // cc)
    slice_ = -(-per // 16) * 16
    t = (-(-slice_ // RUN) + 31) // 32 * 32
    return slice_, min(max(t, 32), MAX_THREADS)


def _hillis_steele(v):
    """Inclusive scan along the last axis (32 lanes), lane l taking lane
    l - d's partial on its left, d = 1 .. 16."""
    v = v.copy()
    for d in (1, 2, 4, 8, 16):
        nv = v.copy()
        nv[..., d:] = v[..., :-d] + v[..., d:]
        v = nv
    return v


def block_excl_scan(tot):
    """Exclusive scan of the threads' totals (threads,) and their sum, in
    the kernel's association (``block_excl_scan``)."""
    warps = tot.shape[0] // 32
    incl = _hillis_steele(tot.reshape(warps, 32))
    excl = np.concatenate([np.zeros((warps, 1), np.float32),
                           incl[:, :-1]], axis=1)
    wt = np.zeros(32, np.float32)
    wt[:warps] = incl[:, 31]
    wincl = _hillis_steele(wt)
    wexcl = np.concatenate([np.zeros(1, np.float32), wincl[:-1]])
    return (wexcl[:warps, None] + excl).reshape(-1), wincl[31]


def scan_tile(s, t0, hi, m, threads):
    """One tile: (run (threads, RUN) inclusive per thread, thread offsets
    (threads,), tile total)."""
    lane = t0 + np.arange(threads * RUN).reshape(threads, RUN)
    valid = lane < hi
    v = np.where(valid, s[np.minimum(lane, s.shape[0] - 1)], 0)
    with np.errstate(over="ignore"):
        e = np.where(valid, np.exp((-v - m).astype(np.float32)),
                     np.float32(0))
    run = np.cumsum(e.astype(np.float32), axis=1, dtype=np.float32)
    toff, total = block_excl_scan(run[:, -1])
    return run, toff, total, lane, valid


def row_mask(neg, perm, n: int, top_p: float, cc: int, *,
             early_out: bool = True, keep=None):
    """The kernel on one row: neg (row,) float32 ascending, perm (row,)
    int32. Returns (keep (n,) bool, cut, per-CTA counts, tiles counted).
    ``keep`` (n,) is the mask's memory before the launch (any bytes)."""
    neg = np.asarray(neg, np.float32)
    top_p = np.float32(top_p)
    slice_, threads = geometry(n, cc)
    tile = threads * RUN
    keep = (np.ones(n, bool) if keep is None else keep.copy())
    m = np.float32(-neg[0])
    spans, tiles, totals = [], [], []
    for c in range(cc):
        lo = min(c * slice_, n)
        hi = min(lo + slice_, n)
        keep[lo:hi] = False                        # 0. zero own columns
        nt = -(-(hi - lo) // tile)
        tt = [scan_tile(neg, lo + j * tile, hi, m, threads)
              for j in range(nt)]
        e_c = np.float32(0)
        for t in tt:
            e_c = np.float32(e_c + t[2])
        spans.append((lo, hi))
        tiles.append(tt)
        totals.append(e_c)
    z, carries = np.float32(0), []
    for c in range(cc):                            # rank order
        carries.append(z)
        z = np.float32(z + totals[c])
    counts, counted = [], 0
    for c in range(cc):
        carry, below = carries[c], 0
        for run, toff, total, lane, valid in tiles[c]:
            if early_out and not np.float32(carry / z) < top_p:
                break
            local = (toff[:, None] + run).astype(np.float32)
            cum = ((carry + local).astype(np.float32) / z).astype(
                np.float32)
            below += int(np.sum(valid & (cum < top_p)))
            counted += 1
            carry = np.float32(carry + total)
        counts.append(below)
    cut = sum(counts)
    kept = min(n, cut + 1)                         # set l <= cut, ranks
    share = (-(-kept // cc) + RUN - 1) // RUN * RUN  # split evenly
    for c in range(cc):
        ls = np.arange(min(c * share, kept), min(c * share + share, kept))
        keep[np.asarray(perm)[ls]] = True
    return keep, cut, counts, counted


def mask_model(neg, perm, n: int, top_p: float, cc: int, **kw):
    """(R, n) keep mask of the rows of neg / perm (R, row >= n)."""
    return np.stack([row_mask(neg[r], perm[r], n, top_p, cc, **kw)[0]
                     for r in range(neg.shape[0])])
