"""A numpy model of the schedule of the port's histogram kernel
(``src/repro_torch/kernels/csrc/hist.cu``): which thread reads which
element, into which warp's sub-histogram it counts, and the split of the
input at its first 16-byte boundary. Imports numpy alone.

The input starts ``addr`` bytes into memory (a view may start at any
element). Elements [0, head) lie before the first 16-byte boundary;
``nvec`` 16-byte vectors follow; the tail [tail0, n) is what is left.
Warp chunk c reads vectors c * 32 * LOADS + 32 * k + lane (k < LOADS),
and warp w of CTA b takes chunks b * WARPS + w, then every
grid * WARPS-th; each element adds 1 to its bin in the warp's
sub-histogram. CTA 0's warp 0 adds the head and the tail, one element a
lane. The CTAs' sub-histograms are summed. Bins are the reference's
formula in float32.
"""
from __future__ import annotations

import numpy as np

THREADS = 256
WARPS = THREADS // 32
LOADS = 4
MAX_GRID = 4 * 132


def split(n: int, addr: int, elsize: int) -> tuple[int, int, int]:
    """(head, nvec, tail0) for n elements of ``elsize`` bytes at
    ``addr``."""
    head = min(n, ((16 - addr % 16) % 16) // elsize)
    vec = 16 // elsize
    nvec = (n - head) // vec
    return head, nvec, head + nvec * vec


def bins(x, nbins: int, lo, hi) -> np.ndarray:
    """clip(int_rz((float32(x) - lo) / width), 0, nbins - 1), width =
    max((hi - lo) / nbins, 1e-30), all in float32; NaN bins to 0."""
    lo, hi = np.float32(lo), np.float32(hi)
    width = np.maximum((hi - lo) / np.float32(nbins), np.float32(1e-30))
    with np.errstate(invalid="ignore", over="ignore"):
        q = (np.asarray(x).astype(np.float32) - lo) / width
    q = np.nan_to_num(q, nan=0.0, posinf=nbins, neginf=-1.0)
    return np.clip(q, 0, nbins - 1).astype(np.int32)


def grid_of(n: int, elsize: int) -> int:
    """CTAs of a launch (the wrapper's sizing)."""
    per_cta = THREADS * LOADS * 16 // elsize
    return max(1, min(-(-n // per_cta), MAX_GRID))


def hist_model(x, nbins: int, lo, hi, *, addr: int = 0):
    """(hist, min, max, stats) of the kernel's schedule on ``x`` (1-D
    numpy, float32 / int32 / bfloat16) starting ``addr`` bytes into
    memory. stats: ``reads`` (times each element was read), ``atomics``
    (shared-memory atomics issued), ``sub`` (the (grid, WARPS, nbins)
    sub-histograms) and ``grid``."""
    x = np.asarray(x)
    n, elsize = x.shape[0], x.dtype.itemsize
    vec = 16 // elsize
    head, nvec, tail0 = split(n, addr, elsize)
    b = bins(x, nbins, lo, hi)
    grid = grid_of(n, elsize)
    sub = np.zeros((grid, WARPS, nbins), np.int64)
    reads = np.zeros(n, np.int64)
    atomics = 0
    chunks = -(-nvec // (32 * LOADS))
    for c in range(chunks):
        gw = c % (grid * WARPS)
        h = sub[gw // WARPS, gw % WARPS]
        for lane in range(32):
            for k in range(LOADS):
                v = c * 32 * LOADS + 32 * k + lane
                if v >= nvec:
                    continue
                i = head + v * vec + np.arange(vec)
                reads[i] += 1
                np.add.at(h, b[i], 1)
                atomics += vec
    for i in [*range(head), *range(tail0, n)]:  # CTA 0, warp 0
        reads[i] += 1
        sub[0, 0, b[i]] += 1
        atomics += 1
    hist = sub.sum(axis=(0, 1)).astype(np.int32)
    return hist, x.min(), x.max(), {"reads": reads, "atomics": atomics,
                                    "sub": sub, "grid": grid}
