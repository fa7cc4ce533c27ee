"""A numpy model of the association of the port's dense scan kernel
(``src/repro_torch/kernels/csrc/scan.cu``): every operation the kernel
does, in its order and with its operand order, on float32 or int32 values
(bfloat16 inputs accumulate in float32, as the kernel does; the caller
rounds the result). Imports numpy alone, so the card tests can hold the
kernel to it bitwise and the CPU tests can hold it to the JAX package.

Tiles of ``TILE`` elements (past n: the identity); in a tile, 512 threads
own 16 consecutive elements each and scan them in sequence from the
identity; each warp scans its 32 threads' totals (Hillis-Steele, the
earlier value on the left), warp 0 the 16 warps' totals. Seeds: ``init``
for a single tile; else tile p of group g (``GROUP`` tiles) takes
``op(E_g, fold)``, the fold over the aggregates of tiles (g, 0 .. p-1)
padded with the identity to ``GROUP``: four a lane in order from the
identity, then a shuffle-down tree over the 32 lanes; ``E_0 = init`` and
``E_{g+1} = op(seed of (g, GROUP-1), its aggregate)``.
"""
from __future__ import annotations

import numpy as np

THREADS, ITEMS = 512, 16
TILE = THREADS * ITEMS
GROUP = 128
WARPS = THREADS // 32


def _op(name):
    """The kernel's operator (``ak_stream.cuh`` ``AkOpF``) on numpy
    arrays of one dtype: min/max let a NaN right operand win."""
    if name == "add":
        return lambda a, b: a + b
    if name == "mul":
        return lambda a, b: a * b
    if name == "min":
        return lambda a, b: np.where((b < a) | (b != b), b, a)
    if name == "max":
        return lambda a, b: np.where((a < b) | (b != b), b, a)
    raise ValueError(name)


def _lane_scan(op, v, ident):
    """Inclusive Hillis-Steele scan along the last axis (32 lanes): lane l
    takes op(lane l - d, lane l) for d = 1, 2, 4, 8, 16."""
    for d in (1, 2, 4, 8, 16):
        nv = v.copy()
        nv[..., d:] = op(v[..., :-d], v[..., d:])
        v = nv
    return v


def _shift(v, ident):
    """The value of the previous lane (the identity at lane 0)."""
    out = np.empty_like(v)
    out[..., 1:] = v[..., :-1]
    out[..., 0] = ident
    return out


def _warp_fold(op, v):
    """``ak_warp_fold``: lane 0 of a shuffle-down tree over 32 lanes (a
    lane whose source is past lane 31 reads its own value)."""
    for d in (16, 8, 4, 2, 1):
        src = np.concatenate([v[..., d:], v[..., 32 - d:]], axis=-1)
        v = op(v, src)
    return v[..., 0]


def scan_model(name: str, x: np.ndarray, init, exclusive: bool = False,
               group: int = GROUP) -> np.ndarray:
    """The kernel's result for flat ``x`` (float32 or int32) under
    ``name`` in {add, mul, min, max}, seeded with ``init``."""
    op = _op(name)
    dt = x.dtype
    n = x.size
    if n == 0:
        return x.copy()
    if name == "add":
        ident = dt.type(0)
    elif name == "mul":
        ident = dt.type(1)
    elif dt == np.int32:
        info = np.iinfo(np.int32)
        ident = dt.type(info.max if name == "min" else info.min)
    else:
        ident = dt.type(np.inf if name == "min" else -np.inf)
    init = dt.type(init)
    tiles = -(-n // TILE)
    xs = np.full(tiles * TILE, ident, dt)
    xs[:n] = x
    runs = xs.reshape(tiles, THREADS, ITEMS)

    # each thread's run, in sequence from the identity
    v = np.empty_like(runs)
    run = np.full((tiles, THREADS), ident, dt)
    for j in range(ITEMS):
        run = op(run, runs[:, :, j])
        v[:, :, j] = run
    tv = _lane_scan(op, run.reshape(tiles, WARPS, 32), ident)
    ev = _shift(tv, ident).reshape(tiles, THREADS)
    wv = np.full((tiles, 32), ident, dt)
    wv[:, :WARPS] = tv[:, :, 31]
    wv = _lane_scan(op, wv, ident)
    pre = _shift(wv, ident)[:, :WARPS]
    tot = wv[:, WARPS - 1]

    # the seeds
    if tiles == 1:
        seed = np.array([init], dt)
    else:
        groups = -(-tiles // group)
        slots = np.full((groups * group,), ident, dt)
        slots[:tiles] = tot
        slots = slots.reshape(groups, group)
        p = np.arange(group)
        # tile p of a group folds slots k < p (the identity elsewhere)
        masked = np.where(p[None, None, :] < p[None, :, None],
                          slots[:, None, :], ident)  # (g, p, k)
        spl = -(-group // 32)  # slots a lane folds (the identity past)
        lanes = np.full((groups, group, 32 * spl), ident, dt)
        lanes[..., :group] = masked
        lanes = lanes.reshape(groups, group, 32, spl)
        a = np.full(lanes.shape[:3], ident, dt)
        for i in range(spl):
            a = op(a, lanes[..., i])
        fold = _warp_fold(op, a)  # (groups, group)
        seed = np.empty((groups, group), dt)
        e = init
        for g in range(groups):
            seed[g] = op(np.full(group, e, dt), fold[g])
            e = op(seed[g, group - 1], slots[g, group - 1])
        seed = seed.reshape(-1)[:tiles]

    # the output
    pw = op(seed[:, None], pre)                       # (tiles, warps)
    pth = op(np.repeat(pw, 32, axis=1), ev)           # (tiles, threads)
    inc = op(pth[:, :, None], v)
    if exclusive:
        out = np.empty_like(inc)
        out[:, :, 0] = pth
        out[:, :, 1:] = inc[:, :, :-1]
    else:
        out = inc
    return out.reshape(-1)[:n]


def chain_depth(n: int, group: int = GROUP) -> int:
    """The most operations on any output's path through the model: the
    run (16), the warp scan (5) and its shift, the warps' scan (5), the
    group fold (group / 32 rounded up, + 5), the E chain (one a group
    before the last) and the four seed applications. A float32 sum along such a path
    is off the exact one by at most ``chain_depth * 2^-24 * sum |x|``
    (first order)."""
    tiles = -(-n // TILE)
    groups = -(-tiles // group)
    return 16 + 5 + 5 + -(-group // 32) + 5 + max(groups - 1, 0) + 4
