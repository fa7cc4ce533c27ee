"""A numpy model of the association of the port's scan kernel
(``src/repro_torch/kernels/csrc/scan.cu`` ``onepass_kernel``), dense and
segmented: every operation the kernel does, in its order and with its
operand order, on float32 or int32 values (bfloat16 inputs accumulate in
float32, as the kernel does; the caller rounds the result). Imports numpy
alone, so the card tests can hold the kernel to it bitwise and the CPU
tests can hold it to the JAX package.

Tiles of ``TILE`` elements (past n: the identity); in a tile, 512 threads
own 16 consecutive elements each and scan them in sequence from the
identity; each warp scans its 32 threads' totals (Hillis-Steele, the
earlier value on the left), warp 0 the 16 warps' totals. Seeds: ``init``
for a single tile; else tile p of group g (``GROUP`` tiles) takes
``E_g + fold``, the fold over the aggregates of tiles (g, 0 .. p-1)
padded with the identity to ``GROUP``: four a lane in order from the
identity, then a shuffle-down tree over the 32 lanes (distances 16 .. 1;
segmented 1 .. 16, which keeps the lanes in order); ``E_0 = init`` and
``E_{g+1} = (seed of (g, GROUP-1)) + its aggregate``. Dense, "+" is op;
segmented (head ``flags`` given), every value carries its flag and "+" is
the flagged monoid (fa, va) + (fb, vb) = (fa | fb, fb ? vb : op(va, vb)),
a head element is ``op(init, x)``, and the exclusive scan sets heads to
``init``.
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


def _combine(op, va, fa, vb, fb):
    """(fa, va) + (fb, vb) of the flagged monoid (``combine`` in the
    kernel); with no flag set anywhere it is op alone."""
    return np.where(fb, vb, op(va, vb)), fa | fb


def _lane_scan(op, v, f):
    """Inclusive Hillis-Steele scan along the last axis (32 lanes): lane l
    takes (lane l - d) + (lane l) for d = 1, 2, 4, 8, 16 (``warp_scan``)."""
    for d in (1, 2, 4, 8, 16):
        nv, nf = v.copy(), f.copy()
        nv[..., d:], nf[..., d:] = _combine(op, v[..., :-d], f[..., :-d],
                                            v[..., d:], f[..., d:])
        v, f = nv, nf
    return v, f


def _shift(v, fill):
    """The value of the previous lane (``fill`` at lane 0)."""
    out = np.empty_like(v)
    out[..., 1:] = v[..., :-1]
    out[..., 0] = fill
    return out


def _warp_fold(op, v, f, seg):
    """Lane 0 of a shuffle-down tree over 32 lanes (a lane whose source is
    past lane 31 reads its own value): distances 16 .. 1 (dense), or 1 ..
    16 (segmented: the order of the lanes kept, since the flagged monoid
    does not commute)."""
    for d in ((1, 2, 4, 8, 16) if seg else (16, 8, 4, 2, 1)):
        sv = np.concatenate([v[..., d:], v[..., 32 - d:]], axis=-1)
        sf = np.concatenate([f[..., d:], f[..., 32 - d:]], axis=-1)
        v, f = _combine(op, v, f, sv, sf)
    return v[..., 0], f[..., 0]


def _identity(name, dt):
    if name == "add":
        return dt.type(0)
    if name == "mul":
        return dt.type(1)
    if dt == np.int32:
        info = np.iinfo(np.int32)
        return dt.type(info.max if name == "min" else info.min)
    return dt.type(np.inf if name == "min" else -np.inf)


def scan_model(name: str, x: np.ndarray, init, exclusive: bool = False,
               group: int = GROUP, flags=None) -> np.ndarray:
    """The kernel's result for flat ``x`` (float32 or int32) under
    ``name`` in {add, mul, min, max}, seeded with ``init``; segmented by
    the head ``flags`` (nonzero at a segment's first element) where
    given."""
    op = _op(name)
    dt = x.dtype
    n = x.size
    if n == 0:
        return x.copy()
    ident = _identity(name, dt)
    init = dt.type(init)
    seg = flags is not None
    tiles = -(-n // TILE)
    xs = np.full(tiles * TILE, ident, dt)
    xs[:n] = x
    fs = np.zeros(tiles * TILE, bool)
    if seg:
        fs[:n] = np.asarray(flags) != 0
    runs = xs.reshape(tiles, THREADS, ITEMS)
    heads = fs.reshape(tiles, THREADS, ITEMS)

    # each thread's run, in sequence from the identity; a head restarts it
    # at op(init, x)
    v = np.empty_like(runs)
    acc = np.empty(runs.shape, bool)
    run = np.full((tiles, THREADS), ident, dt)
    rf = np.zeros((tiles, THREADS), bool)
    for j in range(ITEMS):
        e, h = runs[:, :, j], heads[:, :, j]
        run = np.where(h, op(np.full_like(e, init), e), op(run, e))
        rf = rf | h
        v[:, :, j], acc[:, :, j] = run, rf
    tv, tf = _lane_scan(op, run.reshape(tiles, WARPS, 32),
                        rf.reshape(tiles, WARPS, 32))
    ev = _shift(tv, ident).reshape(tiles, THREADS)
    ef = _shift(tf, False).reshape(tiles, THREADS)
    wv = np.full((tiles, 32), ident, dt)
    wf = np.zeros((tiles, 32), bool)
    wv[:, :WARPS], wf[:, :WARPS] = tv[:, :, 31], tf[:, :, 31]
    wv, wf = _lane_scan(op, wv, wf)
    pre = _shift(wv, ident)[:, :WARPS]
    pf = _shift(wf, False)[:, :WARPS]
    tot, totf = wv[:, WARPS - 1], wf[:, WARPS - 1]

    # the seeds
    if tiles == 1:
        seed = np.array([init], dt)
    else:
        groups = -(-tiles // group)
        slots = np.full((groups * group,), ident, dt)
        sflags = np.zeros((groups * group,), bool)
        slots[:tiles], sflags[:tiles] = tot, totf
        slots = slots.reshape(groups, group)
        sflags = sflags.reshape(groups, group)
        p = np.arange(group)
        # tile p of a group folds slots k < p (the identity elsewhere)
        before = p[None, None, :] < p[None, :, None]
        masked = np.where(before, slots[:, None, :], ident)  # (g, p, k)
        mflags = before & sflags[:, None, :]
        spl = -(-group // 32)  # slots a lane folds (the identity past)
        lanes = np.full((groups, group, 32 * spl), ident, dt)
        lflags = np.zeros((groups, group, 32 * spl), bool)
        lanes[..., :group], lflags[..., :group] = masked, mflags
        lanes = lanes.reshape(groups, group, 32, spl)
        lflags = lflags.reshape(groups, group, 32, spl)
        a = np.full(lanes.shape[:3], ident, dt)
        af = np.zeros(lanes.shape[:3], bool)
        for i in range(spl):
            a, af = _combine(op, a, af, lanes[..., i], lflags[..., i])
        fold, foldf = _warp_fold(op, a, af, seg)  # (groups, group)
        seed = np.empty((groups, group), dt)
        e = init
        for g in range(groups):
            seed[g] = _combine(op, np.full(group, e, dt), False, fold[g],
                               foldf[g])[0]
            e = _combine(op, seed[g, group - 1], False, slots[g, group - 1],
                         sflags[g, group - 1])[0]
        seed = seed.reshape(-1)[:tiles]

    # the output
    pw = np.where(pf, pre, op(seed[:, None], pre))     # (tiles, warps)
    pw = np.repeat(pw, 32, axis=1)
    pth = np.where(ef, ev, op(pw, ev))                 # (tiles, threads)
    inc = np.where(acc, v, op(pth[:, :, None], v))
    if exclusive:
        out = np.empty_like(inc)
        out[:, :, 0] = pth
        out[:, :, 1:] = inc[:, :, :-1]
        if seg:
            out = np.where(heads, init, out)
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
