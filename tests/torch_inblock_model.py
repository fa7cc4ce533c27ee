"""A numpy model of the schedule of the port's in-block sort kernel
(``src/repro_torch/kernels/csrc/bitonic.cu`` ``inblock_kernel``): which
index bits a thread holds in registers in each run, which stages each run
covers, where each key sits in shared memory, and the compare-exchanges
themselves. Imports numpy alone, so the CPU tests can hold it to the
port's plain network and to the JAX package, and the card tests can use
it too.

A block of 2^lb keys is held by 2^(lb - SLOT_BITS) virtual threads of
SLOTS keys each. Under layout c the slot s of virtual thread vt is block
element ``((vt >> c) << (c + SLOT_BITS)) | (s << c) | (vt & (2^c - 1))``:
the register bits are [c, c + SLOT_BITS). A run is a layout and the
stages (k, p) it runs, p the stage's distance bit (j = 2^p).
"""
from __future__ import annotations

import numpy as np

SLOT_BITS = 4
SLOTS = 1 << SLOT_BITS


def top_bit(k: int, lb: int) -> int:
    """The top stage bit of phase k in a block of 2^lb keys."""
    return min(k.bit_length() - 1, lb) - 1


def runs(k_lo: int, k_hi: int, lb: int) -> list[tuple[int, list]]:
    """The kernel's runs for phases k_lo .. k_hi: [(c, [(k, p), ...])], as
    ``inblock_kernel`` walks them: a run starts at stage (k, p) with
    c = max(p - SLOT_BITS + 1, 0) and lasts while the stage bits stay in
    [c, c + SLOT_BITS), across phases when c = 0."""
    out = []
    k, p = k_lo, top_bit(k_lo, lb)
    while k <= k_hi:
        c = max(p - SLOT_BITS + 1, 0)
        stages = []
        while k <= k_hi and p >= c:
            stages.append((k, p))
            if p > 0:
                p -= 1
            else:
                k *= 2
                p = top_bit(k, lb)
                if p >= c + SLOT_BITS:
                    break
        out.append((c, stages))
    return out


def layout_index(vt: np.ndarray, c: int, s: np.ndarray) -> np.ndarray:
    """Block element of slot s of virtual thread vt under layout c."""
    return (((vt >> c) << (c + SLOT_BITS)) | (s << c)
            | (vt & ((1 << c) - 1)))


def swz(i: np.ndarray) -> np.ndarray:
    """The kernel's shared-memory slot of block element i."""
    u = i >> 5
    return i ^ ((u ^ (u << 1)) & 31)


def bank_conflicts(lb: int, c: int, elem_bytes: int) -> int:
    """The most distinct 4-byte words that the 32 lanes of one warp touch
    in one bank, over every warp and slot of layout c (1: no conflict)."""
    vt = np.arange(1 << (lb - SLOT_BITS))
    worst = 0
    for s in range(SLOTS):
        phys = swz(layout_index(vt, c, np.full_like(vt, s)))
        word = (phys * elem_bytes) // 4
        for w in word.reshape(-1, 32):
            bank = w % 32
            counts = [len(set(w[bank == b].tolist())) for b in range(32)]
            worst = max(worst, max(counts))
    return worst


def _less(a, b):
    """``ak_lt``: a < b (float compare for bfloat16 keys given as float32
    values; False where either is NaN)."""
    return a < b


def apply_inblock(keys, vals, k_lo: int, k_hi: int, lb: int, rmask: int,
                  tie_break: bool = False):
    """The kernel's result on flat ``keys`` (and ``vals`` or None) run by
    run: every block gathered into (blocks, virtual threads, SLOTS) by the
    run's layout, the run's stages applied on the slot axis with the
    kernel's direction rule and compare-exchange, scattered back. Returns
    new arrays."""
    keys = keys.copy()
    vals = None if vals is None else vals.copy()
    block = 1 << lb
    nb = keys.size // block
    nvt = block >> SLOT_BITS
    base = (np.arange(nb, dtype=np.int64) << lb)[:, None, None]
    vt = np.arange(nvt)[None, :, None]
    s = np.arange(SLOTS)[None, None, :]
    for c, stages in runs(k_lo, k_hi, lb):
        idx = (base + layout_index(vt, c, s)).reshape(-1)
        kk = keys[idx].reshape(nb, nvt, SLOTS)
        vv = None if vals is None else vals[idx].reshape(nb, nvt, SLOTS)
        for k, p in stages:
            r = p - c
            lo = [t for t in range(SLOTS) if not t & (1 << r)]
            hi = [t | (1 << r) for t in lo]
            gidx = base + layout_index(vt, c, np.array(lo)[None, None, :])
            asc = (gidx & k & rmask) == 0
            ka, kb = kk[..., lo], kk[..., hi]
            gt = _less(kb, ka)
            if tie_break and vv is not None:
                gt = gt | ((ka == kb) & _less(vv[..., hi], vv[..., lo]))
            swap = np.where(asc, gt, ~gt)
            kk[..., lo], kk[..., hi] = (np.where(swap, kb, ka),
                                        np.where(swap, ka, kb))
            if vv is not None:
                va, vb = vv[..., lo], vv[..., hi]
                vv[..., lo], vv[..., hi] = (np.where(swap, vb, va),
                                            np.where(swap, va, vb))
        keys[idx] = kk.reshape(-1)
        if vals is not None:
            vals[idx] = vv.reshape(-1)
    return keys, vals
