"""Bitonic sorting network: the hand-written CUDA kernels and their plain
PyTorch version (counterpart of ``repro/kernels/sort_kernel.py``).

Replaces the TPU kernels ``_inblock_body`` (run by ``_run_inblock``) and
``_hyper_body`` (run by ``_run_hyper``) of ``sort_kernel.py``:

  * **in-block kernel** (``csrc/bitonic.cu`` ``inblock_kernel``): one CTA
    per block of ``block_rows() * block_cols()`` keys (8192 by default);
    it runs every stage (k, j) with j < block of the phases it is given.
    Each thread holds 16 keys (and payloads) in registers and runs the
    stages whose distance bits are its register bits there; between such
    runs the block is re-laid through shared memory once (a transpose),
    so a block's 91 initial stages cost 24 transposes and a phase's 13
    finishing stages 3.
  * **window kernel** (``window_kernel``): the fused hyper-block window,
    up to ``m = sort_hyper`` consecutive cross stages j >= block of one
    phase in one pass over device memory (one stage a pass at
    ``sort_hyper = 0``). One thread holds the 2^w elements that the
    window's stages exchange (stride the window's smallest distance) in
    registers.

Every cross pass reads and writes the whole padded array once, so device
memory bounds the window kernel. A sort of 2^m keys has (m-13)(m-12)/2
cross stages; windows of up to ``m`` of them cut the passes to
sum(ceil(i/m)). The in-block stages never leave the CTA (one read and one
write per block per launch), as the TPU kernel kept them in VMEM.

One difference from the reference's schedule is left: the reference's
last window of a phase absorbs the in-block finish (its VMEM held whole
blocks); here the finish stays one in-block launch, so a cross phase
costs ``ceil(i/m) + 1`` launches against the reference's ``ceil(i/m)``
(``network_schedule``, ``network_launches``).

Padding (type-max to ``max(next_pow2(n), block)``), the stage sequence and
the direction rule ``((global low index) & k) == 0`` are the reference's,
and the network is oblivious. Every compare-exchange, in the kernels and
in the plain version alike, swaps a pair only where the later key compares
smaller (``a > b``; descending: not greater), so kernels and plain version
agree bitwise on every input, NaN and signed zeros included, and the
output is a permutation of the input. The JAX Pallas path agrees with
both on NaN-free keys without mixed signed zeros (its key-only stages take
``minimum``/``maximum``), including the pair order of equal keys when
``tie_break`` is off, whatever the window order.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernels or raises. The CUDA kernels write in place
into the padded copy the wrapper makes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C

SORT_ROWS = 8
SORT_COLS = 1024
SORT_BLOCK = SORT_ROWS * SORT_COLS

# Default hyper-block order m (the ``sort_hyper`` knob when unset): each
# window launch fuses up to m cross stages. Chosen from a sweep of m = 0..6
# of ``merge_sort`` at 2^28 float32 keys on the card (``chip_smoke.py``,
# PERF.md); the reference's 3 was a choice for the TPU's VMEM. 0 selects
# the unfused layout: windows of one stage, one launch a stage.
HYPER_ORDER = 6
MAX_HYPER = 6

# Largest dynamic shared memory one CTA may take on Hopper (bytes).
MAX_SMEM = 232448

_SIGNATURES = {
    "ak_bitonic_inblock": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ],
    "ak_bitonic_window": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p,
    ],
}


def _lib():
    return _build.library("bitonic", _SIGNATURES)


def _geometry() -> tuple[int, int, int]:
    rows, cols = C.block_rows(), C.block_cols()
    block = rows * cols
    if block & (block - 1):
        raise ValueError(
            f"bitonic sort needs a power-of-two block, got "
            f"{rows}x{cols} = {block}"
        )
    return rows, cols, block


def _hyper_order() -> int:
    m = C.sort_hyper()
    return HYPER_ORDER if m is None else m


def _stages_upto_block(k: int, block: int) -> list[tuple[int, int]]:
    """All in-block j stages for a given k: j = min(k//2, block//2) .. 1."""
    j = min(k // 2, block // 2)
    out = []
    while j >= 1:
        out.append((k, j))
        j //= 2
    return out


# --------------------------------------------------------------------------
# Plain PyTorch version: the same (k, j) stages as whole-tensor passes.
# --------------------------------------------------------------------------

def _cx_plain(keys, vals, k: int, j: int, tie_break: bool, row: int):
    """One compare-exchange stage at distance ``j`` over the whole array
    of rows of ``row`` keys. Pairs are (g·2j + t, g·2j + t + j); the
    direction depends only on g because t < j <= k/2, and never on the
    row index (``& (row - 1)``). A pair swaps where ``a > b`` (with the
    tie-break: or equal keys and ``av > bv``) ascending, where not
    descending: the kernels' ``compare_exchange``, so NaN and -0.0 move
    as they do on the card."""
    total = keys.shape[0]
    groups = total // (2 * j)
    g = torch.arange(groups, dtype=torch.int64, device=keys.device)
    asc = (((g * (2 * j)) & k & (row - 1)) == 0).reshape(groups, 1)
    yk = keys.reshape(groups, 2, j)
    a, b = yk[:, 0], yk[:, 1]
    gt = a > b
    if vals is not None:
        yv = vals.reshape(groups, 2, j)
        av, bv = yv[:, 0], yv[:, 1]
        if tie_break:
            gt = gt | ((a == b) & (av > bv))
    swap = torch.where(asc, gt, ~gt)
    nk = torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)], 1)
    if vals is None:
        return nk.reshape(total), None
    nv = torch.stack([torch.where(swap, bv, av), torch.where(swap, av, bv)],
                     1)
    return nk.reshape(total), nv.reshape(total)


# --------------------------------------------------------------------------
# The two kernels behind one network loop
# --------------------------------------------------------------------------

def _ptr(t):
    return t.data_ptr() if t is not None else None


def _codes(keys, vals) -> tuple[int, int]:
    """dtype codes of the keys and of the payload (int32's when none)."""
    vcode = 1 if vals is None else _build.dtype_code(vals.dtype, "sort")
    return _build.dtype_code(keys.dtype, "sort"), vcode


def _run_inblock(keys, vals, k_lo: int, k_hi: int, block: int,
                 tie_break: bool, cuda: bool, row: int | None = None):
    """Every in-block stage of phases k_lo, 2·k_lo, …, k_hi, over rows of
    ``row`` keys (default: one row, the whole array)."""
    row = keys.shape[0] if row is None else row
    if not cuda:
        k = k_lo
        while k <= k_hi:
            for _, j in _stages_upto_block(k, block):
                keys, vals = _cx_plain(keys, vals, k, j, tie_break, row)
            k *= 2
        return keys, vals
    lib = _lib()
    err = lib.ak_bitonic_inblock(
        _ptr(keys), _ptr(vals), *_codes(keys, vals),
        int(tie_break), keys.shape[0], block, k_lo, k_hi, row - 1,
        _build.stream_handle(keys.device),
    )
    _build.check(lib, err, "bitonic in-block kernel")
    C.count_launch("bitonic_inblock")
    return keys, vals


def _run_window(keys, vals, k: int, jtop: int, w: int, tie_break: bool,
                cuda: bool, row: int | None = None):
    """One fused window of phase k: the w cross stages at distances jtop,
    jtop/2, ..., jtop >> (w-1) (all >= block), over rows of ``row`` keys.
    The plain version applies them one by one."""
    row = keys.shape[0] if row is None else row
    if not cuda:
        for s in range(w):
            keys, vals = _cx_plain(keys, vals, k, jtop >> s, tie_break, row)
        return keys, vals
    lib = _lib()
    err = lib.ak_bitonic_window(
        _ptr(keys), _ptr(vals), *_codes(keys, vals),
        int(tie_break), keys.shape[0], k, jtop, w, row - 1,
        _build.stream_handle(keys.device),
    )
    _build.check(lib, err, "bitonic window kernel")
    C.count_launch("bitonic_window")
    return keys, vals


def network_schedule(total: int, *, first_k: int = 2, hyper: int,
                     block: int) -> list[tuple]:
    """The launches of ``_sort_network`` in order, as a pure function of
    the shape: ``("inblock", k_lo, k_hi)`` runs every in-block stage of
    phases k_lo..k_hi; ``("window", k, jtop, w)`` the w cross stages
    jtop .. jtop >> (w-1) of phase k. Per cross phase k > block: its
    ``i = log2(k/block)`` stages in windows of up to ``max(hyper, 1)``
    (largest distance first; hyper 0 is the unfused layout, one stage a
    window), then the in-block finish."""
    if hyper < 0 or hyper > MAX_HYPER:
        raise ValueError(f"hyper must be in [0, {MAX_HYPER}], got {hyper}")
    out = []
    k = first_k
    if k <= min(total, block):
        k_hi = k
        while k_hi * 2 <= min(total, block):
            k_hi *= 2
        out.append(("inblock", k, k_hi))
        k = k_hi * 2
    while k <= total:
        j = k // 2
        while j >= block:
            w = min(max(hyper, 1), (j // block).bit_length())
            out.append(("window", k, j, w))
            j >>= w
        out.append(("inblock", k, k))
        k *= 2
    return out


def _sort_network(keys, vals, total: int, tie_break: bool, *, block: int,
                  cuda: bool, first_k: int = 2):
    """Run bitonic phases k = first_k, 2·first_k, …, total over the padded
    flat arrays, launch by launch as ``network_schedule`` lists them for
    the live ``sort_hyper``: one network per row of ``total`` keys, the
    arrays holding one or more rows end to end. ``first_k = 2L`` resumes
    on data already L-run alternating-sorted: the k-way merge of
    ``merge_kernel``."""
    for item in network_schedule(total, first_k=first_k,
                                 hyper=_hyper_order(), block=block):
        if item[0] == "inblock":
            keys, vals = _run_inblock(keys, vals, item[1], item[2], block,
                                      tie_break, cuda, total)
        else:
            keys, vals = _run_window(keys, vals, item[1], item[2], item[3],
                                     tie_break, cuda, total)
    return keys, vals


def _check_operands(keys, vals, tie_break: bool, cuda: bool, block: int):
    if keys.dim() not in (1, 2):
        raise ValueError(
            f"bitonic sort takes 1-D keys or (rows, n) batches, got "
            f"{tuple(keys.shape)}")
    if vals is not None:
        if vals.shape != keys.shape:
            raise ValueError(
                f"keys {tuple(keys.shape)} and values {tuple(vals.shape)} "
                f"differ in shape"
            )
        if tie_break and vals.dtype not in C.KERNEL_DTYPES:
            raise TypeError(
                f"tie_break compares values as one of {C.KERNEL_DTYPES}, "
                f"got {vals.dtype}"
            )
    if not cuda:
        return
    _codes(keys, vals)
    smem = block * (keys.element_size() +
                    (vals.element_size() if vals is not None else 0))
    if smem > MAX_SMEM:
        raise ValueError(
            f"block of {block} keys needs {smem} bytes of shared memory, "
            f"more than one CTA's {MAX_SMEM}"
        )


def _padded(x, total: int, fill):
    """A fresh contiguous buffer of rows of ``total`` elements: each row of
    ``x`` (1-D: the one row) then ``fill``, flat (the CUDA kernels write
    into it in place)."""
    rows = x.reshape(-1, x.shape[-1])
    out = torch.empty((rows.shape[0], total), dtype=x.dtype,
                      device=x.device)
    out[:, : rows.shape[1]] = rows
    out[:, rows.shape[1]:] = fill
    return out.reshape(-1)


def sort_padded(keys, vals, tie_break: bool, cuda: bool):
    """Sort 1-D keys, or each row of (R, n) keys, one launch set for the
    batch, and return the padded rows: (R, total) keys and payload (None
    without one), total = max(next_pow2(n), block), type-max padding
    sorted to the end of each row."""
    n = keys.shape[-1]
    _, _, block = _geometry()
    _check_operands(keys, vals, tie_break, cuda, block)
    total = max(C.next_pow2(n), block)
    kp = _padded(keys, total, C.type_max(keys.dtype))
    vp = None if vals is None else _padded(vals, total,
                                           C.type_max(vals.dtype))
    kp, vp = _sort_network(kp, vp, total, tie_break, block=block,
                           cuda=cuda)
    return kp.view(-1, total), (None if vp is None else vp.view(-1, total))


def _sort(keys, vals, tie_break: bool, cuda: bool):
    """``sort_padded`` cut back to the input's shape."""
    n = keys.shape[-1]
    kp, vp = sort_padded(keys, vals, tie_break, cuda)

    def cut(p):
        return p[:, :n].reshape(keys.shape)

    return cut(kp), (None if vp is None else cut(vp))


def _on_cuda(*tensors) -> bool:
    return C.require_cuda_or_cpu(*[t for t in tensors if t is not None])


def bitonic_sort(keys: torch.Tensor, *, descending: bool = False,
                 plain: bool = False) -> torch.Tensor:
    """Full ascending sort of 1-D ``keys`` (descending: the reverse).
    ``plain=True`` runs the plain PyTorch version on any device."""
    if keys.shape[0] == 0:
        return keys
    out, _ = _sort(keys, None, False, _on_cuda(keys) and not plain)
    return torch.flip(out, (0,)) if descending else out


def bitonic_sort_kv(keys, vals, *, tie_break: bool = False,
                    plain: bool = False):
    """Sort (keys, vals) pairs by key. ``tie_break=True`` orders equal
    keys by ascending value, compared in the values' dtype (int32,
    float32 or bfloat16; -0.0 equals 0.0): a stable argsort with an iota
    payload, or the segmented sort with segment ids as keys."""
    if keys.shape[0] == 0:
        return keys, vals
    return _sort(keys, vals, tie_break,
                 _on_cuda(keys, vals) and not plain)


def bitonic_argsort(keys: torch.Tensor, *, plain: bool = False):
    """Stable argsort (int32): the kv network with an iota payload and the
    index tie-break (the reference registry's ``_pallas_argsort``)."""
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    _, perm = bitonic_sort_kv(keys, idx, tie_break=True, plain=plain)
    return perm


def network_launches(total: int, *, first_k: int = 2, hyper: int,
                     block: int) -> int:
    """Closed-form launch count of ``_sort_network(total, first_k=…)``
    (the length of ``network_schedule``): one in-block launch if any
    phase fits a block, then per cross phase ``ceil(i/m) + 1`` launches
    for ``i = log₂(k/block)`` (``i + 1`` unfused, m = 0 or 1). The
    reference's fused count is ``ceil(i/m)``: its last window absorbs the
    in-block finish."""
    launches = 0
    k = first_k
    if k <= min(total, block):
        launches += 1
        while k <= min(total, block):
            k *= 2
    while k <= total:
        i = (k // block).bit_length() - 1
        launches += -(-i // max(hyper, 1)) + 1
        k *= 2
    return launches


def cross_launches(n: int, *, hyper: int | None = None,
                   block: int | None = None) -> int:
    """Closed-form launch count of an n-element sort at the live
    ``sort_hyper`` (default ``HYPER_ORDER``), as in the reference."""
    if block is None:
        _, _, block = _geometry()
    if hyper is None:
        hyper = _hyper_order()
    total = max(C.next_pow2(n), block)
    return network_launches(total, first_k=2, hyper=hyper, block=block)


# --------------------------------------------------------------------------
# Batched entry points: rows of the last axis, one launch set per call
# --------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def bitonic_sort_batched(keys: torch.Tensor, *, descending: bool = False,
                         plain: bool = False) -> torch.Tensor:
    """Sort along the last axis of (..., n): every row through the
    network at once (the reference vmaps the 1-D network). Launches equal
    ``cross_launches(n)`` whatever the number of rows."""
    if keys.dim() <= 1:
        return bitonic_sort(keys, descending=descending, plain=plain)
    if keys.numel() == 0:
        return keys
    out, _ = _sort(_rows(keys), None, False, _on_cuda(keys) and not plain)
    out = torch.flip(out, (1,)) if descending else out
    return out.reshape(keys.shape)


def _iota_rows(keys2d: torch.Tensor, reverse: bool = False):
    r, n = keys2d.shape
    idx = torch.arange(n, dtype=torch.int32, device=keys2d.device)
    if reverse:
        idx = (n - 1) - idx
    return idx.expand(r, n)


def bitonic_argsort_batched(keys: torch.Tensor, *,
                            plain: bool = False) -> torch.Tensor:
    """Stable argsort (int32) along the last axis of (..., n): the kv
    network with an iota payload and the index tie-break, all rows in one
    launch set."""
    if keys.dim() <= 1:
        return bitonic_argsort(keys, plain=plain)
    if keys.numel() == 0:
        return torch.zeros(keys.shape, dtype=torch.int32,
                           device=keys.device)
    k2 = _rows(keys)
    _, perm = _sort(k2, _iota_rows(k2), True,
                    _on_cuda(keys) and not plain)
    return perm.reshape(keys.shape)


def bitonic_topk_batched(keys: torch.Tensor, k: int, *,
                         plain: bool = False):
    """Descending top-k (values, int32 indices) along the last axis, with
    ``lax.top_k``'s (value desc, index asc) tie order. Keys are never
    negated (INT_MIN would wrap): the rows sort ascending with a
    reversed-iota payload n-1-i and the index tie-break, then read
    backwards, (key asc, n-1-i asc) reversed being (key desc, i asc)."""
    n = keys.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"top-k needs 0 <= k <= {n}, got {k}")
    k2 = _rows(keys)
    if k2.numel() == 0:
        order = torch.zeros((k2.shape[0], k), dtype=torch.int32,
                            device=keys.device)
    else:
        _, pay = _sort(k2, _iota_rows(k2, reverse=True), True,
                       _on_cuda(keys) and not plain)
        order = (n - 1) - torch.flip(pay, (1,))[:, :k]
    order = order.reshape(*keys.shape[:-1], k)
    return torch.gather(keys, -1, order.long()), order
