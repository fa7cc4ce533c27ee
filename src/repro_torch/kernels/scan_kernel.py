"""``accumulate``: the prefix scan as reduce-then-scan (counterpart of
``repro/kernels/scan_kernel.py``).

Replaces the TPU kernel ``scan_blocks`` (``_scan_body``, ``_row_scan``),
which carried the running prefix in VMEM across its in-order grid. CTAs
run in no order, so the CUDA kernel (``csrc/scan.cu``) computes the carry
in three passes over tiles of :data:`TILE` elements: (1) each tile's
aggregate, (2) one CTA's exclusive scan of the aggregates seeded with
``init``, (3) each tile's scan seeded with its prefix. An input of at most
one tile is one pass. No CTA waits for another; the order of every
operation depends on ``n`` alone, so results repeat bitwise from run to
run. Float ``add``/``mul`` associate differently from the reference
(allclose); int, ``min``/``max`` and exact-arithmetic floats are bitwise.
The segmented scan (``segment_kernel.py``) runs the same passes under the
flagged operator. Bound by the bytes of passes 1 and 3.

The kernel takes ``op`` in {add, mul, min, max} from ``common``'s
catalogue over float32, int32 or bfloat16 (accumulated in float32). The
plain version is ``ref.scan_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels import ref

#: elements per tile: 512 threads x 16 (csrc/scan.cu kTile)
TILE = 8192

INCLUSIVE, EXCLUSIVE, EXCLUSIVE_SEGMENTED, AGGREGATE = 0, 1, 2, 3
SCAN_OPS = ("add", "mul", "min", "max")

_SIGNATURES = {
    "ak_scan_pass": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ],
    "ak_scan_tile": [],
}


def refusal(op, x) -> str | None:
    """Why the kernel cannot take this call (None if it can)."""
    cat = C.catalogued_op(op)
    if cat is None or cat.name not in SCAN_OPS:
        return f"{op!r} is not a scan operator of the catalogue {SCAN_OPS}"
    if x.dtype not in C.KERNEL_DTYPES:
        return f"the scan kernel takes {C.KERNEL_DTYPES}, not {x.dtype}"
    return None


def _ptr(t):
    return None if t is None else t.data_ptr()


def scan_passes(op, x: torch.Tensor, flags, *, unit, mode: int,
                kernel: str) -> torch.Tensor:
    """The kernel's passes over flat CUDA ``x`` (and uint8 head ``flags``
    for the segmented scan, else None); ``mode`` is the output of the last
    pass. Counts each launch under ``kernel``."""
    cat = C.catalogued_op(op)
    n = x.numel()
    acc = ref.acc_dtype(x.dtype)
    ident = _build.as_double(cat.identity(acc), acc)
    init = _build.as_double(unit, x.dtype)
    out = torch.empty_like(x)
    lib = _build.library("scan", _SIGNATURES)
    if lib.ak_scan_tile() != TILE:
        raise RuntimeError("csrc/scan.cu tile differs from scan_kernel.TILE")
    stream = _build.stream_handle(x.device)
    code = _build.dtype_code(x.dtype, "scan")

    def run(src, src_flags, dtype_code, grid, per_cta, prefix, mode_,
            transform, dst, agg_v=None, agg_f=None):
        err = lib.ak_scan_pass(
            _ptr(src), _ptr(src_flags), dtype_code, cat.code, src.numel(),
            grid, per_cta, _ptr(prefix), init, ident, init, mode_,
            transform, _ptr(dst), _ptr(agg_v), _ptr(agg_f), stream)
        _build.check(lib, err, f"{kernel} kernel")
        C.count_launch(kernel)

    tiles = C.ceil_div(n, TILE)
    if tiles == 1:
        run(x, flags, code, 1, 1, None, mode, 1, out)
        return out
    agg_v = torch.empty(tiles, dtype=acc, device=x.device)
    agg_f = None if flags is None else torch.empty(
        tiles, dtype=torch.uint8, device=x.device)
    prefix = torch.empty(tiles, dtype=acc, device=x.device)
    run(x, flags, code, tiles, 1, None, AGGREGATE, 1, None, agg_v, agg_f)
    run(agg_v, agg_f, _build.dtype_code(acc, "scan"), 1,
        C.ceil_div(tiles, TILE), None, EXCLUSIVE, 0, prefix)
    run(x, flags, code, tiles, 1, prefix, mode, 1, out)
    return out


def scan_blocks(op, x: torch.Tensor, *, unit, exclusive: bool = False
                ) -> torch.Tensor:
    """Inclusive ``out[i] = op(unit, x0 .. xi)`` or the exclusive scan
    (``out[0] = unit``) of flat ``x``, in ``x``'s shape and dtype.
    ``unit`` is meant to be the identity of ``op``."""
    why = refusal(op, x)
    if why is not None:
        raise TypeError(f"scan kernel: {why}")
    if not C.require_cuda_or_cpu(x):
        return ref.scan_ref(op, x, unit=unit, exclusive=exclusive)
    if x.numel() == 0:
        return x.clone()
    out = scan_passes(op, x.reshape(-1).contiguous(), None, unit=unit,
                      mode=EXCLUSIVE if exclusive else INCLUSIVE,
                      kernel="scan")
    return out.reshape(x.shape)


def scan_launches(n: int) -> int:
    """Closed-form launch count of ``scan_blocks`` over n elements: none
    for an empty input, one pass for at most one tile, else three."""
    if n == 0:
        return 0
    return 1 if n <= TILE else 3
