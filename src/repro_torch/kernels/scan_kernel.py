"""``accumulate``: the prefix scan in one pass (counterpart of
``repro/kernels/scan_kernel.py``).

Replaces the TPU kernel ``scan_blocks`` (``_scan_body``, ``_row_scan``),
which carried the running prefix in VMEM across its in-order grid. CTAs
run in no order, so the CUDA kernel (``csrc/scan.cu``) is AK.jl's own
single pass with decoupled look-back, made deterministic: a CTA takes the
next tile of :data:`TILE` elements from an atomic counter, scans it,
publishes its aggregate in a 64-bit status word (value and the call's
epoch), and seeds its output with ``op(E_g, fold of the aggregates before
it in its group of GROUP tiles)``, where ``E_g`` (``init`` for the first
group) is published by the previous group's last tile. The fold is a
fixed tree, so results repeat bitwise from run to run; the input is read
once and the output written once. An input of at most one tile is one
launch of the tile scan seeded with ``init``, with no status words.
Float ``add``/``mul`` associate differently from the reference
(allclose); int, ``min``/``max`` and exact-arithmetic floats are bitwise.
The segmented scan (``segment_kernel.py``) runs the same tile scan in
three passes (:func:`scan_passes`) under the flagged operator. Bound by
one read of the input and one write of the output.

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
#: tiles of a look-back group of the single pass (csrc/scan.cu kGroup)
GROUP = 128

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
    "ak_scan_onepass": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
    ],
    "ak_scan_tile": [],
    "ak_scan_group": [],
}

# (device index, stream) -> [int64 status words, epoch of the last call].
# Each call counts the epoch up, so a word an earlier call left never reads
# as published: no memset before a call. Calls on one stream run in order,
# so a stream keeps one buffer, grown (zeros) only with n.
_STATUS: dict = {}
_EPOCH_END = 1 << 32


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


def _status(device: torch.device, n: int) -> tuple[torch.Tensor, int]:
    """The stream's status words for n elements (the tile counter, one a
    tile, one a group) and this call's epoch."""
    key = (device.index, _build.stream_handle(device))
    st = _STATUS.get(key)
    tiles = C.ceil_div(n, TILE)
    words = 1 + tiles + C.ceil_div(tiles, GROUP)
    if st is None or st[0].numel() < words:
        st = _STATUS[key] = [torch.zeros(C.next_pow2(words),
                                         dtype=torch.int64, device=device),
                             0]
    st[1] += 1
    if st[1] == _EPOCH_END:  # every epoch used: start the count again
        st[0].zero_()
        st[1] = 1
    return st[0], st[1]


def scan_onepass(op, x: torch.Tensor, *, unit, exclusive: bool
                 ) -> torch.Tensor:
    """The single-pass kernel over flat CUDA ``x`` of more than one tile:
    one launch, counted under ``scan``."""
    cat = C.catalogued_op(op)
    acc = ref.acc_dtype(x.dtype)
    out = torch.empty_like(x)
    lib = _build.library("scan", _SIGNATURES)
    if lib.ak_scan_tile() != TILE or lib.ak_scan_group() != GROUP:
        raise RuntimeError("csrc/scan.cu tile or group differs from "
                           "scan_kernel.TILE / GROUP")
    status, epoch = _status(x.device, x.numel())
    err = lib.ak_scan_onepass(
        x.data_ptr(), _build.dtype_code(x.dtype, "scan"), cat.code,
        x.numel(), _build.as_double(cat.identity(acc), acc),
        _build.as_double(unit, x.dtype), EXCLUSIVE if exclusive
        else INCLUSIVE, out.data_ptr(), status.data_ptr(), epoch,
        _build.stream_handle(x.device))
    _build.check(lib, err, "scan kernel")
    C.count_launch("scan")
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
    flat = x.reshape(-1).contiguous()
    if flat.numel() > TILE:
        out = scan_onepass(op, flat, unit=unit, exclusive=exclusive)
    else:
        out = scan_passes(op, flat, None, unit=unit,
                          mode=EXCLUSIVE if exclusive else INCLUSIVE,
                          kernel="scan")
    return out.reshape(x.shape)


def scan_launches(n: int) -> int:
    """Closed-form launch count of ``scan_blocks`` over n elements: none
    for an empty input, else one (the single pass, or the tile scan alone
    for at most one tile)."""
    return 0 if n == 0 else 1
