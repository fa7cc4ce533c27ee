"""``accumulate``: the prefix scan in one pass (counterpart of
``repro/kernels/scan_kernel.py``).

Replaces the TPU kernel ``scan_blocks`` (``_scan_body``, ``_row_scan``),
which carried the running prefix in VMEM across its in-order grid. CTAs
run in no order, so the CUDA kernel (``csrc/scan.cu`` ``onepass_kernel``)
is AK.jl's own single pass with decoupled look-back, made deterministic:
a CTA takes the next tile of :data:`TILE` elements from an atomic counter,
scans it, publishes its aggregate in a 64-bit status word (value and the
call's epoch), and seeds its output with ``op(E_g, fold of the aggregates
before it in its group of GROUP tiles)``, where ``E_g`` (``init`` for the
first group) is published by the previous group's last tile. The fold is
a fixed tree, so results repeat bitwise from run to run; the input is read
once and the output written once. An input of one tile is seeded with
``init`` alone. Float ``add``/``mul`` associate differently from the
reference (allclose); int, ``min``/``max`` and exact-arithmetic floats are
bitwise. The segmented scan (``segment_kernel.py``) is the same kernel
under the flagged operator, with the head flags beside the values
(:func:`scan_onepass` with ``flags``). Bound by one read of the input and
one write of the output. Every call is one launch.

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

INCLUSIVE, EXCLUSIVE, EXCLUSIVE_SEGMENTED = 0, 1, 2
SCAN_OPS = ("add", "mul", "min", "max")

_SIGNATURES = {
    "ak_scan_onepass": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
    ],
    "ak_scan_tile": [],
    "ak_scan_group": [],
}

# (device index, stream, segmented) -> [int64 status words, epoch of the
# last call]. Each call counts the epoch up, so a word an earlier call left
# never reads as published: no memset before a call. Calls on one stream
# run in order, so a stream keeps one buffer a mode (the dense and the
# segmented words differ), grown (zeros) only with n. The segmented word
# holds a 31-bit epoch beside the flag.
_STATUS: dict = {}
_EPOCH_END = {False: 1 << 32, True: 1 << 31}


def refusal(op, x) -> str | None:
    """Why the kernel cannot take this call (None if it can)."""
    cat = C.catalogued_op(op)
    if cat is None or cat.name not in SCAN_OPS:
        return f"{op!r} is not a scan operator of the catalogue {SCAN_OPS}"
    if x.dtype not in C.KERNEL_DTYPES:
        return f"the scan kernel takes {C.KERNEL_DTYPES}, not {x.dtype}"
    return None


def _status(device: torch.device, n: int, segmented: bool
            ) -> tuple[torch.Tensor, int]:
    """The stream's status words of one mode for n elements (the tile
    counter, one a tile, one a group) and this call's epoch."""
    key = (device.index, _build.stream_handle(device), segmented)
    st = _STATUS.get(key)
    tiles = C.ceil_div(n, TILE)
    words = 1 + tiles + C.ceil_div(tiles, GROUP)
    if st is None or st[0].numel() < words:
        st = _STATUS[key] = [torch.zeros(C.next_pow2(words),
                                         dtype=torch.int64, device=device),
                             0]
    st[1] += 1
    if st[1] == _EPOCH_END[segmented]:  # every epoch used: start again
        st[0].zero_()
        st[1] = 1
    return st[0], st[1]


def scan_onepass(op, x: torch.Tensor, flags=None, *, unit, mode: int,
                 kernel: str) -> torch.Tensor:
    """The single-pass kernel over flat CUDA ``x`` (n > 0), segmented by
    the uint8 head ``flags`` where given: one launch, counted under
    ``kernel``. ``mode``: INCLUSIVE, EXCLUSIVE or (segmented)
    EXCLUSIVE_SEGMENTED."""
    cat = C.catalogued_op(op)
    acc = ref.acc_dtype(x.dtype)
    out = torch.empty_like(x)
    lib = _build.library("scan", _SIGNATURES)
    if lib.ak_scan_tile() != TILE or lib.ak_scan_group() != GROUP:
        raise RuntimeError("csrc/scan.cu tile or group differs from "
                           "scan_kernel.TILE / GROUP")
    status, epoch = _status(x.device, x.numel(), flags is not None)
    err = lib.ak_scan_onepass(
        x.data_ptr(), None if flags is None else flags.data_ptr(),
        _build.dtype_code(x.dtype, "scan"), cat.code, x.numel(),
        _build.as_double(cat.identity(acc), acc),
        _build.as_double(unit, x.dtype), mode, out.data_ptr(),
        status.data_ptr(), epoch, _build.stream_handle(x.device))
    _build.check(lib, err, f"{kernel} kernel")
    C.count_launch(kernel)
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
    out = scan_onepass(op, x.reshape(-1).contiguous(), unit=unit,
                       mode=EXCLUSIVE if exclusive else INCLUSIVE,
                       kernel="scan")
    return out.reshape(x.shape)


def scan_launches(n: int) -> int:
    """Closed-form launch count of ``scan_blocks`` over n elements: none
    for an empty input, else one."""
    return 0 if n == 0 else 1
