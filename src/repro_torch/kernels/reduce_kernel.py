"""``mapreduce`` / ``reduce``: a catalogue body folded under a catalogue
operator in one launch (counterpart of ``repro/kernels/reduce_kernel.py``).

Replaces the TPU kernel ``reduce_blocks`` (``_reduce_body``), whose
sequential grid carried an (8, 128) accumulator in VMEM. The CUDA kernel
(``csrc/reduce.cu``) is a two-level tree inside one launch: every CTA folds
its grid-stride share and writes a partial, and the last CTA to finish (a
ticket after ``__threadfence``) folds the partials in index order and
applies ``init`` once. The grid depends on ``n`` alone, so a float sum
comes out the same from run to run; its association order differs from
the reference's, so float ``add``/``mul`` agree with it within rounding,
while int, ``min``/``max`` and logical results are exact. Bound by one
read of the operands.

The kernel takes ``f`` from ``map_kernel.BODIES`` and ``op`` from
``common`` (add, mul, min, max over the operands' dtype; and, or into a
bool). The plain version is ``ref.reduce_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels import map_kernel as MK
from repro_torch.kernels import ref

# CTAs of one launch at most; fixed, so the grid depends on n alone.
_MAX_GRID = 1024

# (device index, stream) -> int32 [ticket, partials x _MAX_GRID]. The
# kernel's last CTA sets the ticket back to 0, and calls on one stream run
# in order, so each stream keeps one buffer and a call allocates nothing.
_SCRATCH: dict = {}

_SIGNATURES = {
    "ak_reduce": [ctypes.c_void_p] * MK.MAX_OPERANDS + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong,
    ] + [ctypes.c_float] * 6 + [
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ],
    "ak_reduce_cta_elems": [],
}


def refusal(f, op, arrays, out_dtype) -> str | None:
    """Why the kernel cannot take this call (None if it can)."""
    why = MK.refusal(f, arrays, None)
    if why is not None:
        return why
    cat = C.catalogued_op(op)
    if cat is None:
        return f"{op!r} is not an operator of the kernel catalogue"
    dtype = arrays[0].dtype
    want = torch.bool if cat.logical else dtype
    if (out_dtype or dtype) != want:
        return (f"the reduce kernel folds {cat.name} into {want}, not "
                f"{out_dtype}")
    return None


def reduce_blocks(f, op, *arrays: torch.Tensor, unit, out_dtype=None
                  ) -> torch.Tensor:
    """``op(unit, fold_op(f(*arrays)))`` as a 0-d tensor of ``out_dtype``
    (default: the operands' dtype). ``unit`` is meant to be the identity
    of ``op``."""
    why = refusal(f, op, arrays, out_dtype)
    if why is not None:
        raise TypeError(f"reduce kernel: {why}")
    flat = MK.flat_operands(arrays)
    if not C.require_cuda_or_cpu(*arrays):
        return ref.reduce_ref(f, op, *arrays, unit=unit, out_dtype=out_dtype)
    cat = C.catalogued_op(op)
    out_dtype = out_dtype or arrays[0].dtype
    device = arrays[0].device
    n = flat[0].numel()
    out = torch.empty((), dtype=out_dtype, device=device)
    lib = _build.library("reduce", _SIGNATURES)
    grid = max(1, min(C.ceil_div(n, lib.ak_reduce_cta_elems()), _MAX_GRID))
    stream = _build.stream_handle(device)
    key = (device.index, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = torch.zeros(
            1 + _MAX_GRID, dtype=torch.int32, device=device)
    acc = ref.acc_dtype(out_dtype)
    err = lib.ak_reduce(
        *MK.operand_pointers(flat), f.code,
        _build.dtype_code(arrays[0].dtype, "reduce"),
        _build.BOOL_CODE if out_dtype == torch.bool
        else _build.dtype_code(out_dtype, "reduce"),
        cat.code, n, *f.kernel_params(),
        _build.as_double(cat.identity(acc), acc),
        _build.as_double(unit, out_dtype),
        scratch.data_ptr() + 4,  # the partials
        scratch.data_ptr(), grid, out.data_ptr(), stream,
    )
    _build.check(lib, err, "reduce kernel")
    C.count_launch("reduce")
    return out


def reduce_launches(n: int) -> int:
    """Closed-form launch count of ``reduce_blocks``: one, whatever n (an
    empty input still launches: the last CTA writes ``init``)."""
    return 1
