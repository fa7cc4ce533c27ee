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
``common``: add, mul, min and max into any ``out_dtype`` of float32,
int32 and bfloat16 (by default the operands'), each body value (computed
in the operands' dtype) cast to it and folded in
``ref.acc_dtype(out_dtype)``; and, or into a bool. Besides the bodies'
own dtypes it reads int8 through ``identity`` and ``square`` under add,
mul, min and max (an int8 sum into int32). The plain version is
``ref.reduce_ref``. That is the reference's ``reduce_ref`` for int32 and
float32 outputs; for bfloat16 the port folds in float32 and rounds once
where the reference's folds in bfloat16. The reference's Pallas kernel
itself takes an ``out_dtype`` other than its body's only for integer
widening, and there folds each block's 8 columns in the operands' dtype
first, so an int8 sum wraps; the port follows ``reduce_ref`` (ROADMAP's
differences and faults of the reference).
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


#: bodies that also read int8 operands here (the map kernel does not)
_INT8_BODIES = ("identity", "square")


def _int8_call(f, arrays) -> bool:
    return (isinstance(f, MK.Body) and f.name in _INT8_BODIES
            and len(arrays) == f.arity
            and all(a.dtype == torch.int8 for a in arrays))


def refusal(f, op, arrays, out_dtype) -> str | None:
    """Why the kernel cannot take this call (None if it can)."""
    cat = C.catalogued_op(op)
    int8 = _int8_call(f, arrays) and cat is not None and not cat.logical
    why = None if int8 else MK.refusal(f, arrays, None)
    if why is not None:
        return why
    if cat is None:
        return f"{op!r} is not an operator of the kernel catalogue"
    out = out_dtype or arrays[0].dtype
    if cat.logical and out != torch.bool:
        return (f"the reduce kernel folds {cat.name} into torch.bool, not "
                f"{out}")
    if not cat.logical and out not in C.KERNEL_DTYPES:
        return (f"the reduce kernel folds {cat.name} into one of "
                f"{C.KERNEL_DTYPES}, not {out}")
    return None


def _operand_code(dtype: torch.dtype) -> int:
    if dtype == torch.int8:
        return _build.INT8_CODE
    return _build.dtype_code(dtype, "reduce")


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
        _operand_code(arrays[0].dtype),
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
