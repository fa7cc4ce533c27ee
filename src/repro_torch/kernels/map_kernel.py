"""``foreachindex`` / ``map_elements``: the elementwise kernel and its body
catalogue (counterpart of ``repro/kernels/map_kernel.py``).

Replaces the TPU kernel ``map_blocks`` (``_map_body``), which applied a
traced closure to (8, 1024) VMEM blocks in grid order. A hand-written
kernel cannot run a Python closure, so the CUDA kernel (``csrc/map.cu``)
applies a body from a fixed catalogue, :data:`BODIES`, each entry a
functor in ``csrc/ak_stream.cuh`` beside its plain torch function here:

  * ``identity`` and ``square`` over float32, int32 or bfloat16;
  * the paper's Table II bodies ``rbf`` (3 operands) and ``ljg``
    (6 operands; ``ljg_body(eps, sigma, r0, cutoff)`` binds its
    parameters), float32 only.

It is a grid-stride kernel, four elements in flight per thread, bound by
the bytes it reads and writes. The plain functions repeat the kernel's
arithmetic one IEEE operation at a time (divisions by full tensors: torch
rewrites a division by a scalar as a multiplication by its reciprocal),
so the two differ only where ``expf`` may: the tolerance of a comparison
follows each body's conditioning (``benchmarks_torch/arithmetic.py``).

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels import ref

MAX_OPERANDS = 6
# Largest grid of one launch; a grid-stride loop covers the rest.
_MAX_GRID = 1 << 20

_SIGNATURES = {
    "ak_map": [ctypes.c_void_p] * MAX_OPERANDS + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ] + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p],
    "ak_map_cta_elems": [],
}


@dataclasses.dataclass(frozen=True)
class Body:
    """An elementwise body the kernels know: its code in
    ``csrc/ak_stream.cuh`` (enum AkBody), its operand count, the dtypes
    its kernel takes and its plain torch function ``plain(*operands,
    *params)``. ``params`` are host floats the kernel receives as
    float32. Calling a body runs the plain function."""

    name: str
    code: int
    arity: int
    plain: Callable
    dtypes: tuple
    params: tuple = ()

    def __call__(self, *arrays):
        return self.plain(*arrays, *self.params)

    def kernel_params(self) -> tuple:
        return tuple(self.params) + (0.0,) * (6 - len(self.params))


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, value)


def _identity(a):
    return a


def _square(a):
    return a * a


def _rbf(x, y, z):
    """Paper Algorithm 4: exp(-1 / (1 - sqrt(x^2 + y^2 + z^2)))."""
    r = torch.sqrt(x * x + y * y + z * z)
    return torch.exp(_full(r, -1.0) / (1.0 - r))


def _ljg(x1, y1, z1, x2, y2, z2, eps4, eps, sigma, r0, cutoff, width):
    """Paper Algorithm 5: Lennard-Jones-Gauss, zero at or past the
    cutoff. ``eps4 = 4 eps`` and ``width = 2 * 0.02``, as the reference
    folds them before it meets an array."""
    dx, dy, dz = x1 - x2, y1 - y2, z1 - z2
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    sr = _full(r, sigma) / r
    sr3 = sr * sr * sr
    sr6 = sr3 * sr3
    sr12 = sr6 * sr6
    lj = eps4 * (sr12 - sr6)
    d = r - r0
    gauss = eps * torch.exp(-(d * d) / _full(r, width))
    return torch.where(r < cutoff, lj - gauss, torch.zeros_like(r))


identity = Body("identity", 0, 1, _identity, C.KERNEL_DTYPES)
square = Body("square", 1, 1, _square, C.KERNEL_DTYPES)
rbf = Body("rbf", 2, 3, _rbf, (torch.float32,))

EPS, SIGMA, R0, CUTOFF = 1.0, 1.0, 1.5, 3.0


def ljg_body(eps: float = EPS, sigma: float = SIGMA, r0: float = R0,
             cutoff: float = CUTOFF) -> Body:
    """The LJG body with its parameters bound."""
    return Body("ljg", 3, 6, _ljg, (torch.float32,),
                (4.0 * eps, eps, sigma, r0, cutoff, 2.0 * 0.02))


BODIES = {b.name: b for b in (identity, square, rbf, ljg_body())}


def refusal(f, arrays, out_dtype) -> str | None:
    """Why the kernel cannot take ``f`` over ``arrays`` (None if it can):
    the rule that sends a call to the portable path."""
    if not isinstance(f, Body):
        return f"{f!r} is not a body of the kernel catalogue {sorted(BODIES)}"
    if len(arrays) != f.arity:
        return f"body {f.name} takes {f.arity} operands, got {len(arrays)}"
    dtypes = {a.dtype for a in arrays}
    if len(dtypes) != 1 or arrays[0].dtype not in f.dtypes:
        return f"body {f.name} takes one dtype of {f.dtypes}, got {dtypes}"
    if out_dtype is not None and out_dtype not in C.KERNEL_DTYPES:
        return f"the map kernel writes {C.KERNEL_DTYPES}, not {out_dtype}"
    return None


def flat_operands(arrays) -> list[torch.Tensor]:
    """The operands as flat contiguous tensors of one shape, checked."""
    shape = arrays[0].shape
    for a in arrays:
        if a.shape != shape:
            raise ValueError(f"operand shape mismatch: {tuple(a.shape)} vs "
                             f"{tuple(shape)}")
    return [a.reshape(-1).contiguous() for a in arrays]


def operand_pointers(flat) -> list[int | None]:
    ptrs = [a.data_ptr() for a in flat]
    return ptrs + [None] * (MAX_OPERANDS - len(ptrs))


def map_blocks(f: Body, *arrays: torch.Tensor, out_dtype=None
               ) -> torch.Tensor:
    """``f`` applied elementwise over same-shape ``arrays``, as a tensor of
    that shape and ``out_dtype`` (default: the operands' dtype)."""
    why = refusal(f, arrays, out_dtype)
    if why is not None:
        raise TypeError(f"map kernel: {why}")
    flat = flat_operands(arrays)
    if not C.require_cuda_or_cpu(*arrays):
        return ref.map_ref(f, *arrays, out_dtype=out_dtype)
    out_dtype = out_dtype or arrays[0].dtype
    n = flat[0].numel()
    out = torch.empty(arrays[0].shape, dtype=out_dtype,
                      device=arrays[0].device)
    if n == 0:
        return out
    lib = _build.library("map", _SIGNATURES)
    grid = min(C.ceil_div(n, lib.ak_map_cta_elems()), _MAX_GRID)
    err = lib.ak_map(
        *operand_pointers(flat), f.code,
        _build.dtype_code(arrays[0].dtype, "map"),
        _build.dtype_code(out_dtype, "map"), n, *f.kernel_params(), grid,
        out.data_ptr(), _build.stream_handle(out.device),
    )
    _build.check(lib, err, "map kernel")
    C.count_launch("map")
    return out


def map_launches(n: int) -> int:
    """Closed-form launch count of ``map_blocks`` over n elements."""
    return 1 if n > 0 else 0
