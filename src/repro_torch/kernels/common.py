"""Shared helpers for the hand-written CUDA kernels of the PyTorch port.

Counterpart of ``repro/kernels/common.py``. The block knobs keep their
names and defaults so the registry's tuning table reads the same on both
packages: ``block_rows() * block_cols()`` is the bitonic network's block
(8 x 1024 = 8192 keys, one CTA's shared-memory tile here), and
``sort_hyper()`` is the hyper-block order. The CUDA network implements
only the unfused layout (one launch per cross stage, ``sort_hyper == 0``);
the fused hyper-block window is later work, and the registry accepts no
other value.

The operator catalogue (:data:`OPS` by name, :func:`catalogued_op`) lists
the combining operators the streaming kernels take, each with its code in
``csrc/ak_stream.cuh`` and its identity per dtype; a kernel cannot run a
Python closure, so any other ``op`` runs on the portable path.

The launch counter counts CUDA launches only: every wrapper in this
package calls :func:`count_launch` right where it launches a kernel and
nowhere else, so a plain PyTorch version run on the CPU counts nothing.
Launches are attributed to the innermost :func:`launch_attribution` label
(the registry opens one per primitive call) and to every open telemetry
span on the calling thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import operator
import threading
from typing import Callable

import torch

from repro_torch.runtime import telemetry

# The reference's (8, 128) TPU tile geometry, kept as the validation unit
# of the block knobs so both packages accept the same tuning values.
SUBLANES = 8
LANES = 128

BLOCK_ROWS = 8
BLOCK_COLS = 1024
BLOCK_ELEMS = BLOCK_ROWS * BLOCK_COLS

_tuning = threading.local()


def block_rows() -> int:
    return getattr(_tuning, "block_rows", None) or BLOCK_ROWS


def block_cols() -> int:
    return getattr(_tuning, "block_cols", None) or BLOCK_COLS


def block_elems() -> int:
    return block_rows() * block_cols()


def sort_hyper() -> int | None:
    """Hyper-block order set by the tuning scope (None = default, the
    unfused layout, which is all the CUDA network runs)."""
    return getattr(_tuning, "sort_hyper", None)


@contextlib.contextmanager
def tuning_scope(*, block_rows=None, block_cols=None, sort_hyper=None):
    """Scoped kernel-tuning overrides; ``None`` keeps the current value."""
    prev = (
        getattr(_tuning, "block_rows", None),
        getattr(_tuning, "block_cols", None),
        getattr(_tuning, "sort_hyper", None),
    )
    if block_rows is not None:
        _tuning.block_rows = block_rows
    if block_cols is not None:
        _tuning.block_cols = block_cols
    if sort_hyper is not None:
        _tuning.sort_hyper = sort_hyper
    try:
        yield
    finally:
        _tuning.block_rows, _tuning.block_cols, _tuning.sort_hyper = prev


# --------------------------------------------------------------------------
# Launch counter: plain integers per kernel label, thread-safe.
# --------------------------------------------------------------------------

_launch_lock = threading.Lock()
_launches = 0
_launch_by_label: dict[str, int] = {}
_launch_by_kernel: dict[str, int] = {}
_launch_label = threading.local()


def launch_count() -> int:
    return _launches


def launch_counts() -> dict[str, int]:
    """Per-label tallies (label = primitive name from the registry's
    ``launch_attribution`` scope, else ``"unattributed"``)."""
    with _launch_lock:
        return dict(_launch_by_label)


def kernel_launches() -> dict[str, int]:
    """Per-kernel tallies, keyed by the kernel's name."""
    with _launch_lock:
        return dict(_launch_by_kernel)


def reset_launch_count() -> None:
    global _launches
    with _launch_lock:
        _launches = 0
        _launch_by_label.clear()
        _launch_by_kernel.clear()


@contextlib.contextmanager
def launch_attribution(label: str):
    """Attribute every launch in this thread-local scope to ``label``.
    Nestable: the innermost label wins."""
    prev = getattr(_launch_label, "value", None)
    _launch_label.value = label
    try:
        yield
    finally:
        _launch_label.value = prev


def count_launch(kernel: str) -> None:
    """Record one CUDA launch of ``kernel``. Called by a wrapper right
    after its C entry point returned success, and nowhere else."""
    global _launches
    label = getattr(_launch_label, "value", None) or "unattributed"
    with _launch_lock:
        _launches += 1
        _launch_by_label[label] = _launch_by_label.get(label, 0) + 1
        _launch_by_kernel[kernel] = _launch_by_kernel.get(kernel, 0) + 1
    telemetry.attribute(launches=1)


# --------------------------------------------------------------------------
# Operator catalogue of the streaming kernels
# --------------------------------------------------------------------------

#: dtypes of the kernels' operands: float32, int32 and bfloat16.
KERNEL_DTYPES = (torch.float32, torch.int32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Op:
    """A combining operator the kernels know: its code in
    ``csrc/ak_stream.cuh`` (enum AkOp), its elementwise torch function and
    its identity per dtype. ``logical`` ops fold to a bool."""

    name: str
    code: int
    fn: Callable
    logical: bool = False

    def identity(self, dtype: torch.dtype):
        """The neutral element of the operator in ``dtype``."""
        if self.name == "add":
            return False if dtype == torch.bool else 0
        if self.name == "mul":
            return True if dtype == torch.bool else 1
        if self.name == "min":
            return True if dtype == torch.bool else type_max(dtype)
        if self.name == "max":
            return False if dtype == torch.bool else type_min(dtype)
        return self.name == "and"


ADD = Op("add", 0, torch.add)
MUL = Op("mul", 1, torch.mul)
MIN = Op("min", 2, torch.minimum)
MAX = Op("max", 3, torch.maximum)
AND = Op("and", 4, torch.logical_and, logical=True)
OR = Op("or", 5, torch.logical_or, logical=True)

OPS = {op.name: op for op in (ADD, MUL, MIN, MAX, AND, OR)}
_OPS = {
    torch.add: ADD, operator.add: ADD, torch.mul: MUL, torch.minimum: MIN,
    torch.maximum: MAX, torch.logical_and: AND, torch.logical_or: OR,
}


def catalogued_op(op) -> Op | None:
    """The catalogue entry of ``op`` (a torch or ``operator`` function),
    or None for any other callable: that one runs on the portable path."""
    try:
        return _OPS.get(op)
    except TypeError:  # unhashable callable
        return None


# --------------------------------------------------------------------------
# Size and padding helpers
# --------------------------------------------------------------------------

def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def size_class(n: int) -> int:
    """Pow2 size bucket of an element count: the exponent of next_pow2(n)
    (0 for n <= 1)."""
    return 0 if n <= 1 else int(n - 1).bit_length()


def type_max(dtype: torch.dtype):
    """Largest value of ``dtype`` (+inf for floats) as a Python scalar."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def type_min(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def pad_to(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """Pad 1-D ``x`` up to length ``n`` with ``fill`` (a new tensor unless
    no padding is needed)."""
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                    device=x.device)])


def as_blocks(x: torch.Tensor, fill) -> tuple[torch.Tensor, int]:
    """Flatten ``x``, pad to a whole number of blocks and view it as
    (rows, block_cols). Returns the 2-D view and the original length."""
    n = x.numel()
    elems, cols = block_elems(), block_cols()
    padded = pad_to(x.reshape(-1), max(round_up(n, elems), elems), fill)
    return padded.reshape(-1, cols), n


def require_cuda_or_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        f"operands must all lie on the CPU or on one CUDA device, got "
        f"{sorted(str(t.device) for t in tensors)}"
    )


#: Logit of a masked-out token: finite, so that a row whose every token is
#: masked still has a defined softmax (the reference's value).
NEG_MASK = -1e30
