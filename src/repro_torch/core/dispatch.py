"""Backend dispatch: AK.jl's multiple dispatch on the array type.

In Julia, ``mapreduce(f, op, itr::AbstractGPUVector)`` shadows the Base
method, so the same call site runs the Base CPU code for a ``Vector`` and
the transpiled kernel for a ``CuArray``. JAX arrays carry no such type
split, so the reference keyed dispatch on a policy only. A torch tensor
does carry its device, so here ``"auto"`` is the paper's rule again:

  * ``"cuda"``  -- the hand-written CUDA kernels of ``repro_torch.kernels``;
  * ``"torch"`` -- the portable PyTorch implementations (``kernels/ref.py``);
  * ``"auto"``  -- ``"cuda"`` for an operand on a CUDA device, ``"torch"``
    for one on the CPU.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()

VALID = ("auto", "torch", "cuda")


def default_backend() -> str:
    return getattr(_state, "backend", "auto")


def set_default_backend(name: str) -> None:
    if name not in VALID:
        raise ValueError(f"backend must be one of {VALID}, got {name!r}")
    _state.backend = name


@contextlib.contextmanager
def backend(name: str):
    """Scoped backend override: ``with dispatch.backend('cuda'): ...``"""
    old = default_backend()
    set_default_backend(name)
    try:
        yield
    finally:
        set_default_backend(old)


def resolve(override: str | None = None, operand=None) -> str:
    """Resolve an (optional) per-call override to 'torch' or 'cuda';
    ``"auto"`` reads the device of ``operand``."""
    name = override or default_backend()
    if name not in VALID:
        raise ValueError(f"backend must be one of {VALID}, got {name!r}")
    if name == "auto":
        device = getattr(operand, "device", None)
        return "cuda" if getattr(device, "type", None) == "cuda" else "torch"
    return name
