"""Carry arrays between the reference and the port.

The repo runs no model, so data takes the place of weights: these
round-trip the reference's numpy arrays with their dtypes. bfloat16
arrives from JAX as an ``ml_dtypes`` array, which ``torch.from_numpy``
refuses, so it travels through a ``uint16`` view; ``int32`` stays
``int32``.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_bfloat16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def to_torch(a, device="cpu") -> torch.Tensor:
    """A numpy (or array-like) value as a tensor of the same dtype on
    ``device``."""
    a = np.asarray(a)
    if _is_bfloat16(a.dtype):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array of the same dtype (bfloat16 as an
    ``ml_dtypes.bfloat16`` array, as JAX returns it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
