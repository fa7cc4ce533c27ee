"""Helpers shared by the parity tests of the PyTorch port
(``tests/test_torch_*.py``): seeded numpy inputs handed to both packages,
and bitwise comparison through numpy.

Parity domain: NaN-free keys with no mixed signed zeros. Min/max networks
order -0.0 and +0.0 (and NaN) by where they meet, not by value, so outside
that domain "bitwise" is not defined by either package.
"""
from __future__ import annotations

import ml_dtypes
import numpy as np
import torch

from repro_torch.convert import to_numpy, to_torch

DTYPES = ("f32", "i32", "bf16")


def keys(rng: np.random.Generator, n: int, dtype: str,
         dist: str = "normal") -> np.ndarray:
    """Seeded keys in the target dtype (bf16 as ml_dtypes.bfloat16)."""
    if dist == "duplicates":
        raw = rng.integers(-5, 5, size=n).astype(np.float32)
    elif dist == "constant":
        raw = np.full(n, 3.0, np.float32)
    elif dist == "lognormal":
        raw = rng.lognormal(0.0, 2.0, size=n).astype(np.float32)
    elif dtype == "i32":
        raw = rng.integers(-500, 500, size=n).astype(np.float32)
    else:
        raw = rng.normal(size=n).astype(np.float32)
    if dtype == "i32":
        return raw.astype(np.int32)
    if dtype == "bf16":
        return raw.astype(ml_dtypes.bfloat16)
    return raw


def bits(a) -> np.ndarray:
    """The raw bytes of an array or tensor, for bitwise comparison."""
    if isinstance(a, torch.Tensor):
        a = to_numpy(a)
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


def assert_bitwise(got, want) -> None:
    g, w = np.asarray(to_numpy(got) if isinstance(got, torch.Tensor)
                      else got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype,
                                                      w.shape, w.dtype)
    np.testing.assert_array_equal(bits(g), bits(w))


def t(a) -> torch.Tensor:
    """numpy -> CPU tensor, dtype kept."""
    return to_torch(a)
