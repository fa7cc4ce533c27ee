"""The inputs of the streaming and segmented path at full size, made from a
seed: one builder for ``chip_smoke.py``'s phase 6 and
``benchmarks_torch/streaming_breakdown.py``, so both run the same data.

  * Table II: 2^26 points, coordinates uniform in [0.5, 4.0)
    (``arithmetic.points``);
  * ``x``: 2^28 float32 normals (reduce, accumulate, the segmented CSR
    values); ``xi``: 2^28 int32 in [-1000, 1000); ``xe``: 2^28 float32 in
    {-1, 0, 1}, whose partial sums stay exact in float32 in any order;
  * ``off``: a CSR of 2^28 values in 2^20 segments (:func:`csr_offsets`);
  * ``sv``/``soff``/``spay``: the segmented sort's 2^26 float32 normals in
    2^18 segments and an int32 payload ``arange``.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from benchmarks_torch import arithmetic as AR
from repro_torch.convert import to_torch

MAP_N = 1 << 26      # Table II points
STREAM_N = 1 << 28   # reduce, accumulate and the segmented CSR values
SEGS = 1 << 20
SORT_N = 1 << 26     # segmented sort
SORT_SEGS = 1 << 18


def csr_offsets(rng, nseg: int, total: int) -> np.ndarray:
    """CSR offsets of ``nseg`` segments with lengths geometric(1/256) - 1
    (a few empty; mean 255) and the last one adjusted so the values number
    ``total``: one long segment that spans many scan tiles (should the
    draws overshoot, the offsets are capped at ``total``). A sparse
    matrix's rows."""
    lengths = rng.geometric(1 / 256, nseg).astype(np.int64) - 1
    off = np.zeros(nseg + 1, np.int64)
    off[1:-1] = np.minimum(np.cumsum(lengths[:-1]), total)
    off[-1] = total
    return off.astype(np.int32)


def stream_inputs(seed: int, device="cuda") -> types.SimpleNamespace:
    """Every input of the path (module docstring), on ``device``; the CSR
    offsets also as numpy (``off_np``, ``soff_np``) for float64 checks."""
    rng = np.random.default_rng(seed)
    v, p2 = AR.points(MAP_N, seed, device)
    x = to_torch(rng.standard_normal(STREAM_N, dtype=np.float32), device)
    off_np = csr_offsets(rng, SEGS, STREAM_N)
    soff_np = csr_offsets(rng, SORT_SEGS, SORT_N)
    gen = torch.Generator(device=device).manual_seed(seed)
    xi = torch.randint(-1000, 1000, (STREAM_N,), generator=gen,
                       device=device, dtype=torch.int32)
    xe = torch.randint(-1, 2, (STREAM_N,), generator=gen, device=device,
                       dtype=torch.int32).float()
    sv = torch.randn(SORT_N, generator=gen, device=device)
    return types.SimpleNamespace(
        v=v, p2=p2, x=x, xi=xi, xe=xe, off_np=off_np,
        off=to_torch(off_np, device), soff_np=soff_np,
        soff=to_torch(soff_np, device), sv=sv,
        spay=torch.arange(SORT_N, device=device, dtype=torch.int32))
