"""Paper Table II on the port: the cross-architecture arithmetic kernels
(counterpart of ``benchmarks/arithmetic.py``).

RBF (Algorithm 4) and Lennard-Jones-Gauss (Algorithm 5) run through
``ak.map_elements`` with the map kernel's catalogue bodies
(``kernels/map_kernel.py``): one launch of ``csrc/map.cu`` each on the
card. ``run(n)`` times them with CUDA events beside their plain torch
versions and a single-threaded numpy baseline, on a card only:

    PYTHONPATH=src python -m benchmarks_torch.arithmetic [--n N]

The ``*_check`` functions compare two results elementwise with a
tolerance derived from each body's conditioning, not one tolerance for
the whole array:

  * RBF, f = exp(y) with y = -1 / (1 - r): a relative error e in r
    becomes an error of about (r / (1 - r)^2) e in y, which is the
    relative error of f. So the bound is k eps32 (1 + r / (1 - r)^2 + |y|)
    on |log f_got - log f_want|; just above r = 1, f overflows to inf, and
    a point whose y lies within that bound of log(FLT_MAX) may be inf on
    one side only (an overflow flip, counted and bounded).
  * LJG, u = 4 eps (sr^12 - sr^6) - eps exp(-(r - r0)^2 / 0.04): the error
    scales with each term's magnitude times its sensitivity to r
    (12, 6 and 2 |r - r0| r / 0.04), so the bound is k eps32 (12 |A12| +
    6 |A6| + |G| (1 + 50 |r - r0| r) + |u|). The cutoff branch r < cutoff
    may flip on a one-ulp difference in r: such flips are allowed only
    within 1e-5 of the cutoff, counted and bounded by the number of points
    there.
"""
from __future__ import annotations

import argparse
import math
import statistics
import time

import numpy as np
import torch

from repro_torch import core as ak
from repro_torch.convert import to_torch
from repro_torch.kernels.map_kernel import (
    CUTOFF,
    EPS,
    R0,
    SIGMA,
    ljg_body,
    rbf,
)

EPS32 = 2.0 ** -23
TINY = 2.0 ** -149  # smallest float32 subnormal
LOG_FLT_MAX = math.log(float(np.finfo(np.float32).max))
K_ULPS = 8.0
CUTOFF_WINDOW = 1e-5


# --- kernels (paper Algorithms 4 & 5), AK-style ----------------------------
def rbf_kernel(v, *, backend=None):
    """v: (3, N) coordinates -> rbf (N,)."""
    return ak.map_elements(rbf, v[0], v[1], v[2], backend=backend)


def ljg_kernel(p1, p2, *, backend=None, eps=EPS, sigma=SIGMA, r0=R0,
               cutoff=CUTOFF):
    """Lennard-Jones-Gauss with the cutoff branch. p1, p2: (3, N)."""
    return ak.map_elements(ljg_body(eps, sigma, r0, cutoff), p1[0], p1[1],
                           p1[2], p2[0], p2[1], p2[2], backend=backend)


# --- numpy oracles ---------------------------------------------------------
def rbf_numpy(v):
    r = np.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
    with np.errstate(over="ignore"):  # just above r = 1 the body is inf
        return np.exp(-1.0 / (1.0 - r)).astype(np.float32)


def ljg_numpy(p1, p2, eps=EPS, sigma=SIGMA, r0=R0, cutoff=CUTOFF):
    d = p1 - p2
    r = np.sqrt((d * d).sum(axis=0))
    sr6 = (sigma / r) ** 6
    u = 4 * eps * (sr6 * sr6 - sr6) - eps * np.exp(
        -((r - r0) ** 2) / (2 * 0.02)
    )
    return np.where(r < cutoff, u, 0.0).astype(np.float32)


# --- conditioning-derived comparisons ---------------------------------------
def _as64(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = to_torch(np.asarray(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float64)


def _nonfinite_agree(g, w) -> torch.Tensor:
    """Elements where either side is inf or NaN and the two differ."""
    odd = ~torch.isfinite(g) | ~torch.isfinite(w)
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    return odd & ~same


def rbf_check(got, want, v, *, k: float = K_ULPS) -> dict:
    """Hold ``got`` to ``want`` (RBF over coordinates ``v``, (3, N)).
    Returns {worst, flips, bad}: ``worst`` is the largest error over its
    bound (<= 1 passes), ``flips`` the overflow flips near log(FLT_MAX),
    ``bad`` the elements that fail."""
    dev = got.device if isinstance(got, torch.Tensor) else "cpu"
    g, w = _as64(got, dev), _as64(want, dev)
    x, y, z = (_as64(v[i], dev) for i in range(3))
    r = torch.sqrt(x * x + y * y + z * z)
    arg = -1.0 / (1.0 - r)
    # capped where the bound is vacuous anyway (r within ~1e-7 of 1)
    tol_log = (k * EPS32 * (1.0 + r / (1.0 - r) ** 2 + arg.abs())
               ).clamp(max=700.0)
    one_inf = torch.isinf(g) ^ torch.isinf(w)
    flips = one_inf & ((arg - LOG_FLT_MAX).abs() <= tol_log)
    odd = _nonfinite_agree(g, w) & ~flips
    finite = torch.isfinite(g) & torch.isfinite(w)
    tol = torch.expm1(tol_log) * w.abs() + k * TINY
    ratio = torch.where(finite, (g - w).abs() / tol, torch.zeros_like(g))
    bad = int(odd.sum()) + int((ratio > 1).sum())
    return {"worst": float(ratio.max()) if ratio.numel() else 0.0,
            "flips": int(flips.sum()), "bad": bad}


def ljg_check(got, want, p1, p2, *, eps=EPS, sigma=SIGMA, r0=R0,
              cutoff=CUTOFF, k: float = K_ULPS) -> dict:
    """Hold ``got`` to ``want`` (LJG of ``p1``, ``p2``). Returns {worst,
    flips, window, bad}: ``flips`` are branch flips within
    ``CUTOFF_WINDOW`` of the cutoff, ``window`` the points there (the
    bound on flips), ``bad`` the elements that fail (flips outside the
    window included)."""
    dev = got.device if isinstance(got, torch.Tensor) else "cpu"
    g, w = _as64(got, dev), _as64(want, dev)
    d = [_as64(p1[i], dev) - _as64(p2[i], dev) for i in range(3)]
    r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    sr6 = (sigma / r) ** 6
    a12, a6 = 4 * eps * sr6 * sr6, 4 * eps * sr6
    gauss = eps * torch.exp(-((r - r0) ** 2) / (2 * 0.02))
    scale = (12 * a12.abs() + 6 * a6.abs()
             + gauss * (1 + 50 * (r - r0).abs() * r) + (a12 - a6 - gauss).abs())
    tol = k * EPS32 * scale + k * TINY
    near = (r - cutoff).abs() < CUTOFF_WINDOW
    flip = (g == 0) ^ (w == 0)
    odd = _nonfinite_agree(g, w)
    finite = torch.isfinite(g) & torch.isfinite(w) & ~flip
    ratio = torch.where(finite, (g - w).abs() / tol, torch.zeros_like(g))
    bad = int(odd.sum()) + int((flip & ~near).sum()) + int((ratio > 1).sum())
    return {"worst": float(ratio.max()) if ratio.numel() else 0.0,
            "flips": int((flip & near).sum()), "window": int(near.sum()),
            "bad": bad}


# --- timing on the card -----------------------------------------------------
def _cuda_ms(fn, reps: int = 5) -> float:
    fn()  # warm-up (and the kernels' build)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def points(n: int, seed: int = 0, device="cuda"):
    """Coordinates uniform in [0.5, 4.0), as benchmarks/arithmetic.py
    draws them: (v, p2), each (3, n) float32."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.5, 4.0, size=(3, n)).astype(np.float32)
    p2 = rng.uniform(0.5, 4.0, size=(3, n)).astype(np.float32)
    return to_torch(v, device), to_torch(p2, device)


def run(n: int = 1 << 26, device: str = "cuda", seed: int = 0) -> list:
    """Rows (name, ms, GB/s): kernel, plain torch and numpy per body, on
    the card. Raises without one: a measurement never falls back to the
    CPU."""
    if device != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("benchmarks_torch.arithmetic times the card; "
                           "no CUDA device found")
    v, p2 = points(n, seed, device)
    rows = []

    def add(name, ms, nbytes):
        rows.append((name, ms, nbytes / ms / 1e6))

    rb, lb = 4 * n * 4, 7 * n * 4  # operands read once + output written
    add("table2.rbf.cuda", _cuda_ms(lambda: rbf_kernel(v)), rb)
    add("table2.rbf.torch", _cuda_ms(lambda: rbf_kernel(v, backend="torch")),
        rb)
    add("table2.ljg.cuda", _cuda_ms(lambda: ljg_kernel(v, p2)), lb)
    add("table2.ljg.torch",
        _cuda_ms(lambda: ljg_kernel(v, p2, backend="torch")), lb)
    vh, ph = v.cpu().numpy(), p2.cpu().numpy()
    for name, fn, nbytes in (("table2.rbf.numpy", lambda: rbf_numpy(vh), rb),
                             ("table2.ljg.numpy",
                              lambda: ljg_numpy(vh, ph), lb)):
        t0 = time.perf_counter()
        fn()
        add(name, (time.perf_counter() - t0) * 1e3, nbytes)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 26)
    args = ap.parse_args()
    print(torch.cuda.get_device_name(0) if torch.cuda.is_available()
          else "no CUDA device")
    for name, ms, gbps in run(args.n):
        print(f"{name},{ms:.4f} ms,{gbps:.1f} GB/s")
