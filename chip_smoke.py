#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed S]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main paths: the AK sort primitives at 2^28 float32 keys
and SIHSort over 4 ranks on the one card (2^26 keys + int32 payload per
rank), then the streaming and segmented primitives, then the serving path
on full-width internlm2-1.8B. Phases:

  1. environment: card name and power limit, torch / CUDA / nvcc
     versions, kernel build time, ptxas's registers and spills a kernel, and
     the HGMMA (wgmma) instructions in the attention library's SASS;
  2. every kernel held bitwise against its plain PyTorch version on the
     card (sort network; the in-block kernel at blocks of 2^10, 2^13 and
     2^15 keys on keys with NaN, -0.0 and ties; the fused window at every
     ``sort_hyper`` m = 1..6 against its plain stages and against windows
     of one stage, k-way merge,
     histogram, search: a warp per query below ``THREAD_QUERIES_FROM``
     queries, a thread per query from it);
  3. ``merge_sort`` and ``sortperm`` of 2^28 float32 keys, checked against
     ``torch.sort(stable=True)``, launches against the closed form at the
     default ``sort_hyper``;
  4. SIHSort, 4 ranks x 2^26 keys + payload: the sorted concatenation,
     payload integrity, zero overflow, 19 collectives and the closed-form
     launches per rank;
  5. every kernel held bitwise against its plain version again, on the
     main path's own inputs: the stages timed below, the whole networks
     of phases 3 and 4 (2^28 keys, the 2^26-key kv sort, the 2^27-key
     merge) and the histogram and search of a 2^26-key shard; then
     timings (CUDA events, median of 5 after a warm-up) of each kernel at
     those shapes beside its plain version, a PyTorch call that computes
     the same function, and its bound (the in-block kernel's initial
     launch and one finish, each also by device time: CUDA events around
     20 calls queued behind a sleep kernel; the histogram's too); and a
     sweep of the sort and merge
     primitives over 2^8..2^16 keys, kernels against the portable path,
     which gives the size from which the kernels win (``switch_below``);
     and the ``sort_hyper`` sweep m = 0..6 (m = 0: unfused, windows of one
     stage) of
     ``merge_sort``, ``sortperm``, the 2^26-key kv sort and the P = 4
     merge, bitwise across m, launches against the closed form at each m,
     timed;
  6. the streaming and segmented path (paper Table II and the primitives
     built on it), through the user entry points: RBF and LJG over 2^26
     points (``ak.map_elements`` with the catalogue bodies), their total
     energy (``mapreduce``), ``reduce`` add/max/min and ``accumulate``
     (inclusive add and max in float32, exclusive add in int32) over
     2^28 elements, ``segmented_reduce`` (add, max) and ``segmented_scan``
     (add, inclusive and exclusive) over a CSR of 2^28 values in 2^20
     geometric segments, and ``segmented_sort`` with and without a
     payload over 2^26 values in 2^18 segments; then every new kernel
     against its plain version on those inputs (bitwise where the
     arithmetic is exact, within stated bounds against float64 numpy
     where it is not, within the bodies' conditioning for RBF/LJG), the
     launches against the closed forms, ``portable_calls == 0``, and
     timings beside the plain versions, a PyTorch call where one computes
     the same function, and the bounds; the device time of the map, the
     reduce, the scan and the segmented scan and reduce (CUDA events
     around calls queued behind a sleep kernel,
     ``benchmarks_torch.launch_path.queued_device_us``);
  7. the serving path (``benchmarks_torch/serving.py``): internlm2-1.8B at
     full width (random bf16 weights from the seed), ``Engine(paged=True)``
     with 8 slots serving 16 requests of 256 prompt tokens and 64 new
     tokens (top-k 16, top-p 0.95) through the user entry points; launches
     of the page gather (one a layer and decode step: K and V together),
     the nucleus mask and the batched network against their closed forms
     per decode step and sampler call,
     ``portable_calls == 0`` on the sampler and ``page_gather``; greedy
     paged and contiguous runs of the same requests emit the same tokens;
     the kernels against their plain versions on the inputs that run gave
     them (the page gather bitwise, the nucleus mask equal except at ranks
     whose cumulative mass lies within 1e-5 of top_p, counted); the serve
     CLI once on the smoke config; tokens/s, TTFT, kernel timings and where
     one decode step's device time goes;
  8. flash attention through its entry points at the serving shapes, the
     head dims 8, 80, 256 and 320 and the reference test file's float32
     grid:
     one launch a call under the kernel ``attention_path`` picks (decode,
     tensor-core or CUDA-core), each against its plain version (rtol 2e-4
     / atol 2e-5, + 1 bf16 ulp), timed beside SDPA, ``blockwise_attention``
     and the bound; the decode kernel against the prefill kernels as
     G * Sq grows;
  9. granite-moe-1b through the serving engine and phase 7's traffic.

Launch counters are set to 0 just before phases 3, 4, 6, 7, 8 and 9 and
before each run of the ``sort_hyper`` sweep, and read just after; the
kernels' ``launches`` are the sum of those runs' counts; the in-block,
window and scan kernels' entries also carry ptxas's registers and spilled
bytes over their instantiations (``ptxas``). The last line of
standard output is ``{"ok": true, "device": {...}}``; it is printed only
when every phase passed. Without a CUDA device, or without the repo's
``src/`` beside it, the script exits non-zero and prints no result.
Details too long for the console go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 on the tensor cores, dense

MAIN_N = 1 << 28
RANKS = 4
RANK_N = 1 << 26
SIZES = [1, 5, 8191, 8193, 3 * 8192 + 7, 1 << 20]
DTYPES = (torch.float32, torch.int32, torch.bfloat16)



def sum_rtol(n: int) -> tuple[float, int]:
    """Float add against float64: ``|got - exact| <= rtol * sum |x|`` over
    the same elements, for the kernel and its plain version alike; returns
    (rtol, d). A float32 sum whose every term passes through at most d
    roundings is off by at most d u sum |x| (u = 2^-24), and by about
    sqrt(d) u sum |x| when the roundings do not all align (Higham,
    Accuracy and Stability of Numerical Algorithms, 2nd ed., sec. 2.8 and
    4.2): rtol is the latter. The longest chain is the reduce kernel's:
    each thread folds n / (1024 CTAs x 256 threads) terms in sequence
    (1024 at 2^28), then 8 tree levels in its CTA; the last CTA folds 4
    partials per thread, 8 levels more, and init: d = 1045 and rtol =
    1.93e-6 at 2^28. The scan's single pass is shorter: 16 terms of a
    thread's run, 5 + 5 levels of the warp scans, 9 of the group fold
    (tests/torch_scan_model.py), one hop of the E chain per 128-tile
    group before (255 at 2^28) and 4 seed applications: d <= 294 at
    2^28."""
    d = n // (1024 * 256) + 21
    return math.sqrt(d) * 2.0 ** -24, d

SORT_KERNELS = ("bitonic_inblock", "bitonic_window", "minmax_histogram",
                "searchsorted")
FLASH_KERNELS = ("flash_simt", "flash_decode", "flash_wgmma")
# kernels whose first launch comes after phase 6
LATER_KERNELS = ("nucleus_mask", "page_gather", *FLASH_KERNELS)
REPLACES = {
    "bitonic_inblock": ("src/repro_torch/kernels/csrc/bitonic.cu",
                        "src/repro/kernels/sort_kernel.py:289"),
    "bitonic_window": ("src/repro_torch/kernels/csrc/bitonic.cu",
                       "src/repro/kernels/sort_kernel.py:323"),
    "minmax_histogram": ("src/repro_torch/kernels/csrc/hist.cu",
                         "src/repro/kernels/hist_kernel.py:84"),
    "searchsorted": ("src/repro_torch/kernels/csrc/search.cu",
                     "src/repro/kernels/search_kernel.py:81"),
    "map": ("src/repro_torch/kernels/csrc/map.cu",
            "src/repro/kernels/map_kernel.py:47"),
    "reduce": ("src/repro_torch/kernels/csrc/reduce.cu",
               "src/repro/kernels/reduce_kernel.py:73"),
    "scan": ("src/repro_torch/kernels/csrc/scan.cu",
             "src/repro/kernels/scan_kernel.py:84"),
    "segmented_scan": ("src/repro_torch/kernels/csrc/scan.cu",
                       "src/repro/kernels/segment_kernel.py:167"),
    "nucleus_mask": ("src/repro_torch/kernels/csrc/nucleus.cu",
                     "src/repro/kernels/nucleus_kernel.py:127"),
    "page_gather": ("src/repro_torch/kernels/csrc/page.cu",
                    "src/repro/kernels/page_kernel.py:69"),
    **{name: ("src/repro_torch/kernels/csrc/attention.cu",
              "src/repro/kernels/attention_kernel.py:101")
       for name in FLASH_KERNELS},
}
# the sort path's closed forms at the default sort_hyper (HYPER_ORDER) and
# unfused (sort_hyper=0): a 2^28 sort, the 2^26 local kv sort, the P = 4
# merge finish of 2^27 keys, a re-sort of the same 2^27 buffer
SORT_CLOSED = {"default": (43, 35, 8, 39), "unfused": (136, 105, 29, 120)}


# the kernel instantiations behind each entry of the kernels line: (library,
# substrings of the mangled names; "Lb1E" is a template argument `true`)
PTXAS_OF = {
    "bitonic_inblock": ("bitonic", ("inblock_kernel",)),
    "bitonic_window": ("bitonic", ("window_kernel",)),
    "scan": ("scan", ("onepass_kernel", "Lb0E")),
    "segmented_scan": ("scan", ("onepass_kernel", "Lb1E")),
}


def log(*a):
    print(*a, flush=True)


def ptxas_functions(text: str) -> dict:
    """{mangled kernel: {registers, spill_stores, spill_loads}} from the
    ``nvcc -Xptxas -v`` report of one library."""
    out, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def ptxas_summary(ptx: dict, name: str) -> dict | None:
    """Instantiations, registers (least, most) and the most spilled bytes
    of one entry's kernels."""
    lib, parts = PTXAS_OF.get(name, (None, ()))
    fns = [v for k, v in ptx.get(lib, {}).items()
           if all(p in k for p in parts)]
    if not fns:
        return None
    regs = [f.get("registers", 0) for f in fns]
    return {"instantiations": len(fns), "registers": [min(regs), max(regs)],
            "spill_bytes": max(f.get("spill_stores", 0)
                               + f.get("spill_loads", 0) for f in fns)}


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, setup=lambda: (), reps=5, warmup=1) -> float:
    """Median CUDA-event time of ``fn(*setup())``; ``setup`` runs outside
    the timed window (fresh inputs for in-place kernels)."""
    times = []
    for i in range(warmup + reps):
        args = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S
          ) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over ``ops_per_s`` (float32 on the CUDA cores by
    default; bf16 operands at the tensor-core rate), the larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Errors:
    """Largest |kernel - plain| per kernel over the parity cases."""

    def __init__(self):
        self.err = {k: 0.0 for k in REPLACES}
        self.cases = {k: 0 for k in REPLACES}
        self.float64 = {}  # check -> largest |err| / bound, kernel, plain

    def same(self, names, got, want, what):
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"{what}: {g.dtype}{tuple(g.shape)} vs "
                  f"{w.dtype}{tuple(w.shape)}")
            diff = g != w
            e = 0.0
            if bool(diff.any()):
                e = float((g[diff].double() - w[diff].double()).abs().max())
                e = e if e == e else math.inf
            for n in names:
                self.err[n] = max(self.err[n], e)
                self.cases[n] += 1
            check(e == 0.0, f"{what}: kernel and plain version differ "
                            f"(max abs err {e})")

    def close(self, name, got, want, what, exact64, mass64, rtol):
        """Float results that may differ in rounding: kernel and plain
        version each within ``rtol * mass64`` of the float64 ``exact64``;
        records their largest difference."""
        for label, g in (("kernel", got), ("plain", want)):
            err = (g.double() - exact64).abs()
            lim = rtol * mass64 + 1e-30
            check(bool((err <= lim).all()),
                  f"{what}: {label} off the float64 result by up to "
                  f"{float(err.max())} (bound {rtol} * sum |x|)")
            self.float64.setdefault(what, {})[label] = {
                "max_abs": float(err.max()),
                "share_of_bound": float((err / lim).max())}
        self.record(name, float((got.double() - want.double()).abs().max()))

    def record(self, name, err):
        self.err[name] = max(self.err[name], err)
        self.cases[name] += 1


def keys_on(gen, n, dtype, dist="normal"):
    if dist == "duplicates" or dtype == torch.int32:
        hi = 5 if dist == "duplicates" else 500
        return torch.randint(-hi, hi, (n,), generator=gen, device="cuda",
                             dtype=torch.int32).to(dtype)
    return torch.randn(n, generator=gen, device="cuda").to(dtype)


def awkward_keys(gen, n, dtype):
    """Keys in [-4, 4) (many ties); floats with -0.0 beside 0.0 and NaN."""
    x = torch.randint(-4, 4, (n,), generator=gen, device="cuda",
                      dtype=torch.int32).to(dtype)
    if dtype.is_floating_point:
        u = torch.rand(n, generator=gen, device="cuda")
        x = torch.where(u < 0.1, torch.full_like(x, -0.0), x)
        x = torch.where(u > 0.97, torch.full_like(x, math.nan), x)
    return x


def as_bits(x):
    """The raw bits of x as integers (NaN and -0.0 compare as bits)."""
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def phase_parity(SK, MK, HK, SE, C) -> Errors:
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = Errors()
    both = ("bitonic_inblock", "bitonic_window")
    for dtype in DTYPES:
        for n in SIZES:
            k = keys_on(gen, n, dtype)
            v = torch.randint(0, 50, (n,), generator=gen, device="cuda",
                              dtype=torch.int32)
            errs.same(both, [SK.bitonic_sort(k)],
                      [SK.bitonic_sort(k, plain=True)], f"sort {dtype} {n}")
            for tie in (False, True):
                errs.same(both, SK.bitonic_sort_kv(k, v, tie_break=tie),
                          SK.bitonic_sort_kv(k, v, tie_break=tie,
                                             plain=True),
                          f"sort_kv {dtype} {n} tie={tie}")
        # each kernel alone, one launch, on unsorted data
        x = keys_on(gen, 1 << 20, dtype)
        a, _ = SK._run_inblock(x.clone(), None, 2, 8192, 8192, False, True)
        b, _ = SK._run_inblock(x.clone(), None, 2, 8192, 8192, False, False)
        errs.same(["bitonic_inblock"], [a], [b], f"inblock {dtype}")
        # the in-block kernel at three blocks, the initial phases and a
        # finish, keys with NaN, -0.0 and ties (compared as bits), alone
        # and with an int32 payload and the tie-break
        for block in (1 << 10, 1 << 13, 1 << 15):
            xa = awkward_keys(gen, 1 << 17, dtype)
            va = torch.randint(0, 50, (1 << 17,), generator=gen,
                               device="cuda", dtype=torch.int32)
            for vv, tie in ((None, False), (va, True)):
                if block * (xa.element_size() + (0 if vv is None else 4)) \
                        > SK.MAX_SMEM:
                    continue
                for k_lo, k_hi in ((2, block), (1 << 17, 1 << 17)):
                    got = SK._run_inblock(
                        xa.clone(), None if vv is None else vv.clone(),
                        k_lo, k_hi, block, tie, True)
                    want = SK._run_inblock(
                        xa.clone(), None if vv is None else vv.clone(),
                        k_lo, k_hi, block, tie, False)
                    nk = 1 + (vv is not None)
                    errs.same(["bitonic_inblock"], [as_bits(g) for g in
                                                    got[:nk]],
                              [as_bits(w) for w in want[:nk]],
                              f"inblock {dtype} block {block} phases "
                              f"{k_lo}..{k_hi} kv={vv is not None}")
        # the fused window at every order: against the plain stages and
        # windows of one stage (unfused), keys alone and kv with the
        # tie-break off and on
        v20 = torch.randint(0, 50, (1 << 20,), generator=gen, device="cuda",
                            dtype=torch.int32)
        for m in range(1, SK.MAX_HYPER + 1):
            for vv, tie in ((None, False), (v20, False), (v20, True)):
                cp = (lambda: (x.clone(), None if vv is None
                               else vv.clone()))
                got = SK._run_window(*cp(), 1 << 20, 1 << 19, m, tie, True)
                want = SK._run_window(*cp(), 1 << 20, 1 << 19, m, tie, False)
                ka, va = cp()
                for st in range(m):
                    ka, va = SK._run_window(ka, va, 1 << 20,
                                            (1 << 19) >> st, 1, tie, True)
                errs.same(["bitonic_window"], got[:1 + (vv is not None)],
                          want[:1 + (vv is not None)],
                          f"window m={m} {dtype} kv={vv is not None} "
                          f"tie={tie}")
                errs.same(["bitonic_window"], got[:1 + (vv is not None)],
                          (ka, va)[:1 + (vv is not None)],
                          f"window m={m} vs unfused {dtype}")
            # whole networks at order m, both sides of a window boundary
            with C.tuning_scope(sort_hyper=m):
                for n in (1 << 17, (1 << 19) + 3):
                    k = keys_on(gen, n, dtype)
                    v = torch.randint(0, 50, (n,), generator=gen,
                                      device="cuda", dtype=torch.int32)
                    errs.same(("bitonic_inblock", "bitonic_window"),
                              SK.bitonic_sort_kv(k, v, tie_break=True),
                              SK.bitonic_sort_kv(k, v, tie_break=True,
                                                 plain=True),
                              f"sort_kv m={m} {dtype} {n}")
        # k-way merge: P runs with ragged counts
        for nruns in (2, 3, 4, 8):
            run_len = 5000
            runs = torch.sort(keys_on(gen, nruns * run_len, dtype,
                                      "duplicates").view(nruns, run_len),
                              dim=1).values.reshape(-1)
            pay = torch.randint(0, 1 << 20, (nruns * run_len,),
                                generator=gen, device="cuda",
                                dtype=torch.int32)
            counts = torch.randint(0, run_len + 1, (nruns,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            errs.same(both, MK.kway_merge_kv(runs, pay, nruns, counts=counts),
                      MK.kway_merge_kv(runs, pay, nruns, counts=counts,
                                       plain=True),
                      f"merge {dtype} P={nruns}")
        # histogram with values outside [lo, hi)
        for n in SIZES:
            x = keys_on(gen, n, dtype)
            for nbins in (256, 1024):
                got = HK.minmax_histogram_blocks(x, nbins, -1.0, 1.5)
                want = HK.minmax_histogram_plain(x, nbins, -1.0, 1.5)
                errs.same(["minmax_histogram"], got, want,
                          f"hist {dtype} n={n} bins={nbins}")
        # search: duplicates and type-max keys, queries that hit keys
        top = torch.tensor([math.inf if dtype.is_floating_point
                            else 2**31 - 1], device="cuda").to(dtype)
        for n in SIZES:
            hay = torch.sort(torch.cat([keys_on(gen, n, dtype,
                                                "duplicates"),
                                        top.repeat(7)])).values
            # 601 queries: a warp each; 4x as many: a thread each
            for nq in (300, 4 * SE.THREAD_QUERIES_FROM):
                idx = torch.randint(0, hay.numel(), (nq,), generator=gen,
                                    device="cuda")
                q = torch.cat([hay[idx], keys_on(gen, nq, dtype), top])
                for side in ("left", "right"):
                    errs.same(["searchsorted"],
                              [SE.searchsorted_blocks(hay, q, side=side)],
                              [SE.searchsorted_plain(hay, q, side=side)],
                              f"search {dtype} n={n} nq={q.numel()} {side}")
    torch.cuda.synchronize()
    return errs


def phase_main_parity(SK, MK, HK, SE, errs, x, gx, gp, cap, shard, lo, hi,
                      q) -> None:
    """The kernels against their plain versions on the main path's inputs
    (launches here are not counted in the main path's runs)."""
    both = ("bitonic_inblock", "bitonic_window")
    for name, run, args in (
            ("bitonic_inblock", SK._run_inblock, (2, 8192, 8192, False)),
            ("bitonic_inblock", SK._run_inblock,
             (MAIN_N, MAIN_N, 8192, False)),
            *(("bitonic_window", SK._run_window,
               (MAIN_N, MAIN_N // 2, m, False))
              for m in range(1, SK.MAX_HYPER + 1))):
        got, _ = run(x.clone(), None, *args, True)
        want, _ = run(x.clone(), None, *args, False)
        errs.same([name], [got], [want], f"{name} {args}, 2^28 keys")
        del got, want
    errs.same(both, [SK.bitonic_sort(x)], [SK.bitonic_sort(x, plain=True)],
              "merge_sort network, 2^28 keys")
    errs.same(both, [SK.bitonic_argsort(x)],
              [SK.bitonic_argsort(x, plain=True)],
              "sortperm network, 2^28 keys")
    k, v = gx[:RANK_N], gp[:RANK_N]
    errs.same(both, SK.bitonic_sort_kv(k, v),
              SK.bitonic_sort_kv(k, v, plain=True),
              "SIHSort local kv sort, 2^26 keys")
    # the merge finish: RANKS runs of cap keys, each about half full
    runs, order = torch.sort(gx[:RANKS * cap].view(RANKS, cap), dim=1)
    pay = gp[:RANKS * cap].view(RANKS, cap).gather(1, order).reshape(-1)
    counts = torch.tensor([cap // 2 + d for d in (-4099, 17, 3001, -1)],
                          dtype=torch.int32, device="cuda")
    runs = runs.reshape(-1)
    errs.same(both, MK.kway_merge_kv(runs, pay, RANKS, counts=counts),
              MK.kway_merge_kv(runs, pay, RANKS, counts=counts, plain=True),
              f"SIHSort merge finish, {RANKS} x {cap} keys")
    del runs, order, pay
    errs.same(["minmax_histogram"],
              HK.minmax_histogram_blocks(shard, 256, lo, hi),
              HK.minmax_histogram_plain(shard, 256, lo, hi),
              "histogram of a 2^26-key shard")
    # SIHSort's 3 splitters (a warp each), and as many splitters as take
    # the thread-per-query kernel
    many = shard[torch.arange(SE.THREAD_QUERIES_FROM, device="cuda")
                 * (RANK_N // SE.THREAD_QUERIES_FROM)]
    for qs in (q, many):
        for side in ("left", "right"):
            errs.same(["searchsorted"],
                      [SE.searchsorted_blocks(shard, qs, side=side)],
                      [SE.searchsorted_plain(shard, qs, side=side)],
                      f"search of {qs.numel()} keys into a 2^26-key "
                      f"shard, {side}")
    torch.cuda.synchronize()


def phase_hyper_sweep(ak, registry, SK, MK, C, errs, x, gx, gp, cap
                      ) -> dict:
    """``merge_sort`` and ``sortperm`` of the 2^28 float32 keys, the
    2^26-key kv sort and the P = 4 merge finish of phase 4, through the
    registry at every ``sort_hyper`` m = 0..6 (m = 0 is the unfused
    network, windows of one stage): each bitwise equal across m and to
    ``torch.sort`` or the
    plain network, its counted launches equal to the closed form at m,
    then timed (CUDA events, median of 5). The runs at every m are the
    main path with that knob: their launches add to the kernels' counts."""
    prims = ("sort", "argsort", "sort_kv", "merge_kv")
    ref = torch.sort(x, stable=True)
    k26, v26 = gx[:RANK_N], gp[:RANK_N]
    kv_plain = SK.bitonic_sort_kv(k26, v26, plain=True)
    runs, order = torch.sort(gx[:RANKS * cap].view(RANKS, cap), dim=1)
    pay = gp[:RANKS * cap].view(RANKS, cap).gather(1, order).reshape(-1)
    runs = runs.reshape(-1)
    counts = torch.tensor([cap // 2 + d for d in (-4099, 17, 3001, -1)],
                          dtype=torch.int32, device="cuda")
    merge_plain = MK.kway_merge_kv(runs, pay, RANKS, counts=counts,
                                   plain=True)
    del order
    calls = {
        "merge_sort": (lambda: ak.merge_sort(x), "sort"),
        "sortperm": (lambda: ak.sortperm(x), "argsort"),
        "kv_sort_2^26": (lambda: ak.merge_sort_by_key(k26, v26), "sort_kv"),
        "merge_P4_2^27": (lambda: registry.call(
            "merge_kv", runs, pay, counts, nruns=RANKS), "merge_kv"),
    }
    closed = {
        "merge_sort": lambda m: SK.cross_launches(MAIN_N, hyper=m),
        "sortperm": lambda m: SK.cross_launches(MAIN_N, hyper=m),
        "kv_sort_2^26": lambda m: SK.cross_launches(RANK_N, hyper=m),
        "merge_P4_2^27": lambda m: MK.merge_launches(RANKS * cap, RANKS,
                                                     hyper=m),
    }
    want = {"merge_sort": [ref.values], "sortperm": [ref.indices.int()],
            "kv_sort_2^26": list(kv_plain), "merge_P4_2^27":
            list(merge_plain)}
    kernels: dict = {}
    rows = []
    for m in range(SK.MAX_HYPER + 1):
        row = {"m": m}
        with registry.tuning.overrides({p: {"sort_hyper": m}
                                        for p in prims}):
            for name, (fn, prim) in calls.items():
                torch.cuda.synchronize()
                C.reset_launch_count()
                got = fn()
                torch.cuda.synchronize()
                launches = C.launch_counts().get(prim)
                for kname, n in C.kernel_launches().items():
                    kernels[kname] = kernels.get(kname, 0) + n
                check(launches == closed[name](m),
                      f"{name} at sort_hyper={m}: {launches} launches, "
                      f"closed form {closed[name](m)}")
                got = list(got) if isinstance(got, tuple) else [got]
                errs.same(("bitonic_inblock", "bitonic_window"), got,
                          want[name],
                          f"{name} at sort_hyper={m}")
                del got
                row[f"{name}_launches"] = launches
                row[f"{name}_ms"] = cuda_ms(fn)
        rows.append(row)
        log(f"  sort_hyper={m}: " + json.dumps(row))
    best = min(rows, key=lambda r: r["merge_sort_ms"])["m"]
    del runs, pay, kv_plain, merge_plain, ref
    return {"rows": rows, "kernel_launches": kernels,
            "fastest_merge_sort_m": best,
            "torch_sort_ms": cuda_ms(lambda: torch.sort(x)),
            "bound_ms_one_pass": bound(2 * MAIN_N * 4, 0)[0]}


def phase_crossover(registry) -> dict:
    """Each sort and merge primitive on the kernels and on the portable
    path for 2^8..2^16 keys (4 runs for a merge, kv with an int32
    payload). ``switch_below`` is the smallest size from which the kernels
    are as fast at every larger size of the sweep (None: never)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for e in range(8, 17):
        n = 1 << e
        k = torch.randn(n, generator=gen, device="cuda")
        v = torch.arange(n, device="cuda", dtype=torch.int32)
        runs = torch.sort(k.view(4, -1), dim=1).values.reshape(-1)
        counts = torch.full((4,), n // 4, dtype=torch.int32, device="cuda")
        calls = {
            "sort": lambda b: registry.call("sort", k, backend=b,
                                            switch_below=0),
            "sort_kv": lambda b: registry.call("sort_kv", k, v, backend=b,
                                               switch_below=0),
            "merge": lambda b: registry.call("merge", runs, counts, nruns=4,
                                             backend=b, switch_below=0),
            "merge_kv": lambda b: registry.call(
                "merge_kv", runs, v, counts, nruns=4, backend=b,
                switch_below=0),
        }
        row = {"n": n}
        for prim, fn in calls.items():
            for b in ("cuda", "torch"):
                row[f"{prim}_{b}_ms"] = cuda_ms(lambda: fn(b), reps=21,
                                                warmup=3)
        rows.append(row)
    out = {"rows": rows}
    for prim in ("sort", "sort_kv", "merge", "merge_kv"):
        at = None
        for row in reversed(rows):
            if row[f"{prim}_cuda_ms"] > row[f"{prim}_torch_ms"]:
                break
            at = row["n"]
        out[prim] = at
    return out


def seg_exact(vals64: "np.ndarray", off: "np.ndarray", exclusive=False):
    """Float64 per-segment inclusive (or exclusive) prefix sums and their
    sum |x| counterpart, through one global cumulative sum."""
    cs = np.concatenate([[0.0], np.cumsum(vals64)])
    lengths = np.diff(off.astype(np.int64))
    head = np.repeat(cs[off[:-1]], lengths)
    idx = np.arange(vals64.shape[0])
    return cs[idx + (0 if exclusive else 1)] - head


def phase_streaming(ak, registry, C, errs, seed: int) -> dict:
    """Phase 6: the Table II map bodies, reduce, accumulate and the
    segmented primitives at full size; returns counts, checks, timings."""
    from benchmarks_torch import arithmetic as AR
    from benchmarks_torch import streaming_inputs as SI
    from benchmarks_torch.launch_path import queued_device_us
    from repro_torch.kernels import map_kernel as MAPK
    from repro_torch.kernels import ref as KREF
    from repro_torch.kernels import reduce_kernel as RK
    from repro_torch.kernels import scan_kernel as SCK
    from repro_torch.kernels import segment_kernel as SGK
    from repro_torch.kernels import sort_kernel as SK

    out = {}
    t0 = time.perf_counter()
    inp = SI.stream_inputs(seed)
    v, p2, x, xi, xe = inp.v, inp.p2, inp.x, inp.xi, inp.xe
    off, off_np, soff, sv, spay = (inp.off, inp.off_np, inp.soff, inp.sv,
                                   inp.spay)
    del inp
    MAP_N, STREAM_N, SORT_N = SI.MAP_N, SI.STREAM_N, SI.SORT_N
    rtol, out["sum_depth"] = sum_rtol(STREAM_N)
    out["sum_rtol"] = rtol
    ljg = MAPK.ljg_body()
    inf = math.inf
    torch.cuda.synchronize()
    out["inputs_s"] = time.perf_counter() - t0

    # -- the path, counted: the user entry points only ----------------------
    registry.reset_stats()
    C.reset_launch_count()
    t0 = time.perf_counter()
    e_rbf = AR.rbf_kernel(v)
    e_ljg = AR.ljg_kernel(v, p2)
    energy = ak.mapreduce(MAPK.identity, torch.add, e_ljg, init=0.0)
    r_add = ak.reduce(torch.add, x, init=0.0)
    r_max = ak.reduce(torch.maximum, x, init=-inf)
    r_min = ak.reduce(torch.minimum, x, init=inf)
    a_add = ak.accumulate(torch.add, x, init=0.0)
    a_max = ak.accumulate(torch.maximum, x, init=-inf)
    a_int = ak.accumulate(torch.add, xi, init=0, inclusive=False)
    s_add = ak.segmented_reduce(torch.add, x, off, init=0.0)
    s_max = ak.segmented_reduce(torch.maximum, x, off, init=-inf)
    c_inc = ak.segmented_scan(torch.add, x, off, init=0.0)
    c_exc = ak.segmented_scan(torch.add, x, off, init=0.0, inclusive=False)
    ss = ak.segmented_sort(sv, soff)
    ss_v, ss_p = ak.segmented_sort(sv, soff, vals=spay)
    torch.cuda.synchronize()
    out["path_s"] = time.perf_counter() - t0
    counts, kernels = C.launch_counts(), C.kernel_launches()
    stats = registry.stats()
    out["launches"], out["kernel_launches"] = counts, kernels
    out["stats"] = {k: stats[k] for k in ("map", "mapreduce", "accumulate",
                                          "segmented_reduce",
                                          "segmented_scan",
                                          "segmented_sort")}
    for name, st in stats.items():
        check(st["portable_calls"] == 0,
              f"{name}: {st['portable_calls']} portable calls on the path")
    scan1 = SCK.scan_launches(STREAM_N)
    seg1 = SGK.segmented_scan_launches(STREAM_N)
    sort_l = (SGK.segmented_sort_launches(SORT_N)
              + SGK.segmented_sort_launches(SORT_N, payload=True))
    want = {"map": 2 * MAPK.map_launches(MAP_N),
            "mapreduce": 4 * RK.reduce_launches(STREAM_N),
            "accumulate": 3 * scan1, "segmented_reduce": 2 * seg1,
            "segmented_scan": 2 * seg1, "segmented_sort": sort_l}
    check(counts == want, f"streaming launches {counts} != closed forms "
                          f"{want}")
    check(kernels.get("segmented_scan") == 4 * seg1 == 4
          and kernels.get("scan") == 3 * scan1 == 3
          and kernels.get("reduce") == 4 and kernels.get("map") == 2,
          f"per-kernel launches {kernels}")
    log(f"streaming path: {out['path_s']:.2f} s, launches {counts} (closed "
        f"forms), portable calls 0")

    # -- results against their plain versions and float64 ------------------
    t0 = time.perf_counter()
    res = AR.rbf_check(e_rbf, KREF.map_ref(MAPK.rbf, *v), v)
    check(res["bad"] == 0, f"rbf kernel vs plain: {res}")
    out["rbf_check"] = res
    plain_ljg = KREF.map_ref(ljg, *v, *p2)
    res = AR.ljg_check(e_ljg, plain_ljg, v, p2)
    check(res["bad"] == 0 and res["flips"] <= res["window"],
          f"ljg kernel vs plain: {res}")
    out["ljg_check"] = res
    for g, w in ((e_rbf, KREF.map_ref(MAPK.rbf, *v)), (e_ljg, plain_ljg)):
        fin = torch.isfinite(g) & torch.isfinite(w) & ((g == 0) == (w == 0))
        errs.record("map", float((g[fin] - w[fin]).abs().max()))
    vh, ph = v.cpu().numpy(), p2.cpu().numpy()
    chk = AR.rbf_check(e_rbf, AR.rbf_numpy(vh), v)
    check(chk["bad"] == 0, f"rbf kernel vs numpy oracle: {chk}")
    chk = AR.ljg_check(e_ljg, AR.ljg_numpy(vh, ph), v, p2)
    check(chk["bad"] == 0, f"ljg kernel vs numpy oracle: {chk}")
    del vh, ph
    e64 = e_ljg.double()
    check(torch.isfinite(e64).all(), "ljg energies not finite")
    plain_energy = KREF.reduce_ref(MAPK.identity, torch.add, e_ljg,
                                   unit=0.0)
    errs.close("reduce", energy.reshape(1), plain_energy.reshape(1),
               "mapreduce(ljg energies)", e64.sum().reshape(1),
               e64.abs().sum().reshape(1), rtol)
    out["energy"] = float(energy)

    x64 = x.cpu().numpy().astype(np.float64)
    mass = float(np.abs(x64).sum())
    errs.close("reduce", r_add.reshape(1),
               KREF.reduce_ref(MAPK.identity, torch.add, x,
                               unit=0.0).reshape(1),
               "reduce add 2^28", torch.tensor([x64.sum()], device="cuda",
                                               dtype=torch.float64),
               torch.tensor([mass], device="cuda", dtype=torch.float64),
               rtol)
    for name, got, op, unit in (("max", r_max, torch.maximum, -inf),
                                ("min", r_min, torch.minimum, inf)):
        errs.same(["reduce"], [got],
                  [KREF.reduce_ref(MAPK.identity, op, x, unit=unit)],
                  f"reduce {name} 2^28")
    errs.same(["reduce"], [RK.reduce_blocks(MAPK.identity, torch.add, xe,
                                            unit=0.0)],
              [KREF.reduce_ref(MAPK.identity, torch.add, xe, unit=0.0)],
              "reduce add, exact input, 2^28")
    cs64 = torch.from_numpy(np.cumsum(x64)).cuda()
    cm64 = torch.from_numpy(np.cumsum(np.abs(x64))).cuda()
    errs.close("scan", a_add, KREF.scan_ref(torch.add, x, unit=0.0),
               "accumulate add 2^28", cs64, cm64, rtol)
    del cs64, cm64
    errs.same(["scan"], [a_max], [KREF.scan_ref(torch.maximum, x,
                                                unit=-inf)],
              "accumulate max 2^28")
    errs.same(["scan"], [a_int], [KREF.scan_ref(torch.add, xi, unit=0,
                                                exclusive=True)],
              "accumulate exclusive add int32 2^28")
    errs.same(["scan"], [SCK.scan_blocks(torch.add, xe, unit=0.0)],
              [KREF.scan_ref(torch.add, xe, unit=0.0)],
              "accumulate add, exact input, 2^28")
    del a_add, a_max, a_int

    lengths = np.diff(off_np.astype(np.int64))
    seg_inc = torch.from_numpy(seg_exact(x64, off_np)).cuda()
    seg_mass = torch.from_numpy(seg_exact(np.abs(x64), off_np)).cuda()
    ends = np.maximum(off_np[1:].astype(np.int64) - 1, 0)
    nonempty = torch.from_numpy(lengths > 0).cuda()
    e_idx = torch.from_numpy(ends).cuda()
    zero = torch.zeros((), dtype=torch.float64, device="cuda")
    errs.close("segmented_scan", s_add,
               SGK.segmented_reduce_ref(torch.add, x, off, init=0.0),
               "segmented_reduce add", torch.where(
                   nonempty, seg_inc[e_idx], zero),
               torch.where(nonempty, seg_mass[e_idx], zero), rtol)
    errs.close("segmented_scan", c_inc,
               SGK.segmented_scan_ref(torch.add, x, off, unit=0.0),
               "segmented_scan inclusive add", seg_inc, seg_mass, rtol)
    del seg_inc, seg_mass
    seg_exc = torch.from_numpy(seg_exact(x64, off_np, True)).cuda()
    seg_mass = torch.from_numpy(seg_exact(np.abs(x64), off_np, True)).cuda()
    errs.close("segmented_scan", c_exc,
               SGK.segmented_scan_ref(torch.add, x, off, unit=0.0,
                                      exclusive=True),
               "segmented_scan exclusive add", seg_exc, seg_mass, rtol)
    del seg_exc, seg_mass, x64, c_inc, c_exc
    errs.same(["segmented_scan"], [s_max],
              [SGK.segmented_reduce_ref(torch.maximum, x, off, init=-inf)],
              "segmented_reduce max")
    for exclusive in (False, True):
        errs.same(["segmented_scan"],
                  [SGK.segmented_scan_blocks(torch.add, xe, off, unit=0.0,
                                             exclusive=exclusive)],
                  [SGK.segmented_scan_ref(torch.add, xe, off, unit=0.0,
                                          exclusive=exclusive)],
                  f"segmented_scan exact input exclusive={exclusive}")
    errs.same(["segmented_scan"],
              [SGK.segmented_reduce_blocks(torch.add, xe, off, init=0.0)],
              [SGK.segmented_reduce_ref(torch.add, xe, off, init=0.0)],
              "segmented_reduce add, exact input")
    # the segmented sort: the network against its plain version, and the
    # result against the plain stable-sort formulation
    ids = SGK.segment_ids(soff, SORT_N)
    both = ("bitonic_inblock", "bitonic_window")
    errs.same(both, SK.bitonic_sort_kv(ids, sv, tie_break=True),
              SK.bitonic_sort_kv(ids, sv, tie_break=True, plain=True),
              "segmented sort network (ids, f32 values), 2^26")
    wv, wp = SGK.segmented_sort_ref(sv, soff, spay)
    check(torch.equal(ss, wv) and torch.equal(ss_v, wv)
          and torch.equal(ss_p, wp), "segmented_sort != stable lexsort")
    del ids, wv, wp, ss, ss_v, ss_p
    torch.cuda.synchronize()
    out["parity_s"] = time.perf_counter() - t0
    log(f"streaming parity: kernels against plain versions and float64 "
        f"({out['parity_s']:.1f} s); rbf {out['rbf_check']}, ljg "
        f"{out['ljg_check']}")

    # -- timings at the path's shapes ----------------------------------------
    nb = STREAM_N * 4
    S = SI.SEGS
    off64 = off.long()
    rows = {}

    def row(name, fn, plain, lib, nbytes, ops, lib_note=None,
            device=False):
        r = {"ms": cuda_ms(fn), "plain_ms": cuda_ms(plain, reps=3),
             "library_ms": cuda_ms(lib) if lib else None,
             "library": lib_note}
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
        if device:  # device time alone, by queued events
            r["device_us"] = queued_device_us(fn)
            r["library_device_us"] = queued_device_us(lib) if lib else None
        rows[name] = r
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']})" + (
                f"; device {r['device_us']:.2f} us (library "
                f"{r['library_device_us']})" if device else ""))

    row("map_rbf", lambda: AR.rbf_kernel(v),
        lambda: KREF.map_ref(MAPK.rbf, *v), None, 4 * MAP_N * 4,
        10 * MAP_N, "no single PyTorch call computes the RBF body")
    row("map_ljg", lambda: AR.ljg_kernel(v, p2),
        lambda: KREF.map_ref(ljg, *v, *p2), None, 7 * MAP_N * 4,
        25 * MAP_N, "no single PyTorch call computes the LJG body",
        device=True)
    row("mapreduce_energy",
        lambda: ak.mapreduce(MAPK.identity, torch.add, e_ljg, init=0.0),
        lambda: KREF.reduce_ref(MAPK.identity, torch.add, e_ljg, unit=0.0),
        lambda: torch.sum(e_ljg), MAP_N * 4, MAP_N, "torch.sum")
    for name, op, unit, lib in (
            ("reduce_add", torch.add, 0.0, torch.sum),
            ("reduce_max", torch.maximum, -inf, torch.amax),
            ("reduce_min", torch.minimum, inf, torch.amin)):
        row(name, lambda op=op, unit=unit: ak.reduce(op, x, init=unit),
            lambda op=op, unit=unit: KREF.reduce_ref(MAPK.identity, op, x,
                                                     unit=unit),
            lambda lib=lib: lib(x), nb, STREAM_N, lib.__name__, device=True)
    row("accumulate_add", lambda: ak.accumulate(torch.add, x, init=0.0),
        lambda: KREF.scan_ref(torch.add, x, unit=0.0),
        lambda: torch.cumsum(x, 0), 2 * nb, STREAM_N, "torch.cumsum",
        device=True)
    row("accumulate_max",
        lambda: ak.accumulate(torch.maximum, x, init=-inf),
        lambda: KREF.scan_ref(torch.maximum, x, unit=-inf),
        lambda: torch.cummax(x, 0), 2 * nb, STREAM_N,
        "torch.cummax (also writes int64 indices)", device=True)
    row("accumulate_excl_int32",
        lambda: ak.accumulate(torch.add, xi, init=0, inclusive=False),
        lambda: KREF.scan_ref(torch.add, xi, unit=0, exclusive=True),
        lambda: torch.cumsum(xi, 0, dtype=torch.int32), 2 * nb, STREAM_N,
        "torch.cumsum (inclusive)", device=True)
    seg_bytes = 2 * nb + 4 * (S + 1)
    row("segmented_reduce_add",
        lambda: ak.segmented_reduce(torch.add, x, off, init=0.0),
        lambda: SGK.segmented_reduce_ref(torch.add, x, off, init=0.0),
        lambda: torch.segment_reduce(x, "sum", offsets=off64),
        nb + 4 * (S + 1) + 4 * S, STREAM_N,
        "torch.segment_reduce(sum, offsets)", device=True)
    row("segmented_reduce_max",
        lambda: ak.segmented_reduce(torch.maximum, x, off, init=-inf),
        lambda: SGK.segmented_reduce_ref(torch.maximum, x, off, init=-inf),
        lambda: torch.segment_reduce(x, "max", offsets=off64,
                                     initial=-inf),
        nb + 4 * (S + 1) + 4 * S, STREAM_N,
        "torch.segment_reduce(max, offsets)", device=True)
    row("segmented_scan_incl",
        lambda: ak.segmented_scan(torch.add, x, off, init=0.0),
        lambda: SGK.segmented_scan_ref(torch.add, x, off, unit=0.0),
        None, seg_bytes, STREAM_N,
        "no single PyTorch call computes a segmented scan", device=True)
    row("segmented_scan_excl",
        lambda: ak.segmented_scan(torch.add, x, off, init=0.0,
                                  inclusive=False),
        lambda: SGK.segmented_scan_ref(torch.add, x, off, unit=0.0,
                                       exclusive=True),
        None, seg_bytes, STREAM_N,
        "no single PyTorch call computes a segmented scan", device=True)
    row("segmented_sort", lambda: ak.segmented_sort(sv, soff),
        lambda: SGK.segmented_sort_ref(sv, soff), None,
        SORT_N * 4 * 2 + 4 * (SI.SORT_SEGS + 1), 0,
        "no single PyTorch call sorts segments; plain = two stable sorts")
    row("segmented_sort_payload",
        lambda: ak.segmented_sort(sv, soff, vals=spay),
        lambda: SGK.segmented_sort_ref(sv, soff, spay), None,
        SORT_N * 8 * 2 + 4 * (SI.SORT_SEGS + 1), 0,
        "no single PyTorch call sorts segments; plain = two stable sorts")
    out["rows"] = rows
    return out


def _exclusive_cum64(neg, perm, n):
    """Float64 exclusive cumulative softmax mass of every column's rank in
    the descending order (``neg``/``perm``: the network's sorted rows): a
    rank is kept iff this is below top_p, so two sums in different orders
    may disagree only where it lies near top_p."""
    s = -neg[:, :n].double()
    p = torch.softmax(s, dim=1)
    excl = torch.cumsum(p, dim=1) - p
    out = torch.empty_like(excl)
    out.scatter_(1, perm[:, :n].long(), excl)
    return out


def phase_serving(registry, C, errs, seed: int) -> dict:
    """Phase 7: the serving path on full-width internlm2-1.8B (see
    ``benchmarks_torch/serving.py``): a paged, sampled engine run through
    the user entry points with the launch counters set to 0 just before
    it, then greedy paged and contiguous runs that must agree, the kernels
    against their plain versions on the inputs that run gave them, the
    serve CLI, and timings."""
    from benchmarks_torch import serving as SV
    from repro_torch.kernels import nucleus_kernel as NK
    from repro_torch.kernels import page_kernel as PK
    from repro_torch.kernels import ref as KREF
    from repro_torch.kernels import scan_kernel as SCK
    from repro_torch.kernels import search_kernel as SE
    from repro_torch.kernels import sort_kernel as SK
    from repro_torch.launch import serve
    from repro_torch.launch.engine import COMPLETED
    from repro_torch.models import model as M

    out = {}
    t0 = time.perf_counter()
    w = SV.workload(seed)
    torch.cuda.synchronize()
    cfg = w.cfg
    V = cfg.padded_vocab(16)
    out["params"] = M.param_count(w.params)
    out["init_s"] = time.perf_counter() - t0
    log(f"serve: {cfg.name} at full width, {out['params']} parameters "
        f"(random bf16, seed {seed}), vocab {cfg.vocab} padded to {V}; "
        f"init {out['init_s']:.1f} s")

    # -- the main path: a paged, sampled run; capture the inputs the
    # sampler and the page gather got from it (first full-batch call) and
    # those the page allocator's scan and search got (first call)
    captured = {}
    sizes = {"accumulate": [], "searchsorted": []}
    batched = ("nucleus_mask", "topk", "page_gather")
    prims = {n: registry.get(n) for n in batched + tuple(sizes)}
    originals = {n: p.cuda_impl for n, p in prims.items()}

    def capturing(name, impl):
        def call(*a, **kw):
            if name in sizes:
                sizes[name].append(a[0].numel())
            if name not in captured and (name in sizes
                                         or a[-1].shape[0] == SV.SLOTS):
                captured[name] = ([tuple(y.clone() for y in x)
                                   if isinstance(x, tuple) else x.clone()
                                   for x in a], dict(kw))
            return impl(*a, **kw)
        return call

    for n, p in prims.items():
        p.cuda_impl = capturing(n, originals[n])
    try:
        registry.reset_stats()
        torch.cuda.synchronize()
        C.reset_launch_count()
        t0 = time.perf_counter()
        sampled, st = SV.run(w, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, kern = C.launch_counts(), C.kernel_launches()
        pstats = registry.stats()
    finally:
        for n, p in prims.items():
            p.cuda_impl = originals[n]
    out["engine"] = dict(SV.summary(st), wall_s=wall)
    out["launches_by_primitive"] = counts
    out["kernel_launches"] = kern
    check(st.tokens == SV.REQUESTS * SV.MAX_NEW
          and all(len(t) == SV.MAX_NEW for t in sampled.values()),
          f"paged run emitted {st.tokens} tokens")
    check(all(0 <= x < cfg.vocab for t in sampled.values() for x in t),
          "a sampled token outside the vocabulary")
    samples = st.steps + st.prefills     # one sampler call per each
    want = {
        "page_gather": st.steps * cfg.n_layers,   # K and V in one launch
        "nucleus_mask": samples,
    }
    for name, n in want.items():
        check(kern.get(name) == n,
              f"{name} launched {kern.get(name)} times, closed form {n}")
    check(counts.get("topk") == samples * SK.cross_launches(V),
          f"topk launches {counts.get('topk')}")
    check(counts.get("nucleus_mask") == samples * NK.nucleus_launches(V),
          f"nucleus_mask launches {counts.get('nucleus_mask')}")
    # the allocator: one accumulate + searchsortedfirst per page granted
    # (the engine allocates one page a call) over the whole pool
    allocs, pages = st.pages_allocated_total, SV.SLOTS * (
        w.cache_len // w.page_size)
    check(sizes["accumulate"] == [pages] * allocs
          and len(sizes["searchsorted"]) == allocs,
          f"allocator scans {len(sizes['accumulate'])} / searches "
          f"{len(sizes['searchsorted'])} for {allocs} pages granted")
    check(kern.get("scan") == allocs * SCK.scan_launches(pages)
          and kern.get("searchsorted") == allocs,
          f"allocator launches scan {kern.get('scan')} / searchsorted "
          f"{kern.get('searchsorted')}, closed forms "
          f"{allocs * SCK.scan_launches(pages)} / {allocs}")
    out["allocator"] = {"allocs": allocs, "pool_pages": pages}
    for name in batched + tuple(sizes):
        check(pstats[name]["portable_calls"] == 0
              and pstats[name]["calls"] > 0,
              f"{name} stats {pstats[name]}")
    log(f"serve: {SV.REQUESTS} requests x {SV.MAX_NEW} tokens, paged "
        f"({w.page_size}-token pages, T = {w.cache_len // w.page_size}), "
        f"{SV.SLOTS} slots: "
        f"{st.steps} decode steps, {st.tokens} tokens, "
        f"{st.tokens_per_s:.1f} tok/s, ttft p50 "
        f"{out['engine']['ttft_p50_ms']:.1f} ms p99 "
        f"{out['engine']['ttft_p99_ms']:.1f} ms; launches {kern}; "
        f"by primitive {counts}")

    # -- greedy: paged and contiguous must agree token for token
    g_paged, _ = SV.run(w, temperature=0.0, seed=seed)
    g_contig, gst = SV.run(w, paged=False, temperature=0.0, seed=seed)
    check(g_paged == g_contig, "greedy paged != greedy contiguous tokens")
    out["engine_contiguous_greedy"] = SV.summary(gst)
    log("serve: greedy paged and contiguous runs emit the same tokens "
        f"({sum(len(t) for t in g_paged.values())} tokens)")

    # -- every kernel against its plain version on the path's inputs
    (free,), kw = captured["accumulate"]
    errs.same(["scan"], [SCK.scan_blocks(
        kw["op"], free, unit=kw["init"],
        exclusive=not kw.get("inclusive", True))],
        [KREF.scan_ref(kw["op"], free, unit=kw["init"],
                       exclusive=not kw.get("inclusive", True))],
        f"accumulate on the allocator's {free.numel()}-page free mask")
    (hay, qs), kw = captured["searchsorted"]
    side = kw.get("side", "left")
    errs.same(["searchsorted"], [SE.searchsorted_blocks(hay, qs, side=side)],
              [SE.searchsorted_plain(hay, qs, side=side)],
              "searchsortedfirst on the allocator's running free count")
    (pools, table), _ = captured["page_gather"]
    check(isinstance(pools, tuple) and len(pools) == 2,
          "the model's page gather did not take the K/V pair")
    errs.same(["page_gather"], PK.page_gather_blocks(pools, table),
              PK.page_gather_ref(pools, table),
              "page_gather of a decode step's K/V pools and table")
    for pool in pools:
        errs.same(["page_gather"], [PK.page_gather_blocks(pool, table)],
                  [PK.page_gather_ref(pool, table)],
                  "page_gather of one decode-step pool")
    (lg,), kw = captured["nucleus_mask"]
    top_p = kw["top_p"]
    neg, perm = NK.sorted_rows(lg, cuda=True)
    pneg, pperm = NK.sorted_rows(lg, cuda=False)
    errs.same(["bitonic_inblock", "bitonic_window"], [neg, perm],
              [pneg, pperm], "batched sort network of the nucleus mask")
    check(torch.equal(perm[:, :V].long(),
                      torch.sort(-(lg + 0.0), dim=1, stable=True).indices),
          "nucleus sortperm != torch.sort(stable=True)")
    got = NK.mask_kernel(neg, perm, n=V, top_p=top_p, cuda=True)
    plain = NK.mask_kernel(neg, perm, n=V, top_p=top_p, cuda=False)
    ref = NK.nucleus_mask_ref(lg, top_p=top_p)
    near = (_exclusive_cum64(neg, perm, V) - top_p).abs() < 1e-5
    far = ~near
    check(torch.equal(got[far], plain[far]) and torch.equal(got[far],
                                                           ref[far]),
          "nucleus mask differs from its plain version away from the cut")
    # over every lane: 1.0 where any mask byte differs (only near the cut)
    errs.record("nucleus_mask",
                float((got.int() - plain.int()).abs().max()))
    out["nucleus_near_cut"] = {
        "ranks_within_1e-5": int(near.sum()),
        "lanes_differ": int((got != plain).sum()),
        "kernel_vs_plain_differ_there": int((got != plain)[near].sum()),
        "kept_per_row": got.sum(dim=1).tolist()}
    log(f"serve: nucleus mask (top_p {top_p}) == plain version and "
        f"nucleus_mask_ref on {lg.shape[0]} x {V} logits of a decode step "
        f"except near the cut: {out['nucleus_near_cut']}")
    (lk,), kw = captured["topk"]
    k = kw["k"]
    check(torch.equal(SK.bitonic_argsort_batched(lk).long(),
                      torch.sort(lk, dim=1, stable=True).indices),
          "batched argsort != torch.sort(stable=True)")
    tv, ti = SK.bitonic_topk_batched(lk, k)
    check(torch.equal(tv, torch.topk(lk, k).values) and torch.equal(
        ti.long(), torch.sort(lk, dim=1, descending=True,
                              stable=True).indices[:, :k]),
          "batched topk != torch.topk values / stable descending order")
    log("serve: batched argsort and topk on the sampler's logits equal "
        "torch.sort(stable=True) and torch.topk")

    # -- the CLI, smoke config on the card
    res, cst = serve.main(["--device", "cuda", "--requests", "8",
                           "--slots", "4", "--paged"])
    check(all(r.status == COMPLETED for r in res.values())
          and cst.tokens == 8 * 32, "serve CLI did not complete")

    # -- timings at the path's shapes
    R = lg.shape[0]
    B, T = table.shape
    page_bytes = pools[0][0].numel() * pools[0].element_size()
    tl = table.long()
    rows = {}
    # the model's call: K and V through one table (read and write each)
    b, by = bound(2 * 2 * B * T * page_bytes + table.numel() * 4, 0)
    rows["page_gather"] = {
        "ms": cuda_ms(lambda: PK.page_gather_blocks(pools, table), reps=20),
        "plain_ms": cuda_ms(lambda: PK.page_gather_ref(pools, table),
                            reps=20),
        "library_ms": cuda_ms(lambda: (pools[0][tl], pools[1][tl]),
                              reps=20),
        "library": "pool[table] for K and for V (advanced indexing)",
        "bound_ms": b, "bound_by": by}
    # the mask kernel reads each valid lane's key and rank and writes its
    # mask byte: 9 bytes per valid lane; 2 exp, a divide, a compare each
    b, by = bound(R * V * 9, R * V * 4)
    rows["nucleus_mask"] = {
        "ms": cuda_ms(lambda: NK.mask_kernel(neg, perm, n=V, top_p=top_p,
                                             cuda=True), reps=20),
        "plain_ms": cuda_ms(lambda: NK.mask_kernel(
            neg, perm, n=V, top_p=top_p, cuda=False), reps=20),
        "library_ms": None,
        "library": "no single PyTorch call computes the top-p mask",
        "bound_ms": b, "bound_by": by,
        "lanes_differ": out["nucleus_near_cut"]["lanes_differ"],
        "ranks_near_cut": out["nucleus_near_cut"]["ranks_within_1e-5"]}
    out["sampler_ms"] = {
        "nucleus_mask_primitive": cuda_ms(
            lambda: NK.nucleus_mask_blocks(lg, top_p=top_p), reps=10),
        "nucleus_mask_ref_composition": cuda_ms(
            lambda: NK.nucleus_mask_ref(lg, top_p=top_p), reps=10),
        "topk_primitive": cuda_ms(lambda: SK.bitonic_topk_batched(lk, k),
                                  reps=10),
        "torch_topk": cuda_ms(lambda: torch.topk(lk, k), reps=10),
        "argsort_batched": cuda_ms(lambda: SK.bitonic_argsort_batched(lk),
                                   reps=10),
        "torch_sort_stable": cuda_ms(
            lambda: torch.sort(lk, dim=1, stable=True), reps=10),
    }
    out["rows"] = rows
    for name, r in rows.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']})")
    log(f"serve: sampler calls at {tuple(lg.shape)}, ms: "
        + json.dumps(out["sampler_ms"]))
    out["decode_step"] = SV.breakdown(w, seed=seed)
    log("serve: one paged decode step + sampler, device ms by category: "
        + json.dumps(out["decode_step"]))
    del w, pools, pool, table, lg, lk, neg, perm, pneg, pperm
    torch.cuda.empty_cache()
    return out


# name, B, Sq, Sk, H, KV, hd, causal, dtype: the GQA shapes of phase 8
# (tests/test_torch_attention.py's PHASE8 lists the path each takes)
ATTN_SHAPES = (
    ("internlm2-1.8B prefill", 8, 256, 256, 16, 8, 128, True,
     torch.bfloat16),
    ("granite-moe-1b prefill", 8, 256, 256, 16, 8, 64, True,
     torch.bfloat16),
    ("long prefill", 1, 8192, 8192, 16, 8, 128, True, torch.bfloat16),
    ("decode, ragged", 8, 1, 289, 16, 8, 128, False, torch.bfloat16),
    ("yi-34b smoke prefill, hd 8", 2, 64, 64, 7, 1, 8, True,
     torch.bfloat16),
    ("yi-34b smoke decode, hd 8", 2, 1, 64, 7, 1, 8, False, torch.bfloat16),
    ("prefill, hd 80", 4, 300, 300, 16, 8, 80, True, torch.bfloat16),
    ("prefill, hd 256", 2, 512, 512, 8, 4, 256, True, torch.bfloat16),
    ("decode, hd 256, f32", 4, 1, 1000, 8, 4, 256, False, torch.float32),
    ("prefill, hd 320", 2, 256, 256, 8, 4, 320, True, torch.bfloat16),
    ("prefill, hd 320, f32", 2, 256, 256, 8, 4, 320, True, torch.float32),
)
# (Sq, Sk) of tests/test_attention_kernel.py's grid: BH 4, hd 64, float32
ATTN_GRID = ((128, 512), (128, 1024), (256, 512), (100, 300), (1, 512))
# the kernels' row in the kernels line: the shape each is timed at
ATTN_ROW = {"flash_wgmma": "internlm2-1.8B prefill",
            "flash_decode": "decode, ragged",
            "flash_simt": "grid 128x512 causal=True"}


def visible_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs a head attends: all, or under the top-left
    causal mask min(i + 1, Sk) for query i."""
    if not causal:
        return Sq * Sk
    m = min(Sq, Sk)
    return m * (m + 1) // 2 + (Sq - m) * Sk


def attention_err(got, want, what) -> float:
    """|kernel - plain| within rtol 2e-4 / atol 2e-5 (the reference's
    attention tolerance), plus one bfloat16 ulp of the plain result for a
    bfloat16 output (both sides round their float32 result); returns the
    largest |difference|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = 2e-4 * w.abs() + 2e-5
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        lim = lim + torch.ldexp(torch.ones_like(w), e - 8)
    ok = (got.dtype == want.dtype and got.shape == want.shape
          and bool((err <= lim).all()))
    check(ok, f"{what}: flash kernel off its plain version by up to "
              f"{float(err.max())}")
    return float(err.max())


def phase_attention(C, errs) -> dict:
    """Phase 8: flash attention through its own entry points
    (``flash_attention_gqa`` at the serving shapes and the head dims 8,
    80, 256 and 320 (above 256: the CUDA-core kernel in column slices),
    ``flash_attention`` on the JAX test file's grid), counted:
    one launch per call under the kernel ``attention_path`` picks. Then
    each result against its plain version, timings beside the port's
    ``blockwise_attention`` (what the models run), SDPA (the library
    yardstick) and the bound (bf16 at the tensor-core rate). The table
    behind the path rule is ``benchmarks_torch/attention_paths.py``."""
    import torch.nn.functional as F
    from benchmarks_torch.launch_path import queued_device_us
    from repro_torch.kernels import attention_kernel as AK
    from repro_torch.kernels import ref as KREF
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    for name, B, Sq, Sk, H, KV, hd, causal, dt in ATTN_SHAPES:
        q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(B, Sk, KV, hd, generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        cases.append(dict(name=name, gqa=True, q=q, k=k, v=v, causal=causal,
                          heads=B * H, Sq=Sq, Sk=Sk, hd=hd,
                          path=AK.attention_path(B, Sq, Sk, H, KV, hd, dt,
                                                 causal)))
    for Sq, Sk in ATTN_GRID:
        for causal in (True, False):
            q = torch.randn(4, Sq, 64, generator=gen, device="cuda")
            k, v = (torch.randn(4, Sk, 64, generator=gen, device="cuda")
                    for _ in range(2))
            cases.append(dict(name=f"grid {Sq}x{Sk} causal={causal}",
                              gqa=False, q=q, k=k, v=v, causal=causal,
                              heads=4, Sq=Sq, Sk=Sk, hd=64,
                              path=AK.attention_path(4, Sq, Sk, 1, 1, 64,
                                                     q.dtype, causal)))

    def kernel(c, **kw):
        fn = AK.flash_attention_gqa if c["gqa"] else AK.flash_attention
        return fn(c["q"], c["k"], c["v"], causal=c["causal"], **kw)

    def plain(c):
        fn = (AK.flash_attention_gqa_ref if c["gqa"]
              else KREF.flash_attention_ref)
        return fn(c["q"], c["k"], c["v"], causal=c["causal"])

    def blockwise(c):
        q, k, v = c["q"], c["k"], c["v"]
        if not c["gqa"]:
            q, k, v = q[:, :, None], k[:, :, None], v[:, :, None]
        return L.blockwise_attention(q, k, v, causal=c["causal"])

    def sdpa(c):
        q, k, v = c["q"], c["k"], c["v"]
        if c["gqa"]:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        return F.scaled_dot_product_attention(
            q, k, v, is_causal=c["causal"],
            enable_gqa=q.shape[-3] != k.shape[-3])

    # the main path: every case once through its entry point
    torch.cuda.synchronize()
    C.reset_launch_count()
    outs = [kernel(c) for c in cases]
    torch.cuda.synchronize()
    kern = C.kernel_launches()
    want = {}
    for c in cases:
        name = AK.PATH_KERNELS[c["path"]]
        want[name] = want.get(name, 0) + 1
    check(kern == want, f"flash attention launches {kern}, closed form 1 "
                        f"per call under its path's kernel: {want}")
    rows = []
    for c, got in zip(cases, outs):
        name = AK.PATH_KERNELS[c["path"]]
        err = attention_err(got, plain(c), c["name"])
        errs.record(name, err)
        bp = (blockwise(c).reshape(got.shape).float()
              - got.float()).abs().max()
        q, k, v = c["q"], c["k"], c["v"]
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        ops = 4 * c["heads"] * c["hd"] * visible_pairs(c["Sq"], c["Sk"],
                                                        c["causal"])
        b, by = bound(nbytes, ops, BF16_OPS_PER_S
                      if q.dtype == torch.bfloat16 else F32_OPS_PER_S)
        reps = 3 if c["Sq"] > 4096 else 10
        dev = queued_device_us(lambda: kernel(c))
        lib_dev = queued_device_us(lambda: sdpa(c))
        rows.append({
            "shape": c["name"], "q": list(q.shape), "k": list(k.shape),
            "dtype": str(q.dtype), "causal": c["causal"], "path": c["path"],
            "kernel": name,
            "max_abs_err": err, "blockwise_vs_kernel_max_abs": float(bp),
            "ms": cuda_ms(lambda: kernel(c), reps=reps),
            "plain_ms": cuda_ms(lambda: plain(c), reps=reps),
            "blockwise_ms": cuda_ms(lambda: blockwise(c), reps=reps),
            "library_ms": cuda_ms(lambda: sdpa(c), reps=reps),
            "device_us": dev, "library_device_us": lib_dev,
            "bound_ms": b, "bound_by": by})
        r = rows[-1]
        log(f"  flash {r['shape']} {r['dtype']} [{c['path']}]: "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, blockwise "
            f"{r['blockwise_ms']:.4f}, sdpa {r['library_ms']:.4f}, bound "
            f"{b:.4f} ms by {by}); device {dev:.2f} us (sdpa "
            f"{lib_dev:.2f}); max |kernel - plain| {err:.3g}")
    del outs
    torch.cuda.empty_cache()
    return {"kernel_launches": kern, "rows": rows}


def phase_moe_serving(registry, C, errs, seed: int) -> dict:
    """Phase 9: granite-moe-1b at full width through the serving engine
    (``benchmarks_torch/serving.py --config granite_moe_1b``): a paged,
    sampled run with the launch counters set to 0 just before it, its
    launches against the closed forms (the prefill sortperm network, the
    sampler, the page gather, the allocator) and its portable calls (0
    for the page gather and the sampler; one ``segmented_reduce`` combine
    per MoE layer call); greedy paged and contiguous runs that must agree;
    the grouped-mm expert FFN against the per-expert loop on the inputs
    the run gave it; the CLI; tokens/s, TTFT and a decode-step breakdown.
    """
    from benchmarks_torch import serving as SV
    from repro_torch.kernels import nucleus_kernel as NK
    from repro_torch.kernels import scan_kernel as SCK
    from repro_torch.kernels import sort_kernel as SK
    from repro_torch.launch import serve
    from repro_torch.launch.engine import COMPLETED
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    out = {}
    t0 = time.perf_counter()
    w = SV.workload(seed, arch="granite_moe_1b")
    torch.cuda.synchronize()
    cfg = w.cfg
    V = cfg.padded_vocab(16)
    out["params"] = M.param_count(w.params)
    out["init_s"] = time.perf_counter() - t0
    log(f"moe serve: {cfg.name} at full width, {out['params']} parameters "
        f"(random bf16, seed {seed}), {cfg.n_experts} experts top-"
        f"{cfg.top_k}, vocab {cfg.vocab} padded to {V}; init "
        f"{out['init_s']:.1f} s")

    # the main path; capture the expert FFN's inputs (first decode-shaped
    # and first prefill-shaped call)
    captured = {}
    original = MOE._expert_ffn_bucketed

    def capturing(p, xs, counts, offsets, grouped=None):
        if xs.shape[0] not in captured:
            captured[xs.shape[0]] = (p, xs.clone(), counts.clone(),
                                     offsets.clone())
        return original(p, xs, counts, offsets, grouped)

    MOE._expert_ffn_bucketed = capturing
    try:
        registry.reset_stats()
        torch.cuda.synchronize()
        C.reset_launch_count()
        t0 = time.perf_counter()
        sampled, st = SV.run(w, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, kern = C.launch_counts(), C.kernel_launches()
        pstats = registry.stats()
    finally:
        MOE._expert_ffn_bucketed = original
    out["engine"] = dict(SV.summary(st), wall_s=wall)
    out["launches_by_primitive"] = counts
    out["kernel_launches"] = kern
    check(st.tokens == SV.REQUESTS * SV.MAX_NEW
          and all(len(t) == SV.MAX_NEW for t in sampled.values()),
          f"paged run emitted {st.tokens} tokens")
    check(all(0 <= x < cfg.vocab for t in sampled.values() for x in t),
          "a sampled token outside the vocabulary")
    samples = st.steps + st.prefills
    layer_calls = samples * cfg.n_layers          # MoE FFN calls
    routed = SV.PROMPT_LEN * cfg.top_k            # prefill sortperm keys
    want = {
        ("kernel", "page_gather"): st.steps * cfg.n_layers,
        ("kernel", "nucleus_mask"): samples,
        ("primitive", "topk"): samples * SK.cross_launches(V),
        ("primitive", "nucleus_mask"): samples * NK.nucleus_launches(V),
        ("primitive", "argsort"): (st.prefills * cfg.n_layers
                                   * SK.cross_launches(routed)),
    }
    allocs, pages = st.pages_allocated_total, SV.SLOTS * (
        w.cache_len // w.page_size)
    want[("kernel", "scan")] = allocs * SCK.scan_launches(pages)
    want[("kernel", "searchsorted")] = allocs
    for (kind, name), n in want.items():
        got = (kern if kind == "kernel" else counts).get(name)
        check(got == n, f"{kind} {name} launched {got} times, closed form "
                        f"{n}")
    for name in ("page_gather", "nucleus_mask", "topk", "argsort",
                 "accumulate", "searchsorted"):
        check(pstats[name]["portable_calls"] == 0
              and pstats[name]["calls"] > 0, f"{name} stats {pstats[name]}")
    seg = pstats["segmented_reduce"]
    check(seg["calls"] == seg["portable_calls"] == layer_calls,
          f"segmented_reduce stats {seg}, expected {layer_calls} portable "
          f"combines (one per MoE layer call)")
    out["closed_forms"] = {f"{k} {n}": v for (k, n), v in want.items()}
    out["segmented_reduce_portable"] = seg["portable_calls"]
    log(f"moe serve: {SV.REQUESTS} requests x {SV.MAX_NEW} tokens, paged, "
        f"{SV.SLOTS} slots: {st.steps} decode steps, {st.tokens} tokens, "
        f"{st.tokens_per_s:.1f} tok/s, ttft p50 "
        f"{out['engine']['ttft_p50_ms']:.1f} ms p99 "
        f"{out['engine']['ttft_p99_ms']:.1f} ms; launches {kern}; by "
        f"primitive {counts}; {seg['portable_calls']} portable combines")

    # greedy: paged and contiguous must agree token for token
    g_paged, _ = SV.run(w, temperature=0.0, seed=seed)
    g_contig, gst = SV.run(w, paged=False, temperature=0.0, seed=seed)
    check(g_paged == g_contig, "moe greedy paged != greedy contiguous")
    out["engine_contiguous_greedy"] = SV.summary(gst)
    log("moe serve: greedy paged and contiguous runs emit the same tokens "
        f"({sum(len(t) for t in g_paged.values())} tokens)")

    # the grouped-mm expert FFN against the per-expert loop
    check(SV.SLOTS * cfg.top_k in captured and routed in captured,
          f"expert FFN calls captured at {sorted(captured)} rows")
    out["expert_ffn"] = {}
    for rows in (SV.SLOTS * cfg.top_k, routed):
        p, xs, cnt, off = captured[rows]
        check(MOE.grouped_mm_applies(xs, p["w_gate"]),
              "torch._grouped_mm does not apply on the path's inputs")
        g = MOE._expert_ffn_bucketed(p, xs, cnt, off).float()
        lp = MOE._expert_ffn_bucketed(p, xs, cnt, off, False).float()
        diff, top = float((g - lp).abs().max()), float(lp.abs().max())
        check(diff <= 2 ** -6 * top,
              f"grouped-mm expert FFN off the loop by {diff} (largest "
              f"output {top}; limit two bf16 ulps of it)")
        out["expert_ffn"][rows] = {
            "max_abs_diff": diff, "largest": top,
            "grouped_ms": cuda_ms(lambda: MOE._expert_ffn_bucketed(
                p, xs, cnt, off), reps=10),
            "loop_ms": cuda_ms(lambda: MOE._expert_ffn_bucketed(
                p, xs, cnt, off, False), reps=10)}
    log("moe serve: grouped-mm expert FFN == per-expert loop within two "
        "bf16 ulps of the largest output: " + json.dumps(out["expert_ffn"]))

    res, cst = serve.main(["--device", "cuda", "--config", "granite_moe_1b",
                           "--requests", "8", "--slots", "4", "--paged"])
    check(all(r.status == COMPLETED for r in res.values())
          and cst.tokens == 8 * 32, "serve CLI (granite_moe_1b) did not "
                                    "complete")
    out["decode_step"] = SV.breakdown(w, seed=seed)
    log("moe serve: one paged decode step + sampler: "
        + json.dumps(out["decode_step"]))
    del w, captured
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="End-to-end check of the "
                                 "PyTorch port on one CUDA card")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the streaming phase's inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    sys.path.insert(0, ROOT)
    from repro_torch import core as ak
    from repro_torch.core import registry
    from repro_torch.core import distributed as D
    from repro_torch.kernels import _build
    from repro_torch.kernels import common as C
    from repro_torch.kernels import hist_kernel as HK
    from repro_torch.kernels import merge_kernel as MK
    from repro_torch.kernels import search_kernel as SE
    from repro_torch.kernels import sort_kernel as SK

    report = {}
    # -- 1. environment and build ------------------------------------------
    smi = nvidia_smi()
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    report["env"] = {
        "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": nvcc[-1] if nvcc else None,
        "device": torch.cuda.get_device_name(0), "build_s": build_s,
        "ptxas": {s: ptxas_functions(p.with_suffix(".log").read_text())
                  for s, p in libs.items()},
    }
    ptx = report["env"]["ptxas"]
    # the tensor-core kernel's SASS: wgmma appears as HGMMA
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump"), "-sass",
         str(libs["attention"])], capture_output=True, text=True,
        timeout=300).stdout
    hgmma = [ln.strip() for ln in sass.splitlines() if "HGMMA" in ln]
    report["env"]["attention_sass"] = {"hgmma_instructions": len(hgmma),
                                       "first": hgmma[:4]}
    check(hgmma, "no wgmma (HGMMA) instruction in the attention library")
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{report['env']['nvcc']}")
    log(f"kernel build: {build_s:.3f} s; {len(hgmma)} HGMMA instructions "
        f"in the attention library's SASS")

    # -- 2. every kernel against its plain version, bitwise ------------------
    t0 = time.perf_counter()
    errs = phase_parity(SK, MK, HK, SE, C)
    log(f"parity: {sum(errs.cases.values())} kernel/plain comparisons "
        f"bitwise equal ({time.perf_counter() - t0:.1f} s)")

    # -- 3. main path on one card: 2^28 float32 keys -----------------------
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(MAIN_N, generator=gen, device="cuda")
    torch.cuda.synchronize()
    C.reset_launch_count()
    s = ak.merge_sort(x)
    p = ak.sortperm(x)
    torch.cuda.synchronize()
    main_counts = C.launch_counts()
    main_kernels = C.kernel_launches()
    closed = SK.cross_launches(MAIN_N)
    check(main_counts.get("sort") == closed == SORT_CLOSED["default"][0]
          < SORT_CLOSED["unfused"][0],
          f"merge_sort launches {main_counts} vs closed form {closed}")
    check(main_counts.get("argsort") == closed,
          f"sortperm launches {main_counts} vs closed form {closed}")
    ref = torch.sort(x, stable=True)
    check(torch.equal(s, ref.values), "merge_sort != torch.sort")
    check(p.dtype == torch.int32 and torch.equal(p.long(), ref.indices),
          "sortperm != torch.sort(stable=True).indices")
    del s, p, ref
    log(f"main path: merge_sort + sortperm of 2^28 f32 keys match "
        f"torch.sort(stable=True); launches {main_counts} "
        f"(closed form {closed} each)")

    # -- 4. SIHSort, 4 ranks on the card -----------------------------------
    gx = torch.randn(RANKS * RANK_N, generator=gen, device="cuda")
    gp = torch.arange(RANKS * RANK_N, device="cuda", dtype=torch.int32)
    t0 = time.perf_counter()
    res, stats = ak.sihsort_sharded_with_stats(
        gx.cpu(), RANKS, payload=gp.cpu(), device="cuda", nbins=256,
        capacity_factor=2.0, refine_rounds=16, repeats=6)
    wall = time.perf_counter() - t0
    cap = D.exchange_capacity(RANK_N, RANKS, 2.0,
                              [torch.float32, torch.int32])
    want_sort = SK.cross_launches(RANK_N)
    want_merge = MK.merge_launches(RANKS * cap, RANKS)
    check(int(res.overflow.sum()) == 0, f"overflow {res.overflow}")
    ak.assert_no_overflow(res)
    got = ak.collect_sorted(res).cuda()
    check(torch.equal(got, torch.sort(gx).values),
          "sihsort != sort of the concatenation")
    counts = res.count.tolist()
    per_v = res.values.view(RANKS, -1)
    per_p = res.payload.view(RANKS, -1)
    pay = torch.cat([per_p[r, :counts[r]] for r in range(RANKS)]).cuda()
    check(torch.equal(gx[pay.long()], got), "payload did not ride its key")
    del per_v
    for r, st in enumerate(stats):
        check(sum(st.collectives.values()) == 19
              and st.collectives["all_to_all"] == 1,
              f"rank {r} collectives {st.collectives}")
        check(st.launches.get("sort_kv") == want_sort
              == SORT_CLOSED["default"][1],
              f"rank {r} local sort launches {st.launches}")
        check(st.launches.get("merge_kv") == want_merge
              == SORT_CLOSED["default"][2],
              f"rank {r} merge launches {st.launches}")
        check(want_merge < SK.cross_launches(RANKS * cap)
              == SORT_CLOSED["default"][3],
              "merge finish not below a re-sort")
    for name in REPLACES:
        main_kernels[name] = main_kernels.get(name, 0) + sum(
            st.kernel_launches.get(name, 0) for st in stats)
    for name in SORT_KERNELS:
        check(main_kernels.get(name, 0) > 0,
              f"kernel {name} never launched on the sort path")
    sih_ms = statistics.median(
        [statistics.median(st.seconds[1:]) for st in stats]) * 1e3
    steps = {k: statistics.median([st.steps_ms.get(k, 0.0) for st in stats])
             for k in stats[0].steps_ms}
    report["sihsort"] = {
        "ranks": RANKS, "keys_per_rank": RANK_N, "cap": cap,
        "rank_launches": [st.launches for st in stats],
        "rank_collectives": [st.collectives for st in stats],
        "rank_seconds": [st.seconds for st in stats],
        "launcher_wall_s": wall, "median_ms": sih_ms,
        "rank_steps_ms": [st.steps_ms for st in stats],
        "median_steps_ms": steps,
    }
    log(f"sihsort: 4 ranks x 2^26 keys + payload sorted, zero overflow, "
        f"19 collectives and launches sort_kv {want_sort} / merge_kv "
        f"{want_merge} (re-sort would be {SK.cross_launches(RANKS * cap)}) "
        f"per rank; median {sih_ms:.3f} ms per sort, launcher wall "
        f"{wall:.1f} s")
    log("sihsort steps (median over ranks, ms, traced run): "
        + json.dumps(steps))
    del res, got, pay

    # -- 5. kernel against plain, then timings, at the main path's shapes --
    shard = torch.sort(gx[:RANK_N]).values
    lo, hi = (float(v) for v in torch.aminmax(gx))  # SIHSort's global range
    q = shard[torch.tensor([RANK_N // 4, RANK_N // 2, 3 * RANK_N // 4],
                           device="cuda")]
    t0 = time.perf_counter()
    phase_main_parity(SK, MK, HK, SE, errs, x, gx, gp, cap, shard, lo, hi,
                      q)
    log(f"parity at the main path's shapes: bitwise equal "
        f"({time.perf_counter() - t0:.1f} s); comparisons per kernel "
        + json.dumps(errs.cases))
    nb = MAIN_N * 4
    timing = {}
    sort_ms = cuda_ms(lambda: ak.merge_sort(x))
    perm_ms = cuda_ms(lambda: ak.sortperm(x))
    lib_sort_ms = cuda_ms(lambda: torch.sort(x))
    lib_perm_ms = cuda_ms(lambda: torch.sort(x, stable=True))
    timing["main_path"] = {
        "merge_sort_ms": sort_ms, "sortperm_ms": perm_ms,
        "torch_sort_ms": lib_sort_ms, "torch_sort_stable_ms": lib_perm_ms,
        "merge_sort_GBps": nb / sort_ms / 1e6,
        "sortperm_GBps": nb / perm_ms / 1e6,
        "sihsort_ms": sih_ms,
        "sihsort_GBps": RANKS * RANK_N * 4 / sih_ms / 1e6,
    }
    fresh = lambda: (x.clone(),)  # noqa: E731 (in-place kernels)
    kernels = []

    def entry(name, ms, plain_ms, lib_ms, nbytes, ops):
        b, by = bound(nbytes, ops)
        src, rep = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": main_kernels.get(name, 0),
            "max_abs_err": errs.err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms,
        })

    # The in-block kernel: the initial launch (phases 2 .. 8192, 91 stages)
    # and one finish (phase 2^28, its 13 in-block stages), one launch each
    # over the 2^28 keys. Device us: 20 calls queued behind a sleep kernel,
    # in place on one buffer (the network is oblivious: its time does not
    # depend on the keys). The yardstick is torch.sort of the 8192-key
    # rows, which the finish computes on the network's own input (blocks
    # that are bitonic sequences).
    from benchmarks_torch.launch_path import queued_device_us
    lib_rows = lambda: torch.sort(x.view(-1, 8192), dim=1)  # noqa: E731
    work = x.clone()
    for label, k_lo, k_hi, stages in (("initial", 2, 8192, sum(range(1, 14))),
                                      ("finish", MAIN_N, MAIN_N, 13)):
        run = (lambda k, c, k_lo=k_lo, k_hi=k_hi: SK._run_inblock(
            k, None, k_lo, k_hi, 8192, False, c))
        b, by = bound(2 * nb, MAIN_N // 2 * stages)
        row = {"ms": cuda_ms(lambda k: run(k, True), fresh),
               "plain_ms": cuda_ms(lambda k: run(k, False), fresh, reps=3),
               "library_ms": cuda_ms(lib_rows), "bound_ms": b,
               "bound_by": by,
               "device_us": queued_device_us(lambda: run(work, True))}
        if label == "initial":
            entry("bitonic_inblock", row["ms"], row["plain_ms"],
                  row["library_ms"], 2 * nb, MAIN_N // 2 * stages)
            kernels[-1]["device_us"] = row["device_us"]
        else:
            kernels[-1]["finish"] = row
    del work
    # The top window of the last phase (k = N, distances N/2 .. N/2^w) on
    # a bitonic sequence, which is what the network feeds it: its groups
    # are the columns of view(2^w, -1), each bitonic, so the window sorts
    # each column and one torch.sort along dim 0 computes it (at w = 1,
    # the unfused stage, on any input: the min and max of the halves).
    half = MAIN_N // 2
    xb = torch.cat([torch.sort(x[:half]).values,
                    torch.sort(x[half:], descending=True).values])
    bitonic = lambda: (xb.clone(),)  # noqa: E731
    w = SK.HYPER_ORDER
    for name, run, width in (
            ("bitonic_window", lambda k, c: SK._run_window(
                k, None, MAIN_N, half, w, False, c), w),):
        lib = lambda: torch.sort(xb.view(1 << width, -1), dim=0)  # noqa: E731
        got = run(xb.clone(), True)[0]
        check(torch.equal(got, lib().values.reshape(-1)),
              f"{name}: the top window of phase N on a bitonic sequence != "
              f"torch.sort of view({1 << width}, -1) along dim 0")
        # in place: every key is read, only the keys that change need a
        # write (the kernels store swapped pairs only)
        moved = int((got != xb).sum())
        entry(name, cuda_ms(lambda k: run(k, True), bitonic),
              cuda_ms(lambda k: run(k, False), bitonic, reps=3),
              cuda_ms(lib), nb + 4 * moved, MAIN_N // 2 * width)
        kernels[-1]["keys_moved"] = moved
        del got
    del xb
    entry("minmax_histogram",
          cuda_ms(lambda: HK.minmax_histogram_blocks(shard, 256, lo, hi)),
          cuda_ms(lambda: HK.minmax_histogram_plain(shard, 256, lo, hi)),
          cuda_ms(lambda: (torch.aminmax(shard),
                           torch.histc(shard, 256, lo, hi))),
          RANK_N * 4 + 256 * 4 + 8, 2 * RANK_N)
    kernels[-1]["device_us"] = queued_device_us(
        lambda: HK.minmax_histogram_blocks(shard, 256, lo, hi))
    probes = math.ceil(math.log2(RANK_N + 1))
    entry("searchsorted",
          cuda_ms(lambda: SE.searchsorted_blocks(shard, q, side="right")),
          cuda_ms(lambda: SE.searchsorted_plain(shard, q, side="right")),
          cuda_ms(lambda: torch.searchsorted(shard, q, right=True)),
          3 * (4 + 4 + 4 * probes), 3 * probes)
    t0 = time.perf_counter()
    sweep = phase_hyper_sweep(ak, registry, SK, MK, C, errs, x, gx, gp, cap)
    for name, n in sweep["kernel_launches"].items():
        main_kernels[name] = main_kernels.get(name, 0) + n
    for k in kernels:
        k["launches"] = main_kernels[k["name"]]
    timing["sort_hyper_sweep"] = sweep
    log(f"sort_hyper sweep ({time.perf_counter() - t0:.1f} s): fastest "
        f"merge_sort at m = {sweep['fastest_merge_sort_m']} (default "
        f"{SK.HYPER_ORDER}); torch.sort {sweep['torch_sort_ms']:.3f} ms, "
        f"one pass's byte bound {sweep['bound_ms_one_pass']:.3f} ms")
    report["timing"] = timing
    report["kernels"] = kernels
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}), {k['launches']} launches on the main path")
    log("main path: " + json.dumps(timing["main_path"]))
    del x, gx, gp, shard
    cross = phase_crossover(registry)
    report["crossover"] = cross
    log("smallest size from which the kernels are as fast as the portable "
        "path at every larger size of the sweep (null: none): " + json.dumps(
        {p: cross[p] for p in ("sort", "sort_kv", "merge", "merge_kv")}))

    # -- 6. the streaming and segmented path --------------------------------
    t0 = time.perf_counter()
    stream = phase_streaming(ak, registry, C, errs, args.seed)
    report["streaming"] = stream
    for name, n in stream["kernel_launches"].items():
        main_kernels[name] = main_kernels.get(name, 0) + n
    for name in REPLACES:
        check(name in LATER_KERNELS or main_kernels.get(name, 0) > 0,
              f"kernel {name} never launched on a main path")
    rows = stream["rows"]
    for name, key in (("map", "map_ljg"), ("reduce", "reduce_add"),
                      ("scan", "accumulate_add"),
                      ("segmented_scan", "segmented_scan_incl")):
        r = rows[key]
        b, by = r["bound_ms"], r["bound_by"]
        src, rep = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": main_kernels.get(name, 0),
            "max_abs_err": errs.err[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b,
            "bound_by": by, "library_ms": r["library_ms"],
        })
        for f in ("device_us", "library_device_us"):
            if f in r:  # rows timed by queued events
                kernels[-1][f] = r[f]
    log(f"phase 6 done in {time.perf_counter() - t0:.1f} s; comparisons "
        f"per kernel " + json.dumps(errs.cases))

    # -- 7. the serving path --------------------------------------------------
    t0 = time.perf_counter()
    serving = phase_serving(registry, C, errs, args.seed)
    report["serving"] = serving
    for name, n in serving["kernel_launches"].items():
        main_kernels[name] = main_kernels.get(name, 0) + n
    for name, r in serving["rows"].items():
        src, rep = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": main_kernels.get(name, 0),
            "max_abs_err": errs.err[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("lanes_differ", "ranks_near_cut")
               if k in r},
        })
    log(f"phase 7 done in {time.perf_counter() - t0:.1f} s; comparisons "
        f"per kernel " + json.dumps(errs.cases))

    # -- 8. flash attention on its own entry point ---------------------------
    t0 = time.perf_counter()
    attn = phase_attention(C, errs)
    report["attention"] = attn
    for name, n in attn["kernel_launches"].items():
        main_kernels[name] = main_kernels.get(name, 0) + n
    for name, shape in ATTN_ROW.items():
        r = next(r for r in attn["rows"] if r["shape"] == shape)
        src, rep = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": main_kernels.get(name, 0),
            "max_abs_err": errs.err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "device_us": r["device_us"],
            "library_device_us": r["library_device_us"]})
    log(f"phase 8 done in {time.perf_counter() - t0:.1f} s")

    # -- 9. granite-moe-1b through the serving engine ------------------------
    t0 = time.perf_counter()
    moe = phase_moe_serving(registry, C, errs, args.seed)
    report["serving_moe"] = moe
    for name, n in moe["kernel_launches"].items():
        main_kernels[name] = main_kernels.get(name, 0) + n
    for name in REPLACES:
        check(main_kernels.get(name, 0) > 0,
              f"kernel {name} never launched on a main path")
    for k in kernels:  # earlier kernels' launches now include phases 6-9
        k["launches"] = main_kernels[k["name"]]
    log(f"phase 9 done in {time.perf_counter() - t0:.1f} s")
    for k in kernels:  # the new kernels' registers and spills
        summary = ptxas_summary(ptx, k["name"])
        if summary is not None:
            k["ptxas"] = summary
    report["float64"] = errs.float64
    log(f"float add against float64, bound {stream['sum_rtol']:.4g} * "
        f"sum |x| (depth {stream['sum_depth']}): " + json.dumps(errs.float64))

    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
