#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main path: the AK sort primitives at 2^28 float32 keys
and SIHSort over 4 ranks on the one card (2^26 keys + int32 payload per
rank). Phases:

  1. environment: card name and power limit, torch / CUDA / nvcc
     versions, kernel build time;
  2. every kernel held bitwise against its plain PyTorch version on the
     card (sort network, k-way merge, histogram, search);
  3. ``merge_sort`` and ``sortperm`` of 2^28 float32 keys, checked against
     ``torch.sort(stable=True)``, launches against the closed form;
  4. SIHSort, 4 ranks x 2^26 keys + payload: the sorted concatenation,
     payload integrity, zero overflow, 19 collectives and the closed-form
     launches per rank;
  5. every kernel held bitwise against its plain version again, on the
     main path's own inputs: the stages timed below, the whole networks
     of phases 3 and 4 (2^28 keys, the 2^26-key kv sort, the 2^27-key
     merge) and the histogram and search of a 2^26-key shard; then
     timings (CUDA events, median of 5 after a warm-up) of each kernel at
     those shapes beside its plain version, a PyTorch call that computes
     the same function, and its bound; and a sweep of the sort and merge
     primitives over 2^8..2^16 keys, kernels against the portable path,
     which gives the size from which the kernels win (``switch_below``).

Launch counters are set to 0 just before phases 3 and 4 and read just
after; the kernels' ``launches`` are those runs' counts. The last line of
standard output is ``{"ok": true, "device": {...}}``; it is printed only
when every phase passed. Without a CUDA device, or without the repo's
``src/`` beside it, the script exits non-zero and prints no result.
Details too long for the console go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

MAIN_N = 1 << 28
RANKS = 4
RANK_N = 1 << 26
SIZES = [1, 5, 8191, 8193, 3 * 8192 + 7, 1 << 20]
DTYPES = (torch.float32, torch.int32, torch.bfloat16)

REPLACES = {
    "bitonic_inblock": ("src/repro_torch/kernels/csrc/bitonic.cu",
                        "src/repro/kernels/sort_kernel.py:289"),
    "bitonic_cross": ("src/repro_torch/kernels/csrc/bitonic.cu",
                      "src/repro/kernels/sort_kernel.py:323"),
    "minmax_histogram": ("src/repro_torch/kernels/csrc/hist.cu",
                         "src/repro/kernels/hist_kernel.py:84"),
    "searchsorted": ("src/repro_torch/kernels/csrc/search.cu",
                     "src/repro/kernels/search_kernel.py:81"),
}


def log(*a):
    print(*a, flush=True)


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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Errors:
    """Largest |kernel - plain| per kernel over the parity cases."""

    def __init__(self):
        self.err = {k: 0.0 for k in REPLACES}
        self.cases = {k: 0 for k in REPLACES}

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


def keys_on(gen, n, dtype, dist="normal"):
    if dist == "duplicates" or dtype == torch.int32:
        hi = 5 if dist == "duplicates" else 500
        return torch.randint(-hi, hi, (n,), generator=gen, device="cuda",
                             dtype=torch.int32).to(dtype)
    return torch.randn(n, generator=gen, device="cuda").to(dtype)


def phase_parity(SK, MK, HK, SE) -> Errors:
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = Errors()
    both = ("bitonic_inblock", "bitonic_cross")
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
        a, _ = SK._run_cross(x.clone(), None, 1 << 20, 1 << 16, False, True)
        b, _ = SK._run_cross(x.clone(), None, 1 << 20, 1 << 16, False, False)
        errs.same(["bitonic_cross"], [a], [b], f"cross {dtype}")
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
            idx = torch.randint(0, hay.numel(), (300,), generator=gen,
                                device="cuda")
            q = torch.cat([hay[idx], keys_on(gen, 300, dtype), top])
            for side in ("left", "right"):
                errs.same(["searchsorted"],
                          [SE.searchsorted_blocks(hay, q, side=side)],
                          [SE.searchsorted_plain(hay, q, side=side)],
                          f"search {dtype} n={n} {side}")
    torch.cuda.synchronize()
    return errs


def phase_main_parity(SK, MK, HK, SE, errs, x, gx, gp, cap, shard, lo, hi,
                      q) -> None:
    """The kernels against their plain versions on the main path's inputs
    (launches here are not counted in the main path's runs)."""
    both = ("bitonic_inblock", "bitonic_cross")
    for name, run, args in (
            ("bitonic_inblock", SK._run_inblock, (2, 8192, 8192, False)),
            ("bitonic_cross", SK._run_cross, (MAIN_N, MAIN_N // 2, False))):
        got, _ = run(x.clone(), None, *args, True)
        want, _ = run(x.clone(), None, *args, False)
        errs.same([name], [got], [want], f"{name} stage, 2^28 keys")
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
    for side in ("left", "right"):
        errs.same(["searchsorted"],
                  [SE.searchsorted_blocks(shard, q, side=side)],
                  [SE.searchsorted_plain(shard, q, side=side)],
                  f"search of a 2^26-key shard, {side}")
    torch.cuda.synchronize()


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
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
        "ptxas": {s: [ln for ln in p.with_suffix(".log").read_text()
                      .splitlines() if "registers" in ln or "spill" in ln]
                  for s, p in libs.items()},
    }
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{report['env']['nvcc']}")
    log(f"kernel build: {build_s:.3f} s")

    # -- 2. every kernel against its plain version, bitwise ------------------
    t0 = time.perf_counter()
    errs = phase_parity(SK, MK, HK, SE)
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
    check(main_counts.get("sort") == closed == 136,
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
        check(st.launches.get("sort_kv") == want_sort == 105,
              f"rank {r} local sort launches {st.launches}")
        check(st.launches.get("merge_kv") == want_merge == 29,
              f"rank {r} merge launches {st.launches}")
        check(want_merge < SK.cross_launches(RANKS * cap) == 120,
              "merge finish not below a re-sort")
    for name in REPLACES:
        main_kernels[name] = main_kernels.get(name, 0) + sum(
            st.kernel_launches.get(name, 0) for st in stats)
    for name in REPLACES:
        check(main_kernels.get(name, 0) > 0,
              f"kernel {name} never launched on the main path")
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
            "launches": main_kernels[name], "max_abs_err": errs.err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms,
        })

    stages = sum(range(1, 14))  # k = 2 .. 8192: 1 + 2 + ... + 13 stages
    entry("bitonic_inblock",
          cuda_ms(lambda k: SK._run_inblock(k, None, 2, 8192, 8192, False,
                                            True), fresh),
          cuda_ms(lambda k: SK._run_inblock(k, None, 2, 8192, 8192, False,
                                            False), fresh, reps=3),
          cuda_ms(lambda: torch.sort(x.view(-1, 8192), dim=1)),
          2 * nb, MAIN_N // 2 * stages)
    entry("bitonic_cross",
          cuda_ms(lambda k: SK._run_cross(k, None, MAIN_N, MAIN_N // 2,
                                          False, True), fresh),
          cuda_ms(lambda k: SK._run_cross(k, None, MAIN_N, MAIN_N // 2,
                                          False, False), fresh),
          # every pair of this stage is ascending: the elementwise min and
          # max of the two halves, which a sort along a dimension of 2 is
          cuda_ms(lambda: torch.sort(x.view(2, -1), dim=0)),
          2 * nb, MAIN_N // 2)
    entry("minmax_histogram",
          cuda_ms(lambda: HK.minmax_histogram_blocks(shard, 256, lo, hi)),
          cuda_ms(lambda: HK.minmax_histogram_plain(shard, 256, lo, hi)),
          cuda_ms(lambda: (torch.aminmax(shard),
                           torch.histc(shard, 256, lo, hi))),
          RANK_N * 4 + 256 * 4 + 8, 2 * RANK_N)
    probes = math.ceil(math.log2(RANK_N + 1))
    entry("searchsorted",
          cuda_ms(lambda: SE.searchsorted_blocks(shard, q, side="right")),
          cuda_ms(lambda: SE.searchsorted_plain(shard, q, side="right")),
          cuda_ms(lambda: torch.searchsorted(shard, q, right=True)),
          3 * (4 + 4 + 4 * probes), 3 * probes)
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
