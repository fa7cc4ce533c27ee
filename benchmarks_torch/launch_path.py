"""Where one call of the search and page-gather kernels spends its time,
on the card: device time per launch, host time per call, the one-call
event time, and the PyTorch call that computes the same function.

    PYTHONPATH=src:. python -m benchmarks_torch.launch_path [--out F]

Shapes are the main paths' (``chip_smoke.py`` phases 5 and 7):

- search: 3 float32 queries into a sorted 2^26-key shard, side 'right'
  (SIHSort's refinement and partition), each call with other queries
  drawn from the shard; and the allocator's ``searchsortedfirst`` of one
  query into a 320-entry int32 running count. A sweep over the number of
  queries gives the device time per launch of each kernel variant the
  package has (the count at which the warp-per-query search hands over to
  the thread-per-query one comes from it).
- page gather: internlm2-1.8B's decode step, 24 layers of K and V pools
  of 320 pages of 8 x 8 x 128 bfloat16 (16 KiB), through an 8 x 40 table
  (a random permutation), one layer after another as the model reads
  them: 240 MB in all, so a pool is not in the 50 MB L2 when its turn
  comes. One pool per call, and the K/V pair in one call where the
  package's gather takes a tuple (null otherwise).

Device time: ``torch.profiler`` kernel time over ``CALLS`` back-to-back
calls, divided by the calls. Host time: host clock over 2000 back-to-back
calls and one synchronise, the least of 9 rounds; one-call time: CUDA
events around one call after a synchronise, the median of 9 rounds. The
calls of one row (the kernel's wrapper, the registry call, the PyTorch
call) take their rounds in turns, so the host's noise, which differs
between machines and minutes, falls on all of them alike. The host split
of one page-gather call times each part the wrapper takes, alone.

To measure another tree of the package (a parent commit unpacked under
``build/``), put its ``src`` first on PYTHONPATH: the script uses only
calls that every version has. Prints the card's name and power limit,
then one JSON object. Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch import core as ak
from repro_torch.core import registry
from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels import page_kernel as PK
from repro_torch.kernels import search_kernel as SE

CALLS = 240                       # a multiple of the 24 layers
SHARD_N = 1 << 26
LAYERS, SLOTS, T, PS, KV, HD = 24, 8, 40, 8, 8, 128
POOL_PAGES = SLOTS * T
SWEEP_NQ = (1, 3, 32, 300, 1024, 4096, 6144, 8192, 16384, 65536, 1 << 18,
            1 << 20)


def device_us(fn, calls: int = CALLS, kernels: int = 0) -> float:
    """Device microseconds per call: every kernel ``fn`` launches, summed
    over ``calls`` warm calls in a profiler trace, over ``calls``. Raises
    when the trace holds fewer than ``kernels`` device events a call:
    traces on an H100 have dropped kernels (one in 20 calls of the
    single-pass max scan in every run), and would then read too short."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, seen = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total += float(getattr(evt, "self_device_time_total", 0.0)
                           or getattr(evt, "self_cuda_time_total", 0.0))
            seen += evt.count
    if seen < calls * kernels:
        raise RuntimeError(f"profiler trace holds {seen} device events for "
                           f"{calls} calls of {kernels} kernel(s) each")
    return total / calls


def queued_device_us(fn, calls: int = 20) -> float:
    """Device microseconds per call by CUDA events alone: ``calls`` warm
    calls queued behind a sleep kernel, so the host has launched them all
    before the first starts and the events see the device's time (the
    gaps between back-to-back kernels included). Lengthens the sleep
    while the host is slower than it, and raises if ``fn`` waits on the
    device (its calls can then not be queued)."""
    fn()
    torch.cuda.synchronize()
    for cycles in (1 << 25, 1 << 27, 1 << 29):  # ~17 ms to ~0.3 s
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        queued = not start.query()  # the sleep still runs
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) * 1e3 / calls
    raise RuntimeError("the calls could not be queued behind the sleep")


def row(fns: dict, rounds: int = 9, calls: int = 2000) -> dict:
    """Device us, host us and one-call ms of each of ``fns``, the host
    and one-call timings taken in turns (each function once a round) so
    that the host's noise falls on all of them alike. Host us: the least,
    over the rounds, of the host clock over ``calls`` back-to-back calls
    and one synchronise, per call; one-call ms: the median over the rounds
    of CUDA events around one call after a synchronise."""
    host = {k: [] for k in fns}
    one = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e6 / calls)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            one[name].append(start.elapsed_time(end))
    return {name: {"device_us": device_us(fn), "host_us": min(host[name]),
                   "host_us_median": statistics.median(host[name]),
                   "one_call_ms": statistics.median(one[name])}
            for name, fn in fns.items()}


def cycling(fn, args_list):
    """``fn`` called on the next entry of ``args_list`` at each call."""
    it = itertools.cycle(args_list)
    return lambda: fn(*next(it))


def search_rows(gen) -> dict:
    shard = torch.sort(torch.randn(SHARD_N, generator=gen,
                                   device="cuda")).values

    def queries(nq: int, calls: int = CALLS) -> list:
        """``calls`` sets of ``nq`` sorted keys of the shard, drawn anew
        for each measurement so that no set's probe path is left in L2 by
        an earlier one."""
        idx = torch.randint(0, SHARD_N, (calls, nq), generator=gen,
                            device="cuda")
        return [(q,) for q in torch.sort(shard[idx], dim=1).values]

    running = torch.cumsum(torch.randint(0, 2, (POOL_PAGES,), generator=gen,
                                         device="cuda"), 0).to(torch.int32)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    rows = {
        "shard_3q": row({
            "kernel": cycling(lambda q: SE.searchsorted_blocks(
                shard, q, side="right"), queries(3)),
            "registry": cycling(lambda q: ak.searchsortedlast(shard, q),
                                queries(3)),
            "library": cycling(lambda q: torch.searchsorted(
                shard, q, right=True), queries(3)),
        }),
        "allocator_1q": row({
            "kernel": lambda: SE.searchsorted_blocks(running, one),
            "registry": lambda: ak.searchsortedfirst(running, one),
            "library": lambda: torch.searchsorted(running, one),
        }),
    }
    # device us per launch against the number of queries, per variant
    if hasattr(SE, "_launch"):
        def variant(warp):
            def run(q):
                out = torch.empty(q.shape, dtype=torch.int32, device="cuda")
                SE._launch(shard, q, out, True, warp)
            return run
        variants = {"warp": variant(True), "thread": variant(False)}
    else:
        variants = {"thread": lambda q: SE.searchsorted_blocks(
            shard, q, side="right")}
    variants["library"] = lambda q: torch.searchsorted(shard, q, right=True)
    sweep = {}
    for nq in SWEEP_NQ:
        calls = max(8, min(CALLS, (1 << 22) // nq))
        sweep[nq] = {name: device_us(cycling(v, queries(nq, calls)), calls)
                     for name, v in variants.items()}
    rows["sweep_device_us"] = sweep
    return rows


def gather_rows(gen) -> dict:
    pools = [torch.randn(POOL_PAGES, PS, KV, HD, generator=gen,
                         device="cuda").to(torch.bfloat16)
             for _ in range(2 * LAYERS)]
    table = torch.randperm(POOL_PAGES, generator=gen, device="cuda").to(
        torch.int32).view(SLOTS, T)
    tl = table.long()
    singles = [(p,) for p in pools]
    pairs = [((pools[2 * i], pools[2 * i + 1]),) for i in range(LAYERS)]
    try:
        PK.page_gather_blocks(pairs[0][0], table)
        takes_pair = True
    except (AttributeError, TypeError):   # a gather of one pool only
        takes_pair = False
    rows = {
        "one_pool": row({
            "kernel": cycling(lambda p: PK.page_gather_blocks(p, table),
                              singles),
            "registry": cycling(
                lambda p: registry.call("page_gather", p, table), singles),
            "library": cycling(lambda p: p[tl], singles),
        }),
        "pair": None,
    }
    if takes_pair:
        rows["pair"] = row({
            "kernel": cycling(lambda kv: PK.page_gather_blocks(kv, table),
                              pairs),
            "registry": cycling(
                lambda kv: registry.call("page_gather", kv, table), pairs),
            "library": cycling(lambda kv: (kv[0][tl], kv[1][tl]), pairs),
        })
    # the host split of one one-pool call: each part alone
    pool = pools[0]
    shape = (SLOTS, T * PS, KV, HD)
    out = torch.empty(shape, dtype=pool.dtype, device="cuda")
    sig = PK._SIGNATURES
    lib = _build.library("page", sig)
    page_bytes = pool[0].numel() * pool.element_size()
    stream = _build.stream_handle(pool.device)
    if len(sig["ak_page_gather"]) == 7:      # one pool, boxed arguments
        args = (ctypes.c_void_p(pool.data_ptr()),
                ctypes.c_void_p(table.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), POOL_PAGES, SLOTS * T,
                page_bytes, stream)
    else:                                    # (pool0, pool1, npools, ...)
        args = (pool.data_ptr(), pool.data_ptr(), 1, table.data_ptr(),
                out.data_ptr(), POOL_PAGES, SLOTS * T, page_bytes, stream)
    parts = {
        "ctypes_launch": lambda: lib.ak_page_gather(*args),
        "torch_empty": lambda: torch.empty(shape, dtype=pool.dtype,
                                           device=pool.device),
        "library_lookup": lambda: _build.library("page", sig),
        "stream_handle": lambda: _build.stream_handle(pool.device),
        "count_launch": lambda: C.count_launch("page_gather"),
    }
    rows["one_pool_host_split_us"] = {
        k: v["host_us"] for k, v in row(parts).items()}
    C.reset_launch_count()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_path measures the card; no CUDA device "
                         "found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.build_all(("search", "page"))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"package": repro_torch.__file__, "card": smi,
           "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "raw_stream": hasattr(torch._C, "_cuda_getCurrentRawStream"),
           "search": search_rows(gen), "page_gather": gather_rows(gen)}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
