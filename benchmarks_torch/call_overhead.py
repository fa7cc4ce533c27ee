"""Host time per call of the streaming primitives, on the card.

    PYTHONPATH=src python -m benchmarks_torch.call_overhead [--calls C]

Makes ``C`` back-to-back calls of each primitive on 4096 float32 values,
where the card's work takes a few microseconds, synchronises once, and
reports the host-clock time per call (median of 5 such runs): the
registry, the wrapper with its allocations, and the launches, which the
card's work does not hide at that size. ``torch.add`` on the same tensor
is the floor of one PyTorch launch. Also reports the CUDA-event time of
one ``reduce`` add over 2^28 values (median of 5). Prints the card's name
and power limit, then one JSON object. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import torch

from repro_torch import core as ak

N_SMALL = 4096
N_LARGE = 1 << 28


def per_call_us(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e6 / calls)
    return statistics.median(runs)


def event_ms(fn) -> float:
    fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("call_overhead measures the card; no CUDA device "
                         "found")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N_SMALL, generator=gen, device="cuda")
    off = torch.arange(0, N_SMALL + 1, 64, device="cuda", dtype=torch.int32)
    calls = {
        "torch_add": lambda: torch.add(x, x),
        "reduce_add": lambda: ak.reduce(torch.add, x, init=0.0),
        "reduce_max": lambda: ak.reduce(torch.maximum, x, init=-math.inf),
        "accumulate_add": lambda: ak.accumulate(torch.add, x, init=0.0),
        "segmented_reduce_add": lambda: ak.segmented_reduce(
            torch.add, x, off, init=0.0),
    }
    rows = {k: per_call_us(fn, args.calls) for k, fn in calls.items()}
    big = torch.randn(N_LARGE, generator=gen, device="cuda")
    large_ms = event_ms(lambda: ak.reduce(torch.add, big, init=0.0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi or torch.cuda.get_device_name(0))
    print(json.dumps({"calls": args.calls, "n": N_SMALL,
                      "us_per_call": rows,
                      "reduce_add_2^28_event_ms": large_ms}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
