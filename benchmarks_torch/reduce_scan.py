"""The reduce and the scan at the streaming path's size, on the card, for
the tree of the package on PYTHONPATH.

    PYTHONPATH=src:. python -m benchmarks_torch.reduce_scan [--out F]

Inputs, made on the card from ``--seed``: 2^28 float32 normals and 2^28
int32 in [-1000, 1000) (the sizes and draws ``chip_smoke.py``'s phase 6
reduces and scans), and the page allocator's scan, 320 int32 in {0, 1}
(one tile). For each call through the user entry points
(``ak.reduce``, ``ak.accumulate``): ms by CUDA events (median of 7);
device us by CUDA events around 20 calls queued behind a sleep kernel
(``launch_path.queued_device_us``, the method of ``chip_smoke.py``), for
it and for the PyTorch call that computes the same function, and, as a
check, by ``torch.profiler`` for it alone (20 calls; null, with the
error, where the trace holds fewer kernels than the calls launched);
kernel launches per call by name; the byte bound (each input read once,
each output written once, at 3.35 TB/s); and the PyTorch call's ms,
timed in turns with it.

To measure a parent commit in the same machine call, unpack it under
``build/`` (``git archive <commit> | tar -x -C build/parent``) and run
this script with ``PYTHONPATH=build/parent/src:.``: it uses only calls
that every version of the package has. Run parent, change, change,
parent and compare within the call. Prints the card's name and power
limit, then one JSON object. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

import repro_torch
from benchmarks_torch.launch_path import device_us, queued_device_us
from repro_torch import core as ak
from repro_torch.kernels import common as C

N = 1 << 28
ALLOC_N = 320
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


def events_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of one warm call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def calls(seed: int) -> dict:
    """name -> (the port's call, the PyTorch call, its name, bytes)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, generator=gen, device="cuda")
    xi = torch.randint(-1000, 1000, (N,), generator=gen, device="cuda",
                       dtype=torch.int32)
    free = torch.randint(0, 2, (ALLOC_N,), generator=gen, device="cuda",
                         dtype=torch.int32)
    nb, inf = N * 4, math.inf
    return {
        "reduce_add": (lambda: ak.reduce(torch.add, x, init=0.0),
                       lambda: torch.sum(x), "torch.sum", nb),
        "reduce_max": (lambda: ak.reduce(torch.maximum, x, init=-inf),
                       lambda: torch.amax(x), "torch.amax", nb),
        "reduce_min": (lambda: ak.reduce(torch.minimum, x, init=inf),
                       lambda: torch.amin(x), "torch.amin", nb),
        "accumulate_add": (lambda: ak.accumulate(torch.add, x, init=0.0),
                           lambda: torch.cumsum(x, 0), "torch.cumsum",
                           2 * nb),
        "accumulate_max": (
            lambda: ak.accumulate(torch.maximum, x, init=-inf),
            lambda: torch.cummax(x, 0),
            "torch.cummax (also writes int64 indices)", 2 * nb),
        "accumulate_excl_int32": (
            lambda: ak.accumulate(torch.add, xi, init=0, inclusive=False),
            lambda: torch.cumsum(xi, 0, dtype=torch.int32),
            "torch.cumsum (inclusive)", 2 * nb),
        "accumulate_alloc_320": (
            lambda: ak.accumulate(torch.add, free, init=0),
            lambda: torch.cumsum(free, 0, dtype=torch.int32),
            "torch.cumsum", 2 * ALLOC_N * 4),
    }


def measure(fn, lib, nbytes: int) -> dict:
    fn()
    torch.cuda.synchronize()
    C.reset_launch_count()
    fn()
    torch.cuda.synchronize()
    launches = C.kernel_launches()
    ms, lib_ms = [], []
    for _ in range(2):  # the port's call and the library's in turns
        ms.append(events_ms(fn))
        lib_ms.append(events_ms(lib))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    dev = queued_device_us(fn)
    try:
        prof, prof_error = device_us(
            fn, calls=20, kernels=sum(launches.values())), None
    except RuntimeError as e:  # the trace dropped kernels: no number
        prof, prof_error = None, str(e)
    return {"ms": min(ms), "device_us": dev, "launches": launches,
            "profiler_device_us": prof, "profiler_error": prof_error,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "share_of_bound": bound_ms * 1e3 / dev,
            "library_ms": min(lib_ms),
            "library_device_us": queued_device_us(lib)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("reduce_scan measures the card; no CUDA device "
                         "found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi or torch.cuda.get_device_name(0), flush=True)
    rows = {}
    for name, (fn, lib, lib_name, nbytes) in calls(args.seed).items():
        rows[name] = r = measure(fn, lib, nbytes)
        r["library"] = lib_name
        print(f"{name}: {r['ms']:.4f} ms, device {r['device_us']:.2f} us "
              f"(profiler {r['profiler_device_us'] or r['profiler_error']}) "
              f"({r['share_of_bound']:.2f} of the bound "
              f"{r['bound_ms']:.4f} ms), launches {r['launches']}; "
              f"{lib_name} {r['library_ms']:.4f} ms, device "
              f"{r['library_device_us']:.2f} us", flush=True)
    result = {"tree": repro_torch.__file__, "device":
              torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
