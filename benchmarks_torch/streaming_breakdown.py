"""Where the time of the streaming and segmented primitives goes, on the card.

    PYTHONPATH=src python -m benchmarks_torch.streaming_breakdown [--out F]

Runs each primitive of ``chip_smoke.py``'s phase 6 on the same inputs
(``streaming_inputs.stream_inputs``: RBF and LJG over 2^26 points, reduce /
accumulate / segmented reduce and scan over 2^28 float32 values in 2^20
geometric segments, segmented sort of 2^26 values in 2^18 segments), warm,
under ``torch.profiler``, and prints per
call: the host-clock time (device synchronised), the device time summed
over its kernels, the idle share of the device ``1 - device / wall``, and
the kernels that took the time, largest first. Needs a card; writes the
rows as JSON to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks_torch import arithmetic as AR
from benchmarks_torch import streaming_inputs as SI
from repro_torch import core as ak
from repro_torch.kernels import map_kernel as MAPK

REPS = 3


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def breakdown(fn) -> dict:
    """Profile ``REPS`` warm calls of ``fn``; per-call wall and device ms
    and the kernels by device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / REPS
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / REPS
    device = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": max(0.0, 1.0 - device / wall) if wall else None,
            "kernels_ms": dict(top)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("streaming_breakdown measures the card; no CUDA "
                         "device found")
    inp = SI.stream_inputs(args.seed)
    v, p2, x, off = inp.v, inp.p2, inp.x, inp.off
    sv, soff, spay = inp.sv, inp.soff, inp.spay
    e = AR.ljg_kernel(v, p2)
    calls = {
        "map_rbf": lambda: AR.rbf_kernel(v),
        "map_ljg": lambda: AR.ljg_kernel(v, p2),
        "mapreduce_energy": lambda: ak.mapreduce(MAPK.identity, torch.add,
                                                 e, init=0.0),
        "reduce_add": lambda: ak.reduce(torch.add, x, init=0.0),
        "accumulate_add": lambda: ak.accumulate(torch.add, x, init=0.0),
        "segmented_reduce_add": lambda: ak.segmented_reduce(
            torch.add, x, off, init=0.0),
        "segmented_scan_incl": lambda: ak.segmented_scan(torch.add, x, off,
                                                         init=0.0),
        "segmented_sort": lambda: ak.segmented_sort(sv, soff),
        "segmented_sort_payload": lambda: ak.segmented_sort(sv, soff,
                                                            vals=spay),
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi or torch.cuda.get_device_name(0))
    rows = {}
    for name, fn in calls.items():
        rows[name] = r = breakdown(fn)
        idle = r["idle_share"]
        print(f"{name}: wall {r['wall_ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} ms, idle "
              f"{'n/a' if idle is None or math.isnan(idle) else f'{idle:.3f}'}"
              f"; " + ", ".join(f"{k[:60]} {ms:.4f}"
                                for k, ms in r["kernels_ms"].items()))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
