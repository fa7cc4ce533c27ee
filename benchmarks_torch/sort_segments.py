"""The in-block sort kernel, the sorts it serves and the segmented scan at
the main paths' sizes, on the card, for the tree of the package on
PYTHONPATH.

    PYTHONPATH=src:. python -m benchmarks_torch.sort_segments [--out F]

Inputs, made from ``--seed``: 2^28 float32 normals (the sort path's keys,
on the card from a torch generator, as ``chip_smoke.py`` phase 3 draws
them) with an int32 payload ``arange``; and the streaming path's CSR, 2^28
float32 normals in 2^20 geometric segments (``streaming_inputs``' draws).
Rows:

  * ``inblock_initial`` / ``inblock_finish``: one in-block launch over the
    2^28 keys, phases 2 .. 8192 (91 stages a block) or the finish of phase
    2^28 (13 stages); ``inblock_kv_tie_*`` the same with the int32 payload
    and the tie-break (``sort_kernel._run_inblock``, in place);
  * ``merge_sort`` / ``sortperm`` of the 2^28 keys (``ak``);
  * ``segmented_scan_incl`` / ``_excl`` (add) and ``segmented_reduce_add``
    / ``_max`` over the CSR (``ak``); and the segmented scan's kernel
    launches alone, on head flags made once
    (``segment_kernel.segmented_scan_flags``: ``segmented_kernel_incl`` /
    ``_excl``).

For each: ms by CUDA events (median of 7 warm calls), device us by CUDA
events around 20 calls queued behind a sleep kernel
(``launch_path.queued_device_us``, as ``chip_smoke.py`` reads them; null,
with the error, for a call that waits on the device), the
kernel launches of one call by name, the bound (each input read once and
each output written once at 3.35 TB/s, or the compare-exchanges at 67
TFLOP/s, the larger) and the PyTorch call that computes the same function
where there is one. To measure a parent commit in the same machine call,
unpack it under ``build/`` (``git archive <commit> | tar -x -C
build/parent``) and run this script with ``PYTHONPATH=build/parent/src:.``:
it uses only calls that both trees have. Run parent, change, change,
parent and compare within the call. Prints the card's name and power
limit, then one JSON object. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess

import numpy as np
import torch

import repro_torch
from benchmarks_torch import streaming_inputs as SI
from benchmarks_torch.launch_path import events_ms, queued_device_us
from repro_torch import core as ak
from repro_torch.convert import to_torch
from repro_torch.kernels import common as C
from repro_torch.kernels import segment_kernel as SGK
from repro_torch.kernels import sort_kernel as SK

N = 1 << 28
BLOCK = 8192
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def calls(seed: int) -> dict:
    """name -> (the port's call, the PyTorch call or None, its name,
    bytes, operations)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, generator=gen, device="cuda")
    pay = torch.arange(N, device="cuda", dtype=torch.int32)
    rng = np.random.default_rng(seed)
    xs = to_torch(rng.standard_normal(SI.STREAM_N, dtype=np.float32),
                  "cuda")
    off = to_torch(SI.csr_offsets(rng, SI.SEGS, SI.STREAM_N), "cuda")
    off64 = off.long()
    kw, vw = x.clone(), pay.clone()  # in place: the network is oblivious
    nb, inf = N * 4, math.inf
    rows = lambda: torch.sort(x.view(-1, BLOCK), dim=1)  # noqa: E731
    initial, finish = sum(range(1, 14)), 13
    out = {}
    for label, k_lo, k_hi, st in (("initial", 2, BLOCK, initial),
                                  ("finish", N, N, finish)):
        out[f"inblock_{label}"] = (
            lambda k_lo=k_lo, k_hi=k_hi: SK._run_inblock(
                kw, None, k_lo, k_hi, BLOCK, False, True),
            rows, "torch.sort of 8192-key rows", 2 * nb, N // 2 * st)
        out[f"inblock_kv_tie_{label}"] = (
            lambda k_lo=k_lo, k_hi=k_hi: SK._run_inblock(
                kw, vw, k_lo, k_hi, BLOCK, True, True),
            lambda: torch.sort(x.view(-1, BLOCK), dim=1, stable=True),
            "torch.sort(stable) of 8192-key rows", 4 * nb, N // 2 * st)
    sort_ops = N // 2 * sum(range(1, 29))
    out["merge_sort"] = (lambda: ak.merge_sort(x), lambda: torch.sort(x),
                         "torch.sort", 2 * nb, sort_ops)
    out["sortperm"] = (lambda: ak.sortperm(x),
                       lambda: torch.sort(x, stable=True),
                       "torch.sort(stable)", 2 * nb, sort_ops)
    seg_bytes = 2 * SI.STREAM_N * 4 + 4 * (SI.SEGS + 1)
    out["segmented_scan_incl"] = (
        lambda: ak.segmented_scan(torch.add, xs, off, init=0.0), None,
        None, seg_bytes, SI.STREAM_N)
    out["segmented_scan_excl"] = (
        lambda: ak.segmented_scan(torch.add, xs, off, init=0.0,
                                  inclusive=False), None, None, seg_bytes,
        SI.STREAM_N)
    flags = SGK.head_mask(off, SI.STREAM_N)
    for ex in (False, True):
        out["segmented_kernel_" + ("excl" if ex else "incl")] = (
            lambda ex=ex: SGK.segmented_scan_flags(torch.add, xs, flags,
                                                   unit=0.0, exclusive=ex),
            None, None, 2 * SI.STREAM_N * 4 + SI.STREAM_N, SI.STREAM_N)
    red_bytes = SI.STREAM_N * 4 + 4 * (SI.SEGS + 1) + 4 * SI.SEGS
    out["segmented_reduce_add"] = (
        lambda: ak.segmented_reduce(torch.add, xs, off, init=0.0),
        lambda: torch.segment_reduce(xs, "sum", offsets=off64),
        "torch.segment_reduce(sum, offsets)", red_bytes, SI.STREAM_N)
    out["segmented_reduce_max"] = (
        lambda: ak.segmented_reduce(torch.maximum, xs, off, init=-inf),
        lambda: torch.segment_reduce(xs, "max", offsets=off64,
                                     initial=-inf),
        "torch.segment_reduce(max, offsets)", red_bytes, SI.STREAM_N)
    return out


def measure(fn, lib, nbytes: int, ops: int) -> dict:
    fn()
    torch.cuda.synchronize()
    C.reset_launch_count()
    fn()
    torch.cuda.synchronize()
    launches = C.kernel_launches()
    b, by = bound_ms(nbytes, ops)
    try:
        dev, err = queued_device_us(fn), None
    except RuntimeError as e:  # the call waits on the device
        dev, err = None, str(e)
    return {"ms": events_ms(fn), "device_us": dev, "device_error": err,
            "launches": launches, "bound_ms": b, "bound_by": by,
            "share_of_bound": b * 1e3 / dev if dev else None,
            "library_ms": events_ms(lib) if lib else None,
            "library_device_us": queued_device_us(lib) if lib else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sort_segments measures the card; no CUDA device "
                         "found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi or torch.cuda.get_device_name(0), flush=True)
    rows = {}
    for name, (fn, lib, lib_name, nbytes, ops) in calls(args.seed).items():
        rows[name] = r = measure(fn, lib, nbytes, ops)
        r["library"] = lib_name
        print(f"{name}: {r['ms']:.4f} ms, device {r['device_us']} us "
              f"({r['share_of_bound']} of the bound {r['bound_ms']:.4f}"
              f" ms by {r['bound_by']}), launches {r['launches']}; "
              f"{lib_name} {r['library_ms']} ms, device "
              f"{r['library_device_us']} us", flush=True)
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
