"""Phase 15's sharded decode cell of one model, cut to a few layers and
run in float32 and in bfloat16 on the CPU: whether the bf16 gap between 4
ranks and one rank is rounding or a fault of the placements.

    PYTHONPATH=src:. python -m benchmarks_torch.decode_gap glm4_9b \
        [--layers 4] [--out F]

Each dtype runs ``serving.sharded_decode_check``'s steps with seed 0:
the cell on one rank, then over 4 gloo processes with the same seeded
weights and caches. Prints, per dtype, the largest |difference| of the
ranks' logits and written cache columns from the one-rank run's past
``DECODE_TOL``'s rtol, as a share of the one-rank run's largest |value|
(phase 15 holds it to the dtype's limit). A float32 run within float32's
tolerance leaves the bf16 gap to rounding.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from benchmarks_torch import serving as SV
from benchmarks_torch import training as TB

NRANKS, SEED, DEVICE = 4, 0, "cpu"


def gap(arch: str, layers: int, dtype) -> dict:
    cell = SV.decode_cells()[arch]
    cell = cell._replace(cfg=dataclasses.replace(cell.cfg, n_layers=layers,
                                                 dtype=dtype))
    cells = {arch: cell}
    with tempfile.TemporaryDirectory() as tmp:
        one = {arch: SV.one_rank_decode(cell, SEED, DEVICE)}
        torch.save(one, os.path.join(tmp, "one_rank.pt"))
        procs = TB._spawn(SV._decode_rank, (tmp, NRANKS, DEVICE, SEED, cells),
                          NRANKS)
        TB._join_ranks(procs, tmp, NRANKS, time.monotonic() + 900,
                       "sharded decode")
        ranks = [torch.load(os.path.join(tmp, f"out{r}.pt"))[arch]
                 for r in range(NRANKS)]
    ref = one[arch]["logits"].float()
    written = max(rec["written_diff"][p] / rec["written_max"][p]
                  for rec in ranks for p in rec["written_diff"])
    return {"arch": arch, "layers": layers, "dtype": str(dtype),
            "limit": SV.DECODE_TOL[dtype],
            "logits_share": SV.decode_excess(ranks[0]["logits"], ref, dtype)
            / float(ref.abs().max()),
            "written_share": written,
            "finite": all(r["finite"] for r in ranks),
            "untouched_bitwise": all(r["untouched_bitwise"] for r in ranks)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", choices=sorted(SV.decode_cells()))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = [gap(args.arch, args.layers, dt)
           for dt in (torch.float32, torch.bfloat16)]
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
