"""SIHSort with the PyTorch port: the paper's multi-node sort over 4 ranks.

The counterpart of ``examples/distributed_sort.py``: four processes
joined by a gloo group (the MPI ranks' stand-ins; on the card all four
share it, their exchange staged through host memory) sort several
distributions and a key/payload pair, and print the per-rank balance the
interpolated-histogram splitters reach, the collectives each rank
counted (one fused all_to_all a sort) and the measured time of a sort
a rank, beside the card's name and power limit. The reference's
modelled interconnect economics (``benchmarks/cost.py``) were modelled
for a TPU and are left out.

    PYTHONPATH=src python examples/port_distributed_sort.py [--n N]
    PYTHONPATH=src python examples/port_distributed_sort.py --hetero
    PYTHONPATH=src python examples/port_distributed_sort.py --device cpu

``--hetero`` adds the co-sort (``launch.mesh.co_sort``): one rank on the
card's kernels beside three CPU ranks on the portable path, the
splitters cut by each rank's modelled throughput, so the CPU ranks
receive fewer keys (with ``--device cpu`` every rank is a CPU rank).
"""
import argparse
import statistics
import subprocess

import numpy as np
import torch

from repro_torch import core as ak
from repro_torch.launch import mesh as LM

RANKS = 4


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def report(label, keys, res, stats):
    got = ak.collect_sorted(res).cpu()
    assert torch.equal(got, torch.sort(keys).values), label
    ak.assert_no_overflow(res)
    counts = res.count.reshape(-1).tolist()
    ms = statistics.median(statistics.median(st.seconds) * 1e3
                           for st in stats)
    print(f"{label:18s} sorted ✓  balance {min(counts):7d}..{max(counts):7d}"
          f"  (ideal {keys.numel() // RANKS})  collectives a rank "
          f"{sum(stats[0].collectives.values())} "
          f"(all_to_all {stats[0].collectives.get('all_to_all', 0)})  "
          f"{ms:.1f} ms a sort (median rank)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where each rank keeps its keys")
    ap.add_argument("--n", type=int, default=RANKS * 65_536,
                    help="global keys")
    ap.add_argument("--hetero", action="store_true",
                    help="also run the card + CPU co-sort")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu")
        print(f"card: {card_name()}")
    rng = np.random.default_rng(0)
    n = args.n
    print(f"ranks: {RANKS} ({args.device}), global keys: {n:,}\n")
    kw = dict(device=args.device, capacity_factor=2.0, repeats=2)
    for label, data in (
            ("normal + payload", rng.normal(size=n).astype(np.float32)),
            ("skewed lognormal", rng.lognormal(0, 2, size=n).astype(
                np.float32)),
            ("int32", rng.integers(-10**6, 10**6, size=n).astype(np.int32))):
        keys = torch.from_numpy(data)
        # the first carries a payload: the data pipeline's global shuffle
        payload = (torch.arange(n, dtype=torch.int32) if "payload" in label
                   else None)
        res, stats = ak.sihsort_sharded_with_stats(keys, RANKS,
                                                   payload=payload, **kw)
        report(label, keys, res, stats)
        if payload is not None:
            counts = res.count.reshape(-1).tolist()
            vals = res.values.reshape(RANKS, -1).cpu()
            pays = res.payload.reshape(RANKS, -1).cpu()
            got_k = torch.cat([vals[r, :counts[r]] for r in range(RANKS)])
            got_p = torch.cat([pays[r, :counts[r]] for r in range(RANKS)])
            assert torch.equal(keys[got_p.long()], got_k)
            print(f"{'':18s} every key/payload pair survived the exchange")

    if args.hetero:
        backends = (("cuda",) if args.device == "cuda" else ("torch",)) \
            + ("torch",) * (RANKS - 1)
        hm = LM.make_hetero_mesh(backends)
        keys = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        res, stats, weights, sources = LM.co_sort(
            keys, hm, with_stats=True, capacity_factor=2.0, repeats=1)
        print(f"\nco-sort over {backends}: weights "
              f"{np.round(weights, 4).tolist()} ({sources})")
        report("co-sort", keys, res, stats)


if __name__ == "__main__":
    main()
