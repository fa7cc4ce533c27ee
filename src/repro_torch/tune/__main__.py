"""The autotune CLI: sweep, persist, report.

    PYTHONPATH=src python -m repro_torch.tune [--device cuda|cpu] [--model]
        [--cache PATH] [--sizes 4096,131072,1048576] [--dtypes float32,int32]
        [--primitives sort,mapreduce,...] [--no-presets]

Sweeps the tuned primitives across the size/dtype grid on one device,
writes that device's cache and prints the chosen knobs against the
defaults. The device is the card unless ``--device cpu`` is given; without
a card it exits non-zero rather than measure the CPU in its place.
``--model`` swaps the clock for the deterministic model.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.kernels import common as KC
from repro_torch.tune import cache as tcache
from repro_torch.tune import search


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to tune (default: the card)")
    ap.add_argument("--cache", default=None,
                    help="cache file (default: one a device under "
                         "~/.cache/repro-ak/, or $REPRO_TUNE_CACHE)")
    ap.add_argument("--model", action="store_true",
                    help="use the deterministic model, not the clock")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated element counts "
                         f"(default: {search.DEFAULT_SIZES})")
    ap.add_argument("--dtypes", default="float32")
    ap.add_argument("--primitives", default=None,
                    help="comma-separated subset (default: the tuned suite)")
    ap.add_argument("--no-presets", action="store_true",
                    help="do not seed wildcard entries from named presets")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("python -m repro_torch.tune: no CUDA device; tune the host "
              "CPU with --device cpu", file=sys.stderr)
        return 2

    if not args.no_presets:
        # the caller profiles register the presets that seed wildcards
        import repro_torch.launch.serve    # noqa: F401
        import repro_torch.models.moe      # noqa: F401

    sizes = (tuple(int(s) for s in args.sizes.split(","))
             if args.sizes else search.DEFAULT_SIZES)
    dtypes = tuple(args.dtypes.split(","))
    primitives = (tuple(args.primitives.split(","))
                  if args.primitives else None)

    cache = search.tune_all(
        sizes=sizes, dtypes=dtypes, primitives=primitives,
        measure=search.model_measure if args.model else None,
        path=args.cache, seed_presets=not args.no_presets,
        device=args.device,
    )
    path = cache.save()
    tcache.validate_file(path)

    fp = cache.fingerprint
    print(f"autotune cache: {path}")
    print("device: " + ", ".join(f"{k}={v}" for k, v in fp.items())
          + f"; measure={'model' if args.model else 'wallclock'}")
    print(f"entries: {len(cache)} over sizes={sizes} "
          f"(classes {tuple(KC.size_class(n) for n in sizes)}) "
          f"dtypes={dtypes}")
    for line in search.report_lines(cache):
        print(line)
    nondefault = sum(1 for e in cache.entries.values() if e.get("knobs"))
    print(f"non-default knob sets: {nondefault}/{len(cache)} "
          f"(resolve order: scoped override > set > cache > preset > "
          f"default)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
