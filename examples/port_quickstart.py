"""Quickstart of the PyTorch port: the AK primitive suite on both backends.

The tour of ``examples/quickstart.py`` on ``repro_torch``: the
``foreachindex`` copy kernel (the paper's Algorithm 3), every primitive,
the segmented primitives over a CSR batch, and the same call sites on
the ``"cuda"`` backend, whose hand-written kernels run on the card (on
a CPU tensor, their plain PyTorch versions) and return the portable
path's results. On the card it also times ``merge_sort`` against
``torch.sort`` by CUDA events, beside the card's name and power limit.

    PYTHONPATH=src python examples/port_quickstart.py [--n N]
    PYTHONPATH=src python examples/port_quickstart.py --device cpu

The reference's ``--paged``, ``--chaos``, ``--trace`` and ``--co-sort``
vignettes have their port in ``examples/port_serve_llm.py`` (``--paged``,
``--chaos``) and ``examples/port_distributed_sort.py`` (``--hetero``).
"""
import argparse
import subprocess

import torch

from repro_torch import core as ak


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the keys live (default: the card)")
    ap.add_argument("--n", type=int, default=100_000, help="keys")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(args.n, generator=gen, device=dev)

    # -- Algorithm 3: the foreachindex copy kernel (its result takes the
    # index dtype, so the copy is of int32 keys) ----------------------------
    src = torch.randint(-10**6, 10**6, (args.n,), generator=gen, device=dev,
                        dtype=torch.int32)
    dst = ak.foreachindex(lambda i: src[i.long()], src.shape[0], device=dev)
    assert torch.equal(dst, src)

    # -- the full suite on the default backend ("auto": the kernels for a
    # card tensor, the portable path for a CPU one) -------------------------
    hay = ak.merge_sort(x)
    print("merge_sort        :", hay[:4].tolist())
    print("sortperm          :", ak.sortperm(x)[:4].tolist())
    print("sortperm_lowmem   :", ak.sortperm_lowmem(x)[:4].tolist())
    print("reduce (+)        :", float(ak.reduce(torch.add, x, init=0.0)))
    print("mapreduce (x²,+)  :",
          float(ak.mapreduce(lambda a: a * a, torch.add, x, init=0.0)))
    print("accumulate (max)  :",
          ak.accumulate(torch.maximum, x, init=float("-inf"))[-4:].tolist())
    print("searchsortedfirst :", ak.searchsortedfirst(hay, x[:4]).tolist())
    print("searchsortedlast  :", ak.searchsortedlast(hay, x[:4]).tolist())
    print("any > 4σ          :", bool(ak.any_pred(lambda a: a > 4.0, x)))
    print("all finite        :", bool(ak.all_pred(torch.isfinite, x)))
    hist, mn, mx = ak.minmax_histogram(x, 16, -4.0, 4.0)
    print("histogram         :", hist.tolist())

    # -- segmented primitives: CSR (offsets, values) ragged batches ---------
    offsets = torch.tensor([0, 3, 3, 7, 10], dtype=torch.int32, device=dev)
    seg = x[:10].contiguous()
    print("segmented_reduce  :",
          ak.segmented_reduce(torch.add, seg, offsets, init=0.0).tolist())
    print("segmented_scan    :",
          ak.segmented_scan(torch.add, seg, offsets, init=0.0)[:4].tolist())
    print("segmented_sort    :", ak.segmented_sort(seg, offsets)[:4].tolist())

    # -- the same call sites on the kernels' backend ------------------------
    with ak.backend("cuda"):
        s2 = ak.merge_sort(x)
        r2 = ak.reduce(torch.add, x, init=0.0)
    assert torch.equal(s2, hay)
    torch.testing.assert_close(r2, ak.reduce(torch.add, x, init=0.0,
                                             backend="torch"),
                               rtol=1e-4, atol=1e-3)
    print("cuda backend      : identical sort, reduce within 1e-4 ✓")
    stats = ak.registry.stats("sort")
    print(f"registry          : sort calls {stats['calls']}, portable "
          f"{stats['portable_calls']}")

    if dev.type == "cuda":
        sort_ms = cuda_ms(lambda: ak.merge_sort(x))
        lib_ms = cuda_ms(lambda: torch.sort(x))
        print(f"card              : {card_name()}")
        print(f"merge_sort {args.n} f32: {sort_ms:.4f} ms, torch.sort "
              f"{lib_ms:.4f} ms (CUDA events, one call)")


if __name__ == "__main__":
    main()
