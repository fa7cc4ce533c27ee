"""The histogram and the nucleus mask kernels at the main paths' shapes, on
the card, for the tree of the package on PYTHONPATH.

    PYTHONPATH=src:. python -m benchmarks_torch.hist_nucleus [--out F]

Inputs, made from ``--seed`` on the card:

  * the histogram: SIHSort's local shard, 2^26 keys (float32 normals,
    their bfloat16 rounding, int32 uniform over [-2^30, 2^30)), 256 bins
    over the keys' own range, sorted (what SIHSort bins,
    ``core/distributed.py``) and the same keys shuffled;
    ``hist_<dtype>_<sorted|shuffled>``;
  * the nucleus mask at the serving paths' shapes, 8 rows of 94208
    (internlm2-1.8B) and of 51200 (granite-moe-1b) logits (N(0, 9)),
    filtered by top-k 16 as the sampler does (the rest -1e30) or
    unfiltered (top_p 0.95 then cuts thousands of ranks deep), top_p
    0.95: the mask kernel alone on the network's sorted rows at the
    wrapper's cluster size (``mask_<vocab>_<filtered|unfiltered>``); with
    ``--sweep`` (a tree whose wrapper takes a ``cluster``), also at every
    cluster size 1..16 with ``cudaOccupancyMaxActiveClusters`` of each,
    and at 256 lanes (the smoke configs' vocabulary); at 94208, one
    ``nucleus_mask_blocks`` call (``nucleus_<...>``); and one
    ``serve.sample_logits`` call with top-k 16 (``sample_logits``).

For each: ms by CUDA events (median of 7 warm calls), device us by CUDA
events around 20 calls queued behind a sleep kernel
(``launch_path.queued_device_us``; null, with the error, for a call that
waits on the device), the kernel launches of one call, the bound and the
PyTorch call that computes the same function where there is one. Bounds:
the histogram reads its keys once (bytes at 3.35 TB/s); the mask reads
neg once and writes the mask once (5 bytes a lane) and reads perm for
the ranks <= cut (``bound_ms``), beside the 9 bytes a lane charged before
(``bound_9b_ms``). To measure a parent commit in the same machine call,
unpack it under ``build/`` (``git archive <commit> | tar -x -C
build/parent``) and run this script with ``PYTHONPATH=build/parent/src:.``:
it uses only calls that both trees have. Run parent, change, change,
parent and compare within the call. Prints the card's name and power
limit, then one JSON object. Needs a card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess

import torch

import repro_torch
from benchmarks_torch.launch_path import events_ms, queued_device_us
from repro_torch.configs import granite_moe_1b, internlm2_1_8b
from repro_torch.kernels import common as C
from repro_torch.kernels import hist_kernel as HK
from repro_torch.kernels import nucleus_kernel as NK
from repro_torch.launch import serve

RANK_N = 1 << 26
NBINS = 256
# the logits' widths of chip_smoke.py's serving paths (phases 7 and 9):
# internlm2-1.8B's and granite-moe-1b's vocabularies padded as the models
# pad them; the sweep adds the smoke configs' 256
ROWS = 8
VOCABS = tuple(m.CONFIG.padded_vocab(16) for m in (internlm2_1_8b,
                                                   granite_moe_1b))
SWEEP_VOCABS = (*VOCABS, 256)
TOP_K, TOP_P = 16, 0.95
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def hist_keys(gen, dtype) -> torch.Tensor:
    if dtype == torch.int32:
        return torch.randint(-(1 << 30), 1 << 30, (RANK_N,), generator=gen,
                             device="cuda", dtype=torch.int32)
    return torch.randn(RANK_N, generator=gen, device="cuda").to(dtype)


def sampler_logits(gen, vocab: int, filtered: bool) -> torch.Tensor:
    lg = torch.randn(ROWS, vocab, generator=gen, device="cuda") * 3
    if filtered:
        kth = torch.topk(lg, TOP_K).values[:, -1:]
        lg = torch.where(lg < kth, torch.full((), C.NEG_MASK,
                                              device="cuda"), lg)
    return lg


def calls(seed: int, sweep: bool) -> dict:
    """name -> (the port's call, the PyTorch call or None, its name,
    bound ms, extra fields)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16"),
                         (torch.int32, "i32")):
        keys = hist_keys(gen, dtype)
        lo, hi = (float(v) for v in torch.aminmax(keys))
        for order, x in (("sorted", torch.sort(keys).values),
                         ("shuffled", keys)):
            lib = None
            if dtype == torch.float32:
                lib = (lambda x=x, lo=lo, hi=hi: (
                    torch.aminmax(x), torch.histc(x, NBINS, lo, hi)))
            out[f"hist_{label}_{order}"] = (
                lambda x=x, lo=lo, hi=hi: HK.minmax_histogram_blocks(
                    x, NBINS, lo, hi),
                lib, "torch.aminmax + torch.histc" if lib else None,
                bytes_ms(RANK_N * x.element_size() + NBINS * 4
                         + 2 * x.element_size()), {})
    takes_cluster = "cluster" in inspect.signature(
        NK.mask_kernel).parameters
    for vocab in SWEEP_VOCABS if sweep else VOCABS:
        for label, filtered in (("filtered", True), ("unfiltered", False)):
            lg = sampler_logits(gen, vocab, filtered)
            neg, perm = NK.sorted_rows(lg, cuda=True)
            keep = NK.mask_kernel(neg, perm, n=vocab, top_p=TOP_P,
                                  cuda=False)
            kept = int(keep.sum())  # ranks <= cut over the rows
            extra = {"ranks_kept": kept,
                     "bound_9b_ms": bytes_ms(9 * ROWS * vocab)}
            bound = bytes_ms(5 * ROWS * vocab + 4 * kept)
            if takes_cluster:
                extra["cluster"] = NK.cluster_size(vocab)
            out[f"mask_{vocab}_{label}"] = (
                lambda neg=neg, perm=perm, vocab=vocab: NK.mask_kernel(
                    neg, perm, n=vocab, top_p=TOP_P, cuda=True),
                None, None, bound, dict(extra))
            for cc in (range(1, NK.MAX_CLUSTER + 1) if sweep else ()):
                out[f"mask_{vocab}_{label}_cluster{cc}"] = (
                    lambda neg=neg, perm=perm, vocab=vocab, cc=cc:
                    NK.mask_kernel(neg, perm, n=vocab, top_p=TOP_P,
                                   cuda=True, cluster=cc),
                    None, None, bound,
                    dict(extra, cluster=cc,
                         max_active_clusters=NK.max_active_clusters(
                             vocab, cc)))
            if vocab == VOCABS[0]:
                out[f"nucleus_{label}"] = (
                    lambda lg=lg: NK.nucleus_mask_blocks(lg, top_p=TOP_P),
                    None, None, None, {})
    lg = torch.randn(ROWS, VOCABS[0], generator=gen, device="cuda") * 3
    keys = serve.request_keys(seed, list(range(ROWS)), [5] * ROWS, "cuda")
    out["sample_logits"] = (
        lambda: serve.sample_logits(keys, lg, top_k=TOP_K, top_p=TOP_P),
        None, None, None, {})
    return out


def measure(fn, lib, bound) -> dict:
    fn()
    torch.cuda.synchronize()
    C.reset_launch_count()
    fn()
    torch.cuda.synchronize()
    launches = C.kernel_launches()
    try:
        dev, err = queued_device_us(fn), None
    except RuntimeError as e:  # the call waits on the device
        dev, err = None, str(e)
    return {"ms": events_ms(fn), "device_us": dev, "device_error": err,
            "launches": launches, "bound_ms": bound,
            "share_of_bound": bound * 1e3 / dev if dev and bound else None,
            "library_ms": events_ms(lib) if lib else None,
            "library_device_us": queued_device_us(lib) if lib else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="also time the mask kernel at every cluster size "
                    "1..16, at the vocabularies above and 256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("hist_nucleus measures the card; no CUDA device "
                         "found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi or torch.cuda.get_device_name(0), flush=True)
    rows = {}
    for name, (fn, lib, lib_name, bound, extra) in calls(args.seed, args.sweep).items():
        rows[name] = r = measure(fn, lib, bound)
        r["library"] = lib_name
        r.update(extra)
        print(f"{name}: {r['ms']:.4f} ms, device {r['device_us']} us "
              f"(bound {bound} ms, share {r['share_of_bound']}), launches "
              f"{r['launches']}; {lib_name} {r['library_ms']} ms, device "
              f"{r['library_device_us']} us; {extra}", flush=True)
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
