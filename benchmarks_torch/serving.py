"""The serving path at full width on the card, with random bfloat16
weights from a seeded generator, paged KV cache, 8 slots, 16 requests of
256 random prompt tokens and 64 new tokens each (top-k 16, top-p 0.95).
``--config`` picks the model: internlm2-1.8B (the default; 24 layers,
d_model 2048, 16 heads, 8 KV heads, d_ff 8192, vocab 92544 padded to
94208) or granite-moe-1b (24 layers, d_model 1024, 16 heads, 8 KV heads,
32 experts of d_ff 512, top-8, vocab 49155 padded to 51200).

    PYTHONPATH=src:. python -m benchmarks_torch.serving \
        [--config {internlm2_1_8b,granite_moe_1b}] [--seed S] [--out F]

Prints the engine's tokens/s and TTFT, and where one decode step's time
goes: device time by kernel class from ``torch.profiler`` (weight and
attention products both land in "matmuls" there), and CUDA-event times of
the step's parts run alone at its shapes (the weight products, the
attention core, the page gathers, the sampler; for the MoE model also the
routing, the expert GEMMs and the combine of every layer), and the host
cost of one page-gather call. ``chip_smoke.py``
phases 7 and 9 drive the same workloads from here. Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks_torch.call_overhead import per_call_us
from repro_torch import core as ak
from repro_torch.configs import load_config
from repro_torch.core import registry
from repro_torch.kernels import page_kernel as PK
from repro_torch.launch import serve
from repro_torch.launch.engine import Engine, Request
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

ARCH = "internlm2_1_8b"
ARCHS = (ARCH, "granite_moe_1b")
SLOTS, REQUESTS, PROMPT_LEN, MAX_NEW = 8, 16, 256, 64
TOP_K, TOP_P = 16, 0.95


@dataclasses.dataclass
class Workload:
    cfg: object
    params: dict
    prompts: np.ndarray       # (REQUESTS, PROMPT_LEN) int32
    page_size: int
    cache_len: int


def workload(seed: int = 0, device="cuda", arch: str = ARCH) -> Workload:
    """The full-width model (random weights from ``seed``) and prompts."""
    cfg = load_config(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(gen, cfg, device=device)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(REQUESTS, PROMPT_LEN), dtype=np.int32)
    ps = int(registry.tuning.lookup("page_gather")["page_size"])
    cache_len = -(-(PROMPT_LEN + MAX_NEW) // ps) * ps
    return Workload(cfg, params, prompts, ps, cache_len)


def engine(w: Workload, *, paged=True, temperature=1.0, seed=0) -> Engine:
    return Engine(w.params, w.cfg, slots=SLOTS, cache_len=w.cache_len,
                  prompt_pad=PROMPT_LEN, temperature=temperature,
                  top_k=TOP_K, top_p=TOP_P, seed=seed, paged=paged,
                  page_size=w.page_size)


def requests(w: Workload) -> list:
    return [Request(rid=i, prompt=w.prompts[i], max_new=MAX_NEW)
            for i in range(REQUESTS)]


def run(w: Workload, **kw):
    """One engine run; returns (tokens {rid: list}, EngineStats)."""
    res, stats = engine(w, **kw).run(requests(w))
    return {r: v.tokens for r, v in res.items()}, stats


# ---------------------------------------------------------------------------
# where one decode step's device time goes
# ---------------------------------------------------------------------------

CATEGORIES = (
    ("page gathers", ("page_gather",)),
    ("expert grouped GEMMs", ("groupproblemshape", "grouped")),
    ("sampler sort network", ("inblock_kernel", "cross_kernel")),
    ("sampler mask", ("nucleus_kernel",)),
    ("matmuls", ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "xmma",
                 "splitk", "cublas")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    if "softmax" in low:
        return "attention softmax"
    return "other (elementwise, index, reductions)"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def decode_step_inputs(w: Workload, seed: int = 0):
    """A steady-state decode step of the paged path: every slot live at
    position PROMPT_LEN + MAX_NEW // 2, tables over a full pool of random
    K/V pages (a scattered permutation of page ids)."""
    cfg, dev = w.cfg, w.params["embed"]["embed"].device
    T = w.cache_len // w.page_size
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    caches = M.zero_paged_caches(cfg, num_pages=SLOTS * T,
                                 page_size=w.page_size, device=dev)
    for c in caches["kv"].values():
        c.normal_(generator=gen)
    table = torch.randperm(SLOTS * T, generator=gen, device=dev).to(
        torch.int32).view(SLOTS, T)
    tok = torch.randint(0, cfg.vocab, (SLOTS, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    pos = torch.full((SLOTS,), PROMPT_LEN + MAX_NEW // 2, device=dev)
    keys = serve.request_keys(seed, list(range(SLOTS)), [0] * SLOTS, dev)
    return caches, table, tok, pos, keys


def decode_step(w: Workload, inputs):
    """One engine decode step: the model through the page table, then the
    sampler under the engine's "sampler" preset."""
    caches, table, tok, pos, keys = inputs
    logits, _ = M.decode_step(w.params, w.cfg, tok, caches, pos,
                              block_tables=table, page_size=w.page_size)
    with registry.tuning.preset("sampler"):
        return serve.sample_logits(keys, logits[:, 0], top_k=TOP_K,
                                   top_p=TOP_P, vocab=w.cfg.vocab)


def _kernel_ms(prof, reps: int) -> dict:
    """Device ms per call of each CUDA kernel in a profiler trace of
    ``reps`` calls."""
    kernels: dict[str, float] = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / reps
    return kernels


def _device_ms(fn) -> float:
    """Device ms of one warm call of ``fn``: its kernels' time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(_kernel_ms(prof, 1).values())


def _event_ms(fn, reps: int = 5) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` warm calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def parts(w: Workload, inputs) -> dict:
    """CUDA-event ms of one decode step and of its parts alone (host work
    included), and each part's device ms (its kernels' time in a
    profiler trace), at the step's shapes: every weight product of the layers and the head (the
    dense FFN's included; the experts' are their own part), the attention
    core of every layer, the n_layers K/V page gathers, the sampler; for
    the MoE model also every layer's routing (router, top-k, sortperm,
    counts, offsets), expert GEMMs and combine (``segmented_reduce``) on
    one step's 8 x top_k routed rows."""
    cfg, p = w.cfg, w.params
    caches, table, tok, pos, keys = inputs
    dev = tok.device
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    x = torch.randn(SLOTS, 1, d, device=dev).to(cfg.dtype)
    f = torch.randn(SLOTS, 1, cfg.d_ff, device=dev).to(cfg.dtype)

    def matmuls():
        for lp in p["layers"]:
            a = lp["attn"]
            for wt in (a["wq"], a["wk"], a["wv"], a["wo"]):
                x @ wt
            if "mlp" in lp:
                m = lp["mlp"]
                x @ m["w_gate"]
                x @ m["w_up"]
                f @ m["w_down"]
        x @ p["head"]["unembed"]

    q = torch.randn(SLOTS, 1, H, hd, device=dev).to(cfg.dtype)
    k = caches["kv"]["k"][0][table.long()].reshape(SLOTS, -1, KV, hd)
    v = caches["kv"]["v"][0][table.long()].reshape(SLOTS, -1, KV, hd)

    def attention():
        for _ in range(cfg.n_layers):
            L.blockwise_attention(q, k, v, causal=True, q_offset=pos)

    def gathers():
        kv = caches["kv"]
        for i in range(cfg.n_layers):
            registry.call("page_gather", (kv["k"][i], kv["v"][i]), table)

    logits = torch.randn(SLOTS, cfg.padded_vocab(16), device=dev)

    def sampler():
        with registry.tuning.preset("sampler"):
            serve.sample_logits(keys, logits, top_k=TOP_K, top_p=TOP_P,
                                vocab=cfg.vocab)

    fns = {"weight matmuls": matmuls, "attention core": attention,
           "page gathers": gathers, "sampler": sampler}
    if cfg.family == "moe":
        fns.update(moe_parts(w, x.view(SLOTS, d)))
    out = {"step": _event_ms(lambda: decode_step(w, inputs))}
    out.update((n, _event_ms(f)) for n, f in fns.items())
    out["rest of the step"] = out["step"] - sum(
        v for n, v in out.items() if n != "step")
    return out, {n: _device_ms(f) for n, f in fns.items()}


def moe_parts(w: Workload, xf) -> dict:
    """Every MoE layer's routing, expert GEMMs and combine over one decode
    step's rows ``xf`` (SLOTS, d), as functions to time."""
    cfg, layers = w.cfg, w.params["layers"]
    T, k = xf.shape[0], cfg.top_k
    capacity = max(int(T * k * cfg.moe_capacity_factor / cfg.n_experts), 4)
    mp = layers[0]["moe"]
    ids, gates, _, _ = MOE._route(mp, cfg, xf)
    perm, _, _, _, counts, offsets = MOE._dispatch_indices(cfg, ids, T,
                                                           capacity)
    xs = xf[perm.long() // k]
    contrib = torch.randn(T * k, cfg.d_model, device=xf.device).to(
        cfg.dtype)
    tok_offsets = torch.arange(T + 1, dtype=torch.int32,
                               device=xf.device) * k

    def routing():
        for lp in layers:
            ids, _, _, _ = MOE._route(lp["moe"], cfg, xf)
            MOE._dispatch_indices(cfg, ids, T, capacity)

    def experts():
        for lp in layers:
            MOE._expert_ffn_bucketed(lp["moe"], xs, counts, offsets)

    def combine():
        with registry.tuning.preset("moe_dispatch"):
            for _ in layers:
                ak.segmented_reduce(torch.add, contrib, tok_offsets, init=0)

    return {"moe routing": routing, "moe expert GEMMs": experts,
            "moe combine": combine}


def gather_host_us(w: Workload, inputs, calls: int = 2000) -> dict:
    """Host-clock microseconds per page-gather call on one layer's K/V
    pools and the decode step's table (median of 5 runs of ``calls``
    back-to-back calls, one synchronise each): the registry call the model
    makes, the wrapper alone, and ``pool[table]`` for K and for V. The
    card's work is a few microseconds a call, so a call that costs less on
    the host reads as the device time. ``launch_path.py`` splits a call
    into its parts."""
    caches, table = inputs[0], inputs[1]
    kv = (caches["kv"]["k"][0], caches["kv"]["v"][0])
    tl = table.long()
    parts = {
        "registry_call": lambda: registry.call("page_gather", kv, table),
        "wrapper": lambda: PK.page_gather_blocks(kv, table),
        "pool[table] x 2": lambda: (kv[0][tl], kv[1][tl]),
    }
    return {k: per_call_us(fn, calls) for k, fn in parts.items()}


def breakdown(w: Workload, reps: int = 3, seed: int = 0) -> dict:
    """Device time of one decode step by category (``torch.profiler``),
    the step's host-clock time and the device's idle share."""
    inputs = decode_step_inputs(w, seed)
    decode_step(w, inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            decode_step(w, inputs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = _kernel_ms(prof, reps)
    cats: dict[str, float] = {}
    for name, ms in kernels.items():
        cat = _category(name)
        cats[cat] = cats.get(cat, 0.0) + ms
    device = sum(cats.values())
    event_ms, device_ms = parts(w, inputs)
    return {
        "wall_ms": wall, "device_ms": device,
        "parts_ms": event_ms, "parts_device_ms": device_ms,
        "page_gather_host_us": gather_host_us(w, inputs),
        "idle_share": max(0.0, 1.0 - device / wall) if wall else None,
        "categories_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(kernels.items(),
                                      key=lambda kv: -kv[1])[:12]),
    }


def summary(stats) -> dict:
    tt = stats.ttft_s
    return {"tokens": stats.tokens, "steps": stats.steps,
            "decode_s": stats.decode_s, "tokens_per_s": stats.tokens_per_s,
            "prefill_s": stats.prefill_s,
            "first_prefill_s": stats.compile_prefill_s,
            "first_decode_s": stats.compile_decode_s,
            "ttft_p50_ms": tt.get("p50", 0.0) * 1e3,
            "ttft_p99_ms": tt.get("p99", 0.0) * 1e3,
            "mean_slot_util": stats.mean_slot_util}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=ARCHS, default=ARCH)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serving measures the card; no CUDA device found")
    w = workload(args.seed, arch=args.config)
    _, stats = run(w, seed=args.seed)
    out = {"device": torch.cuda.get_device_name(0), "config": args.config,
           "engine": summary(stats), "decode_step": breakdown(w)}
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
