"""Serving entry point — a thin CLI over the continuous-batching engine
(counterpart of ``repro/launch/serve.py``). ``serve_loop`` hands the
engine's families to the engine and keeps a fixed-batch loop for encdec
and vlm (and for any call given ``frames=`` / ``patches=``): one prefill
that projects the cross K/V, then one decode step a token at a shared
scalar position, no EOS and no refill, as in the reference.

The sampler is built from the paper's primitives — "sorting is the hot
path of real applications" made executable:

    top-k cut       -> ak.topk            (the batched bitonic network)
    top-p (nucleus) -> ak.nucleus_mask    (ONE registry call: batched
                       descending sortperm + one mask launch for softmax,
                       prefix sum, cut and keep scatter;
                       kernels/nucleus_kernel.py)

``fused=False`` keeps the unfused composition (sortperm_batched + a
per-row accumulate + searchsortedfirst + a scatter).

Sampling noise is counter-based: each row draws its Gumbel noise from a
hash of (seed, request id, token index, column), so a sampled token
depends only on the request and its index, never on the slot or batch it
rides in, on every device. It cannot reproduce ``jax.random``'s bits.

    python -m repro_torch.launch.serve [--config ARCH] [--device cuda|cpu]
        [--paged] ...

``--config whisper_medium`` / ``llama32_vision_90b`` serve the smoke
config through the fixed-batch loop, ``--slots`` rows at once, with zero
frames / patches.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import operator
import time

import numpy as np
import torch

from repro_torch import core as ak
from repro_torch.core import registry
from repro_torch.kernels.common import NEG_MASK
from repro_torch.launch.engine import ENGINE_FAMILIES, Engine, Request, _sync
from repro_torch.models import model as M

# Registry tuning for the decode-step sampler: rows shorter than 4096 run on
# the portable path (AK's switch_below, a table entry instead of branches);
# vocabulary-width rows reach the kernels. An explicit ``ak_tuning=``
# argument applies as scoped overrides on top.
SAMPLER_TUNING = registry.tuning.register_preset("sampler", {
    "argsort_batched": {"switch_below": 4096},
    "topk": {"switch_below": 4096},
    "accumulate": {"switch_below": 4096},
    "searchsorted": {"switch_below": 4096},
    "nucleus_mask": {"switch_below": 4096},
})

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without the
    int64 overflow a full product could reach."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x):
    """A 32-bit integer mixer (bit avalanche of every input bit), on
    int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def request_keys(seed: int, rids, idxs, device) -> torch.Tensor:
    """(B,) int64 keys, one per (seed, request id, token index): the
    port's per-request counter, in place of ``fold_in(fold_in(seed, rid),
    idx)``."""
    r = torch.as_tensor(rids, dtype=torch.int64, device=device) & _M32
    i = torch.as_tensor(idxs, dtype=torch.int64, device=device) & _M32
    s = _hash32(torch.tensor(seed & _M32, dtype=torch.int64, device=device))
    return _hash32(_hash32(s ^ r) ^ i)


def gumbel_noise(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) float32 Gumbel noise, element (b, c) a function of
    (keys[b], c) only."""
    col = _hash32(torch.arange(n, dtype=torch.int64, device=keys.device))
    h = _hash32(keys[:, None] ^ col[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24    # (0, 1)
    return -torch.log(-torch.log(u))


def unfused_keep(lg, top_p):
    """The top-p mask as the unfused composition: a descending batched
    sortperm, then per row an inclusive ``accumulate`` of the sorted
    probabilities and ``searchsortedfirst`` of top_p for the cut, then a
    scatter back through the permutation."""
    V = lg.shape[1]
    order = ak.sortperm_batched(-lg).long()
    probs = torch.softmax(torch.gather(lg, 1, order), dim=-1)
    q = torch.tensor([top_p], dtype=torch.float32, device=lg.device)
    cut = torch.stack([
        ak.searchsortedfirst(ak.accumulate(operator.add, row, init=0.0),
                             q)[0]
        for row in probs])
    keep_sorted = torch.arange(V, device=lg.device)[None, :] <= cut[:, None]
    return torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)


def sample_logits(keys, logits, *, temperature=1.0, top_k=0, top_p=1.0,
                  vocab=None, fused=True):
    """logits (B, V) -> int32 token ids (B,). AK-primitive nucleus sampling;
    ``keys`` (B,) from ``request_keys``. ``fused=True`` routes the top-p
    mask through the ``nucleus_mask`` primitive (one registry call);
    ``fused=False`` is the unfused composition."""
    B, V = logits.shape
    lg = logits.to(torch.float32)
    dev = lg.device
    neg = torch.full((), NEG_MASK, dtype=torch.float32, device=dev)
    if vocab is not None and vocab < V:
        lg = torch.where(torch.arange(V, device=dev)[None, :] < vocab, lg,
                         neg)
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    lg = lg / temperature

    if top_k and top_k < V:
        kth = ak.topk(lg, top_k)[0][:, -1]
        lg = torch.where(lg < kth[:, None], neg, lg)

    if top_p < 1.0:
        keep = (ak.nucleus_mask(lg, top_p=float(top_p)) if fused
                else unfused_keep(lg, top_p))
        lg = torch.where(keep, lg, neg)
    return torch.argmax(lg + gumbel_noise(keys, V), dim=-1).to(torch.int32)


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens: int          # EOS-aware when the loop ran with an eos_id
    #: per-rid terminal status
    statuses: dict | None = None
    #: the engine's full EngineStats (preemptions, step_retries, ...)
    engine_stats: object | None = None

    @property
    def tokens_per_s(self):
        return self.tokens / max(self.decode_s, 1e-9)


def serve_loop(params, cfg, prompts, *, max_new: int = 32, cache_len: int,
               temperature=1.0, top_k=0, top_p=1.0, seed=0, eos_id=None,
               frames=None, patches=None, ak_tuning=None, fused=True,
               paged=False, page_size=None, num_pages=None, preempt=False,
               queue_cap=None, deadline=None, chaos=None):
    """prompts: (B, S_prompt) int32. Returns (generated (B, max_new) int32
    on the parameters' device, stats).

    The engine's families: one engine slot per prompt row; a sequence
    that stops early at ``eos_id`` pads its output row with ``eos_id`` and
    stops counting. ``paged``/``page_size``/``num_pages``, ``preempt``,
    ``deadline``, ``queue_cap`` and ``chaos`` (a fault-plan seed) as in the
    engine and the reference (DESIGN.md §8a, §9). encdec / vlm, or any
    call with ``frames`` (B, enc_seq, d) / ``patches`` (B, vision_seq, d),
    take the fixed-batch loop (``_serve_loop_fixed``), which ignores
    ``eos_id`` and the engine's options.
    """
    if cfg.family not in ENGINE_FAMILIES or frames is not None \
            or patches is not None:
        scope = (registry.tuning.preset("sampler") if ak_tuning is None
                 else registry.tuning.overrides(ak_tuning))
        with scope:
            return _serve_loop_fixed(
                params, cfg, prompts, max_new=max_new, cache_len=cache_len,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, frames=frames, patches=patches, fused=fused)
    B, S = prompts.shape
    sup = None
    if chaos is not None:
        from repro_torch.runtime.supervisor import Supervisor
        sup = Supervisor(None, n_hosts=1, max_retries=3,
                         sleep=lambda s: None)
    eng = Engine(
        params, cfg, slots=B, cache_len=cache_len, prompt_pad=S,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        eos_id=eos_id, fused_sampler=fused, ak_tuning=ak_tuning,
        paged=paged, page_size=page_size, num_pages=num_pages,
        preempt=preempt or chaos is not None, queue_cap=queue_cap,
        supervisor=sup,
    )
    host = np.asarray(prompts.cpu() if isinstance(prompts, torch.Tensor)
                      else prompts, np.int32)
    from repro_torch.runtime import faults
    ctx = (faults.active(faults.FaultPlan.seeded(chaos))
           if chaos is not None else contextlib.nullcontext())
    with ctx:
        results, es = eng.run(
            [Request(rid=i, prompt=host[i], max_new=max_new,
                     deadline=deadline)
             for i in range(B)]
        )
    pad = eos_id if eos_id is not None else 0
    toks = np.full((B, max_new), pad, np.int32)
    for i in range(B):
        got = results[i].tokens[:max_new]
        toks[i, :len(got)] = got
    return torch.from_numpy(toks).to(eng.device), ServeStats(
        prefill_s=es.prefill_s, decode_s=es.decode_s, tokens=es.tokens,
        statuses={i: results[i].status for i in sorted(results)},
        engine_stats=es,
    )


def _serve_loop_fixed(params, cfg, prompts, *, max_new, cache_len,
                      temperature, top_k, top_p, seed, frames, patches,
                      fused):
    """The fixed-batch loop (encdec / vlm): prefill (the cross K/V
    projected once), then ``decode_step`` at the shared position ``S +
    step``; no EOS, no refill. Row b's token i is sampled with
    ``request_keys(seed, b, i)``, the key the engine gives request b's
    token i, so a row samples what the engine would sample from the same
    logits. Returns (tokens (B, max_new) int32, ServeStats)."""
    dev = params["embed"]["embed"].device
    prompts = torch.as_tensor(np.asarray(
        prompts.cpu() if isinstance(prompts, torch.Tensor) else prompts,
        np.int32), device=dev)
    B, S = prompts.shape
    rows = list(range(B))

    def sample(step, lg):
        return sample_logits(request_keys(seed, rows, [step] * B, dev), lg,
                             temperature=temperature, top_k=top_k,
                             top_p=top_p, vocab=cfg.vocab, fused=fused)

    t0 = time.perf_counter()
    logits, caches, pos = M.prefill(params, cfg, prompts,
                                    cache_len=cache_len, frames=frames,
                                    patches=patches)
    _sync(logits)
    t1 = time.perf_counter()
    out = [sample(0, logits[:, -1])]
    for step in range(max_new - 1):
        logits, caches = M.decode_step(params, cfg, out[-1][:, None],
                                       caches, pos + step)
        out.append(sample(step + 1, logits[:, 0]))
    toks = torch.stack(out, dim=1)
    _sync(toks)
    t2 = time.perf_counter()
    return toks, ServeStats(prefill_s=t1 - t0, decode_s=t2 - t1,
                            tokens=B * max_new)


def main(argv=None):
    from repro_torch.configs import load_smoke_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--config", dest="arch",
                    default="internlm2_1_8b",
                    help="architecture whose smoke config is served "
                         "(internlm2_1_8b, granite_moe_1b, "
                         "deepseek_moe_16b, mamba2_1_3b, zamba2_7b, "
                         "whisper_medium, llama32_vision_90b, ...)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: the card; 'cpu' "
                         "runs the plain versions of the kernels)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=16)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--eos", type=int, default=None,
                    help="EOS token id (default: none — run to max-new)")
    ap.add_argument("--unfused", action="store_true",
                    help="use the unfused top-p composition")
    ap.add_argument("--paged", action="store_true",
                    help="block-pool KV cache with copy-on-write prefix "
                         "reuse (attention families only)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (default: the page_gather "
                         "primitive's knob)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (default: full footprint — "
                         "slots * cache_len / page_size)")
    ap.add_argument("--defrag-every", type=int, default=0,
                    help="compact the page pool every N retirements "
                         "(0: never)")
    ap.add_argument("--preempt", action="store_true",
                    help="preempt-and-recompute under page exhaustion")
    ap.add_argument("--deadline", type=int, default=None,
                    help="per-request deadline in engine steps from "
                         "submission (default: none)")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bounded admission queue; arrivals past the cap "
                         "are REJECTED newest-first (default: unbounded)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="run under a seeded fault plan (runtime/faults.py)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Perfetto/Chrome-trace JSON to PATH")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write a metrics snapshot to PATH at exit "
                         "(.json: JSON snapshot; else Prometheus text)")
    args = ap.parse_args(argv)

    from repro_torch.runtime import metrics, telemetry
    if args.trace:
        telemetry.enable()

    def export_obs():
        if args.trace:
            doc = telemetry.export(args.trace)
            telemetry.disable()
            print(f"trace: {len(doc['traceEvents'])} events -> "
                  f"{args.trace}")
        if args.metrics:
            metrics.write(args.metrics)
            print(f"metrics: snapshot -> {args.metrics}")

    cfg = load_smoke_config(args.arch)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = M.init_params(gen, cfg, device=args.device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(args.requests, args.prompt_len), dtype=np.int32)

    if cfg.family not in ENGINE_FAMILIES:
        # encdec / vlm: the fixed-batch loop over the first ``slots``
        # prompts, with zero frames / patches (the stub front ends)
        extras = {}
        if cfg.family == "encdec":
            extras["frames"] = torch.zeros(
                (args.slots, cfg.enc_seq, cfg.d_model), dtype=cfg.dtype,
                device=args.device)
        else:
            extras["patches"] = torch.zeros(
                (args.slots, cfg.vision_seq, cfg.d_model), dtype=cfg.dtype,
                device=args.device)
        toks, stats = serve_loop(
            params, cfg, prompts[:args.slots], max_new=args.max_new,
            cache_len=args.prompt_len + args.max_new, top_k=args.top_k,
            top_p=args.top_p, fused=not args.unfused, **extras)
        print(f"generated {tuple(toks.shape)} tokens ({toks.device}); "
              f"prefill {stats.prefill_s:.3f}s; decode "
              f"{stats.tokens_per_s:.1f} tok/s")
        export_obs()
        return toks, stats

    cache_len = args.prompt_len + args.max_new
    if args.paged:
        # the paged cache needs cache_len % page_size == 0 (equal attention
        # widths keep it bit for bit the contiguous engine)
        ps = args.page_size or int(
            registry.tuning.lookup("page_gather")["page_size"])
        cache_len = -(-cache_len // ps) * ps
    chaos = args.chaos is not None
    sup = None
    if chaos:
        from repro_torch.runtime.supervisor import Supervisor
        sup = Supervisor(None, n_hosts=1, max_retries=3,
                         sleep=lambda s: None)
    eng = Engine(
        params, cfg, slots=args.slots, cache_len=cache_len,
        prompt_pad=args.prompt_len, top_k=args.top_k, top_p=args.top_p,
        eos_id=args.eos, fused_sampler=not args.unfused,
        paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages, defrag_every=args.defrag_every,
        preempt=args.preempt or chaos, queue_cap=args.queue_cap,
        supervisor=sup,
    )
    from repro_torch.runtime import faults
    ctx = (faults.active(faults.FaultPlan.seeded(args.chaos))
           if chaos else contextlib.nullcontext())
    with ctx:
        results, stats = eng.run([
            Request(rid=i, prompt=prompts[i], max_new=args.max_new,
                    deadline=args.deadline)
            for i in range(args.requests)
        ])
    done = sum(r.finished_step >= 0 for r in results.values())
    print(
        f"served {done}/{args.requests} requests on {args.slots} slots "
        f"({eng.device}); {stats.tokens} tokens in {stats.steps} steps; "
        f"prefill {stats.prefill_s:.3f}s; "
        f"decode {stats.tokens_per_s:.1f} tok/s; "
        f"slot util {stats.mean_slot_util:.2f}"
    )
    tt, qw = stats.ttft_s, stats.queue_wait_s
    if tt:
        print(
            f"latency: ttft p50 {tt['p50'] * 1e3:.1f}ms "
            f"p99 {tt['p99'] * 1e3:.1f}ms; "
            f"queue-wait p50 {qw.get('p50', 0.0) * 1e3:.1f}ms; "
            f"mean queue depth {stats.mean_queue_depth:.2f}"
        )
    if args.paged:
        print(
            f"paged: {stats.num_pages} pages x {stats.page_size} tokens; "
            f"occupancy {stats.mean_occupancy:.2f}; "
            f"prefix hits {stats.prefix_hits}/{stats.prefix_lookups}; "
            f"cow forks {stats.cow_forks}; defrags {stats.defrags}; "
            f"{stats.resident_bytes_per_active_token:.0f} "
            f"resident B/active token"
        )
    if chaos or args.preempt or args.deadline is not None \
            or args.queue_cap is not None:
        from collections import Counter
        sts = Counter(r.status for r in results.values())
        print(
            "faults: "
            + " ".join(f"{k}={v}" for k, v in sorted(sts.items()))
            + f"; injected={stats.faults_injected} "
            f"preemptions={stats.preemptions} "
            f"resumes={stats.resumes} retries={stats.step_retries} "
            f"rejections={stats.rejections} timeouts={stats.timeouts}"
        )
    export_obs()
    return results, stats


if __name__ == "__main__":
    main()
