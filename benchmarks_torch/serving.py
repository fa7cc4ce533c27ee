"""The serving path at full width on the card, with random bfloat16
weights from a seeded generator, 8 slots, 16 requests of 256 random
prompt tokens and 64 new tokens each (top-k 16, top-p 0.95), over a paged
KV cache for the attention families and the contiguous recurrent state
for the others. ``--config`` picks the model: internlm2-1.8B (the
default; 24 layers, d_model 2048, 16 heads, 8 KV heads, d_ff 8192, vocab
92544 padded to 94208), granite-moe-1b (24 layers, d_model 1024, 16
heads, 8 KV heads, 32 experts of d_ff 512, top-8, vocab 49155 padded to
51200), mamba2-1.3b (48 Mamba2 layers, d_model 2048, 64 heads of 64,
state 128, vocab 50280 padded to 51200) or zamba2-7b (81 Mamba2 layers in
13 groups of 6 + a tail of 3, d_model 3584, 112 heads of 64, state 64;
one shared attention block of 32 heads of 112 and d_ff 14336 after each
group; vocab 32000 padded to 32768), whisper-medium (24 encoder + 24
decoder layers, d_model 1024, 16 heads of 64, d_ff 4096, 1536 frames,
vocab 51865 padded to 53248) or llama-3.2-vision at 10 of its 100 layers
(2 groups of 4 dense layers + 1 gated cross-attention layer; d_model
8192, 64 heads / 8 KV heads of 128, d_ff 28672, 1664 patches, vocab
128256 padded to 129024): 100 layers are ~88 B parameters, ~175 GB in
bfloat16, which no single card holds. The encdec and vlm models serve 8
rows of the same traffic in one wave through ``serve_loop``'s fixed-batch
loop, with stub frames / patches drawn from the seed, and the vlm's
cross-layer gates drawn nonzero from the seed (the published init of 0
makes every cross layer add nothing).

    PYTHONPATH=src:. python -m benchmarks_torch.serving \
        [--config {internlm2_1_8b,granite_moe_1b,mamba2_1_3b,zamba2_7b,
                   whisper_medium,llama32_vision_90b}]
        [--seed S] [--out F]

Prints the engine's tokens/s and TTFT, and where one decode step's time
goes: device time by kernel class from ``torch.profiler`` (weight and
attention products both land in "matmuls" there), and CUDA-event times of
the step's parts run alone at its shapes (the weight products, the
attention core, the page gathers, the sampler; for the MoE model also the
routing, the expert GEMMs and the combine of every layer), and the host
cost of one page-gather call; for the recurrent models the weight
products, the shared block's attention core (zamba2) and the sampler; for
encdec and vlm the weight products, the self- and the cross-attention
cores and the sampler, and the prefill split into the cross K/V (the
encoder, or the patches' projection) and the prompt.
``chip_smoke.py`` phases 7, 9, 11 and 12 drive the same workloads from
here. Needs a card.
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
CROSS_ARCHS = ("whisper_medium", "llama32_vision_90b")
ARCHS = (ARCH, "granite_moe_1b", "mamba2_1_3b", "zamba2_7b", *CROSS_ARCHS)
SLOTS, REQUESTS, PROMPT_LEN, MAX_NEW = 8, 16, 256, 64
TOP_K, TOP_P = 16, 0.95
#: llama-3.2-vision's depth on one card: 2 of its 20 groups
VLM_LAYERS = 10
#: scale of the stub frames' / patches' rank-one part (``cross_extras``)
STUB_AMP = 2.0


@dataclasses.dataclass
class Workload:
    cfg: object
    params: dict
    prompts: np.ndarray       # (REQUESTS, PROMPT_LEN) int32
    page_size: int
    cache_len: int
    #: encdec / vlm: the stub frames / patches of the SLOTS rows
    extras: dict = dataclasses.field(default_factory=dict)


def config(arch: str):
    """``arch``'s published config, llama-3.2-vision cut to
    ``VLM_LAYERS`` layers."""
    cfg = load_config(arch)
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, n_layers=VLM_LAYERS)
    return cfg


def cross_extras(cfg, gen) -> dict:
    """Stub frames (encdec) or patches (vlm) of SLOTS rows from ``gen``, in
    ``cfg.dtype``; {} for the other families. A row is N(0, 1) noise plus
    one direction u ~ N(0, I) scaled at each position by a ~ N(0,
    STUB_AMP^2). Noise alone gives a near-uniform softmax over the 1664
    patches whose output averages to ~0, so the cross path would carry no
    weight; the rank-one part spreads the scores and gives the values a
    common direction."""
    if cfg.family == "encdec":
        seq, name = cfg.enc_seq, "frames"
    elif cfg.family == "vlm":
        seq, name = cfg.vision_seq, "patches"
    else:
        return {}
    dev = gen.device
    x = torch.randn((SLOTS, seq, cfg.d_model), generator=gen, device=dev)
    u = torch.randn((SLOTS, 1, cfg.d_model), generator=gen, device=dev)
    a = torch.randn((SLOTS, seq, 1), generator=gen, device=dev) * STUB_AMP
    return {name: (x + a * u).to(cfg.dtype)}


def set_gates(params, gen) -> None:
    """The vlm cross layers' tanh gates, drawn from +-[0.5, 1.5] by
    ``gen`` (the published init of 0 makes every cross layer add
    nothing)."""
    for pc in params.get("cross", ()):
        for name in ("gate_attn", "gate_mlp"):
            u = torch.rand(2, generator=gen, device=gen.device).tolist()
            pc[name].fill_((0.5 + u[0]) * (1.0 if u[1] < 0.5 else -1.0))


def workload(seed: int = 0, device="cuda", arch: str = ARCH,
             cfg=None) -> Workload:
    """The full-width model (random weights from ``seed``) and prompts;
    ``cfg`` in place of ``arch``'s config (a smoke config). encdec / vlm
    get their stub inputs and (vlm) nonzero gates from the seed too."""
    cfg = config(arch) if cfg is None else cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(gen, cfg, device=device)
    set_gates(params, gen)
    extras = cross_extras(cfg, gen)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(REQUESTS, PROMPT_LEN), dtype=np.int32)
    ps = int(registry.tuning.lookup("page_gather")["page_size"])
    cache_len = -(-(PROMPT_LEN + MAX_NEW) // ps) * ps
    return Workload(cfg, params, prompts, ps, cache_len, extras)


def fixed(w: Workload) -> bool:
    """encdec and vlm serve through ``serve_loop``'s fixed-batch loop."""
    return w.cfg.family in M.CROSS_FAMILIES


def paged_default(w: Workload) -> bool:
    """The attention families serve from the paged pool; the recurrent
    ones keep their O(1) state a slot contiguous (nothing to page)."""
    return w.cfg.family in M.ATTENTION_FAMILIES


def engine(w: Workload, *, paged=None, temperature=1.0, seed=0,
           slots=None) -> Engine:
    if paged is None:
        paged = paged_default(w)
    return Engine(w.params, w.cfg, slots=SLOTS if slots is None else slots,
                  cache_len=w.cache_len,
                  prompt_pad=PROMPT_LEN, temperature=temperature,
                  top_k=TOP_K, top_p=TOP_P, seed=seed, paged=paged,
                  page_size=w.page_size)


def requests(w: Workload, count: int | None = None) -> list:
    return [Request(rid=i, prompt=w.prompts[i], max_new=MAX_NEW)
            for i in range(REQUESTS if count is None else count)]


def run(w: Workload, count: int | None = None, **kw):
    """One engine run of the first ``count`` requests (all by default);
    returns (tokens {rid: list}, EngineStats). encdec / vlm: one wave of
    the first SLOTS requests through ``run_fixed``."""
    if fixed(w):
        return run_fixed(w, **kw)
    res, stats = engine(w, **kw).run(requests(w, count))
    return {r: v.tokens for r, v in res.items()}, stats


def run_fixed(w: Workload, *, temperature=1.0, seed=0):
    """The first SLOTS prompts and their stub inputs through
    ``serve_loop``'s fixed-batch loop; returns (tokens {row: list},
    ServeStats)."""
    dev = w.params["embed"]["embed"].device
    toks, stats = serve.serve_loop(
        w.params, w.cfg, torch.from_numpy(w.prompts[:SLOTS]).to(dev),
        max_new=MAX_NEW, cache_len=PROMPT_LEN + MAX_NEW,
        temperature=temperature, top_k=TOP_K, top_p=TOP_P, seed=seed,
        **w.extras)
    return {i: row for i, row in enumerate(toks.tolist())}, stats


def kv_bytes_per_row(cfg, cache_len: int) -> dict:
    """Decode-cache bytes of one row: the self-attention K/V at
    ``cache_len`` and the static cross K/V."""
    specs = M.cache_specs(cfg, batch=1, cache_len=cache_len)
    return {"self_kv": _spec_bytes(specs["kv"]),
            "cross_kv": _spec_bytes(specs["xkv"])}


def prefill_ms(w: Workload) -> dict:
    """CUDA-event ms of the fixed loop's prefill of SLOTS rows, and of its
    cross K/V part alone (the encoder and every decoder layer's
    projection, or every cross layer's projection of the patches)."""
    dev = w.params["embed"]["embed"].device
    tok = torch.from_numpy(w.prompts[:SLOTS]).to(dev)
    return {
        "prefill": _event_ms(lambda: M.prefill(
            w.params, w.cfg, tok, cache_len=PROMPT_LEN + MAX_NEW,
            **w.extras), 3),
        "cross_kv": _event_ms(lambda: M.cross_kv(w.params, w.cfg,
                                                 **w.extras), 3)}


def state_bytes_per_slot(cfg) -> int:
    """Decode-cache bytes of one slot whose size does not grow with the
    context: the float32 SSM state and the conv history of every layer
    (a hybrid model's K/V, one column a group per token, is left out)."""
    specs = M.cache_specs(cfg, batch=1, cache_len=1)
    specs.pop("kv", None)
    return _spec_bytes(specs)


def _spec_bytes(specs) -> int:
    """Bytes of a tree of ``cache_specs`` (shape, dtype) leaves."""
    leaves = []
    M._tree_map(leaves.append, specs)
    return sum(int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
               for shape, dt in leaves)


# ---------------------------------------------------------------------------
# where one decode step's device time goes
# ---------------------------------------------------------------------------

CATEGORIES = (
    ("page gathers", ("page_gather",)),
    ("expert grouped GEMMs", ("groupproblemshape", "grouped")),
    ("sampler sort network", ("inblock_kernel", "window_kernel")),
    ("sampler mask", ("nucleus_kernel",)),
    ("matmuls", ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "xmma",
                 "splitk", "cublas")),
)


def _category(name: str, categories=CATEGORIES) -> str:
    """The class of kernel ``name``: the first of ``categories`` ((class,
    name fragments) pairs) one of whose fragments it holds."""
    low = name.lower()
    for cat, keys in categories:
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
    """A steady-state decode step: every slot live at position
    PROMPT_LEN + MAX_NEW // 2. The paged path's tables run over a full
    pool of random K/V pages (a scattered permutation of page ids); the
    recurrent models' contiguous state, conv history and (zamba2) K/V
    are random, and their table is None; encdec / vlm: the fixed loop's
    contiguous self and cross K/V, random, at one scalar position."""
    cfg, dev = w.cfg, w.params["embed"]["embed"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if fixed(w):
        # the fixed loop: contiguous self K/V, random cross K/V, every
        # row at one scalar position
        caches = M.zero_caches(cfg, batch=SLOTS,
                               cache_len=PROMPT_LEN + MAX_NEW, device=dev)
        M._tree_map(lambda c: c.normal_(generator=gen), caches)
        tok = torch.randint(0, cfg.vocab, (SLOTS, 1), generator=gen,
                            device=dev, dtype=torch.int32)
        keys = serve.request_keys(seed, list(range(SLOTS)), [0] * SLOTS,
                                  dev)
        return caches, None, tok, PROMPT_LEN + MAX_NEW // 2, keys
    if paged_default(w):
        T = w.cache_len // w.page_size
        caches = M.zero_paged_caches(cfg, num_pages=SLOTS * T,
                                     page_size=w.page_size, device=dev)
        table = torch.randperm(SLOTS * T, generator=gen, device=dev).to(
            torch.int32).view(SLOTS, T)
    else:
        caches = M.zero_caches(cfg, batch=SLOTS, cache_len=w.cache_len,
                               device=dev)
        table = None
    M._tree_map(lambda c: c.normal_(generator=gen), caches)
    tok = torch.randint(0, cfg.vocab, (SLOTS, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    pos = torch.full((SLOTS,), PROMPT_LEN + MAX_NEW // 2, device=dev)
    keys = serve.request_keys(seed, list(range(SLOTS)), [0] * SLOTS, dev)
    return caches, table, tok, pos, keys


def decode_step(w: Workload, inputs):
    """One engine decode step: the model through the page table, then the
    sampler under the engine's "sampler" preset."""
    caches, table, tok, pos, keys = inputs
    logits, _ = M.decode_step(
        w.params, w.cfg, tok, caches, pos, block_tables=table,
        page_size=None if table is None else w.page_size)
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
    """A paged decode step's parts alone, as functions to time at the
    step's shapes: every weight product of the layers and the head (the
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
    return fns


def recurrent_parts(w: Workload, inputs) -> dict:
    """A recurrent model's decode-step parts alone, as functions to time
    at the step's shapes: every weight product (the SSM layers' in and
    out projections, the shared block's and the head), the shared block's
    attention core at each of its G applications (zamba2), the
    sampler."""
    cfg, p = w.cfg, w.params
    caches, _, tok, pos, keys = inputs
    dev = tok.device
    x = torch.randn(SLOTS, 1, cfg.d_model, device=dev).to(cfg.dtype)
    xi = torch.randn(SLOTS, 1, cfg.d_inner, device=dev).to(cfg.dtype)
    hybrid = cfg.family == "hybrid"
    ssm_layers = ([lp for g in p["layers"] for lp in g]
                  + list(p["tail"] or ()) if hybrid else p["layers"])
    G = len(p["layers"]) if hybrid else 0

    def matmuls():
        for lp in ssm_layers:
            x @ lp["ssm"]["in_proj"]
            xi @ lp["ssm"]["out_proj"]
        if hybrid:
            a, m = p["shared"]["attn"], p["shared"]["mlp"]
            f = torch.randn(SLOTS, 1, cfg.d_ff, device=dev).to(cfg.dtype)
            for _ in range(G):
                for wt in (a["wq"], a["wk"], a["wv"], a["wo"],
                           m["w_gate"], m["w_up"]):
                    x @ wt
                f @ m["w_down"]
        x @ p["head"]["unembed"]

    logits = torch.randn(SLOTS, cfg.padded_vocab(16), device=dev)

    def sampler():
        with registry.tuning.preset("sampler"):
            serve.sample_logits(keys, logits, top_k=TOP_K, top_p=TOP_P,
                                vocab=cfg.vocab)

    fns = {"weight matmuls": matmuls, "sampler": sampler}
    if hybrid:
        H, hd = cfg.n_heads, cfg.head_dim
        q = torch.randn(SLOTS, 1, H, hd, device=dev).to(cfg.dtype)
        k, v = caches["kv"]["k"][0], caches["kv"]["v"][0]

        def attention():
            for _ in range(G):
                L.blockwise_attention(q, k, v, causal=True, q_offset=pos)

        fns["attention core"] = attention
    return fns


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


def cross_parts(w: Workload, inputs) -> dict:
    """An encdec / vlm decode step's parts alone, as functions to time at
    the step's shapes: every weight product (each layer's q, k, v, o of
    the self-attention, the cross-attention's q and o, the MLPs and the
    head; the cross K/V are projected at prefill, not here), the
    self-attention core of every self-attention layer, the
    cross-attention core of every cross layer, the sampler."""
    cfg, p = w.cfg, w.params
    caches, _, tok, pos, keys = inputs
    dev = tok.device
    H, hd = cfg.n_heads, cfg.head_dim
    x = torch.randn(SLOTS, 1, cfg.d_model, device=dev).to(cfg.dtype)
    f = torch.randn(SLOTS, 1, cfg.d_ff, device=dev).to(cfg.dtype)
    if cfg.family == "encdec":
        selfs = crosses = mlps = p["layers"]
    else:
        selfs = [lp for g in p["layers"] for lp in g]
        crosses = p["cross"]
        mlps = selfs + crosses

    def matmuls():
        for lp in selfs:
            for wt in ("wq", "wk", "wv", "wo"):
                x @ lp["attn"][wt]
        for lp in crosses:
            x @ lp["xattn"]["wq"]
            x @ lp["xattn"]["wo"]
        for lp in mlps:
            x @ lp["mlp"]["w_gate"]
            x @ lp["mlp"]["w_up"]
            f @ lp["mlp"]["w_down"]
        x @ p["head"]["unembed"]

    q = torch.randn(SLOTS, 1, H, hd, device=dev).to(cfg.dtype)
    kv = caches["kv"]
    sk, sv = (kv["k"][0], kv["v"][0]) if cfg.family == "encdec" \
        else (kv["k"][0, 0], kv["v"][0, 0])
    xk, xv = caches["xkv"]["k"][0], caches["xkv"]["v"][0]

    def self_attention():
        for _ in selfs:
            L.blockwise_attention(q, sk, sv, causal=True, q_offset=pos)

    def cross_attention():
        for _ in crosses:
            L.blockwise_attention(q, xk, xv, causal=False)

    logits = torch.randn(SLOTS, cfg.padded_vocab(16), device=dev)

    def sampler():
        with registry.tuning.preset("sampler"):
            serve.sample_logits(keys, logits, top_k=TOP_K, top_p=TOP_P,
                                vocab=cfg.vocab)

    return {"weight matmuls": matmuls,
            "self-attention core": self_attention,
            "cross-attention core": cross_attention, "sampler": sampler}


def _parts(w: Workload, inputs) -> dict:
    if fixed(w):
        return cross_parts(w, inputs)
    return (parts if paged_default(w) else recurrent_parts)(w, inputs)


def timed_step(w: Workload, inputs) -> dict:
    """CUDA-event ms of one decode step and of each of its parts alone
    (host work included), and the rest of the step. Run it before any
    ``torch.profiler`` run in the process: on the card's machine a
    profiler run leaves every later launch slower."""
    out = {"step": _event_ms(lambda: decode_step(w, inputs))}
    out.update((n, _event_ms(f)) for n, f in _parts(w, inputs).items())
    out["rest of the step"] = out["step"] - sum(
        v for n, v in out.items() if n != "step")
    return out


def profiled_step(w: Workload, inputs, reps: int = 3) -> dict:
    """Device ms of one decode step by kernel class and by kernel
    (``torch.profiler`` over ``reps`` steps), the host clock per profiled
    step, each part's device ms, and (paged) the host cost of a page
    gather."""
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
    out = {
        "wall_ms": wall, "device_ms": sum(cats.values()),
        "parts_device_ms": {n: _device_ms(f)
                            for n, f in _parts(w, inputs).items()},
        "categories_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(kernels.items(),
                                      key=lambda kv: -kv[1])[:12]),
    }
    if paged_default(w):
        out["page_gather_host_us"] = gather_host_us(w, inputs)
    return out


def combine(parts_ms: dict, profiled: dict) -> dict:
    """One breakdown from ``timed_step`` and ``profiled_step``: the idle
    share is 1 - device ms / the step's CUDA-event ms (taken without the
    profiler's own host cost)."""
    step = parts_ms["step"]
    return {"parts_ms": parts_ms, **profiled,
            "idle_share": max(0.0, 1.0 - profiled["device_ms"] / step)}


def breakdown(w: Workload, reps: int = 3, seed: int = 0) -> dict:
    """Where one decode step's time goes: ``timed_step``, then
    ``profiled_step``, combined."""
    inputs = decode_step_inputs(w, seed)
    return combine(timed_step(w, inputs), profiled_step(w, inputs, reps))


def summary(stats) -> dict:
    if isinstance(stats, serve.ServeStats):
        # the fixed-batch loop: no engine, one prefill, one wave
        return {"tokens": stats.tokens, "decode_s": stats.decode_s,
                "tokens_per_s": stats.tokens_per_s,
                "prefill_s": stats.prefill_s}
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
           "engine": summary(stats)}
    if fixed(w):
        out["prefill_ms"] = prefill_ms(w)
        out["kv_bytes_per_row"] = kv_bytes_per_row(
            w.cfg, PROMPT_LEN + MAX_NEW)
    out["decode_step"] = breakdown(w)
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
