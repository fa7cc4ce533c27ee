"""Top-level model of the dense and moe families: init, forward, prefill,
decode step, contiguous and paged caches (counterpart of
``repro/models/model.py``).

Parameters are a plain dict of tensors on one device; the reference's
stacked (L, ...) layer leaves are a list of per-layer dicts here, driven
by a Python loop where the reference scans. Caches keep the reference's
layouts: contiguous ``{"kv": {"k", "v"}}`` of (L, B, S, KV, hd), paged
pools of (L, P, page_size, KV, hd). Decode and prefill write the caches
IN PLACE and return them (the reference donates them to its jit).

A moe model stacks [attention, MoE FFN] layers, with deepseek-moe's
layer 0 a dense layer whose FFN is as wide as the shared and routed
experts' activation together (``params["layer0"]``, cache layer 0).

Other families raise ``NotImplementedError``: ssm, hybrid, encdec and vlm
come with later slices of the port.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TP_DEFAULT = 16
FAMILIES = ("dense", "moe")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: {FAMILIES}); "
            f"ssm, hybrid, encdec and vlm come with later slices")


def _vocab(cfg):
    return cfg.padded_vocab(TP_DEFAULT)


def init_params(gen: torch.Generator, cfg, device="cuda"):
    """Random parameters with the reference's distributions (embedding
    N(0, 0.02^2), projections U(+-1/sqrt(d_in)), norm scales 1), drawn
    from ``gen`` on ``device``; the draws are not the reference's."""
    _check_family(cfg)
    V, d = _vocab(cfg), cfg.d_model
    p = {
        "embed": L.embedding_init(gen, V, d, cfg.dtype, device),
        "final_norm": L.rmsnorm_init(d, device),
        "head": L.lm_head_init(gen, d, V, cfg.dtype, device),
    }
    if cfg.family == "dense":
        p["layers"] = [T.dense_layer_init(gen, cfg, device)
                       for _ in range(cfg.n_layers)]
    else:
        p["layers"] = [T.moe_layer_init(gen, cfg, device)
                       for _ in range(cfg.n_layers - _first_dense(cfg))]
        if _first_dense(cfg):
            p["layer0"] = T.dense_layer_init(gen, _dense_ff_view(cfg),
                                             device)
    return p


def _first_dense(cfg) -> int:
    """1 when layer 0 is a dense layer in front of the moe stack."""
    return int(cfg.family == "moe" and cfg.first_layer_dense)


def _dense_ff_view(cfg):
    """deepseek-moe layer 0: a dense FFN sized like the shared + routed
    activation."""
    return dataclasses.replace(
        cfg, d_ff=cfg.d_ff * (cfg.top_k + cfg.n_shared_experts))


def param_count(params) -> int:
    def count(t):
        if isinstance(t, torch.Tensor):
            return t.numel()
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return sum(count(v) for v in t)
    return count(params)


def forward(params, cfg, tokens, *, chunk=1024):
    """A full sequence (no cache) -> (logits over the padded vocab, the
    MoE balance loss summed over layers: 0 for dense)."""
    _check_family(cfg)
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if _first_dense(cfg):
        x, _ = T.dense_block(params["layer0"], cfg, x, positions,
                             chunk=chunk)
    for p in params["layers"]:
        if cfg.family == "dense":
            x, _ = T.dense_block(p, cfg, x, positions, chunk=chunk)
        else:
            x, aux, _ = T.moe_block(p, cfg, x, positions, chunk=chunk)
            aux_total = aux_total + aux
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(params["head"], x), aux_total


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_specs(cfg, *, batch, cache_len):
    """{"kv": {"k": (shape, dtype), "v": ...}} of the contiguous cache."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}}


def paged_cache_specs(cfg, *, num_pages, page_size):
    """Shapes of the PAGED cache: a pool of ``num_pages`` pages of
    ``page_size`` tokens, no batch axis (a (B, T) block table maps each
    lane's columns onto pages)."""
    _check_family(cfg)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"kv": {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}}


def _zeros(specs, device):
    return {"kv": {n: torch.zeros(shape, dtype=dt, device=device)
                   for n, (shape, dt) in specs["kv"].items()}}


def zero_caches(cfg, *, batch, cache_len, device="cuda"):
    return _zeros(cache_specs(cfg, batch=batch, cache_len=cache_len), device)


def zero_paged_caches(cfg, *, num_pages, page_size, device="cuda"):
    return _zeros(paged_cache_specs(cfg, num_pages=num_pages,
                                    page_size=page_size), device)


def cache_batch_axes(cfg):
    """Each cache leaf's batch axis (the slot scheduler's row)."""
    _check_family(cfg)
    return {"kv": {"k": 1, "v": 1}}


# ---------------------------------------------------------------------------
# decode and prefill
# ---------------------------------------------------------------------------


def decode_step(params, cfg, tokens, caches, position, *, chunk=1024,
                block_tables=None, page_size=None):
    """One serve step: tokens (B, 1) + caches -> (logits (B, 1, V), caches).

    ``position``: absolute index of the incoming token, a scalar or a (B,)
    vector of per-slot positions (positions past the cache park a slot:
    its write drops). With ``block_tables`` (B, T) int32 and ``page_size``
    the caches are the paged pool of ``paged_cache_specs``.
    """
    return _decode(params, cfg, tokens, caches, position, chunk=chunk,
                   block_tables=block_tables, page_size=page_size)


def _decode(params, cfg, tokens, caches, position, *, chunk=1024,
            block_tables=None, page_size=None):
    """Cache-stepping forward for any query length: S = 1 is the decode
    step; S = prompt length on zeroed caches at position 0 is the
    prefill."""
    _check_family(cfg)
    B, S = tokens.shape
    dev = tokens.device
    x = L.embed(params["embed"], tokens)
    positions = (torch.as_tensor(position, device=dev)[..., None]
                 + torch.arange(S, device=dev))
    kvs = caches["kv"]
    kw = dict(cache_index=position, block_table=block_tables,
              page_size=page_size, chunk=chunk)
    first = _first_dense(cfg)
    if first:
        x, _ = T.dense_block(params["layer0"], cfg, x, positions,
                             cache={"k": kvs["k"][0], "v": kvs["v"][0]}, **kw)
    for i, p in enumerate(params["layers"], start=first):
        cache = {"k": kvs["k"][i], "v": kvs["v"][i]}
        if cfg.family == "dense":
            x, _ = T.dense_block(p, cfg, x, positions, cache=cache, **kw)
        else:
            x, _, _ = T.moe_block(p, cfg, x, positions, cache=cache, **kw)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(params["head"], x), caches


def prefill(params, cfg, tokens, *, cache_len, chunk=1024):
    """Run the prompt into fresh caches: (logits (B, S, V), caches, S)."""
    B, S = tokens.shape
    caches = zero_caches(cfg, batch=B, cache_len=cache_len,
                         device=tokens.device)
    logits, caches = _decode(params, cfg, tokens, caches, 0, chunk=chunk)
    return logits, caches, S


def slot_prefill(params, cfg, tokens, caches, slot, *, cache_len,
                 chunk=1024):
    """Prefill ONE request (tokens (1, S), right-padded) into row ``slot``
    of the shared cache. The row is zeroed first and the prefill then
    writes it in place, which equals the reference's fresh batch-1 prefill
    copied into the row; neighbouring slots are untouched.
    Returns (logits (1, S, V), caches)."""
    _check_family(cfg)
    kvs = caches["kv"]
    if kvs["k"].shape[2] != cache_len:
        raise ValueError(f"cache holds {kvs['k'].shape[2]} columns, "
                         f"cache_len is {cache_len}")
    row = {n: kvs[n][:, slot:slot + 1] for n in ("k", "v")}
    for t in row.values():
        t.zero_()
    logits, _ = _decode(params, cfg, tokens, {"kv": row}, 0, chunk=chunk)
    return logits, caches


def paged_prefill(params, cfg, tokens, caches, page_ids, *, cache_len,
                  page_size, chunk=1024):
    """Prefill ONE request and scatter its prompt K/V pages into the pool.

    tokens: (1, S) right-padded prompt; ``page_ids``: (ceil(S /
    page_size),) destination pages. The prefill runs at the same
    ``cache_len`` as ``slot_prefill``, so logits and K/V are bit for bit the
    contiguous engine's. A page id >= the pool size is the don't-write
    sentinel (pure pad, or a prefix page shared by copy-on-write whose
    bytes are already resident): it drops. Returns (logits, caches)."""
    page_ids = torch.as_tensor(page_ids, device=tokens.device).long()
    n_pp = page_ids.shape[0]
    logits, fresh, _ = prefill(params, cfg, tokens, cache_len=cache_len,
                               chunk=chunk)
    keep = torch.nonzero(page_ids < caches["kv"]["k"].shape[1],
                         as_tuple=True)[0]
    for name in ("k", "v"):
        leaf = fresh["kv"][name]                 # (L, 1, cache_len, KV, hd)
        pages = leaf[:, 0, : n_pp * page_size].reshape(
            leaf.shape[0], n_pp, page_size, *leaf.shape[3:])
        pool = caches["kv"][name]                # (L, P, page_size, KV, hd)
        pool[:, page_ids[keep]] = pages[:, keep].to(pool.dtype)
    return logits, caches
