"""Transformer layers: RMSNorm, RoPE, GQA self-attention over contiguous,
per-slot and paged KV caches, blockwise attention, SwiGLU, embedding and head
(counterpart of ``repro/models/layers.py``).

Parameters are plain dicts of tensors, as in the reference. The large
products are ``torch.matmul``, which the JAX package also left to its
compiler; the one kernel on this path is the paged cache's gather, reached
through the ``page_gather`` registry primitive. The reference's sharding
hooks sit where it has them (``models.sharding``): the identity outside
the sharded train step, where each rank computes on its local shards and
the hooks add the collectives (column-parallel Q/K/V and SwiGLU
gate/up, row-parallel out and down projections, the vocab-parallel
embedding and head). Under tensor parallelism each rank computes its
query heads (``_q_project``); K/V heads that do not divide the axis are
gathered whole and each rank reads the ones its query heads use
(``_kv_project``).

Caches are written IN PLACE (the reference's functional ``.at[].set`` on
donated buffers): ``attention_apply`` returns the same cache dict it was
given, its tensors updated.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.paging import page_gather
from repro_torch.models import sharding as SH

# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------


def rmsnorm_init(d, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def dense_init(gen, d_in, d_out, dtype, device):
    """Uniform in [-1/sqrt(d_in), 1/sqrt(d_in)], drawn in float32."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    w.uniform_(-scale, scale, generator=gen)
    return w.to(dtype)


def rope_freqs(head_dim, theta, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)  # (half,)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (S,) or (B, S) absolute positions."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv   # (..., S, half)
    ang = ang[..., None, :]                               # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_init(gen, cfg, device):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, H * hd, cfg.dtype, device),
        "wk": dense_init(gen, d, KV * hd, cfg.dtype, device),
        "wv": dense_init(gen, d, KV * hd, cfg.dtype, device),
        "wo": dense_init(gen, H * hd, d, cfg.dtype, device),
    }


def _mask_scores(s, mask):
    # s: (B, KV, G, Sq, chunk); mask: (Sq, chunk) or (B, Sq, chunk)
    m = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    return torch.where(m, s, torch.full((), -math.inf, device=s.device)), m


def blockwise_attention(q, k, v, *, causal, q_offset=0, chunk=1024,
                        k_offset=0, merge_axes=()):
    """Online-softmax grouped-query attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0; the KV
    planes are never head-repeated (queries reshape to (B, Sq, KV, G, hd)).
    Scans KV in chunks with running (max, sum, acc). ``q_offset``: absolute
    position of q[0] relative to k[0] for causality, a scalar or a (B,)
    per-row vector (each serving slot attends its own ``[0, pos_b]``).

    A decode row (Sq = 1) may read one slice of a cache whose sequence is
    sharded over the mesh axes ``merge_axes`` (``sharding.kv_seq_layout``):
    ``k_offset`` is the global position of k[0], and this slice's (max,
    sum, acc) are merged with the other ranks' (``sharding.merge_split_k``),
    so a slice that lies wholly past the query weighs 0.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg = (q * scale).to(torch.float32).reshape(B, Sq, KV, G, hd)
    q_off = torch.as_tensor(q_offset, device=dev)
    q_pos = q_off[..., None] + torch.arange(Sq, device=dev)  # (Sq,)|(B, Sq)

    if Sq == 1:
        # decode: one query row, the whole cache in one score matrix
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
        k_pos = k_offset + torch.arange(Sk, device=dev)
        mask = (k_pos <= q_pos[..., None] if causal
                else torch.ones((Sq, Sk), dtype=torch.bool, device=dev))
        s, mb = _mask_scores(s, mask)
        if not merge_axes:
            p = torch.softmax(s, dim=-1)
            out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
            return out.reshape(B, Sq, H, hd).to(q.dtype)
        m = s.amax(dim=-1)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(mb, torch.exp(s - m_safe[..., None]), 0.0)
        out = SH.merge_split_k(
            m, p.sum(dim=-1),
            torch.einsum("bkgqs,bskd->bkgqd", p, v.to(torch.float32)),
            merge_axes)                                     # (B,KV,G,Sq,hd)
        return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    if merge_axes:
        raise NotImplementedError(
            "attention over a sequence-sharded cache takes one query row "
            "(a decode step); a prefill into one is not ported")
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    m = torch.full((B, KV, G, Sq), -math.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        lo, hi = ci * chunk, min((ci + 1) * chunk, Sk)
        kb = k[:, lo:hi].to(torch.float32)
        vb = v[:, lo:hi].to(torch.float32)
        k_pos = torch.arange(lo, hi, device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kb)
        mask = (k_pos <= q_pos[..., None] if causal else torch.ones(
            q_pos.shape + (hi - lo,), dtype=torch.bool, device=dev))
        s, mb = _mask_scores(s, mask)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked rows (m_new = -inf): exp(-inf - -inf) would be nan
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mb, p, zero)
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                     torch.full((), -math.inf, device=dev)))
        corr = torch.where(torch.isfinite(m), corr, zero)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                   vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,KV,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _write_kv(cache, rows, cols, valid, k, v):
    """cache[rows, cols] = (k, v) where valid; (rows, cols, valid) are
    (B, Sq) and out-of-range targets DROP, as the reference's
    ``mode="drop"`` scatter does (a clamped write would corrupt a live
    column). Without a host sync: every dropped lane repeats the first
    valid lane's write (the same target and bits, so the duplicates are
    harmless), and when no lane is valid every lane writes element (0, 0)
    back with the value it already holds."""
    ok = valid.reshape(-1)
    n = ok.numel()
    first = torch.argmax(ok.to(torch.int8))      # first valid lane, else 0
    lane = torch.where(ok, torch.arange(n, device=ok.device), first)
    any_ok = ok.any()
    zero = torch.zeros((), dtype=torch.long, device=ok.device)
    r = torch.where(any_ok, rows.reshape(-1)[lane].long(), zero)
    c = torch.where(any_ok, cols.reshape(-1)[lane].long(), zero)
    for name, new in (("k", k), ("v", v)):
        buf = cache[name]
        val = new.reshape(n, *new.shape[2:])[lane].to(buf.dtype)
        buf.index_put_((r, c), torch.where(any_ok, val, buf[0, 0]))


def attention_apply(p, cfg, x, *, positions, causal=True, cache=None,
                    cache_index=None, block_table=None, page_size=None,
                    chunk=1024):
    """Self-attention with an optional KV cache; returns (out, cache).
    Cross-attention is ``transformer._cross_attend`` over K/V projected by
    ``transformer.project_cross_kv``.

    ``cache``: dict(k=(B, S_cache, KV, hd), v=...), written at
    ``cache_index`` (a scalar: every row at one position, or a (B,)
    vector of per-slot positions, out-of-range ones dropping the write:
    a parked slot) and then attended in full under the per-row causal
    offset. A scalar write of one token goes to column clamp(index, 0,
    S - 1), the reference's ``dynamic_update_slice`` start, through the
    drop path of ``_write_kv`` (no host sync).

    Under the sharded decode's context a contiguous cache is this rank's
    block in the placement of ``sharding.cache_spec_tree``. Where its
    sequence is sharded (``sharding.kv_seq_layout``) the column is
    clamped globally and only the rank that holds it writes; the
    positions of its keys are global, and the ranks' softmax statistics
    are merged (``blockwise_attention``). Where that includes ``model``
    each rank holds every KV head, so it projects the new token's K/V for
    all of them and attends every query head (Q gathered over ``model``,
    or projected from the whole ``wq`` where the heads do not divide the
    axis), then keeps its own heads for the row-parallel output.

    PAGED cache: with ``block_table`` (B, T) int32 and ``page_size`` the
    cache leaves are a page pool (P, page_size, KV, hd). Row b's logical
    column c lives at (block_table[b, c // page_size], c % page_size);
    columns past T * page_size and table entries >= P drop, and attention
    reads the logical view back through the ``page_gather`` primitive.
    """
    hd = cfg.head_dim
    B, Sq, _ = x.shape
    dev = x.device
    lay = SH.KVLayout((), 0, 0)
    if cache is not None and block_table is None:
        lay = SH.kv_seq_layout(cfg, cache["k"].shape[1])
    whole = "model" in lay.axes    # every head of a slice on each rank
    x = SH.enter_tp(x)
    q = _q_project(p, cfg, x, all_heads=whole)
    k, v = _kv_project(p, cfg, x, all_heads=whole)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        ci = torch.as_tensor(cache_index, device=dev)
        ci_v = ci if ci.dim() == 1 else ci.expand(B)
        cols = ci_v[:, None] + torch.arange(Sq, device=dev)[None, :]
        if block_table is not None:
            ps = int(page_size)
            P, T = cache["k"].shape[0], block_table.shape[1]
            slot = torch.clamp(cols // ps, 0, T - 1)
            phys = torch.gather(block_table, 1, slot).long()
            valid = (cols < T * ps) & (phys < P)
            offs = cols % ps
            _write_kv(cache, phys, offs, valid, k, v)
            # K and V share the table: one gather (one launch) for both
            k, v = page_gather((cache["k"], cache["v"]), block_table)
        elif ci.dim() == 1 or Sq == 1:
            if ci.dim() == 0:
                # the reference's dynamic_update_slice: the start clamps
                # so the update fits
                cols = torch.clamp(cols, 0, lay.length - 1)
            S = cache["k"].shape[1]
            cols = cols - lay.offset
            rows = torch.arange(B, device=dev)[:, None].expand(B, Sq)
            _write_kv(cache, rows, cols, (cols >= 0) & (cols < S), k, v)
            k, v = cache["k"], cache["v"]
        else:
            if lay.axes:
                raise NotImplementedError(
                    "a prefill into a sequence-sharded cache is not ported "
                    "(the reference's sharded decode runs one token)")
            S = cache["k"].shape[1]
            start = min(max(int(ci), 0), S - Sq)
            cache["k"][:, start:start + Sq] = k.to(cache["k"].dtype)
            cache["v"][:, start:start + Sq] = v.to(cache["v"].dtype)
            k, v = cache["k"], cache["v"]
        q_offset = ci
        causal = True
    else:
        q_offset = 0

    out = blockwise_attention(q, k.to(q.dtype), v.to(q.dtype),
                              causal=causal, q_offset=q_offset, chunk=chunk,
                              k_offset=lay.offset, merge_axes=lay.axes)
    if whole:
        out = own_heads(cfg, out)
    return _o_project(p, cfg, out.reshape(B, Sq, -1)), cache


def own_heads(cfg, out):
    """This ``model`` rank's query heads of an all-heads output (B, S, H,
    hd)."""
    lo, hi = _head_range(cfg)
    return out[:, :, lo:hi]


def _head_range(cfg) -> tuple[int, int]:
    """This ``model`` rank's query heads [lo, hi): its column block when
    the heads divide the axis, else whole heads dealt out in order."""
    n, r, H = SH.tp_size(), SH.tp_rank(), cfg.n_heads
    return r * H // n, (r + 1) * H // n


def _q_project(p, cfg, x, all_heads=False):
    """Q (B, S, H_l, hd) of this rank's query heads, or of every head with
    ``all_heads`` (gathered over ``model``). When the heads do not divide
    the ``model`` axis (the yi smoke model's 7 on 2 ranks) ``wq`` is
    gathered whole over the axis and each rank takes its heads' columns
    (all of them with ``all_heads``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    w = SH.col_parallel(p["wq"])
    if cfg.n_heads % SH.tp_size():
        w = SH.gather_tp(w, -1)
        if not all_heads:
            lo, hi = _head_range(cfg)
            w = w[:, lo * hd:hi * hd]
        return (x @ w).reshape(B, S, -1, hd)
    q = (x @ w).reshape(B, S, -1, hd)
    return SH.gather_tp(q, 2) if all_heads else q


def _o_project(p, cfg, out):
    """The row-parallel output projection of this rank's heads (B, S,
    H_l * hd), summed over ``model``."""
    w = SH.row_parallel(p["wo"])
    if cfg.n_heads % SH.tp_size():
        lo, hi = _head_range(cfg)
        w = SH.gather_tp(w, 0)[lo * cfg.head_dim:hi * cfg.head_dim]
    return SH.finish_tp(out @ w)


def _kv_project(p, cfg, src, all_heads=False):
    """K and V (B, S, KV_l, hd) of ``src`` (B, S, d) for this rank's
    query heads, or every KV head with ``all_heads`` (the weights gathered
    whole over ``model``). Without tensor parallelism, or when the query and KV
    heads both divide the ``model`` axis, each rank's column slice of
    ``wk``/``wv``. Otherwise a column split would cut KV heads in half
    (granite and the 8-KV configs at 16-way TP, glm4's 2, the smoke
    models' 1 and 2): the weights are gathered whole over ``model`` and
    each rank projects the KV heads its query heads read (Megatron's
    replicated KV heads): a contiguous group range when its heads hold
    whole groups, the one head when they share one, else one KV head per
    query head (the GQA grouping undone, exactly)."""
    KV, H, hd = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    B, S, _ = src.shape
    n = SH.tp_size()
    if all_heads:
        return tuple((src @ SH.gather_tp(SH.col_parallel(p[w]), -1))
                     .reshape(B, S, KV, hd) for w in ("wk", "wv"))
    if H % n == 0 and KV % n == 0:
        return tuple((src @ SH.col_parallel(p[w])).reshape(B, S, KV // n, hd)
                     for w in ("wk", "wv"))
    G = H // KV
    lo, hi = _head_range(cfg)
    if lo // G == (hi - 1) // G:
        heads = [lo // G]
    elif lo % G == 0 and hi % G == 0:
        heads = list(range(lo // G, hi // G))
    else:
        heads = [h // G for h in range(lo, hi)]
    idx = torch.tensor(heads, device=src.device)

    def proj(w):
        w = SH.gather_tp(SH.col_parallel(p[w]), -1)
        w = w.reshape(w.shape[0], KV, hd).index_select(1, idx)
        return (src @ w.reshape(w.shape[0], -1)).reshape(B, S, -1, hd)
    return proj("wk"), proj("wv")


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------


def swiglu_init(gen, d, d_ff, dtype, device):
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, device),
        "w_up": dense_init(gen, d, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d, dtype, device),
    }


def swiglu(p, x):
    x = SH.enter_tp(x)
    gate = torch.nn.functional.silu(x @ SH.col_parallel(p["w_gate"]))
    return SH.finish_tp((gate * (x @ SH.col_parallel(p["w_up"])))
                        @ SH.row_parallel(p["w_down"]))


def embedding_init(gen, vocab_padded, d, dtype, device):
    w = torch.empty((vocab_padded, d), dtype=torch.float32, device=device)
    w.normal_(generator=gen)
    return {"embed": (w * 0.02).to(dtype)}


def embed(p, tokens):
    """Rows of the table; vocab-parallel under tensor parallelism (each
    rank looks up the ids in its vocab slice, zeros elsewhere, summed over
    ``model``: one nonzero term, so exact). The lookup is
    ``F.embedding``, whose backward on the card sums a row's
    contributions in float32 and rounds once. With an index lookup
    (``w[tokens]``) the bf16 table gradients of the sharded and the
    one-rank step at granite-moe-1b's widths differed by 0.215 of their
    largest |value| (a frequent token's row sums hundreds of uses); with
    ``F.embedding`` by 0.005, each within 0.004 of the float32 gradient
    (PERF.md section 6)."""
    w = SH.gather_weight(p["embed"], -1)
    if SH.tp_size() == 1:
        return torch.nn.functional.embedding(tokens.long(), w)
    V_l = w.shape[0]
    ids = tokens.long() - SH.tp_rank() * V_l
    ok = (ids >= 0) & (ids < V_l)
    rows = torch.nn.functional.embedding(ids.clamp(0, V_l - 1), w)
    return SH.finish_tp(torch.where(ok[..., None], rows,
                                    torch.zeros((), dtype=rows.dtype,
                                                device=rows.device)))


def lm_head_init(gen, d, vocab_padded, dtype, device):
    return {"unembed": dense_init(gen, d, vocab_padded, dtype, device)}


def lm_head(p, x):
    """Logits over the padded vocab; under tensor parallelism this rank's
    vocab slice (the reference's P(dp, None, "model") logits)."""
    return SH.enter_tp(x) @ SH.col_parallel(p["unembed"])
