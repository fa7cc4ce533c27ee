"""Top-level model of all six families: init, forward, prefill, decode
step, contiguous and paged caches (counterpart of
``repro/models/model.py``).

Parameters are a plain dict of tensors on one device; the reference's
stacked (L, ...) layer leaves are a list of per-layer dicts here (a
hybrid model's (G, gs, ...) leaves a list of G lists of gs dicts),
driven by a Python loop where the reference scans. Caches keep the
reference's layouts (``cache_specs``): attention K/V of (L, B, S, KV,
hd), paged pools of (L, P, page_size, KV, hd), SSM state of (L, B, H, P,
N) in float32 and the conv history of (L, B, K-1, conv_dim). Decode and
prefill write the caches IN PLACE and return them (the reference donates
them to its jit).

A moe model stacks [attention, MoE FFN] layers, with deepseek-moe's
layer 0 a dense layer whose FFN is as wide as the shared and routed
experts' activation together (``params["layer0"]``, cache layer 0). An
ssm model stacks Mamba2 layers. A hybrid model (zamba2) runs G groups of
gs Mamba2 layers, each group followed by ONE shared attention + MLP
block (``params["shared"]``) with that group's own K/V cache, then a
tail of ``n_layers - G * gs`` Mamba2 layers (``params["tail"]``, None
when empty).

An encdec model (whisper) runs an encoder of ``n_enc_layers`` dense
non-causal layers (``params["enc_layers"]``) over the caller's frame
embeddings plus sinusoidal positions, with RoPE at the frame positions
and no final norm; each decoder layer (``params["layers"]``) adds
cross-attention to the encoder's output. A vlm model (llama-3.2-vision)
runs G groups of gs dense layers (``params["layers"]``, G lists of gs
dicts), each group followed by one gated cross-attention layer
(``params["cross"]``, G dicts) over the caller's patch embeddings. Both
serve from a contiguous cache: the self-attention ``kv`` and the static
cross K/V ``xkv``, projected once at prefill (``frames=`` /
``patches=``) and read by every decode step. Neither pages.

Training: ``loss_fn`` is the reference's next-token cross-entropy plus
the MoE balance loss over ``forward``, which recomputes each layer body
in backward under ``cfg.remat`` and runs the MoE layers expert-parallel
under ``use_ep`` and a mesh. Every family backpropagates through eager
torch ops; the routing's kernels need no backward (``moe.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.common import NEG_MASK
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T

TP_DEFAULT = 16
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
#: Families whose decode cache is attention K/V alone (padded prompts,
#: paged pools); the others carry recurrent state or cross K/V.
ATTENTION_FAMILIES = ("dense", "moe")
#: Families that attend to a second input (frames / patches) through a
#: static cross K/V cache.
CROSS_FAMILIES = ("encdec", "vlm")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (families: "
                         f"{FAMILIES})")


def _check_paged(cfg):
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(
            f"paged KV cache needs an attention-family cache; family "
            f"{cfg.family!r} has recurrent state or cross K/V (nothing to "
            f"page)")


def _vocab(cfg):
    return cfg.padded_vocab(TP_DEFAULT)


def init_params(gen: torch.Generator, cfg, device="cuda"):
    """Random parameters with the reference's distributions (embedding
    N(0, 0.02^2), projections U(+-1/sqrt(d_in)), norm scales 1, the SSM
    block's as ``ssm.ssm_init``, the vlm cross layers' gates 0), drawn
    from ``gen`` on ``device``; the draws are not the reference's."""
    _check_family(cfg)
    V, d = _vocab(cfg), cfg.d_model
    p = {
        "embed": L.embedding_init(gen, V, d, cfg.dtype, device),
        "final_norm": L.rmsnorm_init(d, device),
        "head": L.lm_head_init(gen, d, V, cfg.dtype, device),
    }
    fam = cfg.family
    if fam == "dense":
        p["layers"] = [T.dense_layer_init(gen, cfg, device)
                       for _ in range(cfg.n_layers)]
    elif fam == "moe":
        p["layers"] = [T.moe_layer_init(gen, cfg, device)
                       for _ in range(cfg.n_layers - _first_dense(cfg))]
        if _first_dense(cfg):
            p["layer0"] = T.dense_layer_init(gen, _dense_ff_view(cfg),
                                             device)
    elif fam == "ssm":
        p["layers"] = [T.ssm_layer_init(gen, cfg, device)
                       for _ in range(cfg.n_layers)]
    elif fam == "encdec":
        p["enc_layers"] = [T.dense_layer_init(gen, cfg, device)
                           for _ in range(cfg.n_enc_layers)]
        p["layers"] = [T.encdec_dec_layer_init(gen, cfg, device)
                       for _ in range(cfg.n_layers)]
    elif fam == "vlm":
        G, gs = _vlm_shape(cfg)
        p["layers"] = [[T.dense_layer_init(gen, cfg, device)
                        for _ in range(gs)] for _ in range(G)]
        p["cross"] = [T.cross_layer_init(gen, cfg, device)
                      for _ in range(G)]
    else:
        G, gs, tail = _hybrid_shape(cfg)
        p["layers"] = [[T.ssm_layer_init(gen, cfg, device)
                        for _ in range(gs)] for _ in range(G)]
        p["tail"] = ([T.ssm_layer_init(gen, cfg, device)
                      for _ in range(tail)] if tail else None)
        p["shared"] = T.dense_layer_init(gen, cfg, device)  # ONE block
    return p


def _first_dense(cfg) -> int:
    """1 when layer 0 is a dense layer in front of the moe stack."""
    return int(cfg.family == "moe" and cfg.first_layer_dense)


def _dense_ff_view(cfg):
    """deepseek-moe layer 0: a dense FFN sized like the shared + routed
    activation."""
    return dataclasses.replace(
        cfg, d_ff=cfg.d_ff * (cfg.top_k + cfg.n_shared_experts))


def _hybrid_shape(cfg) -> tuple[int, int, int]:
    """(G groups, gs SSM layers a group, the tail's SSM layers)."""
    gs = cfg.hybrid_attn_every
    G = cfg.n_layers // gs
    return G, gs, cfg.n_layers - G * gs


def _vlm_shape(cfg) -> tuple[int, int]:
    """(G groups, gs dense layers a group before its cross layer)."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def _sinusoidal(seq, d, device):
    """(seq, d) float32 sinusoidal positions: sines then cosines."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encode(params, cfg, frames, chunk):
    """The encoder over the frame embeddings (B, Se, d): sinusoidal
    positions added, dense non-causal layers with RoPE at the frame
    positions, no final norm."""
    Se = frames.shape[1]
    h = frames + _sinusoidal(Se, cfg.d_model, frames.device).to(frames.dtype)
    pos = torch.arange(Se, device=frames.device)
    body = _maybe_remat(lambda h, p: T.dense_block(
        p, cfg, h, pos, causal=False, chunk=chunk)[0], cfg)
    for p in params["enc_layers"]:
        h = body(h, p)
    return h


def param_count(params) -> int:
    def count(t):
        if t is None:
            return 0
        if isinstance(t, torch.Tensor):
            return t.numel()
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return sum(count(v) for v in t)
    return count(params)


REMAT_POLICIES = ("full", "dots")


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep every matmul's output, recompute the
    rest (``jax.checkpoint_policies.checkpoint_dots``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg):
    """``fn`` with its activations recomputed in backward (the reference's
    ``jax.checkpoint`` around each scanned layer body) when ``cfg.remat``
    and autograd is on: ``torch.utils.checkpoint.checkpoint`` without
    reentry. Policy ``"full"`` saves the inputs only; ``"dots"`` saves the
    outputs of ``mm``/``bmm``/``addmm`` too (a selective checkpoint), so
    backward recomputes everything but the matmuls."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r} is not one of "
                         f"{REMAT_POLICIES}")
    if not cfg.remat:
        return fn
    import functools

    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def forward(params, cfg, tokens, *, frames=None, patches=None, mesh=None,
            dp_axes=("data",), use_ep=True, chunk=1024):
    """A full sequence (no cache) -> (logits over the padded vocab, the
    MoE balance loss summed over layers: 0 for the other families).
    ``frames`` (B, enc_seq, d) for encdec, ``patches`` (B, vision_seq, d)
    for vlm. With ``use_ep`` and a ``mesh`` (``launch.mesh.HostMesh``)
    the MoE layers run expert-parallel over its ``model`` ranks
    (``moe.moe_ffn_ep``). With ``cfg.remat`` each layer body (an encdec
    encoder or decoder layer, a vlm or hybrid group, a moe, dense or ssm
    layer) is recomputed in backward, as the reference's scan bodies
    are."""
    _check_family(cfg)
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    fam = cfg.family

    def remat(fn, *args):
        return _maybe_remat(fn, cfg)(*args)

    if fam == "encdec":
        def dec_body(x, p, enc):
            return T.encdec_dec_block(p, cfg, x, positions, enc_out=enc,
                                      chunk=chunk)[0]

        enc = _encode(params, cfg, frames, chunk)
        for p in params["layers"]:
            x = remat(dec_body, x, p, enc)
    elif fam == "vlm":
        def group_body(x, group, pc):
            for p in group:
                x, _ = T.dense_block(p, cfg, x, positions, chunk=chunk)
            return T.cross_block(pc, cfg, x, patches, positions, chunk=chunk)

        for group, pc in zip(params["layers"], params["cross"]):
            x = remat(group_body, x, group, pc)
    elif fam == "hybrid":
        def group_body(x, group):
            for p in group:
                x, _, _ = T.ssm_block(p, cfg, x)
            return T.dense_block(params["shared"], cfg, x, positions,
                                 chunk=chunk)[0]

        def ssm_body(x, p):
            return T.ssm_block(p, cfg, x)[0]

        for group in params["layers"]:
            x = remat(group_body, x, group)
        for p in params["tail"] or ():
            x = remat(ssm_body, x, p)
    else:
        def dense_body(x, p):
            return T.dense_block(p, cfg, x, positions, chunk=chunk)[0]

        def moe_body(x, p):
            x, aux, _ = T.moe_block(p, cfg, x, positions, mesh=mesh,
                                    dp_axes=dp_axes, use_ep=use_ep,
                                    chunk=chunk)
            return x, aux

        def ssm_body(x, p):
            return T.ssm_block(p, cfg, x)[0]

        if _first_dense(cfg):   # not scanned in the reference: no remat
            x = dense_body(x, params["layer0"])
        body = {"dense": dense_body, "moe": moe_body, "ssm": ssm_body}[fam]
        for p in params["layers"]:
            if fam == "moe":
                x, aux = remat(body, x, p)
                aux_total = aux_total + aux
            else:
                x = remat(body, x, p)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(params["head"], x), aux_total


def loss_fn(params, cfg, tokens, labels, *, frames=None, patches=None,
            mesh=None, dp_axes=("data",), use_ep=True, aux_weight=0.01):
    """Next-token cross-entropy over the true vocab -> (ce + aux_weight *
    aux, (ce, aux)), as the reference's: logits in float32, the padded
    columns set to ``NEG_MASK`` before the log-sum-exp, the mean over
    every (row, position). The label's logit is a gather, which equals
    the reference's masked sum exactly (one nonzero term).

    Inside the sharded train step (``models.sharding.mesh_context``) the
    logits are this rank's vocab slice, and the log-sum-exp is
    vocab-parallel, the reference's P(dp, None, "model") logits: the max
    (no gradient: the log-sum-exp does not depend on it) and the sum of
    exponentials are reduced over ``model``, and the label's logit comes
    from the rank whose slice holds it (a sum of one nonzero term). The
    mean over the data ranks' rows makes ``ce`` the whole batch's on
    every rank."""
    logits, aux = forward(params, cfg, tokens, frames=frames,
                          patches=patches, mesh=mesh, dp_axes=dp_axes,
                          use_ep=use_ep)
    logits = logits.to(torch.float32)
    V_l = logits.shape[-1]
    lo = SH.tp_rank() * V_l
    iota = lo + torch.arange(V_l, device=logits.device)
    logits = torch.where(iota < cfg.vocab, logits, NEG_MASK)
    if SH.tp_size() == 1:
        m = logits.amax(dim=-1, keepdim=True)
        lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
        label_logit = torch.gather(logits, -1,
                                   labels.long()[..., None])[..., 0]
    else:
        m = SH.tp_max(logits.detach().amax(dim=-1, keepdim=True))
        lse = m[..., 0] + torch.log(
            SH.finish_tp(torch.exp(logits - m).sum(dim=-1)))
        lab = labels.long() - lo
        ok = (lab >= 0) & (lab < V_l)
        picked = torch.gather(logits, -1,
                              lab.clamp(0, V_l - 1)[..., None])[..., 0]
        label_logit = SH.finish_tp(torch.where(ok, picked, 0.0))
    ce = SH.dp_mean(torch.mean(lse - label_logit))
    return ce + aux_weight * aux, (ce, aux)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_specs(cfg, *, batch, cache_len):
    """The contiguous decode cache as a tree of (shape, dtype) leaves, the
    reference's ``cache_specs`` leaf for leaf: ``{"kv": {"k", "v"}}`` for
    the attention families; ``{"ssm", "conv"}`` for ssm; for hybrid the
    groups' ``ssm`` (G, gs, B, ...) and ``conv``, one K/V cache a group
    (``kv`` over G) and, when the tail is not empty, ``ssm_tail`` and
    ``conv_tail``; for encdec ``kv`` and the cross ``xkv`` (L, B,
    enc_seq, ...); for vlm ``kv`` (G, gs, B, S, ...) and ``xkv`` (G, B,
    vision_seq, ...)."""
    _check_family(cfg)
    B, S, dt = batch, cache_len, cfg.dtype

    def kv(*lead, seq=S):
        shape = (*lead, B, seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (shape, dt), "v": (shape, dt)}

    fam = cfg.family
    if fam in ATTENTION_FAMILIES:
        return {"kv": kv(cfg.n_layers)}
    if fam == "encdec":
        return {"kv": kv(cfg.n_layers),
                "xkv": kv(cfg.n_layers, seq=cfg.enc_seq)}
    if fam == "vlm":
        G, gs = _vlm_shape(cfg)
        return {"kv": kv(G, gs), "xkv": kv(G, seq=cfg.vision_seq)}
    state = (B, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    conv = (B, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    if fam == "ssm":
        return {"ssm": ((cfg.n_layers, *state), torch.float32),
                "conv": ((cfg.n_layers, *conv), dt)}
    G, gs, tail = _hybrid_shape(cfg)
    out = {"ssm": ((G, gs, *state), torch.float32),
           "conv": ((G, gs, *conv), dt), "kv": kv(G)}
    if tail:
        out["ssm_tail"] = ((tail, *state), torch.float32)
        out["conv_tail"] = ((tail, *conv), dt)
    return out


def paged_cache_specs(cfg, *, num_pages, page_size):
    """Shapes of the PAGED cache: a pool of ``num_pages`` pages of
    ``page_size`` tokens, no batch axis (a (B, T) block table maps each
    lane's columns onto pages). Attention families only: recurrent state
    is O(1) a lane, so there is nothing to page."""
    _check_family(cfg)
    _check_paged(cfg)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"kv": {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}}


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of like-shaped
    ``rest``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _zeros(specs, device):
    return _tree_map(lambda s: torch.zeros(s[0], dtype=s[1], device=device),
                     specs)


def zero_caches(cfg, *, batch, cache_len, device="cuda"):
    return _zeros(cache_specs(cfg, batch=batch, cache_len=cache_len), device)


def zero_paged_caches(cfg, *, num_pages, page_size, device="cuda"):
    return _zeros(paged_cache_specs(cfg, num_pages=num_pages,
                                    page_size=page_size), device)


def cache_batch_axes(cfg):
    """Each cache leaf's batch axis (the slot scheduler's row), the same
    tree as ``cache_specs``: the hybrid's and the vlm's group axes come
    first."""
    _check_family(cfg)
    kv1 = {"k": 1, "v": 1}
    if cfg.family in ATTENTION_FAMILIES:
        return {"kv": kv1}
    if cfg.family == "encdec":
        return {"kv": kv1, "xkv": kv1}
    if cfg.family == "vlm":
        return {"kv": {"k": 2, "v": 2}, "xkv": kv1}
    if cfg.family == "ssm":
        return {"ssm": 1, "conv": 1}
    out = {"ssm": 2, "conv": 2, "kv": kv1}
    if _hybrid_shape(cfg)[2]:
        out["ssm_tail"] = 1
        out["conv_tail"] = 1
    return out


# ---------------------------------------------------------------------------
# decode and prefill
# ---------------------------------------------------------------------------


def decode_step(params, cfg, tokens, caches, position, *, chunk=1024,
                block_tables=None, page_size=None):
    """One serve step: tokens (B, 1) + caches -> (logits (B, 1, V), caches).

    ``position``: absolute index of the incoming token, a scalar or a (B,)
    vector of per-slot positions (positions past the cache park a slot:
    its K/V write drops; its recurrent state integrates garbage nobody
    reads until admission overwrites the row). With ``block_tables`` (B,
    T) int32 and ``page_size`` the caches are the paged pool of
    ``paged_cache_specs`` (attention families only).

    The sharded decode (the reference's jit over placed caches): under
    ``sharding.mesh_context(mesh, batch_size=B)`` every cache leaf is this
    rank's block in the placement of ``sharding.cache_spec_tree``,
    ``tokens`` its rows of the global batch (every row under
    ``seq_shard``), and the logits come back as its block of P(dp, None,
    "model") (P(None, None, "model") under ``seq_shard``). MoE layers run
    without expert parallelism, as the reference's decode does.
    """
    if block_tables is not None and cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(f"paged decode unsupported for {cfg.family!r}")
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
    fam = cfg.family
    # an ssm model reads no position (the dry run counts what is read)
    positions = None if fam == "ssm" else (
        torch.as_tensor(position, device=dev)[..., None]
        + torch.arange(S, device=dev))
    if fam in ATTENTION_FAMILIES:
        kvs = caches["kv"]
        kw = dict(cache_index=position, block_table=block_tables,
                  page_size=page_size, chunk=chunk)
        first = _first_dense(cfg)
        if first:
            x, _ = T.dense_block(params["layer0"], cfg, x, positions,
                                 cache={"k": kvs["k"][0],
                                        "v": kvs["v"][0]}, **kw)
        for i, p in enumerate(params["layers"], start=first):
            cache = {"k": kvs["k"][i], "v": kvs["v"][i]}
            if fam == "dense":
                x, _ = T.dense_block(p, cfg, x, positions, cache=cache,
                                     **kw)
            else:
                x, _, _ = T.moe_block(p, cfg, x, positions, cache=cache,
                                      **kw)
    elif fam == "ssm":
        x = _ssm_stack(params["layers"], cfg, x, caches["ssm"],
                       caches["conv"])
    elif fam == "encdec":
        kvs, xkv = caches["kv"], caches["xkv"]
        for i, p in enumerate(params["layers"]):
            x, _ = T.encdec_dec_block(
                p, cfg, x, positions,
                enc_kv={"k": xkv["k"][i], "v": xkv["v"][i]},
                cache={"k": kvs["k"][i], "v": kvs["v"][i]},
                cache_index=position, chunk=chunk)
    elif fam == "vlm":
        kvs, xkv = caches["kv"], caches["xkv"]
        for g, (group, pc) in enumerate(zip(params["layers"],
                                            params["cross"])):
            for j, p in enumerate(group):
                x, _ = T.dense_block(p, cfg, x, positions,
                                     cache={"k": kvs["k"][g, j],
                                            "v": kvs["v"][g, j]},
                                     cache_index=position, chunk=chunk)
            x = T.cross_block_cached(pc, cfg, x, {"k": xkv["k"][g],
                                                  "v": xkv["v"][g]},
                                     positions, chunk=chunk)
    else:
        kvs = caches["kv"]
        for g, group in enumerate(params["layers"]):
            x = _ssm_stack(group, cfg, x, caches["ssm"][g],
                           caches["conv"][g])
            # the shared block, with this group's own K/V cache
            x, _ = T.dense_block(params["shared"], cfg, x, positions,
                                 cache={"k": kvs["k"][g], "v": kvs["v"][g]},
                                 cache_index=position, chunk=chunk)
        if params["tail"] is not None:
            x = _ssm_stack(params["tail"], cfg, x, caches["ssm_tail"],
                           caches["conv_tail"])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head(params["head"], x), caches


def _ssm_stack(layers, cfg, x, states, convs):
    """Mamba2 layers in order over their caches (L, B, ...), each layer's
    new state and conv history written in place. S > 1 tokens are a
    prefill from position 0: the chunked scan starts from zero whatever
    the state cache holds, as in the reference. Under the sharded
    decode's context the conv cache is this rank's contiguous block of
    channels (``sharding.cache_spec_tree``): the history is gathered
    whole over ``model`` for the layer and its block written back."""
    for i, p in enumerate(layers):
        x, st, cv = T.ssm_block(p, cfg, x, state=states[i],
                                conv_state=SH.gather_tp(convs[i], -1))
        states[i].copy_(st)
        w = convs[i].shape[-1]
        convs[i].copy_(cv.narrow(-1, SH.tp_rank() * w, w))
    return x


def cross_kv(params, cfg, *, frames=None, patches=None, chunk=1024):
    """The static cross K/V of every cross layer, in ``cfg.dtype``: for
    encdec each decoder layer's projection of the encoder's output over
    ``frames`` ((L, B, Se, KV, hd) leaves), for vlm each cross layer's
    projection of the raw ``patches`` ((G, B, Sv, KV, hd))."""
    if cfg.family == "encdec":
        src, layers = _encode(params, cfg, frames, chunk), params["layers"]
    else:
        src, layers = patches, params["cross"]
    shape = (len(layers), *src.shape[:2], cfg.n_kv_heads, cfg.head_dim)
    out = {n: torch.empty(shape, dtype=cfg.dtype, device=src.device)
           for n in ("k", "v")}
    for i, p in enumerate(layers):
        for n, t in T.project_cross_kv(p["xattn"], cfg, src).items():
            out[n][i] = t
    return out


def prefill(params, cfg, tokens, *, cache_len, frames=None, patches=None,
            chunk=1024):
    """Run the prompt into fresh caches: (logits (B, S, V), caches, S).
    For encdec / vlm the cross K/V is projected from ``frames`` /
    ``patches`` once, here, before the prompt runs."""
    B, S = tokens.shape
    specs = cache_specs(cfg, batch=B, cache_len=cache_len)
    if cfg.family in CROSS_FAMILIES:
        del specs["xkv"]
    caches = _zeros(specs, tokens.device)
    if cfg.family in CROSS_FAMILIES:
        caches["xkv"] = cross_kv(params, cfg, frames=frames,
                                 patches=patches, chunk=chunk)
    logits, caches = _decode(params, cfg, tokens, caches, 0, chunk=chunk)
    return logits, caches, S


def slot_prefill(params, cfg, tokens, caches, slot, *, cache_len,
                 chunk=1024):
    """Prefill ONE request (tokens (1, S): right-padded for the attention
    families, the true prompt for the recurrent ones) into row ``slot``
    of the shared cache. The row of every leaf is zeroed first and the
    prefill then writes it in place, which equals the reference's fresh
    batch-1 prefill copied into the row: a recurrent slot's whole state
    and conv history are overwritten, whatever a parked lane integrated
    there. Neighbouring slots are untouched. Returns (logits (1, S, V),
    caches)."""
    _check_family(cfg)
    axes = cache_batch_axes(cfg)
    if "kv" in caches:
        cols = caches["kv"]["k"].shape[axes["kv"]["k"] + 1]
        if cols != cache_len:
            raise ValueError(f"cache holds {cols} columns, cache_len is "
                             f"{cache_len}")
    row = _tree_map(lambda t, ax: t.narrow(ax, slot, 1), caches, axes)
    _tree_map(lambda t: t.zero_(), row)
    logits, _ = _decode(params, cfg, tokens, row, 0, chunk=chunk)
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
    _check_paged(cfg)
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
