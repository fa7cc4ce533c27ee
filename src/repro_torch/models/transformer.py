"""Layers of every family: init and apply (counterpart of
``repro/models/transformer.py``). The encdec decoder block adds
cross-attention to the encoder's output after its causal self-attention;
the vlm cross layer is a gated (tanh) cross-attention + MLP layer over the
patch embeddings, with no self-attention."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as SH
from repro_torch.models import ssm as SSM


def dense_layer_init(gen, cfg, device):
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": L.attention_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device),
    }


def moe_layer_init(gen, cfg, device):
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": L.attention_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "moe": MOE.moe_init(gen, cfg, device),
    }


def ssm_layer_init(gen, cfg, device):
    return {"ln": L.rmsnorm_init(cfg.d_model, device),
            "ssm": SSM.ssm_init(gen, cfg, device)}


def cross_layer_init(gen, cfg, device):
    """A vlm cross layer; its gates start at 0, as in the reference, so a
    fresh layer adds nothing (tanh(0) = 0)."""
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "xattn": L.attention_init(gen, cfg, device),
        "gate_attn": torch.zeros((), dtype=torch.float32, device=device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device),
        "gate_mlp": torch.zeros((), dtype=torch.float32, device=device),
    }


def encdec_dec_layer_init(gen, cfg, device):
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": L.attention_init(gen, cfg, device),
        "lnx": L.rmsnorm_init(cfg.d_model, device),
        "xattn": L.attention_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device),
    }


def dense_block(p, cfg, x, positions, *, cache=None, cache_index=None,
                block_table=None, page_size=None, causal=True, chunk=1024):
    h, new_cache = L.attention_apply(
        p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
        positions=positions, causal=causal, cache=cache,
        cache_index=cache_index, block_table=block_table,
        page_size=page_size, chunk=chunk,
    )
    x = x + h
    x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, new_cache


def moe_block(p, cfg, x, positions, *, mesh=None, dp_axes=("data",),
              cache=None, cache_index=None, block_table=None,
              page_size=None, chunk=1024, use_ep=True):
    """Attention + the MoE FFN: (x, aux_loss, cache). With ``use_ep`` and
    a ``mesh`` (``launch.mesh.HostMesh``) the FFN is the expert-parallel
    ``moe_ffn_ep`` over its ``model`` ranks, else the single-program
    ``moe_ffn`` (its balance loss over the mesh's ``dp_axes``)."""
    h, new_cache = L.attention_apply(
        p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
        positions=positions, causal=True, cache=cache,
        cache_index=cache_index, block_table=block_table,
        page_size=page_size, chunk=chunk,
    )
    x = x + h
    z = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if use_ep and mesh is not None:
        y, aux = MOE.moe_ffn_ep(p["moe"], cfg, z, mesh=mesh, dp_axes=dp_axes)
    else:
        y, aux = MOE.moe_ffn(p["moe"], cfg, z, mesh=mesh, dp_axes=dp_axes)
    return x + y, aux, new_cache


def ssm_block(p, cfg, x, *, state=None, conv_state=None):
    """A pre-norm Mamba2 layer: (x, new_state, new_conv_state)."""
    h, new_state, new_conv = SSM.ssm_apply(
        p["ssm"], cfg, L.rmsnorm(p["ln"], x, cfg.norm_eps),
        state=state, conv_state=conv_state,
    )
    return x + h, new_state, new_conv


def _gated_add(x, gate, h):
    """x + tanh(gate) * h, the product in float32, cast to x's dtype."""
    return x + (torch.tanh(gate) * h.to(torch.float32)).to(x.dtype)


def _cross_attend(p_attn, cfg, z, enc_kv, chunk, placed=False):
    """Queries of ``z`` against cross K/V (B, Sk, KV, hd): ``placed``, the
    static cross cache of a decode step, which the sharded decode holds
    in its placement (where its sequence is sharded, the ranks' softmax
    statistics are merged unmasked, as ``layers.attention_apply`` merges
    a self-attention cache's); else projected here by
    ``project_cross_kv``, this rank's heads of the whole sequence."""
    B, Sq, _ = z.shape
    axes = (SH.kv_seq_layout(cfg, enc_kv["k"].shape[1]).axes if placed
            else ())
    whole = "model" in axes
    q = L._q_project(p_attn, cfg, SH.enter_tp(z), all_heads=whole)
    h = L.blockwise_attention(q, enc_kv["k"].to(q.dtype),
                              enc_kv["v"].to(q.dtype), causal=False,
                              chunk=chunk, merge_axes=axes)
    if whole:
        h = L.own_heads(cfg, h)
    return L._o_project(p_attn, cfg, h.reshape(B, Sq, -1))


def project_cross_kv(p_attn, cfg, src):
    """The cross K/V of one layer from ``src`` (B, Sk, d): no norm, no
    RoPE (this rank's KV heads under tensor parallelism)."""
    k, v = L._kv_project(p_attn, cfg, SH.enter_tp(src))
    return {"k": k, "v": v}


def encdec_dec_block(p, cfg, x, positions, *, enc_out=None, enc_kv=None,
                     cache=None, cache_index=None, chunk=1024):
    """A decoder block: causal self-attention, cross-attention, MLP.
    ``enc_out`` (the forward: K/V projected here, from the encoder's output
    without a norm) or ``enc_kv`` (serving: K/V projected once at prefill;
    they never change while decoding)."""
    h, new_cache = L.attention_apply(
        p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
        positions=positions, causal=True, cache=cache,
        cache_index=cache_index, chunk=chunk,
    )
    x = x + h
    z = L.rmsnorm(p["lnx"], x, cfg.norm_eps)
    placed = enc_kv is not None
    if not placed:
        enc_kv = project_cross_kv(p["xattn"], cfg, enc_out)
    x = x + _cross_attend(p["xattn"], cfg, z, enc_kv, chunk, placed)
    x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, new_cache


def cross_block(p, cfg, x, vis, positions, *, chunk=1024):
    """A gated cross-attention layer (llama-3.2-vision): K/V projected from
    the raw patches ``vis``, no norm on them and no RoPE."""
    enc_kv = project_cross_kv(p["xattn"], cfg, vis)
    return cross_block_cached(p, cfg, x, enc_kv, positions, chunk=chunk,
                              placed=False)


def cross_block_cached(p, cfg, x, enc_kv, positions, *, chunk=1024,
                       placed=True):
    """The vlm cross layer against the prefill's cached patch K/V
    (``placed``: the decode's cross cache, see ``_cross_attend``)."""
    del positions
    z = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = _gated_add(x, p["gate_attn"], _cross_attend(p["xattn"], cfg, z,
                                                    enc_kv, chunk, placed))
    h = L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return _gated_add(x, p["gate_mlp"], h)
