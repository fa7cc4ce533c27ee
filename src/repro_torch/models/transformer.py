"""Decoder layers of the dense, moe, ssm and hybrid families: init and
apply (counterpart of ``repro/models/transformer.py``). The encdec and
vlm blocks come with their slice."""
from __future__ import annotations

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
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


def moe_block(p, cfg, x, positions, *, cache=None, cache_index=None,
              block_table=None, page_size=None, chunk=1024):
    """Attention + the single-program MoE FFN: (x, aux_loss, cache)."""
    h, new_cache = L.attention_apply(
        p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
        positions=positions, causal=True, cache=cache,
        cache_index=cache_index, block_table=block_table,
        page_size=page_size, chunk=chunk,
    )
    x = x + h
    y, aux = MOE.moe_ffn(p["moe"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + y, aux, new_cache


def ssm_block(p, cfg, x, *, state=None, conv_state=None):
    """A pre-norm Mamba2 layer: (x, new_state, new_conv_state)."""
    h, new_state, new_conv = SSM.ssm_apply(
        p["ssm"], cfg, L.rmsnorm(p["ln"], x, cfg.norm_eps),
        state=state, conv_state=conv_state,
    )
    return x + h, new_state, new_conv
