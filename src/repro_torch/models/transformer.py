"""Dense decoder layer: init and apply (counterpart of the dense part of
``repro/models/transformer.py``). The other families' blocks come with
their slices."""
from __future__ import annotations

from repro_torch.models import layers as L


def dense_layer_init(gen, cfg, device):
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": L.attention_init(gen, cfg, device),
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
