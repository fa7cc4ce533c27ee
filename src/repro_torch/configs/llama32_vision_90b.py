"""llama-3.2-vision-90b [vlm]: dense GQA decoder + gated cross-attention
layers.

100 layers (20 groups of 4 dense + 1 cross-attention), d_model=8192, 64
heads (kv=8), d_ff=28672, vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision (90B scale-up); unverified]

As in the reference: the ViT tower is a stub (the caller hands in patch
embeddings (B, vision_seq, d_model)); the cross-attention layers are
gated by tanh of a learned scalar and carry no causal self-attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama32_vision_90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    vision_seq=1664,
)


def smoke_config():
    return ModelConfig(
        name="llama32_vision_90b_smoke",
        family="vlm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        cross_attn_every=2,
        vision_seq=16,
        remat=False,
    )
