"""zamba2-7b [hybrid]: Mamba2 backbone + ONE shared attention block.

81 layers, d_model=3584, 32 heads (kv=32) in the shared block, d_ff=14336,
vocab=32000, ssm_state=64.  [arXiv:2411.15242; unverified]

Structure, as in the reference: 13 groups of 6 Mamba2 layers, each group
followed by the SHARED attn+MLP block (one parameter set, 13
applications, 13 distinct KV caches), plus a 3-layer Mamba2 tail: 81 SSM
layers in all. Zamba2's LoRA per-application adapters on the shared
block are omitted (a noted deviation).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
)


def smoke_config():
    return ModelConfig(
        name="zamba2_7b_smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        ssm_state=16,
        ssm_headdim=16,
        hybrid_attn_every=2,
        ssm_chunk=8,
        remat=False,
    )
