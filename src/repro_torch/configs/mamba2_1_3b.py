"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.

48 layers, d_model=2048, ssm_state=128, headdim=64 (64 SSD heads at
expand=2), vocab=50280.  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_1_3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
)


def smoke_config():
    return ModelConfig(
        name="mamba2_1_3b_smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=256,
        ssm_state=16,
        ssm_headdim=16,
        ssm_chunk=8,
        remat=False,
    )
