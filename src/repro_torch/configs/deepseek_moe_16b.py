"""deepseek-moe-16b [moe]: 2 shared + 64 routed experts, top-6, fine-grained.

28 layers (layer 0 dense), d_model=2048, 16 heads (kv=16), per-expert
d_ff=1408, vocab=102400.  [arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_moe_16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_layer_dense=True,
)


def smoke_config():
    return ModelConfig(
        name="deepseek_moe_16b_smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab=256,
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        moe_capacity_factor=8.0,  # drop-free: decode/forward logits agree
        first_layer_dense=True,
        remat=False,
    )
