"""granite-moe-1b-a400m [moe]: 32 experts, top-8, fine-grained d_ff=512.

24 layers, d_model=1024, 16 heads (kv=8), per-expert d_ff=512, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_1b",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    top_k=8,
)


def smoke_config():
    return ModelConfig(
        name="granite_moe_1b_smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=32,
        vocab=256,
        n_experts=8,
        top_k=2,
        moe_capacity_factor=8.0,  # drop-free: decode/forward logits agree
        remat=False,
    )
