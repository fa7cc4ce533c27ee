"""glm4-9b [dense]: RoPE + GQA with kv=2.

40 layers, d_model=4096, 32 heads (kv=2), d_ff=13696, vocab=151552.
[hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4_9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
)


def smoke_config():
    return ModelConfig(
        name="glm4_9b_smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        remat=False,
    )
