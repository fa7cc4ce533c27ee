"""yi-34b [dense]: llama-architecture GQA.

60 layers, d_model=7168, 56 heads (kv=8), d_ff=20480, vocab=64000.
[arXiv:2403.04652; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi_34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
)


def smoke_config():
    return ModelConfig(
        name="yi_34b_smoke",
        family="dense",
        n_layers=2,
        d_model=56,   # keeps the 56-head:8-kv ratio family-faithful
        n_heads=7,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        remat=False,
    )
