"""deepseek-67b [dense]: llama-architecture GQA.

95 layers, d_model=8192, 64 heads (kv=8), d_ff=22016, vocab=102400.
[arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
)


def smoke_config():
    return ModelConfig(
        name="deepseek_67b_smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        remat=False,
    )
