"""internlm2-1.8b [dense]: GQA.

24 layers, d_model=2048, 16 heads (kv=8), d_ff=8192, vocab=92544.
[arXiv:2403.17297; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2_1_8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
)


def smoke_config():
    return ModelConfig(
        name="internlm2_1_8b_smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        remat=False,
    )
