"""whisper-medium [encdec]: encoder-decoder transformer backbone.

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16, i.e.
MHA), d_ff=4096, vocab=51865.  [arXiv:2212.04356; unverified]

As in the reference: the log-mel conv stem is a stub (the caller hands
in frame embeddings (B, enc_seq, d_model)); the encoder adds sinusoidal
positions to them, as whisper does after its conv stem; the decoder uses
RoPE in place of learned positional embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    enc_seq=1536,  # 1500 mel frames padded to a multiple of 128
)


def smoke_config():
    return ModelConfig(
        name="whisper_medium_smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        enc_seq=32,
        remat=False,
    )
