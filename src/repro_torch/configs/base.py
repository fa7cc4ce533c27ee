"""Architecture config schema (counterpart of ``repro/configs/base.py``).

One ``<arch>.py`` per ported architecture lives next to this file; each
exports ``CONFIG`` (the published numbers) and ``smoke_config()`` (a
reduced same-family config for CPU tests). The reference's dry-run
surface (``input_specs``, ``cells``, ``SHAPES``) is not ported: nothing
on the serving or training path reads it. The fields keep the
reference's names and defaults, with ``dtype`` a torch dtype; its
cost-model field ``unroll_layers`` belongs to the dry run and is left out.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int           # attention query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int               # dense FFN width (per-expert width for MoE)
    vocab: int

    head_dim: int = 0       # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    first_layer_dense: bool = False

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2): one shared attention block applied every k layers
    hybrid_attn_every: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1536

    # VLM (llama-3.2-vision): cross-attn layer every k layers
    cross_attn_every: int = 0
    vision_seq: int = 1664

    # training
    dtype: Any = torch.bfloat16
    remat: bool = True
    # "full" recomputes each layer in backward (least memory); the
    # reference's "dots" is refused; remat=False keeps every activation
    # (models/model.py::_maybe_remat)
    remat_policy: str = "full"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_headdim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def padded_vocab(self, tp: int = 16) -> int:
        """Vocab rounded up to a multiple of 128 * tp (the reference's
        model-axis shard alignment, kept so the two packages' logits have
        the same width)."""
        q = 128 * tp
        return -(-self.vocab // q) * q


#: Architectures of the port: all ten of the reference's.
ARCH_IDS = ["internlm2_1_8b", "glm4_9b", "yi_34b", "deepseek_67b",
            "granite_moe_1b", "deepseek_moe_16b", "mamba2_1_3b",
            "zamba2_7b", "whisper_medium", "llama32_vision_90b"]


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(
            f"architecture {arch!r} is not ported yet (ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def load_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def load_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
