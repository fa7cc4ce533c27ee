"""Architecture config schema (counterpart of ``repro/configs/base.py``).

One ``<arch>.py`` per ported architecture lives next to this file; each
exports ``CONFIG`` (the published numbers) and ``smoke_config()`` (a
reduced same-family config for CPU tests). ``input_specs`` builds the
``meta`` tensors the dry run (``launch/dryrun.py``) traces against: no
allocation. The fields keep the reference's names and defaults, with
``dtype`` a torch dtype.
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
    # "full" recomputes each layer in backward (least memory); "dots"
    # saves the matmul outputs and recomputes the rest; remat=False keeps
    # every activation (models/model.py::_maybe_remat)
    remat_policy: str = "full"

    # the reference's cost-model mode (unroll every scanned layer so XLA's
    # cost analysis counts each iteration). Eager PyTorch runs every layer
    # anyway and the port's loops are Python loops, so it changes nothing
    # here; kept so a config reads the same in both packages.
    unroll_layers: bool = False

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


# ---------------------------------------------------------------------------
# the assigned shape suite (seq_len, global_batch, kind), the reference's
# ---------------------------------------------------------------------------
SHAPES = {
    "train_4k":    dict(seq=4_096,   batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768,  batch=32,  kind="prefill"),
    "decode_32k":  dict(seq=32_768,  batch=128, kind="decode"),
    "long_500k":   dict(seq=524_288, batch=1,   kind="decode"),
}

#: Architectures of the port: all ten of the reference's, in its order.
ARCH_IDS = [
    "whisper_medium",
    "zamba2_7b",
    "llama32_vision_90b",
    "glm4_9b",
    "internlm2_1_8b",
    "deepseek_67b",
    "yi_34b",
    "granite_moe_1b",
    "deepseek_moe_16b",
    "mamba2_1_3b",
]

# long_500k needs sub-quadratic sequence mixing; only SSM/hybrid archs run
# it (the reference's DESIGN.md §6 records the skip)
SUBQUADRATIC = {"zamba2_7b", "mamba2_1_3b"}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(
            f"architecture {arch!r} is not ported yet (ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def load_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def load_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def cells(include_skipped: bool = False):
    """All (arch, shape, skipped) dry-run cells, honouring the long_500k
    rule."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            skipped = shape == "long_500k" and arch not in SUBQUADRATIC
            if skipped and not include_skipped:
                continue
            out.append((arch, shape, skipped))
    return out


def input_specs(cfg: ModelConfig, shape_name):
    """``meta`` tensors standing in for every model input of a cell (the
    reference's ShapeDtypeStructs; nothing is allocated):

    train   -> {tokens, labels [, frames | patches]}
    prefill -> {tokens [, frames | patches]}
    decode  -> {tokens (B, 1), caches, position}

    ``shape_name``: a SHAPES key or a dict(seq=, batch=, kind=). The
    reference's ``tp`` argument has no counterpart: it placed nothing."""
    from repro_torch.models import model as M

    s = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    B, S = s["batch"], s["seq"]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = meta((B, cfg.enc_seq, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        extras["patches"] = meta((B, cfg.vision_seq, cfg.d_model), cfg.dtype)
    if s["kind"] == "train":
        return dict(tokens=meta((B, S), torch.int32),
                    labels=meta((B, S), torch.int32), **extras)
    if s["kind"] == "prefill":
        return dict(tokens=meta((B, S), torch.int32), **extras)
    caches = _map_leaves(lambda sd: meta(*sd),
                         M.cache_specs(cfg, batch=B, cache_len=S))
    return dict(tokens=meta((B, 1), torch.int32),
                position=meta((), torch.int32), caches=caches)


def _map_leaves(fn, node):
    """``fn`` over the (shape, dtype) leaves of a ``cache_specs`` tree."""
    if isinstance(node, dict):
        return {k: _map_leaves(fn, v) for k, v in node.items()}
    return fn(node)
