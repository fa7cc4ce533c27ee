"""Ported architecture configs (the published numbers) + smoke variants."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    ModelConfig,
    load_config,
    load_smoke_config,
)
