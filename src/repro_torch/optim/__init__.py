"""The port's optimizer: AdamW over parameter trees and int8
error-feedback gradient compression (counterpart of ``repro/optim``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
)
from repro_torch.optim.compression import (  # noqa: F401
    compressed_psum,
    dequantize_int8,
    quantize_int8,
)
