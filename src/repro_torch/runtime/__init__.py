"""Runtime services of the PyTorch port: for now the tracing spans
(``telemetry``), stdlib-only like their JAX-package original."""
from repro_torch.runtime import telemetry  # noqa: F401
