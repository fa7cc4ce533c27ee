"""Runtime services of the PyTorch port: tracing spans (``telemetry``),
the metrics registry (``metrics``), deterministic fault injection
(``faults``) and supervised steps (``supervisor``); stdlib and numpy only,
like their JAX-package originals."""
from repro_torch.runtime import faults  # noqa: F401
from repro_torch.runtime import metrics  # noqa: F401
from repro_torch.runtime import telemetry  # noqa: F401
from repro_torch.runtime.supervisor import (  # noqa: F401
    ElasticPlan,
    NodeLossError,
    StragglerMonitor,
    Supervisor,
    shrink_data_axis,
)
