"""The port's checkpoints (counterpart of ``repro/ckpt``). On a process
group of several ranks ``restore(..., step=None)`` and ``agreed_step`` are
collectives: every rank calls them, or none."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    agreed_step,
    latest_step,
    restore,
    save,
)
