"""The port's data pipeline (counterpart of ``repro/data``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticCorpus,
    global_shuffle_by_sort,
    make_batches,
    shuffle_keys,
)
