"""repro_torch.tune: the measurement-driven autotuning subsystem
(counterpart of ``repro/tune``).

It measures its way to the knob values and the backend of each
(primitive, dtype, size class) on one device, and persists the verdicts
per device, so ``backend="auto"`` resolves the kernels or the portable
path from measured crossovers::

    from repro_torch import tune
    cache = tune.tune_all(sizes=(4096, 2**17))       # on the card
    cache.save()                                      # per-device JSON
    with ak.tuning.using_cache(tune.TuneCache.load(cache.path)):
        ak.merge_sort(x)     # auto backend + knobs from the cache

The CLI: ``python -m repro_torch.tune [--device cuda|cpu]`` (``--model``
for the deterministic model measure).
"""
from repro_torch.tune.cache import (
    CacheStats,
    SCHEMA_VERSION,
    TuneCache,
    default_path,
    device_fingerprint,
    entry_key,
    validate_doc,
    validate_file,
)
from repro_torch.tune.search import (
    DEFAULT_DTYPES,
    DEFAULT_SIZES,
    TUNED_PRIMITIVES,
    candidates,
    make_operands,
    model_measure,
    modelled_time,
    rank_throughput,
    report_lines,
    search_one,
    tune_all,
    wallclock_measure,
)

__all__ = [
    "CacheStats", "SCHEMA_VERSION", "TuneCache", "default_path",
    "device_fingerprint", "entry_key", "validate_doc", "validate_file",
    "DEFAULT_DTYPES", "DEFAULT_SIZES",
    "TUNED_PRIMITIVES", "candidates", "make_operands", "model_measure",
    "modelled_time", "rank_throughput", "report_lines", "search_one",
    "tune_all", "wallclock_measure",
]
