"""repro_torch.core: the AK primitive suite and SIHSort on PyTorch.

Import as a namespace, AK-style::

    from repro_torch import core as ak
    ak.merge_sort(x)                    # cuda kernels for a CUDA tensor,
                                        # torch.sort for a CPU one ("auto")
    ak.merge_sort(x, backend="torch")   # the portable path on any device
    ak.reduce(torch.add, x, init=0.0)   # catalogue op: the reduce kernel
    ak.sihsort(shard)                   # distributed, inside a process group
"""
from repro_torch.core import registry
from repro_torch.core.dispatch import (
    backend,
    default_backend,
    set_default_backend,
)
from repro_torch.core.registry import tuning
from repro_torch.runtime import telemetry  # noqa: F401  (ak.telemetry)
from repro_torch.core.ops import (
    accumulate,
    all_pred,
    any_pred,
    foreachindex,
    map_elements,
    mapreduce,
    reduce,
    segmented_reduce,
    segmented_scan,
)
from repro_torch.core.sort import (
    merge,
    merge_kv,
    merge_sort,
    merge_sort_batched,
    merge_sort_by_key,
    nucleus_mask,
    segmented_sort,
    sortperm,
    sortperm_batched,
    sortperm_lowmem,
    topk,
)
from repro_torch.core.search import searchsortedfirst, searchsortedlast
from repro_torch.core.histogram import bincount, minmax_histogram
from repro_torch.core.paging import page_gather
from repro_torch.core.distributed import (
    ShardedSort,
    assert_no_overflow,
    collect_sorted,
    collective_counts,
    exchange_capacities,
    reset_collective_counts,
    sihsort,
    sihsort_sharded,
    sihsort_sharded_with_stats,
)

__all__ = [
    "backend", "default_backend", "set_default_backend",
    "registry", "tuning", "telemetry",
    "foreachindex", "map_elements", "mapreduce", "reduce", "accumulate",
    "segmented_reduce", "segmented_scan", "any_pred", "all_pred",
    "merge", "merge_kv", "merge_sort", "merge_sort_by_key", "sortperm",
    "sortperm_lowmem", "page_gather",
    "segmented_sort", "merge_sort_batched", "sortperm_batched", "topk",
    "nucleus_mask",
    "searchsortedfirst", "searchsortedlast",
    "bincount", "minmax_histogram",
    "ShardedSort", "assert_no_overflow", "collect_sorted",
    "collective_counts", "reset_collective_counts", "exchange_capacities",
    "sihsort", "sihsort_sharded", "sihsort_sharded_with_stats",
]
