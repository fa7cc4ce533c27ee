"""The port's primitive registry, dispatch and launch counter, and its
import boundary: ``repro_torch``, ``benchmarks_torch`` and
``chip_smoke.py`` never import ``jax`` or anything of ``repro``."""
import ast
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch

from repro_torch import core as ak
from repro_torch.core import dispatch, registry
from repro_torch.kernels import _build
from repro_torch.kernels import common as KC
from repro_torch.runtime import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_registry():
    registry.clear_caches()
    registry.reset_stats()
    registry.tuning.reset()
    yield
    registry.tuning.reset()


def test_slice_primitives_registered():
    assert set(registry.names()) == {
        "sort", "sort_kv", "argsort", "merge", "merge_kv", "searchsorted",
        "minmax_histogram", "bincount", "map", "mapreduce", "accumulate",
        "segmented_reduce", "segmented_scan", "segmented_sort",
        "sort_batched", "argsort_batched", "topk", "nucleus_mask",
        "page_gather",
    }
    with pytest.raises(ValueError):
        registry.register(registry.Primitive("sort", lambda x: x))


def test_auto_resolves_by_device():
    assert dispatch.resolve(None, torch.zeros(3)) == "torch"
    cuda_like = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert dispatch.resolve(None, cuda_like) == "cuda"
    assert dispatch.resolve("torch", cuda_like) == "torch"
    with dispatch.backend("cuda"):
        assert dispatch.resolve(None, torch.zeros(3)) == "cuda"
    with pytest.raises(ValueError):
        dispatch.resolve("pallas")
    ak.merge_sort(torch.randn(64))
    assert registry.get("sort").cache_backends() == ("torch",)


def test_explicit_backend_and_no_cuda_impl():
    x = torch.randn(64)
    ak.merge_sort(x, backend="cuda")
    ak.merge_sort(x, backend="torch")
    assert registry.get("sort").cache_backends() == ("cuda", "torch")
    ak.bincount(torch.tensor([0, 1, 1], dtype=torch.int32), 2,
                backend="cuda")
    assert registry.get("bincount").cache_backends() == ("torch",)
    assert registry.get("bincount").tunables == ()


def test_switch_below_demotes_cuda_to_torch():
    x = torch.randn(1000)
    registry.call("sort", x, backend="cuda", switch_below=4096)
    assert registry.get("sort").cache_backends() == ("torch",)
    with ak.tuning.overrides(sort={"switch_below": 500}):
        ak.merge_sort(x, backend="cuda")
    assert registry.get("sort").cache_backends() == ("cuda", "torch")
    # empty input never reaches a kernel
    registry.get("sort").clear()
    ak.merge_sort(torch.zeros(0), backend="cuda")
    assert registry.get("sort").cache_backends() == ("torch",)


def test_calls_and_hits_count():
    """A hit is a call that built or loaded no kernel library; the plain
    version on CPU tensors loads none."""
    x = torch.randn(300)
    for _ in range(5):
        ak.merge_sort(x, backend="cuda")
    assert registry.stats("sort") == {"calls": 5, "cache_hits": 5,
                                      "portable_calls": 0}
    prim = registry.get("sort")
    orig = prim.cuda_impl

    def loading(x, **kw):  # what the first call on the card does
        _build._loads += 1
        return orig(x, **kw)

    prim.cuda_impl = loading
    try:
        ak.merge_sort(x, backend="cuda", descending=True)
    finally:
        prim.cuda_impl = orig
    assert registry.stats("sort") == {"calls": 6, "cache_hits": 5,
                                      "portable_calls": 0}
    registry.reset_stats()
    assert registry.stats("sort") == {"calls": 0, "cache_hits": 0,
                                      "portable_calls": 0}


def test_override_precedence():
    t = registry.tuning
    assert t.lookup("sort")["switch_below"] == 0
    t.register_preset("p", {"sort": {"switch_below": 1}})
    with t.preset("p"):
        assert t.lookup("sort")["switch_below"] == 1
        t.set("sort", switch_below=2)
        assert t.lookup("sort")["switch_below"] == 2
        with t.overrides(sort={"switch_below": 3}):
            with t.overrides({"sort": {"switch_below": 4}}):
                assert t.lookup("sort")["switch_below"] == 4
            assert t.lookup("sort")["switch_below"] == 3
        assert t.lookup("sort")["switch_below"] == 2
    t.reset("sort")
    assert t.lookup("sort")["switch_below"] == 0
    with pytest.raises(KeyError):
        t.reset("sortt")


@pytest.mark.parametrize("name,knobs,exc", [
    ("sort", {"bogus": 1}, KeyError),
    ("sort", {"switch_below": -1}, ValueError),
    ("sort", {"block_rows": 24}, ValueError),
    ("sort", {"block_cols": 100}, ValueError),
    ("sort", {"sort_hyper": 3}, ValueError),
    ("searchsorted", {"sort_hyper": 0}, KeyError),
    ("searchsorted", {"block_rows": 8}, KeyError),
    ("minmax_histogram", {"block_cols": 128}, KeyError),
    ("bincount", {"switch_below": 1}, KeyError),
    ("mapreduce", {"block_rows": 8}, KeyError),
    ("segmented_scan", {"sort_hyper": 0}, KeyError),
    ("segmented_sort", {"sort_hyper": 3}, ValueError),
])
def test_tuning_validation(name, knobs, exc):
    with pytest.raises(exc):
        registry.tuning.set(name, **knobs)


def test_block_knobs_reach_the_network():
    seen = []
    prim = registry.get("sort")
    orig = prim.cuda_impl
    prim.cuda_impl = lambda x, **kw: (seen.append(KC.block_elems()),
                                      orig(x, **kw))[1]
    try:
        with ak.tuning.overrides(sort={"block_rows": 8, "block_cols": 128}):
            ak.merge_sort(torch.randn(3000), backend="cuda")
    finally:
        prim.cuda_impl = orig
    assert seen == [1024]


def test_launch_counter_attribution_and_spans():
    KC.reset_launch_count()
    with telemetry.enabled_scope():
        with telemetry.span("outer"):
            with KC.launch_attribution("sort"):
                KC.count_launch("bitonic_cross")
                KC.count_launch("bitonic_inblock")
            KC.count_launch("searchsorted")
    assert KC.launch_count() == 3
    assert KC.launch_counts() == {"sort": 2, "unattributed": 1}
    assert KC.kernel_launches() == {"bitonic_cross": 1,
                                    "bitonic_inblock": 1, "searchsorted": 1}
    (ev,) = [e for e in telemetry.events() if e["name"] == "outer"]
    assert ev["args"]["launches"] == 3


def test_import_pulls_in_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import sys
        import repro_torch, repro_torch.core, repro_torch.convert
        import repro_torch.kernels._build, repro_torch.kernels.ops
        import benchmarks_torch.arithmetic, benchmarks_torch.call_overhead
        import benchmarks_torch.streaming_breakdown
        import benchmarks_torch.streaming_inputs
        import repro_torch.launch.serve, repro_torch.configs
        import repro_torch.kernels.attention_kernel, repro_torch.models.moe
        import benchmarks_torch.serving
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for top in (os.path.join(REPO, "src", "repro_torch"),
                os.path.join(REPO, "benchmarks_torch")):
        for root, _, names in os.walk(top):
            files += [os.path.join(root, n) for n in names
                      if n.endswith(".py")]
    assert len(files) > 10
    assert any(f.endswith("benchmarks_torch/arithmetic.py") for f in files)
    for f in files:
        bad = {m for m in _imported_roots(f)} & {"jax", "jaxlib", "repro"}
        assert not bad, (f, bad)
