"""The port's primitive registry, dispatch and launch counter, and its
import boundary: ``repro_torch``, ``benchmarks_torch`` and
``chip_smoke.py`` and ``examples/port_*.py`` never import ``jax`` or
anything of ``repro``."""
import ast
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch

from repro.core import registry as jreg
from repro_torch import core as ak
from repro_torch.core import dispatch, registry
from repro_torch.kernels import _build
from repro_torch.kernels import common as KC
from repro_torch.kernels import sort_kernel as SK
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
    try:
        with t.preset("p"):
            assert t.lookup("sort")["switch_below"] == 1
            t.set("sort", switch_below=2)
            assert t.lookup("sort")["switch_below"] == 2
            with t.overrides(sort={"switch_below": 3}):
                with t.overrides({"sort": {"switch_below": 4}}):
                    assert t.lookup("sort")["switch_below"] == 4
                assert t.lookup("sort")["switch_below"] == 3
            assert t.lookup("sort")["switch_below"] == 2
    finally:   # the table has no unregister: a later tune_all in this
        t._presets.pop("p")   # process would seed the preset
    t.reset("sort")
    assert t.lookup("sort")["switch_below"] == 0
    with pytest.raises(KeyError):
        t.reset("sortt")


@pytest.mark.parametrize("name,knobs,exc", [
    ("sort", {"bogus": 1}, KeyError),
    ("sort", {"switch_below": -1}, ValueError),
    ("sort", {"block_rows": 24}, ValueError),
    ("sort", {"block_cols": 100}, ValueError),
    ("sort", {"sort_hyper": 7}, ValueError),
    ("searchsorted", {"sort_hyper": 0}, KeyError),
    ("searchsorted", {"block_rows": 8}, KeyError),
    ("minmax_histogram", {"block_cols": 128}, KeyError),
    ("bincount", {"switch_below": 1}, KeyError),
    ("mapreduce", {"block_rows": 8}, KeyError),
    ("segmented_scan", {"sort_hyper": 0}, KeyError),
    ("segmented_sort", {"sort_hyper": 7}, ValueError),
])
def test_tuning_validation(name, knobs, exc):
    with pytest.raises(exc):
        registry.tuning.set(name, **knobs)


@pytest.mark.parametrize("value", [None, 0, 1, 2, 3, 4, 5, 6, 7, -1, True,
                                   2.0, "3"])
@pytest.mark.parametrize("name", ["sort", "sort_kv", "segmented_sort"])
def test_sort_hyper_values_match_the_reference(name, value):
    """``sort_hyper`` takes None or an int in [0, 6] and raises
    ``ValueError`` otherwise, case for case as the reference does."""
    outcome = []
    for reg in (jreg, registry):
        try:
            reg.tuning.set(name, sort_hyper=value)
            outcome.append("ok")
        except ValueError:
            outcome.append("ValueError")
        finally:
            reg.tuning.reset(name)
    assert outcome[0] == outcome[1]
    assert outcome[1] == ("ok" if value is None or (
        type(value) is int and 0 <= value <= 6) else "ValueError")


@pytest.mark.parametrize("m", range(1, 7))
def test_sort_hyper_reaches_the_window_kernel(monkeypatch, m):
    """Every order m >= 1 set through the registry reaches the network's
    window launches (stubbed here: the CPU has no card), at most m stages
    a window, and the sort stays right."""
    seen = []
    orig = SK._run_window
    monkeypatch.setattr(SK, "_run_window", lambda k, v, kk, j, w, *a: (
        seen.append(w), orig(k, v, kk, j, w, *a))[1])
    x = torch.randn(40000)
    registry.tuning.set("sort", sort_hyper=m)
    try:
        got = ak.merge_sort(x, backend="cuda")
    finally:
        registry.tuning.reset("sort")
    assert torch.equal(got, torch.sort(x).values)
    assert seen and max(seen) <= m and len(seen) == sum(
        -(-i // m) for i in (1, 2, 3))


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
                KC.count_launch("bitonic_window")
                KC.count_launch("bitonic_inblock")
            KC.count_launch("searchsorted")
    assert KC.launch_count() == 3
    assert KC.launch_counts() == {"sort": 2, "unattributed": 1}
    assert KC.kernel_launches() == {"bitonic_window": 1,
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
        import repro_torch.tune, repro_torch.tune.__main__
        import repro_torch.launch.mesh, repro_torch.core.paging
        import repro_torch.models.ssm, repro_torch.models.model
        import repro_torch.configs.mamba2_1_3b, repro_torch.configs.zamba2_7b
        import repro_torch.optim, repro_torch.data, repro_torch.ckpt
        import repro_torch.launch.train, repro_torch.tree
        import repro_torch.models.sharding, repro_torch.launch.dryrun
        import benchmarks_torch.training
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
    files += [os.path.join(REPO, "examples", n) for n in sorted(os.listdir(
        os.path.join(REPO, "examples"))) if n.startswith("port_")
        and n.endswith(".py")]
    assert len(files) == 5, files     # the four port examples
    for top in (os.path.join(REPO, "src", "repro_torch"),
                os.path.join(REPO, "benchmarks_torch")):
        for root, _, names in os.walk(top):
            files += [os.path.join(root, n) for n in names
                      if n.endswith(".py")]
    assert len(files) > 10
    assert any(f.endswith("benchmarks_torch/arithmetic.py") for f in files)
    for new in ("core/paging.py", "tune/__init__.py", "tune/cache.py",
                "tune/search.py", "tune/__main__.py", "launch/mesh.py",
                "configs/glm4_9b.py", "configs/yi_34b.py",
                "configs/deepseek_67b.py", "models/ssm.py",
                "configs/mamba2_1_3b.py", "configs/zamba2_7b.py",
                "optim/__init__.py", "optim/adamw.py",
                "optim/compression.py", "data/__init__.py",
                "data/pipeline.py", "ckpt/__init__.py",
                "ckpt/checkpoint.py", "launch/train.py", "tree.py",
                "models/sharding.py", "launch/dryrun.py"):
        assert any(f.endswith("repro_torch/" + new) for f in files), new
    for f in files:
        bad = {m for m in _imported_roots(f)} & {"jax", "jaxlib", "repro"}
        assert not bad, (f, bad)


def test_metrics_collector_snapshot_equals_registry_stats():
    """The registry's collector (the reference's registry.py:683-708)
    puts calls, hits and portable calls per primitive, and kernel
    launches by kernel, into the process metrics snapshot."""
    from repro_torch.runtime import metrics

    registry.reset_stats()
    ak.merge_sort(torch.randn(64))
    ak.reduce(lambda a, b: a + b, torch.randn(64), init=0.0,
              backend="auto")
    snap = metrics.snapshot()["metrics"]

    def by_primitive(name):
        return {s["labels"]["primitive"]: s["value"]
                for s in snap[name]["samples"]}

    stats = registry.stats()
    for metric, field in (("ak_registry_calls_total", "calls"),
                          ("ak_registry_cache_hits_total", "cache_hits"),
                          ("ak_registry_portable_calls_total",
                           "portable_calls")):
        assert by_primitive(metric) == {
            n: float(s[field]) for n, s in stats.items()}
    assert stats["sort"]["calls"] == 1
    assert not any(n.startswith(("ak_registry_traces",
                                 "ak_registry_uncached")) for n in snap)
    launches = {s["labels"]["kernel"]: s["value"]
                for s in snap.get("ak_kernel_launches_total",
                                  {"samples": []})["samples"]}
    assert launches == {k: float(v) for k, v in KC.kernel_launches().items()}


# -- a kernel route never cuts the autograd graph ----------------------------

def _grad_calls():
    """(name, call on a float operand) of the primitives whose kernel
    route writes its result through a launch (no grad_fn)."""
    off = torch.tensor([0, 3, 3, 7, 12], dtype=torch.int32)
    return [
        ("sort", lambda x, **kw: ak.merge_sort(x, **kw)),
        ("mapreduce", lambda x, **kw: ak.reduce(torch.add, x, init=0.0,
                                                **kw)),
        ("accumulate", lambda x, **kw: ak.accumulate(torch.add, x,
                                                     init=0.0, **kw)),
        ("segmented_reduce", lambda x, **kw: ak.segmented_reduce(
            torch.add, x, off, init=0.0, **kw)),
        ("segmented_scan", lambda x, **kw: ak.segmented_scan(
            torch.add, x, off, init=0.0, **kw)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_requires_grad_is_refused_by_kernels_without_a_graph(case,
                                                             monkeypatch):
    """An operand that requires grad never reaches a kernel whose output
    carries no grad_fn: ``backend="cuda"`` raises ``TypeError``; under
    ``auto`` on a card operand (modelled by resolving auto to cuda) the
    call runs portable, counted, and backpropagates; without autograd,
    or on a plain operand, the kernel route is taken as before."""
    name, call = _grad_calls()[case]
    x = torch.randn(12, requires_grad=True)
    with pytest.raises(TypeError, match="requires grad"):
        call(x, backend="cuda")
    want = call(x, backend="torch")
    with torch.no_grad():
        call(x, backend="cuda")
    call(x.detach(), backend="cuda")
    assert registry.get(name).cache_backends() == ("cuda", "torch")
    registry.reset_stats()
    monkeypatch.setattr(dispatch, "resolve", lambda *a, **k: "cuda")
    got = call(x)
    assert registry.stats(name)["portable_calls"] == 1
    assert got.grad_fn is not None
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (g,) = torch.autograd.grad(got.sum(), x)
    assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)


def test_kernel_grad_is_declared_per_primitive():
    """The records whose kernel route keeps the graph (topk's values are
    gathered from its input) or returns integers or booleans; every other
    kernel route is refused an operand that requires grad."""
    keeps = {n for n in registry.names() if registry.get(n).kernel_grad}
    assert keeps == {"argsort", "argsort_batched", "searchsorted", "topk",
                     "nucleus_mask"}


def test_topk_kernel_route_keeps_the_gradient():
    """topk on the kernel route (its plain version here) with keys that
    require grad: not refused, and the same gradient as the portable
    route; integer routing ids stay on the kernel route."""
    x = torch.randn(6, 32, requires_grad=True)
    vals_k, idx_k = ak.topk(x, 4, backend="cuda")
    vals_t, idx_t = ak.topk(x, 4, backend="torch")
    assert registry.get("topk").cache_backends() == ("cuda", "torch")
    assert torch.equal(idx_k, idx_t) and vals_k.grad_fn is not None
    w = torch.randn(6, 4)
    (gk,) = torch.autograd.grad((vals_k * w).sum(), x)
    (gt,) = torch.autograd.grad((vals_t * w).sum(), x)
    assert torch.equal(gk, gt)
    ids = torch.randint(0, 8, (64,), dtype=torch.int32)
    ak.sortperm(ids, backend="cuda")
    assert registry.get("argsort").cache_backends() == ("cuda",)


# -- the reduce kernel's out_dtype --------------------------------------------

#: (operand dtype, body, op, out_dtype, refused): the port's kernel takes
#: float32, int32 and bfloat16 for add/mul/min/max (int8 operands through
#: identity and square), bool for and/or (not over int8)
REDUCE_OUT = [
    (torch.int8, "identity", torch.add, torch.int32, False),
    (torch.int8, "square", torch.add, torch.int32, False),
    (torch.bfloat16, "identity", torch.add, torch.float32, False),
    (torch.float32, "identity", torch.maximum, torch.bfloat16, False),
    (torch.int32, "square", torch.mul, torch.float32, False),
    (torch.float32, "identity", torch.add, None, False),
    (torch.int8, "identity", torch.add, None, True),
    (torch.int8, "rbf", torch.add, torch.float32, True),
    (torch.float32, "identity", torch.add, torch.int8, True),
    (torch.float32, "identity", torch.add, torch.bool, True),
    (torch.float64, "identity", torch.add, torch.float32, True),
    (torch.float32, "identity", torch.logical_and, torch.float32, True),
    (torch.int8, "identity", torch.logical_or, torch.bool, True),
]


@pytest.mark.parametrize("case", range(len(REDUCE_OUT)))
def test_reduce_kernel_out_dtype_refusals(case):
    """The kernel route takes an ``out_dtype`` by the rule above: under
    ``backend="cuda"`` a refused one raises, an accepted one runs the
    kernel's plain version here and equals ``ref.reduce_ref``."""
    from repro_torch.kernels import map_kernel as MAPK
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as KREF
    from repro_torch.kernels import reduce_kernel as RK

    dtype, body, op, out, refused = REDUCE_OUT[case]
    f = MAPK.BODIES[body]
    x = [torch.arange(-6, 7).to(dtype)] * f.arity
    unit = {torch.add: 0, torch.mul: 1, torch.maximum: -100,
            torch.logical_and: True, torch.logical_or: False}[op]
    assert (RK.refusal(f, op, x, out) is not None) == refused
    if refused:
        with pytest.raises(TypeError):
            kops.mapreduce(f, op, *x, unit=unit, out_dtype=out)
        return
    got = kops.mapreduce(f, op, *x, unit=unit, out_dtype=out)
    want = KREF.reduce_ref(f, op, *x, unit=unit, out_dtype=out)
    assert got.dtype == (out or dtype) and torch.equal(got, want)


#: the (operand dtype, out_dtype) pairs the kernel casts between
REDUCE_CASTS = [(a, b) for a in ("int8", "int32", "float32", "bfloat16")
                for b in ("int32", "float32", "bfloat16") if a != b]
#: the catalogue's operators, the reference's, and the unit each starts
#: from (127 and -128 lie inside every operand dtype's range here)
_REDUCE_OPS = {"add": (torch.add, "add", 0), "mul": (torch.mul, "multiply", 1),
               "min": (torch.minimum, "minimum", 127),
               "max": (torch.maximum, "maximum", -128)}


def _reduce_operand(dtype, op, rng, exact):
    """8192 seeded values: for a product +-1 with 16 entries +-2; an exact
    input is otherwise 0 with 16 entries in -3..3 (no sum, square or
    product of it rounds or wraps in any dtype); a full-range input is
    int8 over -128..127, int32 over +-2^20, floats standard normal."""
    import numpy as np

    n = 8192
    if op == "mul":
        v = rng.choice([-1.0, 1.0], n)
        v[rng.choice(n, 16, replace=False)] *= 2
    elif exact:
        v = np.zeros(n)
        v[rng.choice(n, 16, replace=False)] = rng.integers(-3, 4, 16)
    elif dtype == "int8":
        v = rng.integers(-128, 128, n)
    elif dtype == "int32":
        v = rng.integers(-2 ** 20, 2 ** 20, n)
    else:
        v = rng.standard_normal(n)
    return torch.from_numpy(v.astype(np.float64)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype,out", REDUCE_CASTS)
def test_reduce_out_dtype_against_the_reference(dtype, out):
    """Every out_dtype the kernel casts to, under add, mul, min and max
    through ``identity`` and ``square``, held to the reference on the same
    inputs. The port's kernel route (its plain version here) against the
    reference's ``reduce_ref``: on an exact input bitwise; at full range
    bitwise for int32 outputs, min, max and products, float32 sums to
    rtol 2e-4 / atol 2e-5, and a bfloat16 sum, which the port folds in
    float32 and rounds once, within one bfloat16 ulp of the reference's
    float32 sum rounded to bfloat16 (the reference's folds in bfloat16).
    The reference's Pallas kernel in interpret mode takes only int8 ->
    int32 of these, bitwise the port's on the exact input, while at full
    range its int8 partial sums wrap; it refuses every other pair."""
    import jax.numpy as jnp
    import numpy as np

    from repro.kernels import ops as JOPS
    from repro.kernels import ref as JREF
    from repro_torch.kernels import map_kernel as MAPK
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(REDUCE_CASTS.index((dtype, out)))
    tout, jout = getattr(torch, out), getattr(jnp, out)
    bodies = {"identity": lambda v: v, "square": lambda v: v * v}
    for body, jf in bodies.items():
        f = MAPK.BODIES[body]
        for name, (op, jname, unit) in _REDUCE_OPS.items():
            jop = getattr(jnp, jname)
            for exact in (True, False):
                x = _reduce_operand(dtype, name, rng, exact)
                xj = jnp.asarray(x.double().numpy()).astype(getattr(jnp, dtype))
                got = kops.mapreduce(f, op, x, unit=unit, out_dtype=tout)
                want = JREF.reduce_ref(jf, jop, xj, unit=unit,
                                       out_dtype=jout)
                want = torch.from_numpy(np.array(
                    want.astype(jnp.float32) if out == "bfloat16"
                    else want)).to(tout)
                what = (body, name, exact)
                assert got.dtype == tout, what
                if exact or out == "int32" or name != "add":
                    assert torch.equal(got, want), (what, got, want)
                elif out == "float32":
                    torch.testing.assert_close(got, want, rtol=2e-4,
                                               atol=2e-5, msg=str(what))
                else:
                    once = float(JREF.reduce_ref(jf, jop, xj, unit=unit,
                                                 out_dtype=jnp.float32))
                    want = torch.tensor(once).to(tout).double()
                    ulp = 2.0 ** (torch.floor(torch.log2(want.abs())) - 7)
                    assert abs(got.double() - want) <= ulp, (what, got, want)
                if (dtype, out) != ("int8", "int32"):
                    with pytest.raises((ValueError, TypeError)):
                        JOPS.mapreduce(jf, jop, xj, unit=unit,
                                       out_dtype=jout)
                    continue
                pallas = torch.tensor(int(JOPS.mapreduce(
                    jf, jop, xj, unit=unit, out_dtype=jout)),
                    dtype=torch.int32)
                wraps = not exact and name == "add"
                assert torch.equal(pallas, got) != wraps, (what, pallas, got)
