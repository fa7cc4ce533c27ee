"""The port's autotune subsystem (repro_torch/tune, the registry's cache
layer) against the contracts of tests/test_autotune.py and against the
JAX package where the two meet: size classes, the legal search space,
the deterministic model and its shared-memory prune, the persistent
cache (roundtrip, atomic write, schema bump, corrupt file, counters),
the resolve order (defaults < presets < cache (exact > wildcard) < set <
overrides), preset seeding with the reference's conflict rule (the same
wildcards as the reference's ``tune_all``), the device rule (a cache
serves only operands on the device it describes; a ``"cuda"`` verdict
never reaches a CPU tensor), files of either package serving nothing in
the other, reuse across processes, the CLI, and ``rank_throughput``'s
measured and model sources. Everything runs on the CPU: caches that
describe the card are built from an explicit fingerprint."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.core import registry as jreg
from repro.kernels import common as JKC
from repro.tune import cache as JTC
from repro.tune import search as JTS
from repro_torch import core as ak
from repro_torch import tune as T
from repro_torch.core import dispatch, registry
from repro_torch.kernels import common as KC
from repro_torch.kernels import sort_kernel as SK
from repro_torch.tune import cache as TC
from repro_torch.tune import search as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a fingerprint of the card, for caches that describe it
CARD_FP = {"device_kind": "NVIDIA H100 80GB HBM3", "capability": "9.0",
           "backend": "cuda"}


@pytest.fixture(autouse=True)
def _clean_registry():
    registry.reset_stats()
    registry.clear_caches()
    registry.tuning.reset()
    registry.tuning.attach_cache(None)
    yield
    registry.tuning.attach_cache(None)
    registry.tuning.reset()


def _cpu_cache(tmp_path, sizes=(4096, 131072), primitives=("sort",)):
    path = str(tmp_path / "torch-cpu.json")
    cache = T.tune_all(sizes=sizes, primitives=primitives, device="cpu",
                       measure=T.model_measure, path=path,
                       seed_presets=False)
    cache.save()
    return cache, path


def _card_cache(tmp_path, entries):
    cache = T.TuneCache(path=str(tmp_path / "torch-cuda.json"),
                        fingerprint=CARD_FP)
    for (prim, cls), (backend, knobs) in entries.items():
        cache.put(prim, "float32", cls, backend=backend, knobs=knobs,
                  t_us=10.0, t_default_us=20.0)
    return cache


# -- size classes and the search space --------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 4096, 2**16 + 1, 100_000, 2**17,
                               2**17 + 1, 2**26])
def test_size_class_matches_the_reference(n):
    assert KC.size_class(n) == JKC.size_class(n)


def test_candidates_are_registry_legal():
    for name in T.TUNED_PRIMITIVES:
        prim = registry.get(name)
        for kv in T.candidates(name):
            registry._validate_tuning(name, kv, prim.tunables)
    assert T.candidates("map") == [{}]  # no geometry knobs there
    sort = T.candidates("sort")
    assert {kv.get("sort_hyper") for kv in sort} == {None, *range(7)}
    for kv in sort:
        block = kv.get("block_rows", 8) * kv.get("block_cols", 1024)
        assert block & (block - 1) == 0
    assert [kv.get("page_size") for kv in T.candidates("page_gather")] == [
        None, 4, 8, 16, 32, 64, 128]
    assert set(T.TUNED_PRIMITIVES) == set(JTS.TUNED_PRIMITIVES) & set(
        registry.names())


def test_model_is_deterministic_and_prunes_shared_memory():
    a = T.modelled_time("sort", "cuda", 2**17, 4, {"sort_hyper": 2})
    assert a == T.modelled_time("sort", "cuda", 2**17, 4, {"sort_hyper": 2})
    # 16 x 2048 keys: 128 KiB alone, 256 KiB with a payload, past one
    # CTA's 227 KB: the kv network's in-block stages run at half the
    # block, and the model counts the window passes that adds
    huge = {"block_rows": 16, "block_cols": 2048, "sort_hyper": 4}
    assert 16 * 2048 * 4 < SK.MAX_SMEM < 16 * 2048 * 8
    kv = T.modelled_time("sort_kv", "cuda", 2**20, 4, huge)
    tiled = SK.network_launches(2**20, hyper=4, block=2**15, elem_bytes=8)
    assert tiled > SK.network_launches(2**20, hyper=4, block=2**15)
    assert kv == tiled * T.search.LAUNCH_S + 2 * 2 * 2**20 * 4 * tiled \
        / T.search.HBM_BYTES_S
    assert T.modelled_time("sort", "cuda", 2**20, 4, huge) < kv < float("inf")
    # from a few blocks up the card's torch.sort rate beats the network's
    # passes (one in-block launch and torch's call cost about the same)
    for n in (2**17, 2**20, 2**26):
        assert T.modelled_time("sort", "torch", n, 4, {}) < \
            T.modelled_time("sort", "cuda", n, 4, {})
    # the host CPU's sort grows as n log n
    assert T.modelled_time("sort", "torch", 2**20, 4, {}, device="cpu") > \
        2 * T.modelled_time("sort", "torch", 2**19, 4, {}, device="cpu")


def test_search_on_the_host_measures_the_portable_path_only():
    res = T.search_one("sort", 4096, "float32", measure=T.model_measure,
                       device="cpu")
    assert res["backend"] == "torch" and res["knobs"] == {}
    assert res["t_us"] == res["t_default_us"] == pytest.approx(
        T.modelled_time("sort", "torch", 4096, 4, {}, device="cpu") * 1e6)


def test_wallclock_measure_runs_through_the_registry():
    ops, opts = T.make_operands("mapreduce", 1024, "float32", device="cpu")
    t = T.wallclock_measure("mapreduce", "torch", ops, opts, {}, repeats=2)
    assert t > 0
    assert registry.stats("mapreduce")["calls"] == 3  # warm-up + 2


# -- the persistent cache ----------------------------------------------------

def test_cache_roundtrip(tmp_path):
    cache, path = _cpu_cache(tmp_path)
    loaded = T.TuneCache.load(path)
    assert loaded.compatible and loaded.device_type == "cpu"
    assert loaded.entries == cache.entries
    doc = T.validate_file(path)
    assert doc["fingerprint"]["threads"] == torch.get_num_threads()
    assert set(doc["entries"]) == {"sort|float32|c12", "sort|float32|c17"}


def test_cache_roundtrip_property(tmp_path):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    knob_values = st.one_of(st.none(), st.booleans(),
                            st.integers(min_value=0, max_value=2**20))
    knobs = st.dictionaries(st.sampled_from(list(registry.TUNABLE_KEYS)),
                            knob_values, max_size=len(registry.TUNABLE_KEYS))

    @settings(max_examples=25, deadline=None)
    @given(st.dictionaries(st.text(alphabet="abc_", min_size=1, max_size=8),
                           knobs, max_size=4),
           st.sampled_from(["torch", "cuda", None]))
    def roundtrip(mapping, backend):
        cache = T.TuneCache(path=str(tmp_path / "prop.json"), device="cpu")
        for i, (prim, kv) in enumerate(mapping.items()):
            cache.put(prim, "float32", i, backend=backend, knobs=kv,
                      t_us=1.0, t_default_us=2.0)
        cache.save()
        loaded = T.TuneCache.load(cache.path)
        assert loaded.entries == cache.entries
        T.validate_file(cache.path)

    roundtrip()


def test_atomic_write_leaves_no_temp_files(tmp_path):
    cache, _ = _cpu_cache(tmp_path, sizes=(4096,))
    cache.save()
    assert [f for f in os.listdir(tmp_path) if f.startswith(".")] == []


def test_schema_bump_invalidates(tmp_path):
    _, path = _cpu_cache(tmp_path)
    doc = json.load(open(path))
    doc["schema"] = TC.SCHEMA_VERSION + 1
    json.dump(doc, open(path, "w"))
    loaded = T.TuneCache.load(path)
    assert len(loaded) == 0
    assert loaded.lookup("sort", "float32", 17) is None
    assert loaded.stats.misses == 1
    with pytest.raises(ValueError):
        T.validate_doc(doc)


def test_corrupt_file_loads_empty(tmp_path):
    path = str(tmp_path / "broken.json")
    with open(path, "w") as f:
        f.write("{not json")
    loaded = T.TuneCache.load(path, device="cpu")
    assert len(loaded) == 0 and loaded.compatible


def test_counters_increment_as_documented(tmp_path):
    _, path = _cpu_cache(tmp_path)
    loaded = T.TuneCache.load(path)
    assert loaded.lookup("sort", "float32", 17) is not None
    assert loaded.lookup("sort", "float32", 3) is None
    assert loaded.lookup("sort", "float32", 17, device="cuda") is None
    assert loaded.stats.as_dict() == {"hits": 1, "misses": 1, "stale": 1}


def test_another_thread_count_is_another_device(tmp_path):
    _, path = _cpu_cache(tmp_path)
    other = torch.get_num_threads() + 1
    loaded = T.TuneCache.load(path, threads=other)
    assert not loaded.compatible
    assert loaded.lookup("sort", "float32", 17) is None
    assert loaded.stats.stale == 1
    assert T.TuneCache.load(path,
                            threads=torch.get_num_threads()).compatible


def test_a_card_file_without_a_card_loads_incompatible(tmp_path):
    cache = _card_cache(tmp_path, {("sort", 17): ("cuda", {})})
    cache.save()
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    loaded = T.TuneCache.load(cache.path)
    assert loaded.device_type == "cuda" and not loaded.compatible
    assert loaded.lookup("sort", "float32", 17) is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TuneCache(device="cuda")


def test_default_path_one_file_a_device(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    paths = {T.default_path("cuda"), T.default_path("cpu"),
             JTC.default_path()}
    assert len(paths) == 3
    assert all(os.path.dirname(p) == os.path.dirname(JTC.default_path())
               for p in paths)
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/elsewhere/c.json")
    assert T.default_path("cpu") == "/elsewhere/c.json"


# -- resolution through the registry -----------------------------------------

def test_cuda_hint_is_never_taken_for_a_cpu_operand(tmp_path):
    card = _card_cache(tmp_path, {("sort", 17): ("cuda",
                                                  {"sort_hyper": 2})})
    x = torch.randn(2**17)
    with registry.tuning.using_cache(card):
        knobs, hint = registry.tuning.resolve("sort", n=2**17,
                                              dtype=torch.float32,
                                              device="cpu")
        out = ak.merge_sort(x)
    assert hint is None and knobs == registry.tuning.lookup("sort")
    assert registry.get("sort").cache_backends() == ("torch",)
    assert card.stats.as_dict() == {"hits": 0, "misses": 0, "stale": 2}
    assert torch.equal(out, torch.sort(x).values)
    # a hand-edited host cache with a cuda verdict: still never taken
    host = T.TuneCache(path=str(tmp_path / "h.json"), device="cpu")
    host.put("sort", "float32", 17, backend="cuda", knobs={})
    with registry.tuning.using_cache(host):
        _, hint = registry.tuning.resolve("sort", n=2**17,
                                          dtype="float32", device="cpu")
        ak.merge_sort(x)
    assert hint is None
    assert registry.get("sort").cache_backends() == ("torch",)


def test_cached_knobs_and_hint_serve_their_device(tmp_path):
    card = _card_cache(tmp_path, {("sort", 17): ("cuda",
                                                  {"sort_hyper": 2})})
    with registry.tuning.using_cache(card):
        knobs, hint = registry.tuning.resolve("sort", n=2**17,
                                              dtype=torch.float32,
                                              device="cuda")
    assert hint == "cuda" and knobs["sort_hyper"] == 2
    assert card.stats.hits == 1


def test_measured_torch_verdict_replaces_the_device_rule_under_auto(
        tmp_path):
    host = T.TuneCache(path=str(tmp_path / "h.json"), device="cpu")
    host.put("sort", "float32", 17, backend="torch", knobs={})
    x = torch.randn(2**17)
    with registry.tuning.using_cache(host), dispatch.backend("cuda"):
        ak.merge_sort(x)  # a dispatch.backend scope beats the cache
    assert registry.get("sort").cache_backends() == ("cuda",)
    registry.clear_caches()
    with registry.tuning.using_cache(host):
        ak.merge_sort(x, backend="cuda")  # an explicit backend too
        ak.merge_sort(x)                  # auto: the verdict
    assert registry.get("sort").cache_backends() == ("cuda", "torch")


def test_resolve_order(tmp_path):
    host = T.TuneCache(path=str(tmp_path / "h.json"), device="cpu")
    host.put("sort", "float32", 17, backend="torch",
             knobs={"block_cols": 2048, "switch_below": 64})
    host.seed_preset("sort", {"block_cols": 512})
    registry.tuning.register_preset("test_preset",
                                    {"sort": {"block_cols": 256,
                                              "block_rows": 16}})
    kw = dict(dtype="float32", device="cpu")
    try:
        _resolve_order_checks(host, kw)
    finally:  # the table has no unregister; keep other tests' presets
        registry.tuning._presets.pop("test_preset")


def _resolve_order_checks(host, kw):
    with registry.tuning.preset("test_preset"), \
            registry.tuning.using_cache(host):
        k, _ = registry.tuning.resolve("sort", n=2**17, **kw)
        assert (k["block_cols"], k["block_rows"]) == (2048, 16)  # exact
        k, _ = registry.tuning.resolve("sort", n=64, **kw)
        assert k["block_cols"] == 512          # the wildcard over a preset
        registry.tuning.set("sort", block_cols=1024)
        k, _ = registry.tuning.resolve("sort", n=2**17, **kw)
        assert k["block_cols"] == 1024         # set beats the cache
        with registry.tuning.overrides(sort={"block_cols": 128}):
            k, _ = registry.tuning.resolve("sort", n=2**17, **kw)
            assert k["block_cols"] == 128      # scoped overrides beat all
    k, hint = registry.tuning.resolve("sort", n=2**17, **kw)
    assert hint is None and k["block_cols"] == 1024


def test_switch_below_override_demotes_a_cuda_hinted_call(tmp_path):
    host = T.TuneCache(path=str(tmp_path / "h.json"), device="cpu")
    x = torch.randn(2**17)
    with registry.tuning.using_cache(host), dispatch.backend("cuda"), \
            registry.tuning.overrides(sort={"switch_below": 2**20}):
        ak.merge_sort(x)
    assert registry.get("sort").cache_backends() == ("torch",)


def test_corrupt_cached_knobs_are_ignored(tmp_path):
    host = T.TuneCache(path=str(tmp_path / "h.json"), device="cpu")
    host.entries[TC.entry_key("sort", "float32", 17)] = {
        "backend": "torch", "knobs": {"block_rows": 24}}  # not pow2
    with registry.tuning.using_cache(host):
        knobs, hint = registry.tuning.resolve("sort", n=2**17,
                                              dtype="float32")
    assert hint == "torch" and knobs["block_rows"] is None


def test_attach_cache_is_global_and_using_cache_shadows_it(tmp_path):
    a = T.TuneCache(path=str(tmp_path / "a.json"), device="cpu")
    registry.tuning.attach_cache(a)
    assert registry.tuning.autotune is a
    with registry.tuning.using_cache(None):
        assert registry.tuning.autotune is None
    assert registry.tuning.autotune is a


def test_unknown_names_raise_everywhere():
    with pytest.raises(KeyError):
        registry.tuning.resolve("sortt", n=4, dtype="float32")
    with pytest.raises(KeyError):
        registry.tuning.preset_mapping("no_such_preset")
    with pytest.raises(KeyError):
        with registry.tuning.preset("no_such_preset"):
            pass


# -- presets ------------------------------------------------------------------

def test_presets_seed_the_reference_wildcards(tmp_path):
    import repro.launch.serve  # noqa: F401  (the reference's presets)
    import repro.models.moe    # noqa: F401
    import repro_torch.launch.serve  # noqa: F401
    import repro_torch.models.moe    # noqa: F401

    assert {"sampler", "moe_routing", "moe_dispatch"} <= set(
        registry.tuning.preset_names())
    cache = T.tune_all(sizes=(), primitives=(), device="cpu",
                       path=str(tmp_path / "c.json"))
    ref = JTS.tune_all(sizes=(), primitives=(), seed_presets=True,
                       path=str(tmp_path / "r.json"))
    assert cache.entries == ref.entries
    e = cache.lookup("argsort_batched", "float32", 12)   # sampler only
    assert e["source"] == "preset" and e["knobs"]["switch_below"] == 4096
    e3 = cache.lookup("topk", "float32", 12)  # sampler and moe disagree
    assert e3 is None or "switch_below" not in e3["knobs"]
    with registry.tuning.using_cache(cache):
        knobs, hint = registry.tuning.resolve("argsort_batched", n=999,
                                              dtype="float32")
    assert knobs["switch_below"] == 4096 and hint is None
    with registry.tuning.preset("sampler"), \
            registry.tuning.using_cache(cache):
        cache.put("topk", "float32", 17, backend="torch",
                  knobs={"switch_below": 128})
        k, _ = registry.tuning.resolve("topk", n=2**17, dtype="float32")
        assert k["switch_below"] == 128       # measured beats hand-rolled
        k, _ = registry.tuning.resolve("topk", n=64, dtype="float32")
        assert k["switch_below"] == 4096      # no key: the preset


# -- files of the two packages --------------------------------------------------

def test_files_of_either_package_serve_nothing_in_the_other(tmp_path):
    jpath = str(tmp_path / "autotune.json")
    jcache = JTS.tune_all(sizes=(4096, 131072), primitives=("sort",),
                          measure=JTS.model_measure, path=jpath,
                          seed_presets=False)
    jcache.save()
    with pytest.raises(ValueError):
        T.validate_file(jpath)
    for device in (None, "cpu"):
        mine = T.TuneCache.load(jpath, device=device)
        assert not mine.compatible
        assert mine.lookup("sort", "float32", 17) is None
        assert mine.stats.stale == 1
    _, ppath = _cpu_cache(tmp_path)
    with pytest.raises(ValueError):
        JTC.validate_file(ppath)
    theirs = JTC.TuneCache.load(ppath)
    assert not theirs.compatible
    assert theirs.lookup("sort", "float32", 17) is None
    assert theirs.stats.stale == 1
    with jreg.tuning.using_cache(theirs):
        _, hint = jreg.tuning.resolve("sort", n=2**17, dtype="float32")
    assert hint is None


# -- two processes share one on-disk cache ------------------------------------

def test_cross_process_cache_reuse(tmp_path):
    cache, path = _cpu_cache(tmp_path, primitives=("sort", "mapreduce"))
    code = f"""
import json
from repro_torch.core import registry
from repro_torch.tune import cache as TC
cache = TC.TuneCache.load({path!r})
hints = {{}}
with registry.tuning.using_cache(cache):
    for prim in ("sort", "mapreduce"):
        for n in (4096, 131072):
            hints[f"{{prim}}{{n}}"] = registry.tuning.resolve(
                prim, n=n, dtype="float32", device="cpu")[1]
print(json.dumps({{"hints": hints, "stats": cache.stats.as_dict()}}))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["stats"] == {"hits": 4, "misses": 0, "stale": 0}
    assert set(out["hints"].values()) == {"torch"}


# -- the CLI ------------------------------------------------------------------------

def test_cli_writes_a_valid_host_cache(tmp_path, capsys):
    from repro_torch.tune.__main__ import main

    path = str(tmp_path / "cli.json")
    rc = main(["--model", "--device", "cpu", "--sizes", "4096,131072",
               "--primitives", "sort,mapreduce", "--cache", path])
    assert rc == 0
    doc = T.validate_file(path)
    assert doc["fingerprint"]["backend"] == "cpu"
    out = capsys.readouterr().out
    assert "sort|float32|c17" in out and "non-default knob sets" in out


def test_cli_without_a_card_refuses_the_card(tmp_path, capsys):
    from repro_torch.tune.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    path = str(tmp_path / "none.json")
    assert main(["--model", "--cache", path]) != 0
    assert not os.path.exists(path)
    assert "no CUDA device" in capsys.readouterr().err


# -- the co-sort's weights from the caches ------------------------------------

def test_foreign_fingerprint_rank_weights_fall_back_to_the_model(tmp_path):
    """A card cache written on another card and a host cache of another
    thread count serve nothing (counted stale): every rank's throughput
    comes from the model, and the weights are still skewed, never
    uniform."""
    from repro_torch.launch import mesh as LM

    card = _card_cache(tmp_path, {("merge_kv", 20): ("cuda", {})})
    card.save()
    doc = json.load(open(card.path))
    doc["fingerprint"]["device_kind"] = "a card elsewhere"
    json.dump(doc, open(card.path, "w"))
    foreign = T.TuneCache.load(card.path, fingerprint=CARD_FP)
    _, hpath = _cpu_cache(tmp_path, sizes=(2**20,), primitives=("merge_kv",))
    host = T.TuneCache.load(hpath, threads=torch.get_num_threads() + 3)
    w, srcs = LM.hetero_rank_weights(("torch", "torch") + ("cuda",) * 6,
                                     2**20, cache=[foreign, host],
                                     primitive="merge_kv")
    assert srcs == ("model",) * 8
    assert foreign.stats.stale == 6 and host.stats.stale == 2
    assert abs(w.sum() - 1.0) < 1e-9
    assert w[0] == w[1] < w[2] and w.max() / w.min() > 1.5


def test_compatible_caches_serve_measured_rank_throughput(tmp_path):
    card = _card_cache(tmp_path, {("sort", 17): ("torch", {})})
    _, hpath = _cpu_cache(tmp_path)
    host = T.TuneCache.load(hpath)
    e = host.lookup("sort", "float32", 17)
    thr, src = TS.rank_throughput(2**17, "float32", backend="torch",
                                  cache=[card, host])
    assert src == "measured"
    assert abs(thr - 2**17 / (e["t_us"] * 1e-6)) < 1e-6 * thr
    # a cuda rank reads the card's entry: the pick where it ran the
    # kernels, else the kernels' default time beside a torch pick
    thr, src = TS.rank_throughput(2**17, "float32", backend="cuda",
                                  cache=[card, host])
    assert src == "measured" and thr == pytest.approx(2**17 / 20e-6)
    _, src = TS.rank_throughput(2**17, "float32", backend="auto",
                                cache=card)
    assert src == "measured"
    _, src = TS.rank_throughput(2**17, "float32", backend="torch",
                                cache=card)   # no host cache: the model
    assert src == "model"
    _, src = TS.rank_throughput(2**17, "float32", backend="cuda",
                                cache=None)
    assert src == "model"
