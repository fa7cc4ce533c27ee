"""The port's sharded decode step over 4 gloo processes on the CPU against
the reference's one-device ``decode_step``, float32 smoke configs, the
same parameters (the reference's ``init_params``, converted; the vlm's
cross gates set nonzero) and the same seeded caches:

  * internlm2 on 2 x 2 (KV 2 divides 2: heads over ``model``, batch over
    ``data``) and on 1 x 4 (KV 2 does not divide 4: the cache sequence
    over ``model``, the softmax statistics merged split-K), and on 1 x 4
    with per-row vector positions, one row parked past the cache;
  * yi on 2 x 2 (7 query heads dealt out, KV 1: the sequence over
    ``model``); granite-moe on 2 x 2 (MoE without expert parallelism),
    drop-free at the smoke config's capacity factor and, at batch 16 and
    capacity factor 1, dropping tokens by the whole batch's capacity (a
    data rank's tokens placed after the lower ranks'); mamba2 on 2 x 2 (the conv cache's channel blocks over ``model``);
    zamba2 on 2 x 2 at batch 1 (``seq_shard``: the K/V sequence over
    ``data``, the heads over ``model``); whisper on 2 x 2; llama-3.2-
    vision on 1 x 4 (the cross cache ``xkv`` sequence-sharded too).

Each case takes three steps across a shard boundary (positions 6, 7, 8
on 16 columns) and one at a position >= 16, whose write clamps to the
last column. Logits within the attention tolerance (rtol 2e-4, atol
2e-5 of the largest |logit|), as are the written cache columns and the
recurrent states; every other cache element bitwise equal, after
``sharding.gather_tree``; nothing is NaN. The reference runs in one
subprocess (``decode_step`` jitted once a config), the port's ranks in
``tests/torch_decode_worker.py`` under a short gloo timeout; both start
as the module begins, under one deadline."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_decode_worker as W
import torch_ranks as R
from repro.configs import load_smoke_config as ref_smoke
from repro.models import model as RM
from repro_torch.convert import params_from_jax
from repro_torch.models import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE, SEED = 16, 7
POSITIONS = (6, 7, 8, CACHE + 4)
#: name -> (arch, mesh (data, model), global batch)
CASES = {
    "heads": ("internlm2_1_8b", (2, 2), 4),
    "seq_model": ("internlm2_1_8b", (1, 4), 4),
    "vector": ("internlm2_1_8b", (1, 4), 4),
    "kv1": ("yi_34b", (2, 2), 4),
    "moe": ("granite_moe_1b", (2, 2), 4),
    "ssm": ("mamba2_1_3b", (2, 2), 4),
    "long": ("zamba2_7b", (2, 2), 1),
    "encdec": ("whisper_medium", (2, 2), 4),
    "vlm": ("llama32_vision_90b", (1, 4), 4),
    "moe_drop": ("granite_moe_1b", (2, 2), 16),
}
#: capacity factors other than the smoke config's (1: the moe_drop case's
#: experts overflow; its test shows the drops change the logits)
CAPACITY = {"moe_drop": 1.0}
#: the vector case's rows start in three shards and one parks past it
VECTOR_START = (2, 6, 13, CACHE + 1)
RTOL, ATOL_SHARE = 2e-4, 2e-5
#: seconds the fixture's processes may take together
WAIT = 300

REFERENCE = """
import dataclasses, json, os
import numpy as np, jax, jax.numpy as jnp
from repro.configs import load_smoke_config
from repro.models import model as M

TMP, CASES = json.loads({args!r})
jitted = {{}}
for name, (arch, cf) in CASES.items():
    cfg = dataclasses.replace(load_smoke_config(arch), dtype=jnp.float32)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
    inp = np.load(os.path.join(TMP, name + ".in.npz"))
    treedef = jax.tree.structure(jax.eval_shape(
        lambda k: M.init_params(k, cfg), jax.random.PRNGKey(0)))
    n = treedef.num_leaves
    params = jax.tree.unflatten(treedef, [jnp.asarray(inp[f"p{{i}}"])
                                          for i in range(n)])
    keys = sorted(k[2:] for k in inp.files if k.startswith("c/"))
    caches = {{}}
    for k in keys:
        node = caches
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {{}})
        node[last] = jnp.asarray(inp["c/" + k])
    step = jitted.setdefault((arch, cf),
                             jax.jit(M.decode_step, static_argnums=1))
    logits = []
    for i in range(inp["tokens"].shape[0]):
        out, caches = step(params, cfg, jnp.asarray(inp["tokens"][i]),
                           caches, jnp.asarray(inp["positions"][i]))
        logits.append(np.asarray(out))
    res = {{"logits": np.stack(logits)}}
    for k in keys:
        node = caches
        for h in k.split("/"):
            node = node[h]
        res["c/" + k] = np.asarray(node)
    np.savez(os.path.join(TMP, name + ".out.part.npz"), **res)
    os.replace(os.path.join(TMP, name + ".out.part.npz"),
               os.path.join(TMP, name + ".out.npz"))
print("reference done")
"""


def _leaves(caches, prefix=""):
    """{"kv/k": leaf, ...} of a nested cache dict."""
    out = {}
    for k, v in caches.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _inputs(name, arch, batch):
    """The reference's parameters (numpy leaves), the seeded caches,
    tokens and positions of one case."""
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    rparams = jax.tree.map(np.asarray, jax.jit(
        RM.init_params, static_argnums=1)(jax.random.PRNGKey(SEED), rcfg))
    rng = np.random.default_rng([SEED, list(CASES).index(name)])
    if rcfg.family == "vlm":   # nonzero gates: the cross path counts
        for gate in ("gate_attn", "gate_mlp"):
            g = rparams["cross"][gate]
            rparams["cross"][gate] = rng.uniform(0.5, 1.5, g.shape).astype(
                np.float32)
    cfg = W.config(arch)
    specs = M.cache_specs(cfg, batch=batch, cache_len=CACHE)
    caches = {k: rng.normal(size=shape).astype(np.float32)
              for k, (shape, _) in _leaves(specs).items()}
    steps = len(POSITIONS)
    tokens = rng.integers(0, cfg.vocab, size=(steps, batch, 1)).astype(
        np.int32)
    if name == "vector":
        positions = (np.asarray(VECTOR_START, np.int32)[None]
                     + np.arange(steps, dtype=np.int32)[:, None])
    else:
        positions = np.asarray(POSITIONS, np.int32)
    return rparams, caches, tokens, positions


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs by case, the reference's outputs, the ranks' outputs): the
    ranks start first and wait for ``in.pt``; the reference subprocess
    starts once its inputs are saved."""
    deadline = time.monotonic() + WAIT
    tmp = str(tmp_path_factory.mktemp("decode"))
    procs = R.spawn(W.main, W.NRANKS, tmp)
    ref = None
    try:
        inp, port_in = {}, {}
        for name, (arch, shape, batch) in CASES.items():
            rparams, caches, tokens, positions = _inputs(name, arch, batch)
            leaves = jax.tree.leaves(rparams)
            np.savez(os.path.join(tmp, name + ".in.npz"),
                     tokens=tokens, positions=positions,
                     **{f"p{i}": x for i, x in enumerate(leaves)},
                     **{"c/" + k: v for k, v in caches.items()})
            port_in[name] = {
                "arch": arch, "mesh": shape, "batch": batch,
                "capacity_factor": CAPACITY.get(name),
                "params": params_from_jax(rparams, W.config(arch),
                                          device="cpu"),
                "caches": _nest({k: torch.from_numpy(v.copy())
                                 for k, v in caches.items()}),
                "tokens": torch.from_numpy(tokens),
                "positions": torch.from_numpy(positions)}
            inp[name] = {"caches": caches, "positions": positions,
                         "port": port_in[name]}
        args = json.dumps([tmp, {n: (c[0], CAPACITY.get(n))
                                 for n, c in CASES.items()}])
        ref = subprocess.Popen(
            [sys.executable, "-c",
             textwrap.dedent(REFERENCE.format(args=args))],
            env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        torch.save(port_in, os.path.join(tmp, "in.part"))
        os.replace(os.path.join(tmp, "in.part"), os.path.join(tmp, "in.pt"))
        codes = R.join(procs, deadline)
        _, stderr = ref.communicate(
            timeout=max(deadline - time.monotonic(), 1))
    finally:
        R.join(procs, 0)
        if ref is not None and ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr[-4000:]
    errs = R.errors(tmp, W.NRANKS)
    assert not errs and codes == [0] * W.NRANKS, (codes, errs)
    out = torch.load(os.path.join(tmp, "out.pt"), weights_only=False)
    want = {name: dict(np.load(os.path.join(tmp, name + ".out.npz")))
            for name in CASES}
    return inp, want, out


def _written(batch, positions, cache_len):
    """(batch, cache_len): the columns each row was written at. A scalar
    step writes every row at its position clamped to the last column; a
    row of a vector step past the cache drops its write."""
    mask = np.zeros((batch, cache_len), bool)
    for pos in positions:
        if np.ndim(pos) == 0:
            mask[:, min(int(pos), cache_len - 1)] = True
        else:
            for b, p in enumerate(pos):
                if p < cache_len:
                    mask[b, p] = True
    return mask


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_the_reference(runs, name):
    inp, want, out = runs
    got, ref = out[name], want[name]
    logits = got["logits"].numpy()
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(
        logits, ref["logits"], rtol=RTOL,
        atol=ATOL_SHARE * float(np.abs(ref["logits"]).max()))
    caches = _leaves(got["caches"])
    assert set(caches) == {k[2:] for k in ref if k.startswith("c/")}
    for key, leaf in caches.items():
        a, b, init = leaf.numpy(), ref["c/" + key], inp[name]["caches"][key]
        assert a.shape == b.shape and np.isfinite(a).all(), key
        if key.startswith("kv/"):
            mask = _written(a.shape[-4], inp[name]["positions"], CACHE)
            mask = np.broadcast_to(mask.reshape(
                (1,) * (a.ndim - 4) + mask.shape + (1, 1)), a.shape)
            np.testing.assert_array_equal(a[~mask], init[~mask], key)
            np.testing.assert_array_equal(b[~mask], init[~mask], key)
            a, b = a[mask], b[mask]
        elif key.startswith("xkv"):   # never written
            assert np.array_equal(a, init) and np.array_equal(b, init), key
            continue
        np.testing.assert_allclose(
            a, b, rtol=RTOL, atol=ATOL_SHARE * float(np.abs(b).max()),
            err_msg=key)


def test_sequence_sharded_cases_merge_and_head_sharded_do_not(runs):
    """The split-K merge runs exactly where ``kv_seq_axes`` shards the
    sequence: once a layer and step, its max and its sums."""
    _, _, out = runs
    for name, (arch, _, _) in CASES.items():
        stats = out[name]["collectives"]
        merges = stats.get("splitk_max", {}).get("count", 0)
        assert merges == stats.get("splitk_sum", {}).get("count", 0)
        assert (merges > 0) == (name in ("seq_model", "vector", "kv1",
                                         "long", "vlm")), name
    assert out["long"]["seq_shard"] and not out["heads"]["seq_shard"]


def test_moe_drop_case_drops_tokens(runs):
    """The moe_drop case's capacity drops tokens: the port's one-process
    first step at its capacity factor differs from a drop-free one."""
    inp, _, _ = runs
    case = inp["moe_drop"]["port"]
    cfg = W.config(case["arch"])
    got = []
    for cf in (CAPACITY["moe_drop"], float(cfg.n_experts)):
        caches = _nest({k: v.clone() for k, v in _leaves(
            case["caches"]).items()})
        with torch.no_grad():
            got.append(M.decode_step(
                case["params"], dataclasses.replace(
                    cfg, moe_capacity_factor=cf),
                case["tokens"][0], caches, int(case["positions"][0]))[0])
    assert not torch.allclose(got[0], got[1], rtol=1e-3, atol=1e-3)
