"""Helpers of the recurrent families' parity tests
(``tests/test_torch_{ssm,hybrid}.py``): the JAX package's smoke model and
the port's converted from it, comparisons of logits, caches and
parameters, and a sequential greedy reference built from the JAX
package's ``prefill`` and ``decode_step``. Logits and outputs within rtol
2e-4 / atol 2e-5 (the reference's attention tolerances; the two sum the
same float32 products in other orders); states within rtol 1e-4 / atol
1e-5."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import load_smoke_config as ref_smoke
from repro.models import model as RM
from repro_torch.configs import load_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.engine import COMPLETED, Engine, Request
from repro_torch.models import model as M

TOL = dict(rtol=2e-4, atol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def jnp_of(a):
    """A private copy as a JAX array (numpy arguments are never shared)."""
    return jnp.asarray(np.array(a, copy=True))


def tree_close(got, want, tol=TOL):
    """Port caches (nested dicts of tensors) against the reference's."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            tree_close(got[k], want[k], tol)
    else:
        assert tuple(got.shape) == tuple(np.shape(want))
        close(got, want, tol)


def f32_setup(arch, seed=0):
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    cfg = dataclasses.replace(load_smoke_config(arch), dtype=torch.float32)
    rparams = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    return rcfg, rparams, cfg, params


def _node(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


#: the reference's stacked parameter subtrees, split per layer by the port
STACKED = ("layers", "tail", "enc_layers", "cross")


def params_keep_every_leaf(arch, stacked_index):
    """``params_from_jax`` of the bfloat16 (served) smoke model keeps
    every leaf, bit for bit and in its dtype. ``stacked_index(params,
    key, i)`` gives the port's layer dict of stacked index ``i`` under
    ``key`` (one of ``STACKED``)."""
    rcfg = ref_smoke(arch)
    cfg = load_smoke_config(arch)
    assert cfg == dataclasses.replace(
        cfg, **{f.name: getattr(rcfg, f.name)
                for f in dataclasses.fields(cfg) if f.name != "dtype"})
    # jitted: the same draws as eager, in a third of the time
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), rcfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    assert M.param_count(params) == RM.param_count(rparams)
    dtypes = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        keys, leaf = [p.key for p in path], np.asarray(leaf)
        if keys[0] in STACKED:
            # the hybrid's and the vlm's (G, gs, ...) groups count as
            # G * gs layers
            lead = 2 if cfg.family in ("hybrid", "vlm") \
                and keys[0] == "layers" else 1
            arrays = list(leaf.reshape((-1,) + leaf.shape[lead:]))
            tensors = [_node(stacked_index(params, keys[0], i), keys[1:])
                       for i in range(len(arrays))]
        else:
            tensors, arrays = [_node(params, keys)], [leaf]
        for t, a in zip(tensors, arrays):
            assert str(t.dtype).split(".")[-1] == a.dtype.name, path
            assert tuple(t.shape) == a.shape, path
            bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}
            tb, nb = bits[a.dtype.itemsize]
            np.testing.assert_array_equal(t.view(tb).numpy(), a.view(nb))
            dtypes.add(a.dtype.name)
    assert dtypes == {"bfloat16", "float32"}
    return params


def cache_layout_matches(arch):
    """``cache_specs``, ``zero_caches`` and ``cache_batch_axes`` against
    the reference's, leaf for leaf."""
    cfg, rcfg = load_smoke_config(arch), ref_smoke(arch)
    want = RM.cache_specs(rcfg, batch=3, cache_len=12)
    got = M.cache_specs(cfg, batch=3, cache_len=12)
    zeros = M.zero_caches(cfg, batch=3, cache_len=12, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, tuple)))
    for path, spec in flat:
        node, z = got, zeros
        for p in path:
            node, z = node[p.key], z[p.key]
        shape, dt = node
        assert shape == spec.shape and tuple(z.shape) == spec.shape
        assert str(dt).split(".")[-1] == jnp.dtype(spec.dtype).name
        assert z.dtype == dt and not z.any()
    assert M.cache_batch_axes(cfg) == RM.cache_batch_axes(rcfg)


def smoke_logits_match(setup, rng_seed):
    """forward, prefill and two decode steps of a float32 smoke model
    against the reference's, with the prefill's caches."""
    rcfg, rparams, cfg, params = setup
    tok = np.random.default_rng(rng_seed).integers(
        0, cfg.vocab, (2, 11)).astype(np.int32)
    lg, _ = M.forward(params, cfg, torch.from_numpy(tok))
    rlg, _ = RM.forward(rparams, rcfg, jnp_of(tok))
    close(lg, rlg)
    lg, caches, n = M.prefill(params, cfg, torch.from_numpy(tok),
                              cache_len=16)
    rlg, rc, rn = RM.prefill(rparams, rcfg, jnp_of(tok), cache_len=16)
    close(lg, rlg)
    tree_close(caches, rc)
    assert n == int(rn) == 11
    for step in range(2):
        nt = np.argmax(np.asarray(rlg)[:, -1, :cfg.vocab], axis=-1
                       ).astype(np.int32)[:, None]
        lg, caches = M.decode_step(params, cfg, torch.from_numpy(nt),
                                   caches, 11 + step)
        rlg, rc = RM.decode_step(rparams, rcfg, jnp_of(nt), rc,
                                 jnp.int32(11 + step))
        close(lg, rlg)
    tree_close(caches, rc)


# (prompt lengths, max_new, prompt_pad, cache_len): requests refilling two
# slots, and tests/test_engine.py's ragged prompts shorter than the pad
CASES = {
    "refill": ([5, 8, 3, 7, 6], [6, 4, 9, 5, 7], 8, 16),
    "ragged": ([2, 5, 3], [4, 4, 4], 5, 12),
}


def sequential_reference(rparams, rcfg, prompts, max_new, cache_len):
    """Greedy tokens of each request alone through the reference's
    ``prefill`` (at the true prompt length) and scalar-position
    ``decode_step``, both jitted once per shape."""
    prefill = jax.jit(functools.partial(RM.prefill, cache_len=cache_len),
                      static_argnums=1)
    decode = jax.jit(RM.decode_step, static_argnums=1)
    out = []
    for prompt, n in zip(prompts, max_new):
        lg, caches, _ = prefill(rparams, rcfg, jnp_of(prompt[None]))
        toks = [int(jnp.argmax(lg[0, len(prompt) - 1, :rcfg.vocab]))]
        while len(toks) < n:
            lg, caches = decode(rparams, rcfg,
                                jnp_of(np.array([[toks[-1]]], np.int32)),
                                caches, jnp.int32(len(prompt) + len(toks)
                                                  - 1))
            toks.append(int(jnp.argmax(lg[0, 0, :rcfg.vocab])))
        out.append(toks)
    return out


def engine_cases(setup, seed):
    """{case: (prompts, reference tokens)} for ``CASES``."""
    rcfg, rparams, cfg, _ = setup
    out = {}
    for i, (case, (plens, max_new, _, cache_len)) in enumerate(
            CASES.items()):
        rng = np.random.default_rng(seed + i)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in plens]
        out[case] = (prompts, sequential_reference(
            rparams, rcfg, prompts, max_new, cache_len))
    return out


def engine_tokens_match(setup, cases, case):
    _, _, cfg, params = setup
    plens, max_new, pad, cache_len = CASES[case]
    prompts, want = cases[case]
    eng = Engine(params, cfg, slots=2, cache_len=cache_len, prompt_pad=pad,
                 temperature=0.0)
    res, stats = eng.run([Request(rid=i, prompt=p, max_new=m)
                          for i, (p, m) in enumerate(zip(prompts, max_new))])
    assert [res[i].tokens for i in range(len(prompts))] == want, case
    assert all(v.status == COMPLETED for v in res.values())
    assert stats.tokens == sum(max_new)
    assert stats.resident_bytes == [] and stats.active_tokens == []
