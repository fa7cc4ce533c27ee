"""Paper Table II on the port (``benchmarks_torch/arithmetic.py``): RBF and
Lennard-Jones-Gauss through the map kernel's catalogue bodies, held to
``benchmarks/arithmetic.py``'s JAX functions on the same seeded points.

The JAX side runs its ``jnp`` backend and its Pallas kernel in interpret
mode; the port runs its ``cuda`` backend (on the CPU: the body's plain
version) and its ``torch`` backend. The tolerance of every element comes
from the body's conditioning (``rbf_check`` / ``ljg_check``): RBF near its
pole at r = 1 and past its overflow, LJG's cutoff branch within 1e-5 of
the cutoff, counted and bounded. Coordinates are uniform in [0.5, 4.0),
as the benchmark draws them, so the pole, the overflow and both sides of
the cutoff all occur.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import arithmetic as JAR
from benchmarks_torch import arithmetic as TAR
from repro_torch.core import registry
from repro_torch.kernels import common as TC
from repro_torch.kernels import map_kernel as TMK

N = 20000


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(0)
    return (rng.uniform(0.5, 4.0, size=(3, N)).astype(np.float32),
            rng.uniform(0.5, 4.0, size=(3, N)).astype(np.float32))


@pytest.mark.parametrize("jbackend", ["jnp", "pallas"])
def test_rbf_vs_jax(pts, jbackend):
    v, _ = pts
    want = np.asarray(JAR.rbf_kernel(jnp.asarray(v), backend=jbackend))
    assert np.isinf(want).any() and (want < 1e-3).any()  # both regimes
    for backend in ("cuda", "torch"):
        got = TAR.rbf_kernel(torch.from_numpy(v), backend=backend)
        res = TAR.rbf_check(got, want, v)
        assert res["bad"] == 0 and res["worst"] <= 1.0, res
    # the plain body and the numpy oracle agree within the same bound
    assert TAR.rbf_check(got, TAR.rbf_numpy(v), v)["bad"] == 0


@pytest.mark.parametrize("jbackend", ["jnp", "pallas"])
def test_ljg_vs_jax(pts, jbackend):
    p1, p2 = pts
    want = np.asarray(JAR.ljg_kernel(jnp.asarray(p1), jnp.asarray(p2),
                                     backend=jbackend))
    assert (want == 0).any() and (want != 0).any()  # both branches
    for backend in ("cuda", "torch"):
        got = TAR.ljg_kernel(torch.from_numpy(p1), torch.from_numpy(p2),
                             backend=backend)
        res = TAR.ljg_check(got, want, p1, p2)
        assert res["bad"] == 0 and res["flips"] <= res["window"], res


def test_ljg_parameters_reach_the_body(pts):
    p1, p2 = pts
    kw = dict(eps=0.5, sigma=1.2, r0=2.0, cutoff=2.5)
    want = np.asarray(JAR.ljg_kernel(jnp.asarray(p1), jnp.asarray(p2),
                                     backend="jnp", **kw))
    got = TAR.ljg_kernel(torch.from_numpy(p1), torch.from_numpy(p2),
                         backend="cuda", **kw)
    assert TAR.ljg_check(got, want, p1, p2, **kw)["bad"] == 0
    assert TMK.ljg_body(**kw).params == (2.0, 0.5, 1.2, 2.0, 2.5, 0.04)


def test_checks_catch_a_wrong_result(pts):
    """The conditioning bounds are tight enough to see a one-part-in-1e5
    error away from the pole and a branch taken far from the cutoff."""
    v, p2 = pts
    want = TAR.rbf_numpy(v)
    r = np.sqrt((v.astype(np.float64) ** 2).sum(0))
    bad = want.copy()
    i = int(np.argmax(np.abs(r - 1) > 2))
    bad[i] *= np.float32(1 + 1e-5)
    assert TAR.rbf_check(bad, want, v)["bad"] == 1
    want = TAR.ljg_numpy(v, p2)
    bad = want.copy()
    j = int(np.argmax(want != 0))
    bad[j] = 0.0
    assert TAR.ljg_check(bad, want, v, p2)["bad"] == 1


def test_table2_path_takes_the_kernel_without_portable_calls(pts):
    v, p2 = pts
    registry.reset_stats()
    TC.reset_launch_count()
    TAR.rbf_kernel(torch.from_numpy(v), backend="cuda")
    TAR.ljg_kernel(torch.from_numpy(v), torch.from_numpy(p2),
                   backend="cuda")
    assert registry.stats("map")["portable_calls"] == 0
    assert registry.stats("map")["calls"] == 2
    with pytest.raises(RuntimeError):
        TAR.run(16)  # timing needs the card
