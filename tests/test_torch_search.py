"""The arithmetic of the port's warp-cooperative 32-ary search
(``csrc/search.cu`` ``search_warp_kernel``), modelled in numpy round by
round, against ``np.searchsorted``, the port's plain version and the JAX
package's ``searchsorted_blocks`` (Pallas in interpret mode), bitwise.

The CUDA kernel runs only on the card (``tests/test_torch_card.py``
holds it there against ``torch.searchsorted``). This model repeats its
integer arithmetic exactly: lane l probes ``lo + (l + 1) * m // 33`` of
the m unknown positions, the ballot of the predicate is a prefix of
lanes of length k, the interval becomes (probe k-1, probe k], and a last
round counts the <= 32 positions left. Haystack sizes sit at the rounds'
edges: 0, 1, 2, 31-34, 33^2 - 1 .. 33^2 + 1 and 33^3 +- 1, with
duplicates, all-equal keys and type-max keys, both sides, in float32,
int32 and bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro import core as jak
from repro_torch.kernels import search_kernel as TSE

from torch_parity import DTYPES, keys, t

LANES = np.arange(32, dtype=np.int64)
N_GRID = (0, 1, 2, 31, 32, 33, 34, 1088, 1089, 1090, 33 ** 3 - 1,
          33 ** 3 + 1)


def _before(h, v, right: bool):
    """The kernel's predicate: h lies before v's insertion point."""
    return ~(v < h) if right else h < v


def kary_search(hay: np.ndarray, q: np.ndarray, right: bool):
    """Insertion indices of ``q`` into sorted ``hay`` by the warp kernel's
    rounds, every query at once; returns (indices, rounds per query) and
    asserts each round's invariants: probes strictly rising inside
    [lo, hi), the ballot a prefix of lanes."""
    n = hay.shape[0]
    lo = np.zeros(q.shape[0], np.int64)
    hi = np.full(q.shape[0], n, np.int64)
    rounds = np.zeros(q.shape[0], np.int64)
    while True:
        live = hi - lo > 32
        if not live.any():
            break
        m, base, top = (hi - lo)[live], lo[live], hi[live]
        p = base[:, None] + (LANES + 1)[None, :] * m[:, None] // 33
        assert (np.diff(p, axis=1) > 0).all()
        assert (p >= base[:, None]).all() and (p < top[:, None]).all()
        ballot = _before(hay[p], q[live][:, None], right)
        k = ballot.sum(axis=1)
        assert (ballot == (LANES[None, :] < k[:, None])).all()
        hi[live] = np.where(k < 32, base + (k + 1) * m // 33, top)
        lo[live] = np.where(k > 0, base + k * m // 33 + 1, base)
        rounds[live] += 1
    pos = lo[:, None] + LANES[None, :]
    inside = pos < hi[:, None]
    if n:
        hit = inside & _before(hay[np.minimum(pos, n - 1)], q[:, None],
                               right)
    else:
        hit = inside
    return lo + hit.sum(axis=1), rounds + 1


def _case(dtype: str, n: int, dist: str, seed: int):
    """A sorted haystack of n keys (its last 3 type-max when n > 3) and
    queries that hit keys, miss them, and lie past both ends."""
    rng = np.random.default_rng(seed)
    hay = keys(rng, n, dtype, dist)
    top = np.array([np.iinfo(np.int32).max if dtype == "i32" else np.inf]
                   ).astype(hay.dtype)
    bottom = np.array([np.iinfo(np.int32).min if dtype == "i32"
                       else -np.inf]).astype(hay.dtype)
    if n > 3:
        hay[-3:] = top[0]
    hay = np.sort(hay, kind="stable")
    parts = [keys(rng, 24, dtype), top, bottom]
    if n:
        parts.insert(0, rng.choice(hay, 24))
    return hay, np.concatenate(parts).astype(hay.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dist", ("normal", "duplicates", "constant"))
def test_kary_model_bitwise_vs_searchsorted_and_reference(dtype, dist):
    for i, n in enumerate(N_GRID):
        hay, q = _case(dtype, n, dist, seed=i)
        for side in ("left", "right"):
            got, rounds = kary_search(hay, q, side == "right")
            want = np.searchsorted(hay.astype(np.float64),
                                   q.astype(np.float64), side=side)
            np.testing.assert_array_equal(got, want, f"n={n} {side}")
            np.testing.assert_array_equal(
                got, TSE.searchsorted_plain(t(hay), t(q), side=side)
                .numpy(), f"n={n} {side}")
            # 33^(r+1) - 1 keys take at most r rounds and the last
            assert rounds.max() <= 1 + (n > 32) + (n > 33 ** 2 - 1) \
                + (n > 33 ** 3 - 1), (n, rounds.max())
            if n in (0, 33, 1089, 33 ** 3 + 1):
                fn = (jak.searchsortedfirst if side == "left"
                      else jak.searchsortedlast)
                ref = np.asarray(fn(jnp.asarray(hay), jnp.asarray(q),
                                    backend="pallas"))
                np.testing.assert_array_equal(got, ref, f"n={n} {side}")


def _worst_rounds(n: int) -> int:
    """Rounds of 32 probes before <= 32 positions are left, on the
    largest sub-interval every round (ballot prefix k = 0 .. 32)."""
    rounds = 0
    while n > 32:
        p = [(k + 1) * n // 33 for k in range(32)]
        sizes = [p[0]] + [p[k] - p[k - 1] - 1 for k in range(1, 32)] \
            + [n - p[31] - 1]
        assert sum(sizes) + 32 == n
        n = max(sizes)
        rounds += 1
    return rounds


@pytest.mark.parametrize("n,full_rounds", [
    (32, 0), (33, 1), (33 ** 2 - 1, 1), (33 ** 2, 2), (33 ** 3 - 1, 2),
    (33 ** 3, 3), (1 << 20, 3), (1 << 26, 5), (1 << 31, 6)])
def test_kary_round_count(n, full_rounds):
    """SIHSort's 2^26-key shard takes 5 rounds of 32 independent probes
    and the last one, where a binary search makes 26 dependent loads."""
    assert _worst_rounds(n) == full_rounds
