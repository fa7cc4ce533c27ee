"""Data pipeline: a deterministic synthetic corpus and the sort-based
global shuffle (counterpart of ``repro/data/pipeline.py``).

The global shuffle is the paper's "processing of large data sets" use
case: shuffling a distributed dataset is a distributed sort of (random
key, sample id) pairs, so it rides SIHSort (``core.distributed``) over
``nranks`` processes, a new key each epoch, with its minimal collectives
(2 + refine_rounds + 1 a rank).

The synthetic corpus is a counter-based PRNG token stream (zipf-like over
the vocabulary): every host draws its own shard from (seed, step, host)
with no coordination, so a restart needs only the step counter. It is
numpy only and the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticCorpus:
    vocab: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, batch_size: int, host: int = 0,
              n_hosts: int = 1):
        """Deterministic (tokens, labels), int32 numpy, for this host's
        slice of the global batch at ``step`` (restart-safe)."""
        per_host = batch_size // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host]))
        # zipf-flavoured ids clipped to the vocabulary: a heavy head
        raw = rng.zipf(1.3, size=(per_host, self.seq_len + 1))
        toks = np.minimum(raw - 1, self.vocab - 1).astype(np.int32)
        return toks[:, :-1], toks[:, 1:]


def make_batches(cfg, shape, *, n_steps: int, seed: int = 0,
                 device="cuda"):
    """``n_steps`` batches {"tokens", "labels"} of ``shape`` ({"batch",
    "seq"}) as int32 tensors on ``device``."""
    corpus = SyntheticCorpus(cfg.vocab, shape["seq"], seed)
    for step in range(n_steps):
        tokens, labels = corpus.batch(step, shape["batch"])
        yield {"tokens": torch.from_numpy(tokens).to(device),
               "labels": torch.from_numpy(labels).to(device)}


def shuffle_keys(n: int, seed: int = 0) -> torch.Tensor:
    """The shuffle's (n,) float32 keys in [0, 1), from a ``torch.Generator``
    seeded by ``seed`` on the host (the reference draws them from
    ``jax.random``, which torch cannot reproduce)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n, generator=gen, dtype=torch.float32)


def global_shuffle_by_sort(sample_ids, nranks: int, *, seed: int = 0,
                           device="cuda", with_stats: bool = False):
    """Epoch-level global shuffle: SIHSort of (random key, sample id)
    pairs over ``nranks`` processes (``core.distributed.sihsort_sharded``,
    capacity factor 2, as the reference's).

    ``sample_ids``: 1-D int32, its length divisible by ``nranks`` (rank r
    holds slice r). Returns (the shuffled ids, padded-ragged: ``nranks``
    shards of ``nranks * cap`` slots; the valid count a shard), as the
    reference does; with ``with_stats`` also the ranks' ``RankStats``
    (collectives, launches by kernel)."""
    from repro_torch.core import distributed as D

    ids = torch.as_tensor(sample_ids)
    keys = shuffle_keys(ids.shape[0], seed)
    res, stats = D.sihsort_sharded_with_stats(
        keys, nranks, payload=ids, device=device, capacity_factor=2.0)
    out = (res.payload, res.count)
    return (*out, stats) if with_stats else out
