"""AdamW with decoupled weight decay and global-norm clipping
(counterpart of ``repro/optim/adamw.py``).

Plain functions over the port's parameter tree (nested dicts and lists of
tensors, ``repro_torch.tree``), not a ``torch.optim.Optimizer``: the
state is a tree the checkpoint writes leaf by leaf, and a step returns new
trees (the supervisor retries a step on the same inputs). The casts are
the reference's: m and v are float32 whatever the parameters' dtype;
clipped gradients are cast back to the gradient's dtype before the update
casts them to float32 again; the new parameter is computed in float32 and
cast to the parameter's dtype. With bfloat16 parameters each of those
roundings changes bits.

Sharded state (``launch.train.jitted_train_step``): the update runs on
each rank's local shards as they are (it is elementwise), and the global
gradient norm comes from ``sq_sum``, which sums each leaf's squares once
over the mesh (``launch.train.global_sq_sum``: a leaf kept whole over an
axis is not counted once a rank).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d, on the parameters' device
    m: dict
    v: dict


def adamw_init(params) -> AdamWState:
    """Zero float32 moments of the parameters' shapes, step 0."""
    zeros = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v=tree.map(torch.clone, zeros))


def sq_sum(grads) -> torch.Tensor:
    """The float32 sum of every gradient element's square."""
    return sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in tree.leaves(grads))


def clip_by_global_norm(grads, max_norm: float, *, sum_of_squares=sq_sum):
    """(grads scaled to a global norm of at most ``max_norm``, each cast
    back to its own dtype; the float32 global norm before clipping).
    ``sum_of_squares(grads)`` gives the squared norm (the sharded step's
    sums over the mesh)."""
    gnorm = torch.sqrt(sum_of_squares(grads))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree.map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gnorm


def adamw_update(params, grads, state: AdamWState, *, lr=3e-4, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, max_grad_norm=1.0,
                 sum_of_squares=sq_sum):
    """One AdamW step -> (new params, new state, global grad norm before
    clipping). Pure: no argument is written."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm,
                                       sum_of_squares=sum_of_squares)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        pf = p.to(torch.float32)
        pf = pf - lr * (update + weight_decay * pf)
        return pf.to(p.dtype), m_new, v_new

    outs = tree.map(upd, params, grads, state.m, state.v)

    def pick(i):   # component i of the (p, m, v) triple at each leaf
        return tree.map(lambda _, o: o[i], params, outs)

    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2)), gnorm
