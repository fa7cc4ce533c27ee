"""Mixture-of-Experts with AK-sort-based token routing (counterpart of
``repro/models/moe.py``).

Expert dispatch is a key sort of (expert_id, token) pairs, as in the
reference:

    router top-k            -> ak.topk
    group tokens by expert  -> ak.sortperm  (stable: token order within an
                                             expert decides the capacity
                                             drops, deterministically)
    tokens per expert       -> ak.bincount
    expert buffer offsets   -> ak.accumulate (exclusive scan)

``moe_ffn`` dispatches ``"bucketed"`` by default: tokens gathered
expert-contiguously off the sortperm, the expert FFN over the ragged
buckets, and the per-token top-k combine as ONE ``ak.segmented_reduce``
over uniform k-wide segments (whose (T*k, d) values take the portable
flagged path, as in the reference, counted in its ``portable_calls`` on
the card). ``"padded"`` keeps the capacity-padded scatter with its ghost
row. Both drop the same tokens.

The reference's ``lax.ragged_dot`` lies outside any Pallas kernel, so a
library call stands in for it: ``torch._grouped_mm`` with the bucket ends
computed on the device from the ``accumulate`` (no host sync), where its
dtype and stride checks pass on the card (bfloat16, 16-byte aligned rows,
sm_90); otherwise, and on the CPU, a loop over experts with
``torch.matmul``, whose per-expert products are joined by ``torch.cat``
(no ``out=``, so autograd records them). The router's product runs in
IEEE float32 (no TF32): a flipped top-k id changes a token.

``moe_ffn_ep`` is the reference's shard_map expert-parallel path over the
ranks of a ``launch.mesh.HostMesh``: each rank takes its slice of the
sequence, owns ``n_experts / ep`` experts and exchanges the capacity
buffers with two differentiable all_to_alls a layer.

Training: both dispatches backpropagate. The kernels under the routing
(``topk``, ``sortperm``; kernel rows 1-2 of PERF.md) need no backward of
their own: ``sortperm``'s and ``bincount``'s results are integers that
feed only index arithmetic, and ``topk``'s values are gathered from the
differentiable probabilities (``sort_kernel.bitonic_topk_batched``).
The reference has no ``custom_vjp`` either. The combine's
``segmented_reduce`` over (T*k, d) values carries its graph on the
portable path, where the registry sends any operand that requires grad.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import core as ak
from repro_torch.core import registry
from repro_torch.kernels.ref import full_f32_matmul
from repro_torch.models import layers as L

# The reference's presets, with its values. Routing arrays are (T*k,)
# sized; below 2048 elements the portable path beats kernel launches (at
# decode T*k = 64), above it (prefill) sortperm reaches the bitonic
# kernels. topk compares the row length E, which stays below the cut-off.
ROUTING_TUNING = registry.tuning.register_preset("moe_routing", {
    "argsort": {"switch_below": 2048},
    "accumulate": {"switch_below": 2048},
    "topk": {"switch_below": 2048},
})

DISPATCH_TUNING = registry.tuning.register_preset("moe_dispatch", {
    "segmented_reduce": {"switch_below": 2048},
    "segmented_scan": {"switch_below": 2048},
    "segmented_sort": {"switch_below": 2048},
})

DISPATCHES = ("bucketed", "padded")


def moe_init(gen, cfg, device):
    """Router (float32) + stacked expert weights (+ shared experts), with
    the reference's distributions: U(+-1/sqrt(d_model)) everywhere."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / math.sqrt(d)

    def experts_w(a, b):
        w = torch.empty((E, a, b), dtype=torch.float32, device=device)
        w.uniform_(-1.0, 1.0, generator=gen)
        return (w * scale).to(cfg.dtype)

    p = {
        "router": L.dense_init(gen, d, E, torch.float32, device),
        "w_gate": experts_w(d, ff),
        "w_up": experts_w(d, ff),
        "w_down": experts_w(ff, d),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.swiglu_init(gen, d, ff * cfg.n_shared_experts,
                                    cfg.dtype, device)
    return p


def _route(p, cfg, x_flat):
    """Router: (ids (T, k) int32, gates (T, k), occupancy (E,), importance
    (E,)); balance loss = E * sum_e occupancy_e * importance_e."""
    with full_f32_matmul():
        logits = x_flat.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    with registry.tuning.preset("moe_routing"):
        gate_vals, ids = ak.topk(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    T = x_flat.shape[0]
    occupancy = ak.bincount(ids.reshape(-1), cfg.n_experts).to(
        torch.float32) / (T * cfg.top_k)
    importance = probs.mean(dim=0)
    return ids, gate_vals.to(x_flat.dtype), occupancy, importance


def _aux_loss(cfg, occupancy, importance):
    return cfg.n_experts * torch.sum(occupancy * importance)


def _expert_ffn(p, xe):
    """xe: (E, C, d) -> (E, C, d), batched over experts."""
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xe,
                                              p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


def grouped_mm_applies(x, w) -> bool:
    """Whether ``torch._grouped_mm`` takes (N, K) rows times (E, K, N')
    weights: bfloat16 on an sm_90+ card, rows of 16-byte multiples."""
    return (x.is_cuda and w.is_cuda and hasattr(torch, "_grouped_mm")
            and x.dtype == w.dtype == torch.bfloat16
            and x.shape[1] % 8 == 0 and w.shape[2] % 8 == 0
            and x.is_contiguous() and w.is_contiguous()
            and torch.cuda.get_device_capability(x.device) >= (9, 0))


def grouped_matmul(x, w, counts, ends, *, grouped=None):
    """Rows ``x`` (N, K) in expert-contiguous buckets of ``counts`` (E,)
    rows, bucket e ending at ``ends[e]``, times ``w[e]`` (E, K, N') ->
    (N, N'): ``lax.ragged_dot``. ``grouped`` (None: where it applies)
    picks ``torch._grouped_mm`` over the per-expert loop."""
    if grouped is None:
        grouped = grouped_mm_applies(x, w)
    if grouped:
        return torch._grouped_mm(x, w, offs=ends.to(torch.int32))
    parts, start = [], 0
    for e, n in enumerate(counts.tolist()):
        if n:
            parts.append(x[start:start + n] @ w[e])
        start += n
    if start < x.shape[0] or not parts:   # rows past the last bucket
        parts.append(x.new_zeros((x.shape[0] - start, w.shape[2])))
    return torch.cat(parts)


def _expert_ffn_bucketed(p, xs, counts, offsets, grouped=None):
    """xs: (N, d) expert-contiguous rows -> (N, d): expert e's weights
    applied to exactly its bucket, no capacity padding. ``grouped`` as in
    ``grouped_matmul`` (False: the per-expert loop, the card's
    reference)."""
    gm = functools.partial(grouped_matmul, counts=counts,
                           ends=offsets + counts, grouped=grouped)
    h = torch.nn.functional.silu(gm(xs, p["w_gate"])) * gm(xs, p["w_up"])
    return gm(h, p["w_down"])


def _dispatch_indices(cfg, ids, T, capacity):
    """The AK routing core over the (T*k,) flat axis: (perm, slot, keep,
    sorted_ids, counts, offsets); counts/offsets describe the expert
    buckets as CSR."""
    k = cfg.top_k
    flat_ids = ids.reshape(-1)
    with registry.tuning.preset("moe_routing"):
        perm = ak.sortperm(flat_ids)
        sorted_ids = flat_ids[perm.long()]
        counts = ak.bincount(flat_ids, cfg.n_experts)
        offsets = ak.accumulate(torch.add, counts, init=0, inclusive=False)
    pos_in_expert = (torch.arange(T * k, dtype=torch.int32,
                                  device=ids.device)
                     - offsets[sorted_ids.long()])
    keep = pos_in_expert < capacity
    slot = sorted_ids * capacity + torch.clamp(pos_in_expert,
                                               max=capacity - 1)
    return perm, slot, keep, sorted_ids, counts, offsets


def _scatter_to_slots(rows, slot, keep, n_slots):
    """Scatter kept ``rows`` into their capacity slots; dropped rows land
    in a GHOST row (index ``n_slots``) that is sliced off."""
    buf = torch.zeros((n_slots + 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    target = torch.where(keep, slot, n_slots).long()
    buf.index_add_(0, target, torch.where(keep[:, None], rows, 0))
    return buf[:n_slots]


def moe_ffn(p, cfg, x, *, capacity_factor=None, dispatch="bucketed",
            mesh=None, dp_axes=("data",)):
    """Single-program MoE FFN. x: (B, S, d) -> (y, aux_loss).

    ``dispatch``: ``"bucketed"`` (the reference's default) or
    ``"padded"``; both apply the same capacity drop policy. With a
    ``mesh`` (data-parallel training, x this rank's rows) ``occ`` and
    ``imp`` are averaged over ``dp_axes`` before their product, so
    ``aux`` is the whole batch's balance loss, as the reference's jit
    computes it over the sharded batch; the capacity is the rank's own,
    as in its shard_map body (``moe_ffn_ep``)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    B, S, d = x.shape
    T = B * S
    k = cfg.top_k
    cf = capacity_factor or cfg.moe_capacity_factor
    capacity = max(int(T * k * cf / cfg.n_experts), 4)

    xf = x.reshape(T, d)
    ids, gates, occ, imp = _route(p, cfg, xf)
    for ax in dp_axes if mesh is not None else ():
        occ = mesh.mean(occ, ax)
        imp = mesh.mean(imp, ax)
    aux = _aux_loss(cfg, occ, imp)
    perm, slot, keep, _, counts, offsets = _dispatch_indices(
        cfg, ids, T, capacity)
    perm = perm.long()
    token_of = perm // k
    gate_of = gates.reshape(-1)[perm]

    if dispatch == "bucketed":
        ys = _expert_ffn_bucketed(p, xf[token_of], counts, offsets)
        contrib = torch.where(keep[:, None], ys * gate_of[:, None], 0)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(T * k, device=x.device)
        tok_offsets = torch.arange(T + 1, dtype=torch.int32,
                                   device=x.device) * k
        with registry.tuning.preset("moe_dispatch"):
            out = ak.segmented_reduce(torch.add, contrib[inv], tok_offsets,
                                      init=0)
    else:
        E = cfg.n_experts
        buf = _scatter_to_slots(xf[token_of], slot, keep, E * capacity)
        ye = _expert_ffn(p, buf.reshape(E, capacity, d)).reshape(
            E * capacity, d)
        contrib = torch.where(keep[:, None], ye[slot.long()]
                              * gate_of[:, None], 0)
        out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
        out.index_add_(0, token_of, contrib)

    out = out.to(x.dtype)
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], xf)
    return out.reshape(B, S, d), aux


def moe_ffn_ep(p, cfg, x, *, mesh, dp_axes=("data",), ep_axis="model",
               capacity_factor=None):
    """Expert-parallel MoE FFN over the ``ep_axis`` ranks of ``mesh`` (a
    ``launch.mesh.HostMesh``, one process a rank). x: (B, S, d), this
    data rank's batch, the same on every rank of ``ep_axis`` -> (y (B,
    S, d), aux), both the same on those ranks.

    As the reference's shard_map body: rank r takes sequence slice r
    (S must divide by the axis size) and owns experts [r * E_l, (r + 1) *
    E_l) of ``p``'s stacks (E_l = n_experts / ep); its tokens are routed
    and scattered into capacity-padded (E, C, d) buffers, exchanged so
    each rank receives its experts' tokens from every peer, run through
    the batched expert FFN and exchanged back (two all_to_alls), then
    combined. ``occ`` and ``imp`` are averaged over ``ep_axis`` and
    ``dp_axes`` before their product, so ``aux`` is the global balance
    loss. The slices of y are gathered over ``ep_axis`` at the end
    (the reference's GSPMD gathers its sequence-sharded output where it
    is used). Shared experts, when the config has them, run replicated
    on the rank's tokens (the reference column-shards them over the
    axis).

    The collectives are differentiable (``torch.distributed.nn``), and
    their backward sums the cotangents over the ranks. Gradient
    convention: every rank backpropagates the same replicated loss, and
    the rank-MEAN of the ranks' parameter gradients (a DP all-reduce
    mean) is the single-program gradient: the gather and the all_reduce
    of ``occ``/``imp`` each count the replicated loss once a rank, and
    an expert's weights get their gradient on the rank that owns them
    only. Summing instead of averaging gives ep times the gradient.
    """
    ep = mesh.shape[ep_axis]
    if cfg.n_experts % ep or x.shape[1] % ep:
        raise ValueError(f"n_experts {cfg.n_experts} and sequence "
                         f"{x.shape[1]} must divide by the {ep_axis!r} "
                         f"axis size {ep}")
    E_l = cfg.n_experts // ep
    B, S, d = x.shape
    S_l = S // ep
    r = mesh.index(ep_axis)
    k = cfg.top_k
    cf = capacity_factor or cfg.moe_capacity_factor
    T_l = B * S_l
    capacity = max(int(T_l * k * cf / cfg.n_experts), 4)

    xf = x[:, r * S_l:(r + 1) * S_l].reshape(T_l, d)
    ids, gates, occ, imp = _route(p, cfg, xf)
    for ax in (ep_axis, *dp_axes):   # the global balance loss exactly
        occ = mesh.mean(occ, ax)
        imp = mesh.mean(imp, ax)
    aux = _aux_loss(cfg, occ, imp)
    perm, slot, keep, _, _, _ = _dispatch_indices(cfg, ids, T_l, capacity)
    perm = perm.long()
    token_of = perm // k
    gate_of = gates.reshape(-1)[perm]

    buf = _scatter_to_slots(xf[token_of], slot, keep,
                            cfg.n_experts * capacity)
    # (ep, E_l, C, d): row q of what a rank receives holds peer q's tokens
    # for this rank's experts
    buf = mesh.all_to_all(buf.reshape(ep, E_l, capacity, d), ep_axis)
    local = {w: p[w][r * E_l:(r + 1) * E_l]
             for w in ("w_gate", "w_up", "w_down")}
    ye = _expert_ffn(local, buf.transpose(0, 1).reshape(
        E_l, ep * capacity, d))
    ye = ye.reshape(E_l, ep, capacity, d).transpose(0, 1)
    ye = mesh.all_to_all(ye, ep_axis).reshape(cfg.n_experts * capacity, d)

    contrib = torch.where(keep[:, None], ye[slot.long()] * gate_of[:, None],
                          0)
    out = torch.zeros((T_l, d), dtype=x.dtype, device=x.device).index_add(
        0, token_of, contrib.to(x.dtype))
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], xf)
    y = mesh.all_gather(out.reshape(B, S_l, d), ep_axis, dim=1)
    return y, aux
