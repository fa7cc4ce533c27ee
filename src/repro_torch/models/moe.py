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
ranks of a mesh: each rank takes its slice of the sequence, owns
``n_experts / ep`` experts and exchanges the capacity buffers with two
differentiable all_to_alls a layer (``models.sharding``'s collectives).

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
from repro_torch.models import sharding as SH

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


def _expert_ffn_bucketed(p, xs, counts, offsets, grouped=None, first=0):
    """xs: (N, d) expert-contiguous rows -> (N, d): expert e's weights
    applied to exactly its bucket, no capacity padding. ``grouped`` as in
    ``grouped_matmul`` (False: the per-expert loop, the card's
    reference). Stacks of fewer than all experts hold experts ``first``
    on (a ``model`` rank's under the sharded step): their buckets are
    run and the other rows are zeros."""
    El = p["w_gate"].shape[0]
    lo, hi = 0, xs.shape[0]
    if El < counts.shape[0]:
        ends = offsets + counts
        lo, hi = torch.stack([offsets[first],
                              ends[first + El - 1]]).tolist()
        counts = counts[first:first + El]
        offsets = offsets[first:first + El] - lo
    gm = functools.partial(grouped_matmul, counts=counts,
                           ends=offsets + counts, grouped=grouped)
    x = xs[lo:hi]
    ys = gm(torch.nn.functional.silu(gm(x, p["w_gate"])) * gm(x, p["w_up"]),
            p["w_down"])
    if (lo, hi) == (0, xs.shape[0]):
        return ys
    return torch.nn.functional.pad(ys, (0, 0, lo, xs.shape[0] - hi))


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
    as in its shard_map body (``moe_ffn_ep``). Under the sharded step's
    hooks the stacks are this ``model`` rank's experts (the reference's
    ``_expert_ffn(constrain=True)``): the rank routes every token of its
    data row and runs its experts' rows; the other rows are zeros and the
    partial outputs are summed over ``model``."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    B, S, d = x.shape
    T = B * S
    k = cfg.top_k
    cf = capacity_factor or cfg.moe_capacity_factor
    capacity = max(int(T * k * cf / cfg.n_experts), 4)

    xf = x.reshape(T, d)
    # the sharded step: every ``model`` rank routes its data row's tokens
    # (the router gathered over the data axes) and runs the experts it
    # holds (the stacks stay on ``model``, their data dims gathered); the
    # tokens and gates its experts take enter through *f* and the partial
    # outputs are summed over ``model`` (*g*)
    p = {**p, "router": SH.gather_weight(p["router"], 0),
         **{w: SH.gather_weight(p[w], 2 if w == "w_down" else 1)
            for w in ("w_gate", "w_up", "w_down")}}
    first = SH.tp_rank() * p["w_gate"].shape[0]
    ids, gates, occ, imp = _route(p, cfg, xf)
    grid = SH.grid_of(mesh)
    for ax in dp_axes if grid is not None else ():
        occ = grid.mean(occ, ax)
        imp = grid.mean(imp, ax)
    aux = _aux_loss(cfg, occ, imp)
    perm, slot, keep, _, counts, offsets = _dispatch_indices(
        cfg, ids, T, capacity)
    perm = perm.long()
    token_of = perm // k
    gate_of = SH.enter_tp(gates).reshape(-1)[perm]
    xe = SH.enter_tp(xf)

    if dispatch == "bucketed":
        ys = _expert_ffn_bucketed(p, xe[token_of], counts, offsets,
                                  first=first)
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
        buf = _scatter_to_slots(xe[token_of], slot, keep, E * capacity)
        El = p["w_gate"].shape[0]
        ye = _expert_ffn(p, buf.reshape(E, capacity, d)[first:first + El])
        if El < E:   # the other ranks' experts: zeros here
            ye = torch.nn.functional.pad(ye, (0, 0, 0, 0, first,
                                              E - first - El))
        ye = ye.reshape(E * capacity, d)
        contrib = torch.where(keep[:, None], ye[slot.long()]
                              * gate_of[:, None], 0)
        out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
        out.index_add_(0, token_of, contrib)

    out = SH.finish_tp(out.to(x.dtype))
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], xf)
    return out.reshape(B, S, d), aux


def moe_ffn_ep(p, cfg, x, *, mesh, dp_axes=("data",), ep_axis="model",
               capacity_factor=None):
    """Expert-parallel MoE FFN over the ``ep_axis`` ranks of ``mesh`` (a
    ``launch.mesh.HostMesh``, a ``DeviceMesh`` or a
    ``models.sharding.Grid``; one process a rank). ``p``: this rank's
    blocks as ``models.sharding.param_spec_tree`` cuts them (its E_l =
    n_experts / ep experts of the stacks, their d dims over the data
    axes; on a mesh of one process, the whole tree). x: (B, S, d), this
    data rank's batch, the same on every rank of ``ep_axis`` -> (y (B,
    S, d), aux), both the same on those ranks.

    As the reference's shard_map body: rank r takes sequence slice r
    (S must divide by the axis size) and owns experts [r * E_l, (r + 1) *
    E_l); its tokens are routed and scattered into capacity-padded (E, C,
    d) buffers, exchanged so each rank receives its experts' tokens from
    every peer, run through the batched expert FFN and exchanged back
    (two all_to_alls), then combined. ``occ`` and ``imp`` are averaged
    over ``ep_axis`` and ``dp_axes`` before their product, so ``aux`` is
    the global balance loss. The slices of y are gathered over
    ``ep_axis`` at the end (the reference's GSPMD gathers its
    sequence-sharded output where it is used). Shared experts, when the
    config has them, are gathered whole and run on the rank's tokens.

    The stacks' data dims are gathered at the boundary (the reference's
    shard_map in_specs), and the collectives follow Megatron's gradient
    convention (``models/sharding.py``): every rank backpropagates the
    same global loss (each data rank's part through
    ``sharding.dp_mean``), x and the router enter through *f*, the means
    are *g* and the output's gather keeps this rank's slice backward, so
    each rank's gradient of its blocks is their whole gradient. No hook
    fires inside the body (``mesh_context(None)``, as the reference's).
    """
    grid = SH.grid_of(mesh)
    ep = grid.shape[ep_axis]
    if cfg.n_experts % ep or x.shape[1] % ep:
        raise ValueError(f"n_experts {cfg.n_experts} and sequence "
                         f"{x.shape[1]} must divide by the {ep_axis!r} "
                         f"axis size {ep}")
    with SH.mesh_context(grid):
        x = SH.enter_tp(x)
        at_use = {"router": SH.enter_tp(SH.gather_weight(p["router"], 0)),
                  **{w: SH.gather_weight(p[w], 2 if w == "w_down" else 1)
                     for w in ("w_gate", "w_up", "w_down")}}
        if cfg.n_shared_experts:
            sp = p["shared"]
            at_use["shared"] = {
                "w_gate": SH.gather_tp(SH.col_parallel(sp["w_gate"]), -1),
                "w_up": SH.gather_tp(SH.col_parallel(sp["w_up"]), -1),
                "w_down": SH.gather_tp(SH.row_parallel(sp["w_down"]), 0)}
    with SH.mesh_context(None):
        return _ep_body(at_use, cfg, x, grid, dp_axes, ep_axis,
                        capacity_factor)


def _ep_body(p, cfg, x, mesh, dp_axes, ep_axis, capacity_factor):
    ep = mesh.shape[ep_axis]
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
    ye = _expert_ffn(p, buf.transpose(0, 1).reshape(
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
