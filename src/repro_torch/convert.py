"""Carry arrays between the reference and the port.

``to_torch`` / ``to_numpy`` round-trip the reference's numpy arrays
with their dtypes, ``params_from_jax`` turns the reference model's
parameter tree into the port's (and any tree of its structure: the
reference's gradients, its AdamW moments), and ``adamw_from_jax`` the
reference's ``AdamWState``, and ``shard_tree`` places either in the
sharded train step's placements, so that a test starts both packages'
sharded steps from the same numbers. bfloat16
arrives from JAX as an ``ml_dtypes`` array, which ``torch.from_numpy``
refuses, so it travels through a ``uint16`` view; ``int32`` stays
``int32``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M


def _is_bfloat16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def to_torch(a, device="cpu") -> torch.Tensor:
    """A numpy (or array-like) value as a tensor of the same dtype on
    ``device``."""
    a = np.array(a, order="C")  # a C-contiguous copy; 0-d stays 0-d
    if _is_bfloat16(a.dtype):
        t = torch.from_numpy(a.view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array of the same dtype (bfloat16 as an
    ``ml_dtypes.bfloat16`` array, as JAX returns it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(params_np, cfg, device="cuda"):
    """The reference's ``init_params`` pytree (numpy leaves, bf16 as
    ``ml_dtypes.bfloat16``) as the port's parameters on ``device``, every
    leaf in its dtype: the same dict, with the stacked (L, ...) leaves of
    ``layers`` split into one dict per layer (a moe layer's stacked expert
    weights, router and shared experts included; deepseek-moe's dense
    ``layer0`` is not stacked and stays one dict). A hybrid model's
    (G, gs, ...) ``layers`` become G lists of gs dicts, its ``tail`` a
    list of dicts (None when empty) and ``shared`` one dict. An encdec
    model's ``enc_layers`` and ``layers`` become lists of dicts; a vlm
    model's (G, gs, ...) ``layers`` G lists of gs dicts and its (G, ...)
    ``cross`` a list of G dicts. Every family, as the port's model. A
    tree of the same structure (the reference's gradients or AdamW
    moments) converts leaf for leaf the same way."""
    fam = cfg.family

    def tree(node, pick=None):
        if isinstance(node, dict):
            return {k: tree(v, pick) for k, v in node.items()}
        a = np.asarray(node)
        return to_torch(a if pick is None else a[pick], device)

    stacked = ("layers", "tail", "enc_layers", "cross")
    out = {k: tree(v) for k, v in params_np.items() if k not in stacked}
    layers = params_np["layers"]
    if fam in ("hybrid", "vlm"):
        if fam == "hybrid":
            G, gs, n_tail = M._hybrid_shape(cfg)
            tail = params_np["tail"]
            out["tail"] = None if tail is None else [
                tree(tail, i) for i in range(n_tail)]
        else:
            G, gs = M._vlm_shape(cfg)
            out["cross"] = [tree(params_np["cross"], g) for g in range(G)]
        out["layers"] = [[tree(layers, (g, j)) for j in range(gs)]
                         for g in range(G)]
        return out
    if fam == "encdec":
        out["enc_layers"] = [tree(params_np["enc_layers"], i)
                             for i in range(cfg.n_enc_layers)]
    n = cfg.n_layers - int(fam == "moe" and cfg.first_layer_dense)
    out["layers"] = [tree(layers, i) for i in range(n)]
    return out


def adamw_from_jax(state, cfg, device="cuda"):
    """The reference's ``AdamWState`` (step, m, v: moments with the
    parameters' structure, float32) as the port's ``optim.AdamWState``
    on ``device``."""
    from repro_torch.optim import AdamWState

    return AdamWState(step=to_torch(np.asarray(state.step), device),
                      m=params_from_jax(state.m, cfg, device),
                      v=params_from_jax(state.v, cfg, device))


def shard_tree(tree_, cfg, mesh):
    """A whole parameter tree (from ``params_from_jax``) or AdamW state
    (from ``adamw_from_jax``) as this rank's blocks in the placements
    ``launch.train.shardings_for`` gives on ``mesh`` (DTensors; the step
    counter stays a plain replicated tensor)."""
    from repro_torch.launch.train import shardings_for
    from repro_torch.models import sharding as SH
    from repro_torch.optim import AdamWState

    pshard = shardings_for(cfg, mesh)[0]
    if isinstance(tree_, AdamWState):
        return AdamWState(step=tree_.step,
                          m=SH.place(tree_.m, mesh, pshard),
                          v=SH.place(tree_.v, mesh, pshard))
    return SH.place(tree_, mesh, pshard)
