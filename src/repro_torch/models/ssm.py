"""Mamba2 — the SSD (state-space duality) block, chunked (counterpart of
``repro/models/ssm.py``).

The inter-chunk recurrence

    state_c = decay_c * state_{c-1} + chunk_contribution_c

is a scan with a carry over (H, P, N) state tensors. The reference runs
it as a ``lax.scan`` over chunks; here it is a Python loop over chunks
carrying the float32 state, and everything inside a chunk is dense
``torch.einsum``/``matmul`` work, as the reference leaves it to its
compiler (no Pallas kernel runs here, so none is ported).

Shapes follow the Mamba2 paper: x (B,S,H,P), A (H,), B/C (B,S,N) with
one group broadcast over the heads, dt (B,S,H); the chunk length is
``cfg.ssm_chunk``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding as SH


def ssm_init(gen, cfg, device):
    """The reference's distributions (drawn from ``gen``, not its bits):
    ``A_log = log U(1, 16)``, ``D = 1``, ``dt_bias`` the inverse softplus
    of U(1e-3, 0.1), all float32; ``conv_w`` N(0, 1)/sqrt(K) cast to
    ``cfg.dtype``; the projections as ``layers.dense_init``."""
    d, di = cfg.d_model, cfg.d_inner
    H, N, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
    conv_dim = di + 2 * N  # the x part, B and C go through the conv

    def f32(shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    # in_proj packs [z (di), xBC (conv_dim), dt (H)]
    in_proj = L.dense_init(gen, d, di + conv_dim + H, cfg.dtype, device)
    conv_w = (f32((K, conv_dim)).normal_(generator=gen)
              * (1.0 / math.sqrt(K))).to(cfg.dtype)
    a = f32((H,)).uniform_(1.0, 16.0, generator=gen)
    dt0 = f32((H,)).uniform_(1e-3, 0.1, generator=gen)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.dtype, device=device),
        "A_log": torch.log(a),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.exp(dt0) - 1.0),
        "norm": L.rmsnorm_init(di, device),
        "out_proj": L.dense_init(gen, di, d, cfg.dtype, device),
    }


def _segsum(x):
    """Segment sums: out[..., i, j] = sum_{k=j+1..i} x[..., k] below the
    diagonal, -inf above it; x: (..., T). A cumsum then a difference, as
    the reference writes it, so the float32 sums associate alike."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(T, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, torch.full((), -math.inf,
                                              device=x.device))


def ssd_chunked(x, dt, A, Bm, Cm, chunk):
    """The chunked SSD scan from a zero state.

    x: (B,S,H,P) dt: (B,S,H) A: (H,) Bm/Cm: (B,S,N), S a multiple of
    ``chunk``. Returns y (B,S,H,P) and the final state (B,H,P,N), both
    float32. One step a chunk: its quadratic intra-chunk products, the
    carried state read through C, and the state carried on.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)

    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xk, dtk, Bk, Ck = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dtk * A[None, None, :]                        # (B,l,H) < 0
        dA_cum = torch.cumsum(dA, dim=1)
        # intra-chunk
        Ltri = torch.exp(_segsum(dA.transpose(1, 2)))      # (B,H,l,l)
        scores = torch.einsum("bln,bsn->bls", Ck, Bk)      # (B,l,l)
        gated = scores[:, None] * Ltri                     # (B,H,l,l)
        xdt = xk * dtk[..., None]                          # (B,l,H,P)
        y_diag = torch.einsum("bhls,bshp->blhp", gated, xdt)
        # the carried state read through C, decayed in
        decay_in = torch.exp(dA_cum)                       # (B,l,H)
        y_off = torch.einsum("bln,blh,bhpn->blhp", Ck, decay_in, h)
        # the state: decay-to-end weighted outer products + carried state
        decay_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)  # (B,l,H)
        st = torch.einsum("bln,blh,blhp->bhpn", Bk, dtk * decay_end, xk)
        h = torch.exp(dA_cum[:, -1, :])[..., None, None] * h + st
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, h


def ssm_apply(p, cfg, x, *, state=None, conv_state=None):
    """The Mamba2 block on x (B,S,d) -> (y, new_state, new_conv_state).

    Without a state, or with S > 1 (a prefill from position 0, where the
    given state is zeros): the chunked scan from zero. With a state
    (B,H,P,N) and S == 1: one step of the recurrence. ``conv_state``
    (B,K-1,conv_dim) is the causal conv's history (zeros when None).

    Under the sharded step's hooks each ``model`` rank runs its
    ``ssm_heads / tp`` heads (the reference's column-parallel in_proj and
    row-parallel out_proj): the states it takes and returns are its
    heads', and its conv channels are its heads' x and the whole B and C.
    """
    Bsz, S, _ = x.shape
    di, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    K = cfg.ssm_conv
    f32 = torch.float32
    tp = SH.tp_size()
    if H % tp:
        raise ValueError(f"{H} ssm heads do not divide over {tp} model "
                         f"ranks")
    Hl = H // tp           # this rank's heads (all of them without TP)
    dl = Hl * P

    # column-parallel in_proj; the packed [z, xBC, dt] columns do not
    # fall on head boundaries, so the row is gathered over ``model`` and
    # each rank keeps its heads' z, x and dt and the shared B and C
    zxbcdt = SH.gather_tp(SH.enter_tp(x) @ SH.col_parallel(p["in_proj"]), -1)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    conv_w = SH.gather_tp(p["conv_w"], 1)
    conv_b = SH.gather_tp(p["conv_b"], 0)
    A_log, D, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    scale = p["norm"]["scale"]
    if tp > 1:
        lo = SH.tp_rank() * Hl
        ch = slice(lo * P, lo * P + dl)
        z, dt = z[..., ch], dt[..., lo:lo + Hl]
        xBC = torch.cat([xBC[..., ch], xBC[..., di:]], dim=-1)
        conv_w = torch.cat([conv_w[:, ch], conv_w[:, di:]], dim=1)
        conv_b = torch.cat([conv_b[ch], conv_b[di:]])
        # per-head leaves are whole on every rank: f sums their gradient
        A_log, D, dt_bias = (SH.enter_tp(t)[lo:lo + Hl]
                             for t in (A_log, D, dt_bias))
        scale = SH.enter_tp(scale)[ch]
    conv_dim = dl + 2 * N
    dt = F.softplus(dt.to(f32) + dt_bias)                     # (B,S,Hl)

    # depthwise causal conv over the sequence (zero history: a prefill);
    # a prompt shorter than K-1 keeps part of that history in the new one
    if conv_state is None:
        conv_state = torch.zeros((Bsz, K - 1, conv_dim), dtype=xBC.dtype,
                                 device=x.device)
    padded = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    new_conv_state = padded[:, -(K - 1):, :]
    windows = torch.stack([padded[:, i:i + S, :] for i in range(K)],
                          dim=2)                              # (B,S,K,C)
    xBC = F.silu(
        torch.einsum("bskc,kc->bsc", windows.to(f32), conv_w.to(f32))
        + conv_b.to(f32)
    ).to(x.dtype)

    xin, Bm, Cm = torch.split(xBC, [dl, N, N], dim=-1)
    xin = xin.reshape(Bsz, S, Hl, P)
    A = -torch.exp(A_log)                                     # (Hl,) < 0

    if state is None or S > 1:
        # pad AFTER the softplus: a pad step's dt is exactly 0, so it
        # neither decays nor feeds the state
        pad = (-S) % cfg.ssm_chunk
        if pad:
            xin_p = F.pad(xin, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            Bm_p = F.pad(Bm, (0, 0, 0, pad))
            Cm_p = F.pad(Cm, (0, 0, 0, pad))
        else:
            xin_p, dt_p, Bm_p, Cm_p = xin, dt, Bm, Cm
        y, new_state = ssd_chunked(xin_p, dt_p, A, Bm_p, Cm_p,
                                   cfg.ssm_chunk)
        y = y[:, :S]
    else:
        # one step: h' = exp(dt A) h + dt B x ; y = C h'
        dt1 = dt[:, 0]                                        # (B,H)
        dec = torch.exp(dt1 * A[None, :])
        outer = torch.einsum("bhp,bn->bhpn",
                             xin[:, 0].to(f32) * dt1[..., None],
                             Bm[:, 0].to(f32))
        new_state = dec[..., None, None] * state + outer
        y = torch.einsum("bhpn,bn->bhp", new_state,
                         Cm[:, 0].to(f32))[:, None]           # (B,1,H,P)

    y = y + xin.to(f32) * D[None, None, :, None]
    y = y.reshape(Bsz, S, dl).to(x.dtype)
    y = y * F.silu(z)  # gated
    if tp > 1:
        # the gated norm over all of d_inner: the heads' sums of squares
        # summed over ``model``
        yf = y.to(f32)
        ss = SH.tp_sum(torch.sum(yf * yf, dim=-1, keepdim=True))
        y = (yf * torch.rsqrt(ss / di + cfg.norm_eps) * scale).to(x.dtype)
    else:
        y = L.rmsnorm(p["norm"], y, cfg.norm_eps)
    return (SH.finish_tp(y @ SH.row_parallel(p["out_proj"])), new_state,
            new_conv_state)
