"""Flash attention, forward only (counterpart of
``repro/kernels/attention_kernel.py``).

``flash_attention`` takes head-flattened (BH, S, hd) operands and
``flash_attention_gqa`` grouped-query (B, S, H, hd) / (B, S, KV, hd) ones,
with the reference's signatures, padding semantics (keys past Sk masked,
the causal mask aligned top-left) and output dtype (q's). No model calls
them, in the reference or here: the models use
``models.layers.blockwise_attention``. They are plain functions, not
registry records, as in the reference.

Replaces the TPU kernel ``flash_attention`` (``_flash_body``) with three
CUDA kernels (``csrc/attention.cu``, whose note gives each design), one
per path. ``attention_path`` picks the path from the shape alone:

  * ``"decode"`` when the G = H / KV query heads times Sq queries that
    share a KV head fit ``DECODE_ROWS`` rows (and, where the tensor
    cores would take the call, Sq <= ``DECODE_MAX_SQ_TC``: both bounds
    from device times on the card, ``benchmarks_torch/attention_paths.py``;
    ``attention_path`` says where the rule departs from them): a split-K
    kernel, one CTA per (b, KV head, key split), partials merged by
    log-sum-exp in the last CTA of each (b, KV head) (``decode_split``
    sizes the splits);
  * ``"wgmma"`` for bfloat16 with hd a multiple of 16: the tensor-core
    prefill kernel (TMA ring, ``wgmma``, P fed as bf16 hi + lo);
  * ``"simt"`` otherwise (float32, other head dims, and every head dim
    above ``HEAD_DIM_MAX``): the CUDA-core kernel, every product an IEEE
    float32 fma; above 256 it walks the output columns in slices of 256
    along its grid's z axis.

Every head dim from 1 up runs, as in the reference; below 1 the wrapper
raises. A call is one launch, counted under its path's
kernel name (``PATH_KERNELS``). The bound is operations at prefill shapes
(bf16 at the tensor-core rate, float32 at the CUDA-core rate) and bytes at
decode shapes (``chip_smoke.py`` computes both).

On CPU tensors both functions run the plain version
(``ref.flash_attention_ref`` and its grouped form below); on CUDA tensors
they launch the path's kernel or raise. ``flash_decode_split_ref`` is the
decode kernel's split-and-merge arithmetic in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels.ref import flash_attention_ref, full_f32_matmul

#: largest head dim the decode and tensor-core kernels take (the
#: CUDA-core kernel takes any)
HEAD_DIM_MAX = 256
#: rows (G * Sq) one decode CTA holds: ``attention_path`` takes the
#: decode kernel up to there
DECODE_ROWS = 16
#: Sq up to which the decode kernel takes calls the tensor cores could
#: run (the tensor-core kernel's time grows in waves of B * H CTAs and
#: not with Sq up to a CTA's rows, the decode kernel's with G * Sq)
DECODE_MAX_SQ_TC = 1
#: keys a decode tile holds
DECODE_TILE = 64
#: most key splits of one (b, KV head)
DECODE_MAX_SPLIT = 256
#: launch counter name of each path's kernel
PATH_KERNELS = {"simt": "flash_simt", "decode": "flash_decode",
                "wgmma": "flash_wgmma"}
_PATH_CODES = {"simt": 0, "decode": 1, "wgmma": 2}

_LL = ctypes.c_longlong
_P = ctypes.c_void_p
_SIGNATURES = {
    "ak_flash_attention": [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
        _LL, _LL, _LL, _LL, _LL, _LL,
        _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P, _P, _P, ctypes.c_int, _P,
    ],
}

# (device index, stream) -> int32 tickets of the decode kernel's merge, one
# per (b, KV head). The last CTA of each sets its ticket back to 0, and
# calls on one stream run in order, so a buffer serves every call.
_TICKETS: dict = {}


def attention_path(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
                   dtype: torch.dtype, causal: bool) -> str:
    """The kernel a call of this shape takes on the card: ``"decode"``,
    ``"wgmma"`` or ``"simt"`` (a pure function of the shape; see the
    module note): ``"simt"`` for every head dim above ``HEAD_DIM_MAX``.
    Raises for a head dim below 1.

    At Sq = 1 the rule keeps decode even where the tensor-core kernel
    was measured 2-9% faster (B 8, KV 8, G 2: its B * H = 128 CTAs fill
    the 132 SMs in one wave); at G = 1 (half the SMs) and G = 4, 8 (2-4
    waves) decode won by 6-40% (``benchmarks_torch/attention_paths.py``,
    NVIDIA H100 80GB HBM3, 700.00 W). That margin turns on B * H against
    the SM count, which this rule does not read."""
    if hd < 1:
        raise ValueError(f"the flash kernels take head dims from 1, got "
                         f"{hd}")
    if hd > HEAD_DIM_MAX:
        return "simt"
    tc = dtype == torch.bfloat16 and hd % 16 == 0
    if (H // KV) * Sq <= DECODE_ROWS and (not tc or Sq <= DECODE_MAX_SQ_TC):
        return "decode"
    return "wgmma" if tc else "simt"


def decode_split(Sq: int, Sk: int, causal: bool) -> tuple[int, int, int]:
    """(nsplit, tps, ntiles) of the decode kernel: the ntiles 64-key tiles
    that any query sees (min(Sk, Sq) keys under the top-left causal mask)
    cut into nsplit splits of tps tiles each: one tile a CTA, up to
    ``DECODE_MAX_SPLIT`` splits (a CTA's tile loop does not overlap its
    loads with its arithmetic: many CTAs in flight hide the latency)."""
    kend = min(Sk, Sq) if causal else Sk
    ntiles = -(-kend // DECODE_TILE)
    tps = max(1, -(-ntiles // DECODE_MAX_SPLIT))
    return max(1, -(-ntiles // tps)), tps, ntiles


def flash_decode_split_ref(q, k, v, *, causal: bool = True,
                           nsplit: int | None = None):
    """The decode kernel's arithmetic in plain PyTorch, float32: q (B, Sq,
    H, hd), k and v (B, Sk, KV, hd). The keys any query sees are cut into
    ``nsplit`` splits of whole 64-key tiles (default: ``decode_split``);
    each split keeps its own (m, l, acc) with the kernel's m_safe rule,
    and the splits are merged by log-sum-exp, a split whose m is -inf (no
    key of it visible to the row) weighing 0. Returns q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dflt, tps, ntiles = decode_split(Sq, Sk, causal)
    if nsplit is None:
        nsplit = dflt
    else:
        tps = max(1, -(-ntiles // nsplit))
    scale = 1.0 / math.sqrt(hd)
    qg = (q.to(torch.float32) * scale).reshape(B, Sq, KV, G, hd)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    qi = torch.arange(Sq, device=q.device)
    ms, ls, accs = [], [], []
    with full_f32_matmul():
        for sp in range(nsplit):
            lo = sp * tps * DECODE_TILE
            hi = max(lo, min((sp + 1) * tps * DECODE_TILE,
                             ntiles * DECODE_TILE, Sk))
            kj = torch.arange(lo, hi, device=q.device)
            s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf[:, lo:hi])
            ok = (kj[None, :] < Sk).expand(Sq, -1)
            if causal:
                ok = ok & (kj[None, :] <= qi[:, None])
            s = torch.where(ok, s, -math.inf)
            m = s.amax(dim=-1, keepdim=True) if s.shape[-1] else \
                torch.full(s.shape[:-1] + (1,), -math.inf,
                           device=q.device)
            m_safe = torch.where(torch.isfinite(m), m, 0.0)
            p = torch.where(ok, torch.exp(s - m_safe), 0.0)
            ms.append(m)
            ls.append(p.sum(dim=-1, keepdim=True))
            accs.append(torch.einsum("bkgqs,bskd->bkgqd", p, vf[:, lo:hi]))
        m_all = torch.stack(ms)
        mx = m_all.amax(dim=0)
        mx_safe = torch.where(torch.isfinite(mx), mx, 0.0)
        w = torch.where(torch.isfinite(m_all), torch.exp(m_all - mx_safe),
                        0.0)
        tot = (w * torch.stack(ls)).sum(dim=0)
        acc = (w * torch.stack(accs)).sum(dim=0)
        out = acc / torch.clamp(tot, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_gqa_ref(q, k, v, *, causal: bool = True):
    """Plain grouped-query attention in float32: q (B, Sq, H, hd), k and v
    (B, Sk, KV, hd); query head h reads KV head h // (H // KV) (the
    grouped einsum indexes it, nothing is repeated). Same masks and
    output dtype as ``flash_attention_ref``."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = q.to(torch.float32).reshape(B, Sq, KV, H // KV, hd)
    with full_f32_matmul():
        s = torch.einsum("bqkgd,bskd->bkgqs", qg,
                         k.to(torch.float32)) * scale
        if causal:
            mask = (torch.arange(Sk, device=s.device)[None, :]
                    <= torch.arange(Sq, device=s.device)[:, None])
            s = torch.where(mask, s, -math.inf)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _check(q, k, v, H, KV, hd):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k "
                        f"and v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when TMA can address it (16-byte aligned base, row and
    head strides multiples of 16 bytes), else an aligned contiguous copy."""
    ok = t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, _build.stream_handle(device))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def _resolve(path, B, Sq, Sk, H, KV, hd, dtype, causal) -> str:
    """``path`` if the caller forced one the shape allows, else the rule's
    (``attention_path`` also refuses head dims below 1)."""
    want = attention_path(B, Sq, Sk, H, KV, hd, dtype, causal)
    if path is None or path == want:
        return want
    if path in ("wgmma", "decode") and hd > HEAD_DIM_MAX:
        raise ValueError(f"the {path} kernel takes head dims 1 to "
                         f"{HEAD_DIM_MAX}, got {hd}")
    if path == "wgmma" and not (dtype == torch.bfloat16 and hd % 16 == 0):
        raise ValueError(f"the tensor-core kernel takes bfloat16 with hd a "
                         f"multiple of 16, got {dtype} hd {hd}")
    if path == "decode" and (H // KV) * Sq > DECODE_ROWS:
        raise ValueError(f"the decode kernel holds {DECODE_ROWS} rows a "
                         f"CTA, got G * Sq = {(H // KV) * Sq}")
    if path not in _PATH_CODES:
        raise ValueError(f"unknown flash attention path {path!r}")
    return path


def _launch(q, k, v, out, B, H, KV, Sq, Sk, hd, dims, causal, path,
            split_p=True):
    """One launch of ``path``'s kernel; ``dims`` gives each of q, k, v and
    out as (b, head, row) dimension indices, whose strides address it.
    ``split_p=False`` drops the tensor-core kernel's P_lo product (P as one
    bf16, outside the tolerance: ``benchmarks_torch/attention_paths.py``
    measures it as a note; no entry point exposes it)."""
    if path == "wgmma":
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    for t in (q, k, v, out):
        if t.stride(-1) != 1:
            raise ValueError("flash attention needs the head dim contiguous")
    strides = []
    for t, dd in zip((q, k, v, out), dims):
        strides += [t.stride(i) if i is not None else 0 for i in dd]
    nsplit = tps = 0
    acc_p = ml_p = tickets = None
    if path == "decode":
        nsplit, tps, _ = decode_split(Sq, Sk, causal)
        rows = B * KV * nsplit * (H // KV) * Sq
        scratch = torch.empty(rows * (hd + 2), dtype=torch.float32,
                              device=q.device)
        acc_p = scratch.data_ptr()
        ml_p = acc_p + rows * hd * 4
        tickets = _tickets(q.device, B * KV).data_ptr()
    lib = _build.library("attention", _SIGNATURES)
    err = lib.ak_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.dtype_code(q.dtype, "flash attention"), _PATH_CODES[path],
        B, H, KV, Sq, Sk, hd, *strides, 1.0 / math.sqrt(hd),
        int(bool(causal)), nsplit, tps, acc_p, ml_p, tickets, int(split_p),
        _build.stream_handle(q.device))
    _build.check(lib, err, f"flash attention kernel ({path})")
    C.count_launch(PATH_KERNELS[path])
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    path: str | None = None):
    """q (BH, Sq, hd); k, v (BH, Sk, hd) -> (BH, Sq, hd) in q's dtype.
    ``path`` forces one kernel on the card (default ``attention_path``)."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    _check(q, k, v, 1, 1, hd)
    path = _resolve(path, BH, Sq, Sk, 1, 1, hd, q.dtype, causal)
    if not C.require_cuda_or_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    return _launch(q, k, v, out, BH, 1, 1, Sq, Sk, hd, [(0, None, 1)] * 4,
                   causal, path)


def flash_attention_gqa(q, k, v, *, causal: bool = True,
                        path: str | None = None):
    """Grouped-query attention: q (B, Sq, H, hd), k/v (B, Sk, KV, hd) ->
    (B, Sq, H, hd) in q's dtype. Query head h reads KV head
    h // (H // KV) (the reference's docstring says so; its code repeats
    the heads, with the same values). ``path`` forces one kernel on the
    card (default ``attention_path``)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check(q, k, v, H, KV, hd)
    path = _resolve(path, B, Sq, Sk, H, KV, hd, q.dtype, causal)
    if not C.require_cuda_or_cpu(q, k, v):
        return flash_attention_gqa_ref(q, k, v, causal=causal)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, B, H, KV, Sq, Sk, hd, [(0, 2, 1)] * 4,
                   causal, path)
