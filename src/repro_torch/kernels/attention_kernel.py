"""Flash attention, forward only (counterpart of
``repro/kernels/attention_kernel.py``).

``flash_attention`` takes head-flattened (BH, S, hd) operands and
``flash_attention_gqa`` grouped-query (B, S, H, hd) / (B, S, KV, hd) ones,
with the reference's signatures, padding semantics (keys past Sk masked,
the causal mask aligned top-left) and output dtype (q's). No model calls
them, in the reference or here: the models use
``models.layers.blockwise_attention``. They are plain functions, not
registry records, as in the reference.

Replaces the TPU kernel ``flash_attention`` (``_flash_body``): the CUDA
kernel (``csrc/attention.cu``) gives one CTA to 64 query rows of one head
and streams 64-row K/V tiles through shared memory with the running max,
sum and float32 accumulator in registers, every product an IEEE float32
fma. It masks padding by index, so a call is one launch and makes no
padded copy of q, k or v; GQA reads KV head ``h // (H // KV)`` through its
strides instead of repeating it. The bound is operations at prefill shapes
and bytes at decode shapes (``chip_smoke.py`` computes both).

On CPU tensors both functions run the plain version
(``ref.flash_attention_ref`` and its grouped form below); on CUDA tensors
they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels.ref import flash_attention_ref, full_f32_matmul

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)

_LL = ctypes.c_longlong
_SIGNATURES = {
    "ak_flash_attention": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, _LL, _LL, _LL, _LL, _LL, _LL,
        _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ],
}


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


def _launch(q, k, v, out, B, H, KV, Sq, Sk, hd, strides, causal):
    """One launch of the kernel; ``strides`` holds the (b, head, row)
    element strides of q, k, v and out."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    for t in (q, k, v, out):
        if t.stride(-1) != 1:
            raise ValueError("flash attention needs the head dim contiguous")
    lib = _build.library("attention", _SIGNATURES)
    err = lib.ak_flash_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        _build.dtype_code(q.dtype, "flash attention"), B, H, KV, Sq, Sk, hd,
        *strides, 1.0 / math.sqrt(hd), int(bool(causal)),
        _build.stream_handle(q.device))
    _build.check(lib, err, "flash attention kernel")
    C.count_launch("flash_attention")
    return out


def flash_attention(q, k, v, *, causal: bool = True):
    """q (BH, Sq, hd); k, v (BH, Sk, hd) -> (BH, Sq, hd) in q's dtype."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    _check(q, k, v, 1, 1, hd)
    if not C.require_cuda_or_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (q.stride(0), 0, q.stride(1), k.stride(0), 0, k.stride(1),
               v.stride(0), 0, v.stride(1), out.stride(0), 0, out.stride(1))
    return _launch(q, k, v, out, BH, 1, 1, Sq, Sk, hd, strides, causal)


def flash_attention_gqa(q, k, v, *, causal: bool = True):
    """Grouped-query attention: q (B, Sq, H, hd), k/v (B, Sk, KV, hd) ->
    (B, Sq, H, hd) in q's dtype. Query head h reads KV head
    h // (H // KV) (the reference's docstring says so; its code repeats
    the heads, with the same values)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check(q, k, v, H, KV, hd)
    if not C.require_cuda_or_cpu(q, k, v):
        return flash_attention_gqa_ref(q, k, v, causal=causal)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (q.stride(0), q.stride(2), q.stride(1),
               k.stride(0), k.stride(2), k.stride(1),
               v.stride(0), v.stride(2), v.stride(1),
               out.stride(0), out.stride(2), out.stride(1))
    return _launch(q, k, v, out, B, H, KV, Sq, Sk, hd, strides, causal)
