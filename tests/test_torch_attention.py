"""The port's flash attention against the JAX package's, on the CPU (the
plain versions; the CUDA kernel is held to them on the card in
tests/test_torch_card.py): ``flash_attention`` over
tests/test_attention_kernel.py's grid (the reference's Pallas kernel in
interpret mode, causal and not, ragged Sk, Sq = 1), ``flash_attention_gqa``
against the reference's GQA wrapper and the port's ``blockwise_attention``,
all at the reference's tolerance (rtol 2e-4, atol 2e-5). Inputs come from a
numpy seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_kernel as RA
from repro.kernels import ref as RREF
from repro_torch.kernels import attention_kernel as A
from repro_torch.kernels import ref as KREF
from repro_torch.models import layers as L

TOL = dict(rtol=2e-4, atol=2e-5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sq,sk", [(128, 512), (128, 1024), (256, 512),
                                   (100, 300), (1, 512)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference_kernel(sq, sk, causal):
    rng = np.random.default_rng(sq * 7 + sk)
    BH, hd = 4, 64
    q, k, v = (_normal(rng, (BH, s, hd)) for s in (sq, sk, sk))
    got = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal)
    want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    assert got.dtype == torch.float32 and got.shape == (BH, sq, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        KREF.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal).numpy(),
        np.asarray(RREF.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=causal)),
        **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa_matches_reference_and_blockwise(causal):
    rng = np.random.default_rng(1)
    B, Sq, Sk, H, KV, hd = 2, 128, 512, 8, 2, 64
    q = _normal(rng, (B, Sq, H, hd))
    k, v = _normal(rng, (B, Sk, KV, hd)), _normal(rng, (B, Sk, KV, hd))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = A.flash_attention_gqa(tq, tk, tv, causal=causal)
    want = RA.flash_attention_gqa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(),
        L.blockwise_attention(tq, tk, tv, causal=causal, chunk=256).numpy(),
        **TOL)


def test_flash_bf16_keeps_the_dtype_and_the_decode_shape():
    """bfloat16 in, bfloat16 out; a decode-shaped call (Sq = 1, ragged
    Sk, not causal) equals the reference's to one bf16 ulp."""
    rng = np.random.default_rng(2)
    B, Sk, H, KV, hd = 2, 37, 4, 2, 16
    q = torch.from_numpy(_normal(rng, (B, 1, H, hd))).to(torch.bfloat16)
    k = torch.from_numpy(_normal(rng, (B, Sk, KV, hd))).to(torch.bfloat16)
    v = torch.from_numpy(_normal(rng, (B, Sk, KV, hd))).to(torch.bfloat16)
    got = A.flash_attention_gqa(q, k, v, causal=False)
    want = RA.flash_attention_gqa(*(jnp.asarray(t.float().numpy())
                                    .astype(jnp.bfloat16) for t in (q, k, v)),
                                  causal=False)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -8 + 2e-4, atol=2e-5)


def test_flash_refuses_mixed_dtypes_and_ungrouped_heads():
    q = torch.zeros(1, 4, 3, 16)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="do not group"):
        A.flash_attention_gqa(q, k, k)
    with pytest.raises(TypeError, match="one dtype"):
        A.flash_attention(q[:, :, 0], k[:, :, 0].to(torch.bfloat16),
                          k[:, :, 0])


# The GQA shapes of chip_smoke.py's phase 8 (name, B, Sq, Sk, H, KV, hd,
# causal, dtype) and the path each takes on the card.
PHASE8 = [
    ("internlm2-1.8B prefill", 8, 256, 256, 16, 8, 128, True,
     torch.bfloat16, "wgmma"),
    ("granite-moe-1b prefill", 8, 256, 256, 16, 8, 64, True,
     torch.bfloat16, "wgmma"),
    ("long prefill", 1, 8192, 8192, 16, 8, 128, True, torch.bfloat16,
     "wgmma"),
    ("decode, ragged", 8, 1, 289, 16, 8, 128, False, torch.bfloat16,
     "decode"),
    ("yi-34b smoke prefill, hd 8", 2, 64, 64, 7, 1, 8, True,
     torch.bfloat16, "simt"),
    ("yi-34b smoke decode, hd 8", 2, 1, 64, 7, 1, 8, False, torch.bfloat16,
     "decode"),
    ("prefill, hd 80", 4, 300, 300, 16, 8, 80, True, torch.bfloat16,
     "wgmma"),
    ("prefill, hd 256", 2, 512, 512, 8, 4, 256, True, torch.bfloat16,
     "wgmma"),
    ("decode, hd 256, f32", 4, 1, 1000, 8, 4, 256, False, torch.float32,
     "decode"),
    ("prefill, hd 320", 2, 256, 256, 8, 4, 320, True, torch.bfloat16,
     "simt"),
    ("prefill, hd 320, f32", 2, 256, 256, 8, 4, 320, True, torch.float32,
     "simt"),
]


@pytest.mark.parametrize("shape", PHASE8, ids=[s[0] for s in PHASE8])
def test_attention_path_of_phase8_shapes(shape):
    _, B, Sq, Sk, H, KV, hd, causal, dtype, want = shape
    assert A.attention_path(B, Sq, Sk, H, KV, hd, dtype, causal) == want
    # float32 never takes the tensor cores (TF32 cannot hold rtol 2e-4)
    f32 = A.attention_path(B, Sq, Sk, H, KV, hd, torch.float32, causal)
    assert f32 == ("decode" if want == "decode" else "simt")


@pytest.mark.parametrize("hd", [8, 80, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_path_by_head_dim(hd, dtype):
    """Every head dim in [1, 256] has a path; the tensor cores take bf16
    at multiples of 16; decode takes G * Sq <= 16 rows at any width, and
    only Sq = 1 where the tensor cores would take the call; a head dim
    below 1 raises, one above 256 takes the CUDA-core kernel."""
    tc = dtype == torch.bfloat16 and hd % 16 == 0
    assert A.attention_path(2, 256, 256, 16, 8, hd, dtype, True) == (
        "wgmma" if tc else "simt")
    assert A.attention_path(2, 1, 256, 64, 8, hd, dtype, True) == "decode"
    assert A.attention_path(2, 2, 256, 16, 8, hd, dtype, True) == (
        "wgmma" if tc else "decode")
    assert A.attention_path(2, 8, 256, 16, 8, hd, dtype, True) == (
        "wgmma" if tc else "decode")
    assert A.attention_path(2, 9, 256, 16, 8, hd, dtype, True) != "decode"
    for bad in (0, -3):
        with pytest.raises(ValueError, match="head dims"):
            A.attention_path(2, 1, 8, 2, 2, bad, dtype, False)
    assert A.attention_path(2, 1, 8, 2, 2, hd + 257, dtype, False) == "simt"


@pytest.mark.parametrize("hd", [257, 320, 1000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal", [
    (2, 256, 256, 16, 8, True),    # a prefill the tensor cores take below
    (8, 1, 289, 16, 8, False),     # a decode shape
    (1, 2, 64, 8, 8, True)])
def test_attention_path_above_256_is_simt(hd, dtype, B, Sq, Sk, H, KV,
                                          causal):
    """Above 256 every shape and dtype takes the CUDA-core kernel, which
    walks the output columns in slices of 256."""
    assert A.attention_path(B, Sq, Sk, H, KV, hd, dtype, causal) == "simt"


def test_head_dims_past_256_raise():
    """Past 256 only a forced decode or tensor-core path raises; the rule
    sends such head dims to the CUDA-core kernel (the plain version on
    CPU tensors), and a head dim below 1 raises."""
    q = torch.zeros(1, 4, 2, 264)
    for path, t in (("decode", q), ("wgmma", q.bfloat16())):
        with pytest.raises(ValueError, match="head dims 1 to 256"):
            A.flash_attention_gqa(t, t, t, path=path)
    out = A.flash_attention_gqa(q, q, q)
    assert out.shape == q.shape and bool((out == 0).all())
    assert A.flash_attention_gqa(q, q, q, path="simt").shape == q.shape
    e = torch.zeros(1, 4, 2, 0)
    with pytest.raises(ValueError, match="head dims from 1"):
        A.flash_attention_gqa(e, e, e)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa_hd_320_matches_reference_kernel(causal):
    """hd 320 (two column slices of the CUDA-core kernel on the card): the
    port's plain ``flash_attention_gqa`` against the reference's Pallas
    kernel in interpret mode, at the reference's tolerance (rtol 2e-4,
    atol 2e-5), on a small GQA shape with a ragged key tile."""
    rng = np.random.default_rng(320 + causal)
    B, Sq, Sk, H, KV, hd = 1, 70, 150, 4, 2, 320
    q = _normal(rng, (B, Sq, H, hd))
    k, v = _normal(rng, (B, Sk, KV, hd)), _normal(rng, (B, Sk, KV, hd))
    got = A.flash_attention_gqa(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal)
    want = RA.flash_attention_gqa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
    assert got.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hd", [8, 80])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_other_head_dims_match_reference_kernel(hd, causal):
    """Head dims the port's kernels took only from this slice on: the
    plain version against the reference's Pallas kernel (interpret mode),
    which takes any hd."""
    rng = np.random.default_rng(hd + causal)
    BH, Sq, Sk = 3, 100, 300
    q, k, v = (_normal(rng, (BH, s, hd)) for s in (Sq, Sk, Sk))
    got = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal)
    want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,nsplit", [
    (2, 1, 289, 16, 8, 128, False, None),   # the decode shape, 5 splits
    (2, 1, 289, 16, 8, 128, False, 9),      # more splits than tiles
    (1, 150, 300, 2, 2, 16, True, 3),       # early rows see no key of a split
    (2, 100, 70, 4, 2, 32, True, None),     # Sq > Sk under causal
    (2, 100, 70, 4, 2, 32, True, 4),
    (1, 3, 200, 8, 2, 8, False, 3),         # Sk not a multiple of 64
    (2, 2, 1000, 8, 1, 64, True, 2),        # causal: keys past Sq unseen
])
def test_split_k_merge_equals_the_reference(B, Sq, Sk, H, KV, hd, causal,
                                            nsplit):
    """The decode kernel's split-and-merge in plain torch: wholly masked
    splits weigh nothing, and the merge equals ``flash_attention_ref`` at
    the reference's tolerance (rtol 2e-4, atol 2e-5)."""
    rng = np.random.default_rng(Sq * 31 + Sk)
    q = torch.from_numpy(_normal(rng, (B, Sq, H, hd)))
    k = torch.from_numpy(_normal(rng, (B, Sk, KV, hd)))
    v = torch.from_numpy(_normal(rng, (B, Sk, KV, hd)))
    got = A.flash_decode_split_ref(q, k, v, causal=causal, nsplit=nsplit)
    G = H // KV
    qf = q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(G, 1).reshape(B * H, Sk, hd)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(G, 1).reshape(B * H, Sk, hd)
    want = KREF.flash_attention_ref(qf, kf, vf, causal=causal)
    np.testing.assert_allclose(
        got.numpy(), want.reshape(B, H, Sq, hd).permute(0, 2, 1, 3).numpy(),
        **TOL)


def test_p_hi_lo_error_bound_at_granite_prefill():
    """A numpy model of the tensor-core kernel's P V at phase 8's smallest
    tensor-core shape (granite-moe-1b's prefill: 8 x 256 x 256, 16/8 heads,
    hd 64, causal, bf16 operands). P = bf16(P) + bf16(P - bf16(P)) holds P
    to 2^-16 relative, so each output is within 2^-16 sum_j p_j |v_j| / l
    of the exact P V / l, and the largest error stays under atol (2e-5).
    P as one bf16 (2^-8) breaks the tolerance: why the kernel feeds two."""
    import ml_dtypes
    rng = np.random.default_rng(64)
    B, S, H, KV, hd = 8, 256, 16, 8, 64
    bf = ml_dtypes.bfloat16
    q = _normal(rng, (B, H, S, hd)).astype(bf).astype(np.float64)
    k = _normal(rng, (B, KV, S, hd)).astype(bf).astype(np.float64)
    v = _normal(rng, (B, KV, S, hd)).astype(bf).astype(np.float64)
    k, v = np.repeat(k, H // KV, 1), np.repeat(v, H // KV, 1)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(hd)
    s = np.where(np.tri(S, dtype=bool), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    p_hi = p.astype(bf).astype(np.float32)
    p_lo = (p - p_hi).astype(bf).astype(np.float32)
    assert np.all(p - p_hi == (p.astype(np.float64) - p_hi))  # exact in f32
    rep = np.abs(p.astype(np.float64) - p_hi - p_lo)
    assert np.all(rep <= 2.0 ** -16 * p)
    p64, l = p.astype(np.float64), p.astype(np.float64).sum(-1)[..., None]
    exact = p64 @ v / l
    err = np.abs((p_hi.astype(np.float64) + p_lo) @ v / l - exact)
    bound = 2.0 ** -16 * (p64 @ np.abs(v)) / l
    assert np.all(err <= bound) and err.max() < 2e-5
    single = np.abs(p_hi.astype(np.float64) @ v / l - exact)
    assert np.any(single > 2e-4 * np.abs(exact) + 2e-5)
