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
