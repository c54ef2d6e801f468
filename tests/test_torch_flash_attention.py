"""Flash attention (B7) on the CPU: ``ops.flash_attention`` runs its
plain version (the full softmax in float32), held against the
reference's Pallas kernel ``flash_attention_bhsd`` in interpret mode at
the reference test's shapes (``tests/test_flash_attention.py``): float32
at 1e-5, bfloat16 at the reference's own 5e-2. And the model path's
``_sdpa_flash`` (GQA expansion, S padded to 128, hd padded to 128, the
scale of the unpadded hd) against the reference's, at S = 40.

The CUDA kernel is held to float64 in ``test_torch_kernels_cuda.py``,
which runs where a card is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bhsd
from repro.models import attention as rattn
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import attention as tattn

SHAPES = [(2, 128, 128), (4, 256, 128), (1, 512, 256), (3, 384, 128)]


def _qkv(BH, S, hd, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(BH, S, hd).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("BH,S,hd", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference_kernel(BH, S, hd, causal):
    q, k, v = _qkv(BH, S, hd, BH + S)
    ops.reset_launch_counts()
    out = ops.flash_attention(*map(torch.as_tensor, (q, k, v)), causal)
    assert ops.launch_counts()["flash_attention"] == 0
    assert out.shape == (BH, S, hd) and out.dtype == torch.float32
    ref = flash_attention_bhsd(*map(jnp.asarray, (q, k, v)), causal=causal,
                               interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_matches_reference_kernel(causal):
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in _qkv(2, 256, 128, 0))
    out = ops.flash_attention(*(torch.as_tensor(a).bfloat16()
                                for a in (q, k, v)), causal)
    assert out.dtype == torch.bfloat16
    ref = flash_attention_bhsd(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)), causal=causal,
                               interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("scale", [None, 0.125, 0.3])
def test_flash_attention_scale_and_ragged_keys(scale):
    """S != T: causal rows see the keys at or before their own index."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 128, 128).astype(np.float32)
    kv = [rng.randn(2, 256, 128).astype(np.float32) for _ in range(2)]
    for causal in (True, False):
        out = ops.flash_attention(torch.as_tensor(q), *map(torch.as_tensor,
                                                           kv), causal, scale)
        ref = flash_attention_bhsd(jnp.asarray(q), *map(jnp.asarray, kv),
                                   causal=causal, scale=scale,
                                   interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("nq,nkv,hd", [(4, 2, 32), (4, 4, 32), (8, 2, 128),
                                       (4, 1, 160)])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_flash_matches_reference(nq, nkv, hd, causal):
    """GQA expansion and the S (40 -> 128) and hd padding, as the
    reference's ``_sdpa_flash``; non-causal included, where the padded
    zero keys take part in the softmax in both (ROADMAP Queue C)."""
    rng = np.random.RandomState(nq * hd + nkv)
    B, S = 2, 40
    q = rng.randn(B, S, nq, hd).astype(np.float32)
    k, v = (rng.randn(B, S, nkv, hd).astype(np.float32) for _ in range(2))
    out = tattn._sdpa_flash(*map(torch.as_tensor, (q, k, v)), nq, nkv,
                            causal=causal)
    ref = rattn._sdpa_flash(*map(jnp.asarray, (q, k, v)), nq, nkv,
                            causal=causal)
    assert out.shape == (B, S, nq * hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_sdpa_flash_causal_matches_naive():
    """Causal, the padded keys are masked from every real row, so the
    flash path computes the naive path's function."""
    rng = np.random.RandomState(7)
    B, S, nq, nkv, hd = 2, 40, 4, 2, 32
    q = torch.as_tensor(rng.randn(B, S, nq, hd).astype(np.float32))
    k, v = (torch.as_tensor(rng.randn(B, S, nkv, hd).astype(np.float32))
            for _ in range(2))
    mask = torch.ones((S, S), dtype=torch.bool).tril()
    torch.testing.assert_close(tattn._sdpa_flash(q, k, v, nq, nkv),
                               tattn._sdpa(q, k, v, mask, nq, nkv),
                               rtol=1e-5, atol=1e-5)


def test_plain_version_masks_and_normalises_as_the_oracle():
    """The plain version is the reference test's oracle: the full
    softmax with scores masked to -1e30 above the diagonal."""
    q, k, v = map(torch.as_tensor, _qkv(2, 64, 128, 5))
    out = flash_attention.flash_attention_torch(q, k, v, True)
    s = q @ k.transpose(1, 2) / np.sqrt(128)
    s = torch.where(torch.ones(64, 64, dtype=torch.bool).tril(), s, -1e30)
    torch.testing.assert_close(out, torch.softmax(s, -1) @ v, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(out[:, 0], v[:, 0])       # row 0 sees key 0 only


def test_flash_attention_refuses_bad_operands():
    q = torch.zeros((2, 64, 128))
    with pytest.raises(ValueError, match="BH, S, hd"):
        ops.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, q[:, :, :64], q[:, :, :64])
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError, match="float32"):
        ops.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, q, q)
