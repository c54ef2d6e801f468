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


# ---------------------------------------------------------------------------
# The arithmetic the CUDA kernel's two designs commit to, emulated on the
# CPU and held to float64 attention by B5's rule (ratio 8; chip_smoke.py's
# f64_limit), the rule the kernel itself is held to on the card:
# * float32: 3xTF32 products, each operand x split into hi = x rounded to
#   10 mantissa bits (cvt.rna: to nearest, ties away from zero) and lo =
#   x - hi rounded the same way; for K and V lo = 0 where x is not
#   finite, and the cross term lo(q or p) * hi(k or v) reads that hi as 0
#   where it is not finite; 32-key tiles;
# * bf16 / f16: products of the 16-bit inputs summed in float32, P
#   rounded to the input type before P V; 128-key tiles (64 at hd 256);
# * both: an online softmax over the key tiles with exp2 of the scores
#   times scale * log2(e), folded into one float32 constant.
# ---------------------------------------------------------------------------

RATIO, FLOOR = 8.0, 2.0 ** -22       # B5's rule


def _tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, to nearest with
    ties away from zero; NaN and Inf as they are."""
    i = x.view(torch.int32)
    r = ((i + (1 << 12)) & -(1 << 13)).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _split(x, guard_lo=True, guard_cross=True):
    """(hi, lo, hi for the cross terms) of float32 ``x``."""
    hi = _tf32(x)
    fin = torch.isfinite(x)
    lo = _tf32(x - hi)
    if guard_lo:
        lo = torch.where(fin, lo, 0.0)
    hic = torch.where(fin, hi, 0.0) if guard_cross else hi
    return hi, lo, hic


def _mm_3xtf32(a, b, **guards):
    """a @ b as 3xTF32 does it: the small terms first, float32 sums. Only
    b (K, V) is guarded: a non-finite a (q, p) makes its row NaN or
    infinite in the plain version too."""
    ahi, alo, _ = _split(a, guard_lo=False, guard_cross=False)
    bhi, blo, bhic = _split(b, **guards)
    return (alo @ bhic + ahi @ blo) + ahi @ bhi


def _emulated(q, k, v, causal, scale=None, **guards):
    """The kernel's function with its arithmetic: float32 for float32
    inputs (3xTF32), the 16-bit design's for bf16 / f16."""
    BH, S, hd = q.shape
    T = k.shape[1]
    tf32 = q.dtype == torch.float32
    bk = 32 if tf32 else (128 if hd == 128 else 64)
    scale = hd ** -0.5 if scale is None else scale
    c2 = torch.tensor(scale * np.log2(np.e), dtype=torch.float32)
    mm = (lambda a, b: _mm_3xtf32(a, b, **guards)) if tf32 else torch.matmul
    qf = q.float()
    m = torch.full((BH, S, 1), -1e30)
    l = torch.zeros((BH, S, 1))
    acc = torch.zeros((BH, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, T, bk):
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        x = mm(qf, kt.transpose(1, 2)) * c2
        if causal:
            keys = k0 + torch.arange(kt.shape[1])[None, :]
            x = torch.where(keys > rows, -1e30, x)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = mm(p, vt) if tf32 else p.to(q.dtype).float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _f64(q, k, v, causal, scale=None):
    hd = q.shape[-1]
    scale = float(torch.tensor(hd ** -0.5 if scale is None else scale,
                               dtype=torch.float32))
    s = (q.double() @ k.double().transpose(1, 2)) * scale
    if causal:
        s = torch.where(torch.ones(q.shape[1], k.shape[1],
                                   dtype=torch.bool).tril(), s, -1e30)
    return torch.softmax(s, -1) @ v.double()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("BH,S,hd", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_arithmetic_within_float64_bound(BH, S, hd, causal, dtype):
    q, k, v = (torch.as_tensor(a).to(dtype)
               for a in _qkv(BH, S, hd, BH + S))
    exact = _f64(q, k, v, causal)
    plain = flash_attention.flash_attention_torch(q, k, v, causal)
    out = _emulated(q, k, v, causal)
    plain_err = float((plain.double() - exact).abs().max())
    limit = RATIO * max(plain_err, FLOOR * float(exact.abs().max()))
    err = float((out.double() - exact).abs().max())
    assert err <= limit, (err, plain_err)
    if dtype == torch.float32:
        # float32 accuracy: one pass of TF32 would not pass
        one_pass = _emulated(_tf32(q), _tf32(k), _tf32(v), causal)
        assert float((one_pass.double() - exact).abs().max()) > limit


def test_3xtf32_guards_keep_an_inf_in_v():
    """An Inf in v at a key every row sees: the plain version gives Inf
    in that column. Without the guards 3xTF32 turns it into NaN, twice
    over: lo = Inf - Inf is NaN, and a cross term lo(p) * hi(v) is
    0 * Inf = NaN wherever p is exactly a TF32 value (p = 1 at each
    row's largest score)."""
    q, k, v = map(torch.as_tensor, _qkv(1, 64, 128, 11))
    v[0, 0, 7] = float("inf")
    k[0, 0] = 10 * q[0, 0]               # key 0 holds row 0's largest score
    plain = flash_attention.flash_attention_torch(q, k, v, True)
    col = plain[0, :, 7]
    assert bool(torch.isinf(col).all())
    guarded = _emulated(q, k, v, True)
    assert torch.equal(guarded[0, :, 7], col)
    naive_lo = _emulated(q, k, v, True, guard_lo=False)
    assert bool(torch.isnan(naive_lo[0, :, 7]).all())
    naive_cross = _emulated(q, k, v, True, guard_cross=False)
    assert bool(torch.isnan(naive_cross[0, 0, 7]))     # p = 1 there
    assert bool(torch.isfinite(guarded[0, :, :7]).all())


# B7's 16-bit results are held row by row as well (chip_smoke.py's
# f64_row_limits): one limit over all rows is set by the rows of largest
# output, the first rows of a causal head, which see few keys
UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def _ratios(out, plain, exact):
    """``out``'s error against float64 as a multiple of B5's limit over
    all entries, and the largest multiple of its row's limit."""
    plain_err = float((plain.double() - exact).abs().max())
    limit = RATIO * max(plain_err, FLOOR * float(exact.abs().max()))
    err, row_plain, scale = ((t.abs()).amax(-1) for t in
                             (out.double() - exact, plain.double() - exact,
                              exact))
    row_limit = RATIO * torch.maximum(row_plain, UNIT[plain.dtype] * scale)
    return (float((out.double() - exact).abs().max()) / limit,
            float((err / row_limit).max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("BH,S,hd", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_16_bit_arithmetic_within_float64_bound_row_by_row(BH, S, hd, causal,
                                                          dtype):
    q, k, v = (torch.as_tensor(a).to(dtype)
               for a in _qkv(BH, S, hd, BH + S))
    exact = _f64(q, k, v, causal)
    plain = flash_attention.flash_attention_torch(q, k, v, causal)
    _, by_row = _ratios(_emulated(q, k, v, causal), plain, exact)
    assert by_row <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_row_rule_refuses_the_last_keys_dropped(dtype):
    """At the serve path's (S, hd) = (4096, 128), causal: a kernel that
    drops the last 64 keys changes only the last 64 rows, whose outputs
    average thousands of keys and are small. The row rule refuses it;
    in bf16 B5's rule over all rows, set by the early rows, does not."""
    q, k, v = (torch.as_tensor(a).to(dtype) for a in _qkv(1, 4096, 128, 7))
    exact = _f64(q, k, v, True)
    plain = flash_attention.flash_attention_torch(q, k, v, True)
    assert max(_ratios(_emulated(q, k, v, True), plain, exact)) <= 1.0
    over_all, by_row = _ratios(
        _emulated(q, k[:, :-64], v[:, :-64], True), plain, exact)
    assert by_row > 1.0
    if dtype == torch.bfloat16:
        assert over_all < 1.0
