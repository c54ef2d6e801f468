"""The port's logistic-gradient ops (``repro_torch.kernels.ops.matmul``,
``_margin``, ``logreg_grad``) and oracles against the reference's.

On the CPU each op runs its kernel's plain torch version; it is held
against the reference's Pallas kernels in interpret mode and its
oracles (``repro.kernels.ref``) at the reference's own tolerances:
rtol 1e-4 / atol 1e-3 for the matmul (``tests/test_kernels.py:95``),
rtol 1e-4 / atol 1e-5 for the gradient (``:107``, ``:119``), and 1e-6
for the elementwise margin. The CUDA kernels are held to their plain
versions (and the matmul to float64) in ``test_torch_kernels_cuda.py``,
which runs where a card is.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import logreg, ops, ref

# the reference exports the op ``logreg_grad`` under its module's name
rlg = importlib.import_module("repro.kernels.logreg_grad")

MATMUL_SHAPES = [(128, 128, 128), (256, 384, 128), (100, 50, 30),
                 (129, 257, 65)]


def _logreg_inputs(m, d, seed=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(m, d).astype(np.float32)
    y = rng.choice([-1.0, 1.0], m).astype(np.float32)
    w = (rng.randn(d) * 0.2).astype(np.float32)
    return X, y, w


def _torch_loss(X, y):
    return lambda w: torch.mean(torch.log1p(torch.exp(-y * (X @ w))))


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES + [(129, 257, 1)])
@pytest.mark.parametrize("transpose_a", [False, True])
def test_matmul_matches_reference(m, k, n, transpose_a):
    rng = np.random.RandomState(1)
    A = rng.randn(*((k, m) if transpose_a else (m, k))).astype(np.float32)
    B = rng.randn(k, n).astype(np.float32)
    C = ops.matmul(torch.as_tensor(A), torch.as_tensor(B),
                   transpose_a=transpose_a)
    assert C.shape == (m, n) and C.dtype == torch.float32
    Cr = rops.matmul(jnp.asarray(A), jnp.asarray(B), transpose_a=transpose_a,
                     interpret=True)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cr), rtol=1e-4,
                               atol=1e-3)
    exact = (A.T if transpose_a else A).astype(np.float64) @ B
    np.testing.assert_allclose(C.numpy(), exact, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m,d", [(64, 32), (200, 300), (129, 257)])
def test_logreg_grad_matches_reference(m, d):
    X, y, w = _logreg_inputs(m, d)
    g = ops.logreg_grad(*map(torch.as_tensor, (X, y, w)))
    assert g.shape == (d,)
    gr = rops.logreg_grad(*map(jnp.asarray, (X, y, w)), interpret=True)
    np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=1e-4,
                               atol=1e-5)
    ge = rref.logreg_grad_ref(*map(jnp.asarray, (X, y, w)))
    np.testing.assert_allclose(g.numpy(), np.asarray(ge), rtol=1e-4,
                               atol=1e-5)


def test_logreg_grad_matches_autograd():
    X, y, w = map(torch.as_tensor, _logreg_inputs(50, 20, seed=3))
    w_req = w.clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(_torch_loss(X, y)(w_req), w_req)
    torch.testing.assert_close(ops.logreg_grad(X, y, w), g_auto, rtol=1e-4,
                               atol=1e-5)
    g_jax = jax.grad(lambda z: jnp.mean(jnp.log1p(jnp.exp(
        -jnp.asarray(y.numpy()) * (jnp.asarray(X.numpy()) @ z)))))(
        jnp.asarray(w.numpy()))
    np.testing.assert_allclose(g_auto.numpy(), np.asarray(g_jax), rtol=1e-4,
                               atol=1e-5)


def test_logreg_oracles_match_reference():
    X, y, w = _logreg_inputs(129, 257, seed=4)
    tX, ty, tw = map(torch.as_tensor, (X, y, w))
    jX, jy, jw = map(jnp.asarray, (X, y, w))
    np.testing.assert_allclose(ref.logreg_margin_ref(tX, ty, tw).numpy(),
                               np.asarray(rref.logreg_margin_ref(jX, jy, jw)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref.logreg_grad_ref(tX, ty, tw).numpy(),
                               np.asarray(rref.logreg_grad_ref(jX, jy, jw)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 128), (256, 128), (512, 128)])
def test_margin_matches_reference(shape):
    rng = np.random.RandomState(5)
    s = (rng.randn(*shape) * 4).astype(np.float32)
    y = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    v = ops._margin(torch.as_tensor(s), torch.as_tensor(y))
    vr = rlg.margin(jnp.asarray(s), jnp.asarray(y), interpret=True)
    np.testing.assert_allclose(v.numpy(), np.asarray(vr), rtol=1e-6,
                               atol=1e-6)


def test_margin_overflow_and_nan():
    """exp overflows to inf for -y*s << 0 and v -> 0, with no NaN; for
    -y*s >> 0, v -> -y; a NaN in s or y gives NaN in v, and nowhere
    else. The same as the reference's kernel."""
    s = np.array([[1e4, -1e4, 100.0, -100.0, 89.0, -89.0, 0.0, np.nan]] * 2,
                 np.float32)
    y = np.ones_like(s)
    y[1] = -1.0
    y[0, 6] = np.nan
    v = ops._margin(torch.as_tensor(s), torch.as_tensor(y)).numpy()
    nan = np.isnan(s) | np.isnan(y)
    np.testing.assert_array_equal(np.isnan(v), nan)
    assert np.isfinite(v[~nan]).all()
    # -y*s = -1e4, -100, -89 (row 0), and the mirror in row 1: v -> 0
    assert v[0, 0] == v[0, 2] == 0.0 and v[1, 1] == v[1, 3] == 0.0
    assert abs(v[0, 4]) < 1e-37 and abs(v[1, 5]) < 1e-37
    # -y*s = +1e4, +100 : v = -y exactly
    assert v[0, 1] == v[0, 3] == -1.0 and v[1, 0] == v[1, 2] == 1.0
    assert v[1, 6] == 0.5                     # sigmoid(0) = 1/2, y = -1
    vr = np.asarray(rlg.margin(jnp.asarray(np.tile(s, (4, 1))),
                               jnp.asarray(np.tile(y, (4, 1))),
                               interpret=True))[:2]
    np.testing.assert_allclose(v, vr, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.float16])
def test_logreg_ops_take_float32_only(dtype):
    """float32, bfloat16 and float16 are the kernels' types; any other
    dtype, or operands of two dtypes, raise ``TypeError`` (the message
    names float32). A 16-bit call returns its operands' dtype."""
    a = torch.ones((4, 3), dtype=dtype)
    f = torch.ones((4, 3))
    with pytest.raises(TypeError, match="float32"):
        ops.matmul(f, torch.ones((3, 2), dtype=dtype))
    with pytest.raises(TypeError, match="float32"):
        ops._margin(f, a)
    if dtype == torch.float64:
        with pytest.raises(TypeError, match="float32"):
            ops.matmul(a, torch.ones((3, 2), dtype=dtype))
        with pytest.raises(TypeError, match="float32"):
            ops._margin(a, a)
        with pytest.raises(TypeError, match="float32"):
            ops.logreg_grad(a, torch.ones(4, dtype=dtype),
                            torch.ones(3, dtype=dtype))
    else:
        assert ops.matmul(a, torch.ones((3, 2), dtype=dtype)).dtype == dtype
        assert ops._margin(a, a).dtype == dtype
        assert ops.logreg_grad(a, torch.ones(4, dtype=dtype), torch.ones(
            3, dtype=dtype)).dtype == dtype


# bf16 parity: the reference's interpret-mode kernels take the input dtype
# (f32 accumulator, output in a.dtype); held at the reference's own bf16
# tolerance, 5e-2 (tests/test_flash_attention.py:42)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _bf16(a):
    """numpy f32 values exactly representable in bf16, and both tensors."""
    j = jnp.asarray(a, jnp.bfloat16)
    return torch.as_tensor(np.asarray(j, np.float32)).bfloat16(), j


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES + [(129, 257, 1)])
@pytest.mark.parametrize("transpose_a", [False, True])
def test_matmul_bf16_matches_reference(m, k, n, transpose_a):
    rng = np.random.RandomState(6)
    (ta, ja), (tb, jb) = (_bf16(rng.randn(*s).astype(np.float32)) for s in
                          ((k, m) if transpose_a else (m, k), (k, n)))
    C = ops.matmul(ta, tb, transpose_a=transpose_a)
    assert C.dtype == torch.bfloat16 and C.shape == (m, n)
    Cr = rops.matmul(ja, jb, transpose_a=transpose_a, interpret=True)
    assert Cr.dtype == jnp.bfloat16
    np.testing.assert_allclose(C.float().numpy(), np.asarray(Cr, np.float32),
                               **BF16_TOL)
    # fp32 accumulator, one rounding: within half a bf16 ulp of the exact
    exact = (ta.double().T if transpose_a else ta.double()) @ tb.double()
    assert bool(((C.double() - exact).abs()
                 <= exact.abs() * 2.0 ** -8 + 1e-30).all())


@pytest.mark.parametrize("shape", [(8, 128), (256, 128)])
def test_margin_bf16_matches_reference(shape):
    rng = np.random.RandomState(7)
    (ts, js), (ty, jy) = _bf16((rng.randn(*shape) * 4).astype(np.float32)), \
        _bf16(rng.choice([-1.0, 1.0], shape).astype(np.float32))
    v = ops._margin(ts, ty)
    assert v.dtype == torch.bfloat16
    vr = rlg.margin(js, jy, interpret=True)
    np.testing.assert_allclose(v.float().numpy(), np.asarray(vr, np.float32),
                               **BF16_TOL)
    # computed in float32 and rounded once
    assert torch.equal(v, logreg.margin_torch(ts.float(), ty.float())
                       .bfloat16())


def test_logreg_grad_bf16_matches_reference():
    X, y, w = _logreg_inputs(200, 300)
    (tX, jX), (ty, jy), (tw, jw) = map(_bf16, (X, y, w))
    g = ops.logreg_grad(tX, ty, tw)
    assert g.dtype == torch.bfloat16
    gr = rops.logreg_grad(jX, jy, jw, interpret=True)
    np.testing.assert_allclose(g.float().numpy(), np.asarray(gr, np.float32),
                               **BF16_TOL)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    X, y, w = map(torch.as_tensor, _logreg_inputs(64, 32))
    ops.reset_launch_counts()
    s = ops.matmul(X, w[:, None])
    assert torch.equal(s, logreg.matmul_torch(X, w[:, None]))
    v = ops._margin(s, y[:, None])
    assert torch.equal(v, logreg.margin_torch(s, y[:, None]))
    g = ops.matmul(X, v, transpose_a=True)
    assert torch.equal(g, logreg.matmul_torch(X, v, transpose_a=True))
    assert torch.equal(ops.logreg_grad(X, y, w), g[:, 0] / 64)
    assert ops.launch_counts()["matmul"] == 0
    assert ops.launch_counts()["margin"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        logreg.matmul_cuda(X, w[:, None])
    with pytest.raises(ValueError, match="CUDA"):
        logreg.margin_cuda(s, y[:, None])


# ---------------------------------------------------------------------------
# The CUDA designs' arithmetic, emulated in numpy (the kernels run only on
# the card). B5's rule, as chip_smoke.py and the card tests hold the
# kernels: max|out - f64| <= 8 * max(max|plain - f64|, 2^-22 max|f64|),
# where plain is the float32 product (in 16 bits, rounded once to the
# type).

def _b5_ratio(out, plain, exact):
    """max|out - exact| as a share of B5's limit (<= 1 passes)."""
    err = np.abs(out.astype(np.float64) - exact).max()
    plain_err = np.abs(plain.astype(np.float64) - exact).max()
    return err / (8 * max(plain_err, 2.0 ** -22 * np.abs(exact).max()))


def _tf32(x):
    """cvt.rna.tf32 of finite float32 values: round the 13 low bits of
    the magnitude away (to nearest, ties away from zero)."""
    i = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((i + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _split(x):
    """The kernel's split of finite values: x = hi + lo, both TF32."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _trunc32(x):
    """float64 to float32, rounded toward zero (the tensor core's
    accumulation); non-finite values pass through."""
    f = x.astype(np.float32)
    with np.errstate(invalid="ignore"):
        over = np.isfinite(x) & (np.abs(f.astype(np.float64)) > np.abs(x))
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tf32x3_emulated(A, B, terms=3):
    """matmul_tf32x3_kernel's arithmetic on A (M, K) and B (K, N) float32.
    The products that involve an Inf or a NaN are formed in float32 and
    added apart; the tensor cores see those entries as 0. Each k8 step's
    products go through three mma.sync steps into a fresh accumulator
    (exact TF32 products, the sum rounded toward zero at each step),
    lo(a) hi(b), then hi(a) lo(b), then hi(a) hi(b); the fresh
    accumulator is added to the float32 sum, rounded to nearest. With
    ``terms=1``, only hi(a) hi(b): one pass of TF32."""
    fa, fb = np.isfinite(A), np.isfinite(B)
    (ah, al), (bh, bl) = _split(np.where(fa, A, 0)), _split(np.where(fb, B, 0))
    steps = [(al, bh), (ah, bl), (ah, bh)][3 - terms:]
    acc = np.zeros((A.shape[0], B.shape[1]), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for k in np.flatnonzero(~fa.all(0) | ~fb.all(1)):
            odd = ~(fa[:, k, None] & fb[None, k, :])
            acc[odd] += (A[:, k, None] * B[None, k, :])[odd]
        for k0 in range(0, A.shape[1], 8):
            t = np.zeros_like(acc)
            for x, y in steps:
                t = _trunc32(t + x[:, k0:k0 + 8].astype(np.float64)
                             @ y[k0:k0 + 8].astype(np.float64))
            acc = acc + t
    return acc


@pytest.mark.parametrize("m,k,n", [(64, 512, 48), (40, 1000, 24)])
def test_tf32x3_arithmetic_meets_b5_rule_and_one_pass_does_not(m, k, n):
    rng = np.random.RandomState(8)
    A = rng.randn(m, k).astype(np.float32)
    B = rng.randn(k, n).astype(np.float32)
    exact = A.astype(np.float64) @ B.astype(np.float64)
    plain = ops.matmul(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert _b5_ratio(_tf32x3_emulated(A, B), plain, exact) <= 0.5
    assert _b5_ratio(_tf32x3_emulated(A, B, terms=1), plain, exact) > 4.0


def test_tf32x3_nonfinite_products_fall_where_plain_has_them():
    """An Inf in A or B: split, x - hi is NaN there, and a cross term
    0 * Inf (a TF32-exact partner has lo = 0) would turn the plain
    version's Inf into NaN. The kernel forms the products that involve
    an Inf or a NaN in float32 and gives the tensor cores 0 in their
    place: NaN and Inf fall where the float32 product has them."""
    A = np.array([[1.0, 2.0], [np.inf, 1.0], [1.5, np.nan]], np.float32)
    B = np.array([[1.0, -np.inf, 0.0], [3.0, 1.0, 2.0]], np.float32)
    A, B = np.pad(A, ((0, 0), (0, 6))), np.pad(B, ((0, 6), (0, 0)))
    plain = ops.matmul(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    out = _tf32x3_emulated(A, B)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(plain))
    np.testing.assert_array_equal(np.isinf(out), np.isinf(plain))
    np.testing.assert_array_equal(np.sign(out[np.isinf(out)]),
                                  np.sign(plain[np.isinf(plain)]))
    fin = np.isfinite(plain)
    np.testing.assert_array_equal(out[fin], plain[fin])
    assert np.isinf(plain[1, 0]) and np.isinf(plain[0, 1])
    # the split of the raw values gives NaN there
    with np.errstate(invalid="ignore"):
        ah, al = _split(A)
        bh, bl = _split(B)
        raw = al.astype(np.float64) @ bh + ah.astype(np.float64) @ bl
    assert np.isnan(raw[1, 0]) and np.isnan(raw[0, 1])


# csrc/logreg_grad.cu's split of gemv16_cols_kernel (X^T v in 16 bits)
COL16_WIDTH, COL16_WARPS, COL16_BLOCKS, COL16_MIN_ROWS = 256, 8, 4096, 256


def _col16_split(M, K):
    """(splits, rows a split) as the kernel's plan computes them."""
    groups = -(-M // COL16_WIDTH)
    want = max(1, min(-(-COL16_BLOCKS // groups), -(-K // COL16_MIN_ROWS)))
    seg = -(-K // want)
    return -(-K // seg), seg


def _gemv16_cols_emulated(A, v):
    """gemv16_cols_kernel + gemv16_sum_kernel on A stored (K, M) and v
    (K,), both bf16-valued float32: per split, 8 warps each sum a
    contiguous eighth of the split's rows in k order (fmaf: the product of
    two bf16 values is exact in float32, so each step is one float32
    add), the block adds the 8 in warp order into the split's row, and
    the splits' rows are added in split order and rounded to bf16 once."""
    K, M = A.shape
    splits, seg = _col16_split(M, K)
    total = np.zeros(M, np.float32)
    for s in range(splits):
        lo, hi = s * seg, min((s + 1) * seg, K)
        sub = -(-(hi - lo) // COL16_WARPS)
        part = np.zeros(M, np.float32)
        for w in range(COL16_WARPS):
            acc = np.zeros(M, np.float32)
            for k in range(min(lo + w * sub, hi), min(lo + (w + 1) * sub, hi)):
                acc = acc + A[k] * v[k]
            part = acc if w == 0 else part + acc
        total = part if s == 0 else total + part
    return torch.as_tensor(total).bfloat16().float().numpy()


@pytest.mark.parametrize("K,M", [(4096, 64), (1000, 2048), (777, 520)])
def test_gemv16_split_column_sum_meets_b5_rule(K, M):
    """The 16-bit X^T v's fixed-order two-pass column sum, split over K
    into (splits, rows) = ``_col16_split``, within B5's rule of float64."""
    rng = np.random.RandomState(9)
    A = torch.as_tensor(rng.randn(K, M).astype(np.float32)).bfloat16()
    v = torch.as_tensor(rng.randn(K, 1).astype(np.float32)).bfloat16()
    assert _col16_split(M, K)[0] > 1                # a real split of K
    exact = A.double().T.numpy() @ v.double().numpy()
    plain = ops.matmul(A, v, transpose_a=True).float().numpy()
    out = _gemv16_cols_emulated(A.float().numpy(), v.float().numpy()[:, 0])
    assert _b5_ratio(out[:, None], plain, exact) <= 1.0
    # the emulation sums in another order than the plain product; both
    # are float32 sums rounded once to bf16
    np.testing.assert_allclose(out[:, None], plain, rtol=2.0 ** -7,
                               atol=1e-2)


# shapes the tensor-core designs take: a tile multiple (3 x 2 tiles of
# 128 x 256, 8 steps of 64) and a ragged one (no edge on a tile)
TENSOR_CORE_SHAPES = [(384, 512, 512), (200, 136, 264)]


@pytest.mark.parametrize("m,k,n", TENSOR_CORE_SHAPES)
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_reference_at_design_shapes(m, k, n, transpose_a,
                                                   dtype):
    rng = np.random.RandomState(10)
    A = rng.randn(*((k, m) if transpose_a else (m, k))).astype(np.float32)
    B = rng.randn(k, n).astype(np.float32)
    if dtype == "float32":
        ta, ja = torch.as_tensor(A), jnp.asarray(A)
        tb, jb = torch.as_tensor(B), jnp.asarray(B)
        tol = dict(rtol=1e-4, atol=1e-3)
    else:
        (ta, ja), (tb, jb) = _bf16(A), _bf16(B)
        tol = BF16_TOL
    C = ops.matmul(ta, tb, transpose_a=transpose_a)
    assert C.shape == (m, n) and str(C.dtype) == f"torch.{dtype}"
    Cr = rops.matmul(ja, jb, transpose_a=transpose_a, interpret=True)
    np.testing.assert_allclose(C.float().numpy(), np.asarray(Cr, np.float32),
                               **tol)


def test_cpu_matmul_counts_no_design():
    ops.reset_launch_counts()
    ops.matmul(torch.ones((16, 8)), torch.ones((8, 16)))
    assert ops.matmul_design_counts() == {
        "tiled": 0, "gemv": 0, "gemv16": 0, "wgmma": 0, "tf32x3": 0}
