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
