"""The plain versions of B2 and B6 against the reference's Pallas kernels
(interpret mode, as the reference's own tests run them) at the shapes
their CUDA designs single out.

B2 (``server_prox_update_torch``) on one block column, (N, 1, d): the
PS runtime's block commit. The CUDA kernel reads each thread's edge
column as a bit mask of 64 workers and loads the rows of 8 workers
before it adds them, so N = 1, 3, 8 (one group, ragged or whole), 17
(groups past the first) and 70 (a second 64-bit mask) are the cases;
every edge pattern (all true, all false, mixed), with NaN in rows on
and off the edge set, l1 / clip on and off. Tolerance 1e-5, the
reference's between its backends.

B6 (``margin_torch``) at lengths 1, 7, 8, 9 and 1025: the CUDA kernel
takes 16-byte words (8 elements in 16 bits, 4 in float32) and the
elements before the first and after the last word one at a time, so
these are shorter than a word, one word, a word and one, and many words
and one. In float32 at 1e-6 (the elementwise kernels' tolerance), in
bfloat16 and float16 at the reference's 16-bit tolerance, 5e-2
(``tests/test_flash_attention.py:42``); in 16 bits also bitwise the
float32 result rounded once. The output the CUDA wrapper allocates
shares s's address modulo 16 bytes (``logreg.out_like``), checked here
on CPU tensors.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import prox_update as rprox
from repro_torch.kernels import logreg, ops, prox_update

# the reference exports the op ``logreg_grad`` under its module's name
rlg = importlib.import_module("repro.kernels.logreg_grad")

B2_TOL = 1e-5
PROXES = [(1e-3, 0.8), (0.0, 0.0)]            # (l1, clip): on, off
EDGES = ["all", "none", "mixed"]


def _column_inputs(N, d, edges, nan, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(1, d).astype(np.float32)
    w = (3.0 * rng.randn(N, 1, d)).astype(np.float32)
    if edges == "all":
        edge = np.ones((N, 1), bool)
    elif edges == "none":
        edge = np.zeros((N, 1), bool)
    else:
        edge = rng.rand(N, 1) < 0.5
        edge[N - 1, 0] = True                  # the last worker counts
        edge[0, 0] = N == 1                    # one row off the set (N > 1)
    if nan:
        w[N - 1, 0, :3] = np.nan               # reaches the sum where edged
        w[0, 0, 5] = np.nan                    # off the set where mixed
        z[0, 7] = np.inf
    rho = (0.5 + 2.0 * rng.rand(N)).astype(np.float32)
    rho_sum = np.where(edge, rho[:, None], 0.0).sum(0).astype(np.float32)
    return z, w, edge, rho_sum


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("l1,clip", PROXES)
@pytest.mark.parametrize("edges", EDGES)
@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("N", [1, 3, 8, 17, 70])
def test_server_prox_column_matches_reference(N, d, edges, l1, clip, nan):
    z, w, edge, rho_sum = _column_inputs(N, d, edges, nan, seed=N + d)
    port = prox_update.server_prox_update_torch(
        torch.as_tensor(z), torch.as_tensor(w), torch.as_tensor(edge),
        torch.as_tensor(rho_sum), 0.1, l1, clip)
    ref = rprox.server_prox_fused_2d(
        jnp.asarray(z), jnp.asarray(w),
        jnp.asarray(edge[:, :, None].astype(np.float32)),
        jnp.asarray(rho_sum[:, None]), 0.1, l1, clip, interpret=True)
    assert port.shape == (1, d)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=B2_TOL,
                               atol=B2_TOL)
    # the NaN rows reach the result exactly where they are on the edge set
    assert bool(torch.isnan(port[0, :3]).all()) == (nan and bool(edge[N - 1]))
    # and the port's op takes the same route on the CPU
    assert torch.equal(ops.server_prox_update(
        torch.as_tensor(z), torch.as_tensor(w), torch.as_tensor(edge),
        torch.as_tensor(rho_sum), 0.1, l1, clip).nan_to_num(7.0),
        port.nan_to_num(7.0))


def _reference_margin(s, y):
    """The reference's kernel on (m, 1); rows padded with zeros to its
    256-row tile where m > 256 (as its ``logreg_grad`` pads), then cut."""
    m = s.shape[0]
    rows = m if m <= 256 else -(-m // 256) * 256
    pad = ((0, rows - m), (0, 0))
    return np.asarray(rlg.margin(jnp.pad(s, pad), jnp.pad(y, pad),
                                 interpret=True))[:m]


MARGIN_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
              torch.bfloat16: dict(rtol=5e-2, atol=5e-2),
              torch.float16: dict(rtol=5e-2, atol=5e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 1025])
def test_margin_lengths_match_reference(m, dtype):
    rng = np.random.RandomState(m)
    s32 = (4.0 * rng.randn(m, 1)).astype(np.float32)
    y32 = rng.choice([-1.0, 1.0], (m, 1)).astype(np.float32)
    s32[m // 2, 0] = np.nan if m > 2 else s32[m // 2, 0]
    js, jy = jnp.asarray(s32, JNP[dtype]), jnp.asarray(y32, JNP[dtype])
    # the same values in both packages: the reference's rounding of them
    ts = torch.as_tensor(np.asarray(js, np.float32)).to(dtype)
    ty = torch.as_tensor(np.asarray(jy, np.float32)).to(dtype)
    v = ops._margin(ts, ty)
    assert v.dtype == dtype and v.shape == (m, 1)
    ref = _reference_margin(js, jy)
    np.testing.assert_allclose(v.float().numpy(), ref.astype(np.float32),
                               **MARGIN_TOL[dtype])
    # computed in float32 and rounded once
    assert torch.equal(v.float().nan_to_num(7.0),
                       logreg.margin_torch(ts.float(), ty.float())
                       .to(dtype).float().nan_to_num(7.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("offset", range(8))
def test_margin_output_shares_the_inputs_16_byte_phase(offset, dtype):
    """The CUDA wrapper's output for s a view at any element offset: the
    same shape and dtype, contiguous, at s's address modulo 16."""
    base = torch.zeros(40, dtype=dtype)
    s = base[offset:offset + 25].view(5, 5)
    out = logreg.out_like(s)
    assert out.shape == s.shape and out.dtype == dtype
    assert out.is_contiguous()
    assert out.data_ptr() % 16 == s.data_ptr() % 16
