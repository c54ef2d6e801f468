"""The port's kernel ops (``repro_torch.kernels``) against the reference's:
the fused worker update (B1), the fused server update (B2), the
server prox from a reduced w_sum (B3) and the unmasked worker update on
a flat buffer (B4, f32 and bf16).

On the CPU each port op runs its kernel's plain torch version; it is held
against the reference's Pallas kernel in interpret mode (the kernel
flavour: y' = -g, the worker sum in order) and the port's oracles
against ``repro.kernels.ref``, at rtol = atol = 1e-6; the plain
``torch`` backend's epoch steps are held against the port's oracles.
The CUDA kernels
themselves are held to their plain versions in
``test_torch_kernels_cuda.py``, which runs where a card is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core.blocks import make_flat_blocks
from repro_torch.core.prox import make_prox
from repro_torch.core.space import FlatSpace
from repro_torch.kernels import admm_update, ops, prox_update, ref

TOL = 1e-6
SHAPES = [(1, 1, 128), (3, 5, 256), (3, 8, 128), (1, 8, 256), (3, 1, 256)]


def _close(port, reference):
    np.testing.assert_allclose(port.numpy(), np.asarray(reference),
                               rtol=TOL, atol=TOL)


def _worker_inputs(N, M, d, with_x, seed=0, nan=False):
    rng = np.random.RandomState(seed)
    bundles = [rng.randn(N, M, d).astype(np.float32)
               for _ in range(5 if with_x else 4)]
    sel = rng.rand(N, M) < 0.5
    rho = (0.5 + 2.0 * rng.rand(N)).astype(np.float32)     # heterogeneous
    if nan:
        sel[0, 0] = True
        bundles[0][0, 0, :7] = np.nan                       # g, selected row
        bundles[0][0, 0, 7] = np.inf
        if M > 1:
            sel[0, M - 1] = False
            bundles[3][0, M - 1, 3] = np.nan                # w_old, kept row
    g, y, zt, w = bundles[:4]
    x = bundles[4] if with_x else None
    return g, y, zt, w, sel, rho, x


def _server_inputs(N, M, d, seed=0, nan=False):
    rng = np.random.RandomState(seed)
    z = rng.randn(M, d).astype(np.float32)
    w = (3.0 * rng.randn(N, M, d)).astype(np.float32)
    edge = rng.rand(N, M) < 0.6                              # sparse edge set
    if M > 1:
        edge[:, M - 1] = False                  # no workers: mu = gamma
    rho = (0.5 + 2.0 * rng.rand(N)).astype(np.float32)
    rho_sum = np.where(edge, rho[:, None], 0.0).sum(0).astype(np.float32)
    if nan:
        edge[0, 0] = True
        w[0, 0, :5] = np.nan                                 # reaches the sum
        if N > 1:
            edge[1, 0] = False
            w[1, 0, 5] = np.nan                              # off the edge set
        z[0, 9] = np.inf
    return z, w, edge, rho_sum


def _t(*arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape,with_x", [
    (shape, i % 2 == 1) for i, shape in enumerate(SHAPES)] + [
    (SHAPES[1], False)])
def test_worker_select_update_matches_reference(shape, with_x):
    args = _worker_inputs(*shape, with_x)
    port = ops.admm_worker_select_update(*_t(*args))
    kernel = rops.admm_worker_select_update(*_j(*args), interpret=True)
    assert len(port) == len(kernel) == (3 if with_x else 2)
    for p, k in zip(port, kernel):
        _close(p, k)
    # the oracles, unfused form (y' = y + rho (x - z~))
    for p, r in zip(ref.admm_worker_select_update_ref(*_t(*args)),
                    rref.admm_worker_select_update_ref(*_j(*args))):
        _close(p, r)


# the reference's flat-op shapes (every one (8*128)-element aligned)
FLAT_SHAPES = [(1024,), (2048,), (8, 128), (2, 8, 128), (4, 2, 128)]


def _as_dtype(a, dtype):
    """One f32 numpy array as (torch, jax) tensors of ``dtype``; both
    round f32 to bf16 to nearest even, so they hold the same values."""
    if dtype == "float32":
        return torch.as_tensor(a), jnp.asarray(a)
    return torch.as_tensor(a).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("shape", FLAT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rho", [0.5, 100.0])
def test_admm_worker_update_matches_reference(shape, dtype, rho):
    """f32 at 1e-6 against the reference's kernel (interpret mode); bf16
    at the reference's own bf16 tolerance, 4e-2 * max(1, rho): the
    reference rounds g + y to bf16 before the division, the port rounds
    each output once. Both also against the f32 oracle at the
    reference's tolerances for it (``tests/test_kernels.py:32-38``: the
    oracle's unfused y' = y + rho (x - z~) cancels, so f32 is held at
    rtol 1e-5 / atol 1e-4 there)."""
    rng = np.random.RandomState(hash((shape, rho)) % 2**31)
    arrays = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    pairs = [_as_dtype(a, dtype) for a in arrays]
    port = ops.admm_worker_update(*(p[0] for p in pairs), rho)
    kernel = rops.admm_worker_update(*(p[1] for p in pairs), rho,
                                     interpret=True)
    exact = rref.admm_worker_update_ref(
        *(p[1].astype(jnp.float32) for p in pairs), rho)
    if dtype == "float32":
        tol, oracle_tol = dict(rtol=TOL, atol=TOL), dict(rtol=1e-5, atol=1e-4)
    else:
        tol = oracle_tol = dict(rtol=4e-2, atol=4e-2 * max(1.0, rho))
    for p, k, e in zip(port, kernel, exact):
        assert tuple(p.shape) == shape and str(p.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(k, np.float32), **tol)
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(e, np.float32), **oracle_tol)
    # the port's oracle, unfused form, against the reference's
    for p, r in zip(ref.admm_worker_update_ref(*_t(*arrays), rho),
                    rref.admm_worker_update_ref(*_j(*arrays), rho)):
        _close(p, r)


def test_admm_worker_update_y_identity():
    """Eq. 25: y' must equal -g exactly, in both dtypes."""
    g = np.random.RandomState(0).randn(1024).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        tg = torch.as_tensor(g).to(dtype)
        o = torch.ones(1024, dtype=dtype)
        _, yn, _ = ops.admm_worker_update(tg, o, o, 3.0)
        assert torch.equal(yn, -tg)


@pytest.mark.parametrize("shape", [(64,), (7, 33), (3, 5, 17), (513,)])
def test_admm_worker_update_rejects_unaligned(shape):
    """Ragged buffers get no pad copy: the reference's error, naming the
    layout builder that produces aligned tables."""
    a = torch.ones(shape)
    with pytest.raises(ValueError, match="make_flat_blocks"):
        ops.admm_worker_update(a, a, a, 1.0)


def test_admm_worker_update_takes_f32_or_bf16():
    for dtype in (torch.float16, torch.float64):
        a = torch.ones(1024, dtype=dtype)
        with pytest.raises(TypeError, match="bfloat16"):
            ops.admm_worker_update(a, a, a, 1.0)
    a = torch.ones(1024)
    rho = torch.tensor([2.0])                 # a one-element tensor rho
    for p, q in zip(ops.admm_worker_update(a, a, a, rho),
                    ops.admm_worker_update(a, a, a, 2.0)):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="one value"):
        ops.admm_worker_update(a, a, a, torch.ones(2))


PROXES = [(1e-3, 0.8), (0.0, 0.8), (0.05, 0.0), (0.0, 0.0)]


@pytest.mark.parametrize("shape,l1,clip", [
    (shape,) + PROXES[i % len(PROXES)] for i, shape in enumerate(SHAPES)])
def test_server_prox_update_matches_reference(shape, l1, clip):
    z, w, edge, rho_sum = _server_inputs(*shape)
    port = ops.server_prox_update(*_t(z, w, edge, rho_sum), 0.1, l1, clip)
    kernel = rops.server_prox_update(*_j(z, w, edge, rho_sum), gamma=0.1,
                                     l1=l1, clip=clip, interpret=True)
    _close(port, kernel)
    _close(ref.server_prox_update_ref(*_t(z, w, edge, rho_sum), 0.1, l1,
                                      clip),
           rref.server_prox_update_ref(*_j(z, w, edge, rho_sum), 0.1, l1,
                                       clip))
    if clip > 0:
        assert float(port.abs().max()) <= clip + 1e-6


def _prox_inputs(M, d, seed=0, nan=False):
    rng = np.random.RandomState(seed)
    z = rng.randn(M, d).astype(np.float32)
    w_sum = (3.0 * rng.randn(M, d)).astype(np.float32)
    rho_sum = (4.0 * rng.rand(M)).astype(np.float32)
    rho_sum[-1] = 0.0                              # a block with no workers
    if nan:
        w_sum[0, :5] = np.nan
        z[0, 9] = np.inf
    return z, w_sum, rho_sum


@pytest.mark.parametrize("M,d,l1,clip", [
    (1, 128, 1e-3, 0.8), (5, 256, 0.0, 0.8), (8, 128, 0.05, 0.0),
    (64, 128, 0.0, 0.0), (3, 384, 1e-3, 0.8), (16, 128, 1e-3, 0.8)])
def test_prox_consensus_matches_reference(M, d, l1, clip):
    """B3's op, on the CPU its plain version, against the reference's
    Pallas kernel (interpret mode) and both oracles; rho_sum as (M,) and
    as the reference's (M, 1) column."""
    z, w_sum, rho_sum = _prox_inputs(M, d, seed=M)
    port = ops.prox_consensus(*_t(z, w_sum, rho_sum), 0.1, l1, clip)
    kernel = rops.prox_consensus(*_j(z, w_sum, rho_sum), gamma=0.1, l1=l1,
                                 clip=clip, interpret=True)
    _close(port, kernel)
    _close(ops.prox_consensus(*_t(z, w_sum, rho_sum[:, None]), 0.1, l1,
                              clip), kernel)
    _close(ref.prox_consensus_ref(*_t(z, w_sum, rho_sum[:, None]), 0.1, l1,
                                  clip),
           rref.prox_consensus_ref(*_j(z, w_sum, rho_sum[:, None]), 0.1, l1,
                                   clip))
    if clip > 0:
        assert float(port.abs().max()) <= clip + 1e-6


@pytest.mark.parametrize("l1,clip", [(1e-3, 0.8), (0.0, 0.0)])
def test_prox_consensus_propagates_nan(l1, clip):
    z, w_sum, rho_sum = _prox_inputs(5, 256, seed=3, nan=True)
    port = ops.prox_consensus(*_t(z, w_sum, rho_sum), 0.1, l1, clip)
    _close(port, rops.prox_consensus(*_j(z, w_sum, rho_sum), gamma=0.1,
                                     l1=l1, clip=clip, interpret=True))
    assert bool(torch.isnan(port[0, :5]).all())
    assert not bool(torch.isnan(port[0, 5:]).any())


@pytest.mark.parametrize("shape,l1,clip", [
    (SHAPES[1], 1e-3, 0.8), (SHAPES[2], 0.0, None), (SHAPES[4], 0.05, 0.8)])
def test_torch_backend_matches_the_oracles(shape, l1, clip):
    """The plain ``torch`` backend's two epoch steps (core/admm.py and the
    select; the worker sum and core/prox.py) against the port's unfused
    oracles in ``kernels/ref.py``."""
    N, M, d = shape
    space = FlatSpace(make_flat_blocks(M * d, M), N, backend="torch")
    g, y, zt, w, sel, rho, x = _t(*_worker_inputs(N, M, d, with_x=True))
    got = space.worker_select_update(g, y, zt, w, x, sel, rho, track_x=True)
    for p, r in zip(got, ref.admm_worker_select_update_ref(g, y, zt, w, sel,
                                                           rho, x)):
        _close(p, r)
    z, w, edge, rho_sum = _t(*_server_inputs(N, M, d))
    got = space.server_consensus_update(z, w, edge, rho_sum, 0.1,
                                        make_prox(l1, clip))
    _close(got, ref.server_prox_update_ref(z, w, edge, rho_sum, 0.1, l1,
                                           clip or 0.0))
    z, w_sum, rho_sum = _t(*_prox_inputs(M, d))
    got = space.server_prox(z, w_sum, rho_sum, 0.1, make_prox(l1, clip))
    _close(got, ref.prox_consensus_ref(z, w_sum, rho_sum[:, None], 0.1, l1,
                                       clip or 0.0))


def test_nan_propagates_like_the_reference():
    """A NaN reaching the update or the worker sum stays NaN (the
    finite-check watchdog must see it); one masked off does not leak."""
    args = _worker_inputs(3, 5, 256, with_x=True, seed=3, nan=True)
    port = ops.admm_worker_select_update(*_t(*args))
    kernel = rops.admm_worker_select_update(*_j(*args), interpret=True)
    for p, k in zip(port, kernel):
        _close(p, k)                            # NaN where the reference is
    assert bool(torch.isnan(port[1][0, 0, :7]).all())
    assert bool(torch.isnan(port[1][0, 4, 3]))
    z, w, edge, rho_sum = _server_inputs(3, 5, 256, seed=3, nan=True)
    for l1, clip in [(1e-3, 0.8), (0.0, 0.0)]:
        port = ops.server_prox_update(*_t(z, w, edge, rho_sum), 0.1, l1, clip)
        kernel = rops.server_prox_update(*_j(z, w, edge, rho_sum), gamma=0.1,
                                         l1=l1, clip=clip, interpret=True)
        _close(port, kernel)
        assert bool(torch.isnan(port[0, :5]).all())
        assert not bool(torch.isnan(port[0, 5]))


@pytest.mark.parametrize("op", ["admm_worker_select_update",
                                "server_prox_update", "prox_consensus"])
def test_ops_reject_ragged_rows(op):
    """d % 128 != 0 raises the reference's layout-pointing ValueError."""
    a3 = torch.ones((2, 4, 129))
    sel = torch.ones((2, 4), dtype=torch.bool)
    rho = torch.ones(2)
    with pytest.raises(ValueError, match=f"{op}.*129"):
        if op == "admm_worker_select_update":
            ops.admm_worker_select_update(a3, a3, a3, a3, sel, rho)
        elif op == "server_prox_update":
            ops.server_prox_update(a3[0], a3, sel, torch.ones(4), 0.1)
        else:
            ops.prox_consensus(a3[0], a3[0], torch.ones(4), 0.1)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    ops.reset_launch_counts()
    g, y, zt, w, sel, rho, x = _t(*_worker_inputs(3, 5, 256, with_x=True))
    out = ops.admm_worker_select_update(g, y, zt, w, sel, rho, x)
    plain = admm_update.admm_worker_select_update_torch(g, y, zt, w, sel,
                                                        rho, x)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    z, w2, edge, rho_sum = _t(*_server_inputs(3, 5, 256))
    assert torch.equal(
        ops.server_prox_update(z, w2, edge, rho_sum, 0.1, 1e-3, 0.8),
        prox_update.server_prox_update_torch(z, w2, edge, rho_sum, 0.1, 1e-3,
                                             0.8))
    z, w_sum, rho_sum = _t(*_prox_inputs(5, 256))
    assert torch.equal(
        ops.prox_consensus(z, w_sum, rho_sum, 0.1, 1e-3, 0.8),
        prox_update.prox_consensus_torch(z, w_sum, rho_sum, 0.1, 1e-3, 0.8))
    flat = [t.reshape(-1)[:1024] for t in (g, y, zt)]
    assert all(torch.equal(a, b) for a, b in zip(
        ops.admm_worker_update(*flat, 2.0),
        admm_update.admm_worker_update_torch(*flat, 2.0)))
    assert ops.launch_counts() == {"admm_worker_select_update": 0,
                                   "admm_worker_update": 0,
                                   "server_prox_update": 0,
                                   "prox_consensus": 0,
                                   "matmul": 0, "margin": 0,
                                   "flash_attention": 0}
    with pytest.raises(ValueError, match="CUDA"):
        admm_update.admm_worker_update_cuda(*flat, 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        admm_update.admm_worker_select_update_cuda(g, y, zt, w, sel, rho, x)
    with pytest.raises(ValueError, match="CUDA"):
        prox_update.server_prox_update_cuda(z, w2, edge, rho_sum, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        prox_update.prox_consensus_cuda(z, w_sum, rho_sum, 0.1)
