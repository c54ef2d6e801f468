"""The CUDA kernels (B1-B6) against their plain torch versions, on the
card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports neither JAX nor the reference, so it runs on a
machine that has only torch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: max|kernel - plain| <= 1e-6 * (1 + max|plain|), with NaN and
Inf at the same places. The elementwise kernels round as the plain
versions do (no FMA contraction, IEEE division, expf), so in practice
they agree exactly. The matmul (B5) sums in another order than cuBLAS,
so it is held against a float64 product instead: its largest error
there at most 8 times the plain fp32 result's own (or 8 * 2^-22 of the
largest exact entry, where that is larger).
"""
import pytest
import torch

from repro_torch.api import ConsensusSession
from repro_torch.configs.base import ADMMConfig
from repro_torch.kernels import admm_update, logreg, ops, prox_update

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 128), (3, 5, 256), (3, 8, 128), (1, 8, 256), (3, 1, 256),
          (8, 16, 128), (8, 64, 4096)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _agree(kernel, plain):
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(kernel), torch.isnan(plain))
    fin = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(kernel), fin)
    assert torch.equal(kernel[~fin & ~torch.isnan(plain)],
                       plain[~fin & ~torch.isnan(plain)])
    if bool(fin.any()):
        err = (kernel[fin] - plain[fin]).abs().max()
        assert float(err) <= 1e-6 * (1 + float(plain[fin].abs().max()))


def _worker_case(gen, N, M, d, with_x, nan):
    b = [torch.randn((N, M, d), generator=gen, device="cuda")
         for _ in range(5)]
    sel = torch.rand((N, M), generator=gen, device="cuda") < 0.5
    rho = 0.5 + 2.0 * torch.rand((N,), generator=gen, device="cuda")
    if nan:
        sel[0, 0] = True
        b[0][0, 0, :3] = float("nan")
        b[0][0, 0, 3] = float("inf")
    return b[0], b[1], b[2], b[3], sel, rho, (b[4] if with_x else None)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("with_x", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_worker_kernel_matches_plain(gen, shape, with_x, nan):
    case = _worker_case(gen, *shape, with_x, nan)
    ks = admm_update.admm_worker_select_update_cuda(*case)
    ps = admm_update.admm_worker_select_update_torch(*case)
    assert len(ks) == len(ps) == (3 if with_x else 2)
    for k, p in zip(ks, ps):
        _agree(k, p)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("l1,clip", [(1e-3, 0.8), (0.0, 0.8), (0.05, 0.0),
                                     (0.0, 0.0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_server_kernel_matches_plain(gen, shape, l1, clip, nan):
    N, M, d = shape
    z = torch.randn((M, d), generator=gen, device="cuda")
    w = torch.randn((N, M, d), generator=gen, device="cuda")
    edge = torch.rand((N, M), generator=gen, device="cuda") < 0.6
    if M > 1:
        edge[:, M - 1] = False                  # a block without workers
    rho_sum = torch.rand((M,), generator=gen, device="cuda") * edge.sum(0)
    if nan:
        edge[0, 0] = True
        w[0, 0, :3] = float("nan")
        z[0, 3] = float("inf")
    _agree(prox_update.server_prox_update_cuda(z, w, edge, rho_sum, 0.1, l1,
                                               clip),
           prox_update.server_prox_update_torch(z, w, edge, rho_sum, 0.1, l1,
                                                clip))


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("l1,clip", [(1e-3, 0.8), (0.0, 0.8), (0.05, 0.0),
                                     (0.0, 0.0)])
@pytest.mark.parametrize("shape", SHAPES + [(1, 64, 128)])
def test_prox_consensus_kernel_matches_plain(gen, shape, l1, clip, nan):
    _, M, d = shape
    z = torch.randn((M, d), generator=gen, device="cuda")
    w_sum = 3.0 * torch.randn((M, d), generator=gen, device="cuda")
    rho_sum = 4.0 * torch.rand((M,), generator=gen, device="cuda")
    rho_sum[-1] = 0.0                           # a block without workers
    if nan:
        w_sum[0, :3] = float("nan")
        w_sum[-1, 1] = float("inf")
        z[0, 3] = float("inf")
        z[-1, 5] = float("-inf")
    _agree(prox_update.prox_consensus_cuda(z, w_sum, rho_sum, 0.1, l1, clip),
           prox_update.prox_consensus_torch(z, w_sum, rho_sum, 0.1, l1,
                                            clip))


def test_kernels_refuse_bad_tensors(gen):
    g = torch.randn((2, 3, 128), generator=gen, device="cuda")
    sel = torch.ones((2, 3), dtype=torch.bool, device="cuda")
    rho = torch.ones(2, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        admm_update.admm_worker_select_update_cuda(
            g, g, g.transpose(0, 1).contiguous().transpose(0, 1), g, sel,
            rho)
    with pytest.raises(ValueError, match="float32"):
        admm_update.admm_worker_select_update_cuda(g, g.double(), g, g, sel,
                                                   rho)
    with pytest.raises(ValueError, match="sel"):
        admm_update.admm_worker_select_update_cuda(g, g, g, g, sel.float(),
                                                   rho)
    with pytest.raises(ValueError, match="rho_sum"):
        prox_update.server_prox_update_cuda(g[0], g, sel, torch.ones(
            4, device="cuda"), 0.1)
    with pytest.raises(ValueError, match="w_sum"):
        prox_update.prox_consensus_cuda(g[0], g[0].T.contiguous().T,
                                        torch.ones(3, device="cuda"), 0.1)
    with pytest.raises(ValueError, match="rho_sum"):
        prox_update.prox_consensus_cuda(g[0], g[0], rho[:2].double(), 0.1)


def test_session_on_the_card_goes_through_the_kernels(gen):
    """``ConsensusSession.flat`` defaults to the card and the kernels, and
    its z follows the plain torch backend's."""
    N, M, dim = 4, 8, 2000
    centers = torch.randn((N, dim), generator=gen, device="cuda")
    cfg = ADMMConfig(rho=2.0, gamma=0.1, max_delay=1, block_fraction=0.5,
                     num_blocks=M, l1_coef=1e-3, clip=1.0, seed=0)

    def loss(z, c):
        return 0.5 * torch.sum(torch.square(z - c))

    zs = {}
    for backend in ("auto", "torch"):
        sess = ConsensusSession.flat(loss, centers, dim=dim, cfg=cfg,
                                     backend=backend)
        ops.reset_launch_counts()
        state = sess.init()
        for _ in range(5):
            state, _ = sess.step(state)
        zs[backend] = sess.z(state)
        expect = 5 if backend == "auto" else 0
        assert ops.launch_counts() == {"admm_worker_select_update": expect,
                                       "admm_worker_update": 0,
                                       "server_prox_update": expect,
                                       "prox_consensus": 0,
                                       "matmul": 0, "margin": 0}
    torch.testing.assert_close(zs["auto"], zs["torch"], rtol=1e-5, atol=1e-5)


FLAT_SHAPES = [(1024,), (2048,), (8, 128), (2, 8, 128), (4, 2, 128),
               (8, 64, 4096)]


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rho", [0.5, 100.0])
@pytest.mark.parametrize("shape", FLAT_SHAPES)
def test_worker_update_kernel_matches_plain(gen, shape, rho, dtype, nan):
    g, y, z = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    if nan:
        g.view(-1)[:3] = float("nan")
        y.view(-1)[5] = float("inf")
        z.view(-1)[7] = float("-inf")
    ops.reset_launch_counts()
    ks = ops.admm_worker_update(g, y, z, rho)
    assert ops.launch_counts()["admm_worker_update"] == 1
    ps = admm_update.admm_worker_update_torch(g, y, z, rho)
    for k, p in zip(ks, ps):
        assert k.dtype == dtype and k.shape == g.shape
        _agree(k.float(), p.float())
    torch.testing.assert_close(ks[1], -g, rtol=0, atol=0, equal_nan=True)


def _f64_errors(c, plain, a, b, transpose_a):
    """max|c - exact| and max|plain - exact| over the finite entries of
    the float64 product, and the largest of them."""
    exact = (a.double().T if transpose_a else a.double()) @ b.double()
    fin = torch.isfinite(exact)
    if not bool(fin.any()):
        return 0.0, 0.0, 0.0
    return tuple(float(t[fin].abs().max()) for t in
                 (c.double() - exact, plain.double() - exact, exact))


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (100, 50, 30), (129, 257, 65),
                                   (129, 257, 1), (1000, 3000, 1),
                                   (1, 1, 1), (5, 0, 3)])
def test_matmul_kernel_within_float64_bound(gen, m, k, n, transpose_a, nan):
    a = torch.randn((k, m) if transpose_a else (m, k), generator=gen,
                    device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    if nan and k > 1 and n > 2:
        a[0, 0] = float("nan")
        b[1, 2] = float("inf")
    ops.reset_launch_counts()
    c = ops.matmul(a, b, transpose_a=transpose_a)
    assert ops.launch_counts()["matmul"] == 1
    assert c.shape == (m, n) and c.dtype == torch.float32
    plain = logreg.matmul_torch(a, b, transpose_a)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(c), torch.isnan(plain))
    assert torch.equal(torch.isinf(c), torch.isinf(plain))
    err, plain_err, scale = _f64_errors(c, plain, a, b, transpose_a)
    assert err <= 8 * max(plain_err, 2.0 ** -22 * scale)
    # the fixed-order sum repeats bit for bit
    torch.testing.assert_close(ops.matmul(a, b, transpose_a=transpose_a), c,
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("shape", [(1, 1), (129, 1), (256, 128), (1000, 3),
                                   (1 << 20, 1)])
def test_margin_kernel_matches_plain(gen, shape):
    s = 4.0 * torch.randn(shape, generator=gen, device="cuda")
    y = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5,
                    -1.0, 1.0)
    flat_s, flat_y = s.view(-1), y.view(-1)
    extremes = [1e4, -1e4, 100.0, -100.0, 89.0, -89.0, float("nan")]
    n = min(len(extremes), flat_s.numel())
    flat_s[:n] = torch.tensor(extremes[:n], device="cuda")
    ops.reset_launch_counts()
    v = ops._margin(s, y)
    assert ops.launch_counts()["margin"] == 1
    _agree(v, logreg.margin_torch(s, y))
    assert bool(torch.isnan(v).eq(torch.isnan(s)).all())


def test_logreg_grad_on_the_card_launches_the_kernels(gen):
    m, d = 3000, 700
    X = torch.randn((m, d), generator=gen, device="cuda")
    X *= torch.rand((m, d), generator=gen, device="cuda") < 0.1
    y = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.5,
                    -1.0, 1.0)
    w = 0.05 * torch.randn(d, generator=gen, device="cuda")
    ops.reset_launch_counts()
    g = ops.logreg_grad(X, y, w)
    counts = ops.launch_counts()
    assert (counts["matmul"], counts["margin"]) == (2, 1)
    w_req = w.clone().requires_grad_(True)
    loss = torch.mean(torch.log1p(torch.exp(-y * (X @ w_req))))
    (g_auto,) = torch.autograd.grad(loss, w_req)
    torch.testing.assert_close(g, g_auto, rtol=1e-4, atol=1e-5)


def test_logreg_kernels_refuse_bad_tensors(gen):
    a = torch.randn((8, 4), generator=gen, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        logreg.matmul_cuda(a.double(), a.T.contiguous().double())
    with pytest.raises(TypeError, match="float32"):
        logreg.margin_cuda(a.half(), a.half())
    with pytest.raises(ValueError, match="contiguous"):
        logreg.matmul_cuda(a.T, a)
    with pytest.raises(ValueError, match="inner sizes"):
        logreg.matmul_cuda(a, a)
    with pytest.raises(ValueError, match="shape"):
        logreg.margin_cuda(a, a[:4])
    with pytest.raises(TypeError, match="bfloat16"):
        admm_update.admm_worker_update_cuda(*(torch.ones(
            1024, dtype=torch.float16, device="cuda") for _ in range(3)), 1.0)
