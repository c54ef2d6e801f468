"""The CUDA kernels (B1-B7) against their plain torch versions, on the
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
largest exact entry, where that is larger). Flash attention (B7) sums
in another order than its plain version (the full softmax) and is held
to float64 attention by the same rule. In bfloat16 both are held to the
float64 result of the same (bf16) inputs, where the plain result's own
error is its rounding to bf16; B7 in 16 bits is also held row by row
(each row's limit from that row's plain error, or the type's unit
roundoff of the row's largest entry), as chip_smoke.py holds it.
"""
import copy

import pytest
import torch

from repro_torch.api import ConsensusSession
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ADMMConfig
from repro_torch.kernels import (admm_update, flash_attention, logreg, ops,
                                 prox_update)
from repro_torch.models import build_model

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


def _bitwise(kernel, plain):
    """The same values bit for bit, NaN where the other has NaN."""
    torch.cuda.synchronize()
    nan = torch.isnan(plain)
    assert kernel.dtype == plain.dtype
    assert torch.equal(torch.isnan(kernel), nan)
    bits = {2: torch.int16, 4: torch.int32}[plain.element_size()]
    assert torch.equal(kernel[~nan].view(bits), plain[~nan].view(bits))


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("edges", ["all", "none", "mixed"])
@pytest.mark.parametrize("N", [1, 8, 17, 70])
def test_server_kernel_on_one_column(gen, N, edges, nan):
    """B2 at the PS runtime's commit shape (N, 1, 315,904): groups of 8
    rows loaded together, ragged and whole, and a second 64-bit edge mask
    at N = 70. Without l1 the kernel is the plain version bit for bit;
    with it, within 1e-6 (the plain soft threshold takes l1 / mu as
    l1 * (1 / mu), an ulp off the kernel's IEEE division)."""
    d = 315_904
    z = torch.randn((1, d), generator=gen, device="cuda")
    w = torch.randn((N, 1, d), generator=gen, device="cuda")
    if edges == "mixed":
        edge = torch.rand((N, 1), generator=gen, device="cuda") < 0.5
        edge[N - 1] = True
        edge[0] = N == 1
    else:
        edge = torch.full((N, 1), edges == "all", dtype=torch.bool,
                          device="cuda")
    if nan:
        w[N - 1, 0, :3] = float("nan")
        w[0, 0, 5] = float("nan")
        z[0, 7] = float("inf")
    rho_sum = 0.5 + torch.rand((1,), generator=gen, device="cuda") * N
    for l1, clip in ((0.0, 0.0), (0.0, 0.8), (1e-3, 0.8)):
        ops.reset_launch_counts()
        k = ops.server_prox_update(z, w, edge, rho_sum, 0.1, l1, clip)
        assert ops.launch_counts()["server_prox_update"] == 1
        p = prox_update.server_prox_update_torch(z, w, edge, rho_sum, 0.1,
                                                 l1, clip)
        if l1 == 0.0:
            _bitwise(k, p)
        else:
            _agree(k, p)


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
                                       "matmul": 0, "margin": 0,
                                       "flash_attention": 0}
    torch.testing.assert_close(zs["auto"], zs["torch"], rtol=1e-5, atol=1e-5)



def test_server_crash_replay_on_the_kernels_is_bitwise(gen):
    """A PS run whose block server 1 crashes and comes back by WAL
    replay, on the kernels: B1 once per worker compute, B2 once per
    block commit and once per replayed block version; its trace replays
    through the epoch on the kernels with z bitwise equal at every
    round."""
    from repro_torch import ps
    N, M, rounds = 3, 4, 8
    centers = torch.randn((N, M * 128), generator=gen, device="cuda")
    cfg = ADMMConfig(rho=2.0, gamma=0.1, max_delay=2, block_fraction=0.5,
                     num_blocks=M, l1_coef=1e-3, clip=0.8, seed=0)

    def loss(z, c):
        return 0.5 * torch.sum(torch.square(z - c))

    def session(delay_model=None):
        return ConsensusSession.flat(loss, centers, dim=M * 128, cfg=cfg,
                                     delay_model=delay_model)

    timing = ps.CostProfile(t_worker=ps.ConstantService(1.0),
                            t_server_block=ps.ConstantService(0.25))
    plan = ps.FaultPlan.of(ps.FaultPlan.server_crash(1, at=2.0, down=3.0))
    ops.reset_launch_counts()
    res = session().run_ps(rounds, timing=timing, faults=plan)
    launches = ops.launch_counts()
    replayed = sum(e["replayed"] for e in res.trace.events
                   if e["kind"] == "server_recover")
    assert res.metrics["server_recoveries"] == 1 and replayed >= 1
    assert launches["admm_worker_select_update"] \
        == res.metrics["worker_iterations"]
    assert launches["server_prox_update"] == M * rounds + replayed
    replay = session(res.to_delay_model())
    state = replay.init()
    for t in range(rounds):
        state, _ = replay.step(state)
        assert torch.equal(replay.z(state), res.z_versions[t + 1]), t


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
        logreg.margin_cuda(a.double(), a.double())
    with pytest.raises(TypeError, match="one dtype"):
        logreg.matmul_cuda(a.half(), a.T.contiguous().bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        logreg.matmul_cuda(a.T, a)
    with pytest.raises(ValueError, match="inner sizes"):
        logreg.matmul_cuda(a, a)
    with pytest.raises(ValueError, match="shape"):
        logreg.margin_cuda(a, a[:4])
    with pytest.raises(TypeError, match="bfloat16"):
        admm_update.admm_worker_update_cuda(*(torch.ones(
            1024, dtype=torch.float16, device="cuda") for _ in range(3)), 1.0)


def _within_f64_rule(out, plain, exact):
    """B5's rule: max|out - exact| <= 8 * max(max|plain - exact|,
    2^-22 * max|exact|), over the entries finite in float64."""
    fin = torch.isfinite(exact)
    if not bool(fin.any()):
        return
    err, plain_err, scale = (float(t[fin].abs().max()) for t in
                             (out.double() - exact, plain.double() - exact,
                              exact))
    assert err <= 8 * max(plain_err, 2.0 ** -22 * scale), (err, plain_err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (129, 257, 65),
                                   (129, 257, 1), (1000, 3000, 1)])
def test_matmul_kernel_takes_16_bit_types(gen, m, k, n, transpose_a, dtype):
    a = torch.randn((k, m) if transpose_a else (m, k), generator=gen,
                    device="cuda").to(dtype)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    ops.reset_launch_counts()
    c = ops.matmul(a, b, transpose_a=transpose_a)
    assert ops.launch_counts()["matmul"] == 1
    assert c.shape == (m, n) and c.dtype == dtype
    plain = logreg.matmul_torch(a, b, transpose_a)
    exact = (a.double().T if transpose_a else a.double()) @ b.double()
    _within_f64_rule(c, plain, exact)


def _within_f64_entry_rule(out, plain, exact, scale):
    """B5's rule entry by entry, as chip_smoke.py holds 16-bit results:
    |out - exact| <= 8 * max(|plain - exact|, 2^-22 * scale) at each
    entry finite in float64 and in the plain result, scale = |A| |B| in
    float64."""
    fin = torch.isfinite(exact) & torch.isfinite(plain.double())
    err = (out.double() - exact).abs()[fin]
    limit = 8 * torch.maximum((plain.double() - exact).abs()[fin],
                              2.0 ** -22 * scale[fin])
    assert bool((err <= limit).all()), float((err / limit).max())


def _expected_design(m, k, n, transpose_a, dtype):
    """The design of B5 that csrc/logreg_grad.cu's plan picks for
    contiguous operands on 16-byte boundaries (as torch allocates them):
    by N, the element type and whether A's rows and N allow TMA's or
    cp.async's 16-byte strides."""
    lead = m if transpose_a else k          # A's stored row, elements
    if n == 1:
        half = dtype != torch.float32
        return "gemv16" if half and k > 0 and lead % 8 == 0 else "gemv"
    if k == 0:
        return "tiled"
    if dtype == torch.float32:
        return "tf32x3" if lead % 4 == 0 and n % 4 == 0 else "tiled"
    return "wgmma" if lead % 8 == 0 and n % 8 == 0 else "tiled"


# chip_smoke.py's MATMUL_SHAPES: the reference's four, the gradient
# passes' N = 1, and for the tensor-core designs a tile multiple and a
# ragged shape
DESIGN_SHAPES = [(128, 128, 128), (256, 384, 128), (100, 50, 30),
                 (129, 257, 65), (129, 257, 1), (1000, 3000, 1),
                 (96, 1024, 1), (1024, 96, 1), (384, 512, 512),
                 (200, 136, 264)]


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("m,k,n", DESIGN_SHAPES)
def test_matmul_designs_within_float64_bound(gen, m, k, n, transpose_a,
                                             dtype, nan):
    """Each of B5's designs: the one the shape and type call for runs
    (one launch), NaN and Inf fall where the plain version has them, the
    result is within B5's rule of float64 and a second call repeats it
    bit for bit."""
    a = torch.randn((k, m) if transpose_a else (m, k), generator=gen,
                    device="cuda").to(dtype)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    if nan and k > 1 and n > 2:
        a[0, 0] = float("nan")
        b[1, 2] = float("inf")
    ops.reset_launch_counts()
    c = ops.matmul(a, b, transpose_a=transpose_a)
    assert ops.launch_counts()["matmul"] == 1
    ran = {d: v for d, v in ops.matmul_design_counts().items() if v}
    assert ran == {_expected_design(m, k, n, transpose_a, dtype): 1}
    assert c.shape == (m, n) and c.dtype == dtype
    plain = logreg.matmul_torch(a, b, transpose_a)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(c), torch.isnan(plain))
    assert torch.equal(torch.isinf(c), torch.isinf(plain))
    a64 = a.double().T if transpose_a else a.double()
    exact = a64 @ b.double()
    _within_f64_rule(c, plain, exact)
    if dtype != torch.float32:
        _within_f64_entry_rule(c, plain, exact, a64.abs() @ b.double().abs())
    torch.testing.assert_close(ops.matmul(a, b, transpose_a=transpose_a), c,
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_misaligned_operands_take_designs_without_tma(gen, dtype):
    """A contiguous A one element past a 16-byte boundary: N > 1 takes
    the tiled kernel and N = 1 the one-element-a-load gemv."""
    m = k = 128
    flat = torch.randn(m * k + 1, generator=gen, device="cuda").to(dtype)
    a = flat[1:].view(m, k)
    for n, design in ((128, "tiled"), (1, "gemv")):
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        ops.reset_launch_counts()
        c = ops.matmul(a, b)
        ran = {d: v for d, v in ops.matmul_design_counts().items() if v}
        assert ran == {design: 1}
        _within_f64_rule(c, logreg.matmul_torch(a, b),
                         a.double() @ b.double())


def test_logreg_grad_bf16_on_the_card_takes_gemv16(gen):
    """``ops.logreg_grad`` in bf16 (d a multiple of 8): B5's gemv16
    design for both passes and B6 once; the gradient within B5's rule of
    the float64 gradient of the same bf16 inputs."""
    m, d = 3000, 704
    X = torch.randn((m, d), generator=gen, device="cuda")
    X *= torch.rand((m, d), generator=gen, device="cuda") < 0.1
    X = X.bfloat16()
    y = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.5,
                    -1.0, 1.0).bfloat16()
    w = (0.05 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    ops.reset_launch_counts()
    g = ops.logreg_grad(X, y, w)
    counts = ops.launch_counts()
    assert (counts["matmul"], counts["margin"]) == (2, 1)
    assert ops.matmul_design_counts()["gemv16"] == 2
    assert g.dtype == torch.bfloat16 and g.shape == (d,)
    s = logreg.matmul_torch(X, w[:, None])
    plain = logreg.matmul_torch(
        X, logreg.margin_torch(s, y[:, None]), True)[:, 0] / m
    X64, y64 = X.double(), y.double()
    s64 = X64 @ w.double()
    v64 = -y64 * torch.sigmoid(-y64 * s64)
    exact = X64.T @ v64 / m
    _within_f64_rule(g, plain, exact)
    _within_f64_entry_rule(g, plain, exact, X64.abs().T @ v64.abs() / m)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(129, 1), (1000, 3), (1 << 20, 1)])
def test_margin_kernel_takes_16_bit_types(gen, shape, dtype):
    s = (4.0 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    y = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5,
                    -1.0, 1.0).to(dtype)
    s.view(-1)[:2] = torch.tensor([float("nan"), 100.0], device="cuda")
    v = ops._margin(s, y)
    assert v.dtype == dtype
    _agree(v.float(), logreg.margin_torch(s, y).float())


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("n", [1, 7, 8, 9, (1 << 20) + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_margin_kernel_at_lengths_and_offsets(gen, dtype, n, offset):
    """B6 on views that start ``offset`` elements into their buffers:
    the elements before the first 16-byte word and after the last one
    one at a time, the words between whole; y also at another 16-byte
    phase than s. Bit for bit the plain version."""
    s = (4.0 * torch.randn(n + 8, generator=gen, device="cuda")).to(dtype)
    y = torch.where(torch.rand(n + 8, generator=gen, device="cuda") < 0.5,
                    -1.0, 1.0).to(dtype)
    s[offset] = float("nan")
    s[offset + n - 1] = 100.0
    sv = s[offset:offset + n]
    for yv in (y[offset:offset + n], y[(offset + 1) % 8:][:n]):
        ops.reset_launch_counts()
        v = ops._margin(sv, yv)
        assert ops.launch_counts()["margin"] == 1
        assert v.shape == (n,) and v.data_ptr() % 16 == sv.data_ptr() % 16
        _bitwise(v, logreg.margin_torch(sv, yv))


def _within_f64_row_rule(out, plain, exact):
    """B7's 16-bit rule, row by row (chip_smoke.py's f64_row_limits): a
    row's max|out - exact| <= 8 * max(the plain result's in that row,
    the type's unit roundoff * the row's max|exact|), over the entries
    finite in float64."""
    unit = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}[
        plain.dtype]
    fin = torch.isfinite(exact)
    err, plain_err, scale = (torch.where(fin, t.abs(), 0.0).amax(-1) for t in
                             (out.double() - exact, plain.double() - exact,
                              exact))
    limit = 8 * torch.maximum(plain_err, unit * scale)
    assert bool((err <= limit).all()), float((err / limit).max())


def _f64_attention(q, k, v, causal, scale):
    """Attention in float64, one head at a time."""
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    S, T = q.shape[1], k.shape[1]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril()
    for h in range(q.shape[0]):
        s = (q[h].double() @ k[h].double().T) * scale
        if causal:
            s = torch.where(mask, s, -1e30)
        out[h] = torch.softmax(s, dim=-1) @ v[h].double()
    return out


def _attention_case(gen, BH, S, T, hd, dtype, nan):
    q, k, v = (torch.randn((BH, n, hd), generator=gen, device="cuda")
               .to(dtype) for n in (S, T, T))
    if nan:
        q[0, S // 2, 3] = float("nan")           # one query row
        k[-1, T // 3, 5] = float("nan")          # one key, last head
        v[0, min(T, 64) - 1, 7] = float("inf")   # a key of the first tile
    return q, k, v


# the reference test's shapes, ragged S and T, S != T, and S and T at the
# tile edges of the two designs (128-row q tiles and 128- or 64-key tiles
# in 16 bits, 64-row q tiles and 32-key tiles in float32)
ATTN_SHAPES = [(2, 128, 128, 128), (4, 256, 256, 128), (1, 512, 512, 256),
               (3, 384, 384, 128), (2, 100, 100, 128), (1, 65, 200, 128),
               (2, 300, 70, 256), (2, 127, 127, 128), (1, 129, 129, 128),
               (2, 255, 257, 128), (1, 257, 255, 128), (1, 129, 127, 256),
               (2, 255, 128, 256), (1, 127, 257, 256)]


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,S,T,hd", ATTN_SHAPES)
def test_flash_attention_kernel_within_float64_bound(gen, BH, S, T, hd,
                                                     causal, dtype, nan):
    q, k, v = _attention_case(gen, BH, S, T, hd, dtype, nan)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal)
    assert ops.launch_counts()["flash_attention"] == 1
    assert out.shape == q.shape and out.dtype == dtype
    plain = flash_attention.flash_attention_torch(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(out), torch.isnan(plain))
    assert torch.equal(torch.isinf(out), torch.isinf(plain))
    exact = _f64_attention(q, k, v, causal, hd ** -0.5)
    _within_f64_rule(out, plain, exact)
    if dtype != torch.float32:
        _within_f64_row_rule(out, plain, exact)
    # no atomics: a second call repeats the first bit for bit
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal), out,
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "chatglm3-6b"])
def test_flash_prefill_on_the_card_launches_b7_per_layer(gen, arch, dtype):
    cfg = get_smoke(arch).with_(dtype=dtype, param_dtype=dtype)
    params = build_model(cfg).init(0)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                        device="cuda")
    ref = build_model(cfg).prefill(params, tok)
    ops.reset_launch_counts()
    out = build_model(cfg.with_(attn_impl="flash")).prefill(params, tok)
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    assert out.dtype == ref.dtype
    if dtype == "float32":
        assert float((out - ref).abs().max()) < 2e-3
        return
    # bf16: both paths against the f32 prefill of the same (bf16-rounded)
    # weights; the flash path within twice the naive path's error plus
    # one bf16 ulp of the largest logit (the ratio of the serve phase)
    cfg32 = cfg.with_(dtype="float32", param_dtype="float32")
    exact = build_model(cfg32).prefill(copy.deepcopy(params).float(), tok)
    naive_err = float((ref.float() - exact).abs().max())
    flash_err = float((out.float() - exact).abs().max())
    assert flash_err <= 2 * naive_err + 2.0 ** -7 * float(exact.abs().max())


def test_flash_kernel_refuses_bad_tensors(gen):
    q = torch.randn((2, 64, 128), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_cuda(q[..., :64].contiguous(),
                                             q[..., :64].contiguous(),
                                             q[..., :64].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_cuda(q, q.transpose(0, 1)
                                             .contiguous().transpose(0, 1), q)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention.flash_attention_cuda(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention.flash_attention_cuda(q, q[:1], q[:1])
    # TMA and cp.async copy 16-byte units: a contiguous view that starts
    # off a 16-byte boundary is refused, in every dtype
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        flat = torch.zeros(2 * 64 * 128 + 1, dtype=dtype, device="cuda")
        shifted = flat[1:].view(2, 64, 128)
        assert shifted.is_contiguous()
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention.flash_attention_cuda(shifted, q.to(dtype),
                                                 q.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pytree_session_on_the_card_launches_b1_b2_per_epoch(gen, dtype):
    """``ConsensusSession.pytree`` on the qwen3-1.7b smoke config's
    stacked tree (leaves in ``dtype``): B1 (no x) and B2 once an epoch,
    z within the kernels' rule of the plain backend's at every epoch
    (bf16 leaves: from epoch 2 at the reference's bf16 tolerance,
    tests/test_kernels.py:37), pad lanes exactly 0, z back in the
    leaves' dtype."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.weights import stacked_params

    cfg = get_smoke("qwen3-1.7b")
    params = tree_map(lambda t: t.to(dtype), stacked_params(cfg, 0, "cuda"))
    c = tree_leaves(stacked_params(cfg, 1, "cuda"))

    def loss(p, a):
        return 0.5 * sum(torch.sum(torch.square(x.float() - a * cx))
                         for x, cx in zip(tree_leaves(p), c))
    admm = ADMMConfig(rho=2.0, gamma=0.1, max_delay=1, block_fraction=0.5,
                      num_blocks=3, l1_coef=1e-3, clip=1.0, seed=0)
    a = torch.tensor([0.5, 1.5], device="cuda")
    runs = {}
    for backend in ("cuda", "torch"):
        sess = ConsensusSession.pytree(loss, params, admm, num_workers=2,
                                       backend=backend)
        pad = ~torch.as_tensor(sess.spec.space.layout.padding_mask(),
                               device="cuda")
        ops.reset_launch_counts()
        state, zs = sess.init(), []
        for _ in range(4):
            state, _ = sess.step(state, a)
            for t in (state.z_hist, state.y, state.w_cache):
                assert not bool(t[..., pad].any())
            zs.append(state.z_blocks.clone())
        runs[backend] = (zs, ops.launch_counts(), sess.z(state))
    launches = runs["cuda"][1]
    assert launches["admm_worker_select_update"] == 4
    assert launches["server_prox_update"] == 4
    assert not any(runs["torch"][1].values())
    for t, (zk, zp) in enumerate(zip(runs["cuda"][0], runs["torch"][0])):
        if dtype == torch.float32 or t == 0:
            _agree(zk, zp)
        else:        # z~ rounds to bf16 for the loss: a 1e-8 gap can flip
            torch.testing.assert_close(zk, zp, rtol=4e-2, atol=4e-2)
    assert all(x.dtype == dtype for x in tree_leaves(runs["cuda"][2]))


@pytest.mark.parametrize("shape", [(3, 5, 256), (8, 64, 4096), (70, 3, 128)])
def test_every_autotune_launch_is_bitwise_the_default(gen, shape):
    """B1 (with and without x) and B2 at every launch the autotuner may
    pick, NaN and Inf among the inputs and half the rows selected: each
    output bitwise the default launch's; a launch the kernels do not
    take is refused."""
    from repro_torch.kernels import autotune
    N, M, d = shape
    for with_x in (False, True):
        case = _worker_case(gen, N, M, d, with_x, nan=True)
        base = admm_update.admm_worker_select_update_cuda(*case)
        launches = autotune.launch_candidates("worker_select_update", N, M,
                                              d, "cuda")
        occ = admm_update.admm_worker_select_update_occupancy(1024, with_x,
                                                              "cuda")
        assert occ >= 1 and (1024, min(occ, 2)) in launches
        for launch in launches:
            out = admm_update.admm_worker_select_update_cuda(*case, launch)
            assert autotune.same_bits(out, base), launch
    z = torch.randn((M, d), generator=gen, device="cuda")
    w = torch.randn((N, M, d), generator=gen, device="cuda")
    edge = torch.rand((N, M), generator=gen, device="cuda") < 0.6
    w[0, 0, :3] = float("nan")
    w[-1, -1, 4] = float("inf")
    edge[0, 0] = edge[-1, -1] = True
    rho_sum = 1.0 + edge.sum(0).float()
    base = prox_update.server_prox_update_cuda(z, w, edge, rho_sum, 0.1,
                                               1e-3, 0.8)
    for launch in autotune.launch_candidates("server_prox_fused", N, M, d,
                                             "cuda"):
        out = prox_update.server_prox_update_cuda(z, w, edge, rho_sum, 0.1,
                                                  1e-3, 0.8, launch)
        assert autotune.same_bits((out,), (base,)), launch
    with pytest.raises(RuntimeError, match="launch failed"):
        prox_update.server_prox_update_cuda(z, w, edge, rho_sum, 0.1, 1e-3,
                                            0.8, (96, 1))
    with pytest.raises(RuntimeError, match="launch failed"):
        admm_update.admm_worker_select_update_cuda(*case, (256, 0))
