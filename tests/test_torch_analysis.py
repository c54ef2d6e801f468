"""``repro_torch.analysis`` (the cost counter, the H100 roofline, the
report) against programs of known cost and against the reference's
``analysis/roofline.py``:

* ``model_flops`` equal to the reference's for all ten archs at every
  shape of its ``INPUT_SHAPES`` (arithmetic on the config);
* the counter's FLOPs exact on a matmul (as ``tests/test_hlo_cost.py``
  checks the reference's), a Python loop of k iterations costing k
  times its body, an elementwise op's bytes exact, views free;
* each kernel's declared cost (B1-B7) charged once per dispatch and
  nothing of its plain version's ops, identical on the CPU and on meta
  (and on the card, ``tests/test_torch_kernels_cuda.py``), and the
  bytes a call of ``PERF.md`` §6 at the paths' shapes, costed on meta;
* the smoke ADMM train step counting more FLOPs with ``remat=True``,
  by one forward of the layers (within 5 %), and a lower
  ``useful_flops_ratio``;
* the roofline's terms and its peak by dtype and TF32 setting.

``per_shard_cost_program`` is held against the count of a real rank in
``tests/test_torch_sharded.py``.
"""
import numpy as np
import pytest
import torch

from repro.analysis.roofline import model_flops as ref_model_flops
from repro.configs import get_config as ref_config
from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro_torch.analysis import cost as cost_mod
from repro_torch.analysis.cost import count, counting, kernel_cost
from repro_torch.analysis.report import (layers_forward_flops,
                                         roofline_table, smoke_rows,
                                         train_step_program)
from repro_torch.analysis.roofline import (HBM_BW, PEAK, Roofline,
                                           model_flops, peak_flops)
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke, list_archs
from repro_torch.configs.base import ADMMConfig
from repro_torch.kernels import ops


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_model_flops_match_reference(arch):
    assert set(INPUT_SHAPES) == set(REF_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert model_flops(get_config(arch), shape) == \
            ref_model_flops(ref_config(arch), REF_SHAPES[name])


def test_matmul_flops_exact():
    M, K, N = 256, 512, 128
    a, b = torch.randn(M, K), torch.randn(K, N)
    _, c = count(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * M * K * N
    assert c.hbm_bytes == 4 * (M * K + K * N + M * N)
    assert dict(c.ops) == {"mm": 1}
    # batched and on meta alike
    _, cb = count(torch.bmm, torch.empty(3, M, K, device="meta"),
                  torch.empty(3, K, N, device="meta"))
    assert cb.flops == 3 * 2 * M * K * N


def test_loop_costs_its_trip_count():
    D, TRIPS = 64, 17
    x, w = torch.randn(D, D), torch.randn(TRIPS, D, D)

    def loop(x0, ws, trips):
        for i in range(trips):
            x0 = torch.tanh(x0 @ ws[i])
        return x0

    _, one = count(loop, x, w, 1)
    _, many = count(loop, x, w, TRIPS)
    assert many.flops == TRIPS * one.flops
    assert many.hbm_bytes == TRIPS * one.hbm_bytes
    assert many.ops["mm"] == TRIPS and many.ops["tanh"] == TRIPS


def test_elementwise_bytes_exact_and_views_free():
    a = torch.randn(1000, 24)
    b = torch.randn(24).to(torch.float64)
    _, c = count(lambda: a.float() * 3.0 + a)
    assert c.flops == 2 * a.numel()
    assert c.hbm_bytes == 2 * 4 * a.numel() + 3 * 4 * a.numel()
    _, c = count(lambda: (a + b).sum())
    assert c.hbm_bytes == (4 * a.numel() + 8 * 24 + 8 * a.numel()) + \
        (8 * a.numel() + 8)
    _, c = count(lambda: a.reshape(-1).view(24, 1000).t()[::2].unsqueeze(0))
    assert c.flops == 0 and c.hbm_bytes == 0
    # a reshape that needs a copy is one
    _, c = count(lambda: a.t().reshape(-1))
    assert dict(c.ops) == {"clone": 1} and c.hbm_bytes == 2 * 4 * a.numel()


def _kernel_calls(device, gen):
    """One dispatch of each kernel op on ``device``, its inputs made
    beforehand: (name, call)."""
    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype).to(device)

    N, M, d = 3, 4, 128
    sel = (torch.rand(N, M, generator=gen) < 0.5).to(device)
    edge = torch.rand(N, M, generator=gen) < 0.7
    rho = torch.rand(N, generator=gen) + 0.5
    rho_sum = torch.sum(torch.where(edge, rho[:, None], 0.0), dim=0).to(
        device)
    edge, rho = edge.to(device), rho.to(device)
    g, y, zt, w, x = (t(N, M, d) for _ in range(5))
    z, w_sum = t(M, d), t(M, d)
    flat = [t(8, 128) for _ in range(3)]
    a, b = t(40, 24), t(40, 8)
    a16, b16 = t(6, 8, dtype=torch.bfloat16), t(8, 5, dtype=torch.bfloat16)
    q, k, v = t(2, 33, 16), t(2, 33, 16), t(2, 33, 16)
    q2, k2, v2 = t(2, 20, 16), t(2, 36, 16), t(2, 36, 16)
    s, ys = t(100, 1), t(100, 1)
    return [
        ("admm_worker_select_update", lambda: ops.admm_worker_select_update(
            g, y, zt, w, sel, rho, x)),
        ("admm_worker_select_update", lambda: ops.admm_worker_select_update(
            g, y, zt, w, sel, rho)),
        ("server_prox_update", lambda: ops.server_prox_update(
            z, w, edge, rho_sum, 0.1, 1e-3, 1.0)),
        ("prox_consensus", lambda: ops.prox_consensus(
            z, w_sum, rho_sum, 0.1, 1e-3, 1.0)),
        ("admm_worker_update", lambda: ops.admm_worker_update(*flat, 2.0)),
        ("matmul", lambda: ops.matmul(a, b, True)),
        ("matmul", lambda: ops.matmul(a16, b16)),
        ("margin", lambda: ops._margin(s, ys)),
        ("flash_attention", lambda: ops.flash_attention(q, k, v,
                                                        causal=True)),
        ("flash_attention", lambda: ops.flash_attention(q2, k2, v2,
                                                        causal=False)),
    ]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_each_kernel_charged_its_declared_cost(device):
    """A dispatch charges the kernel's declared cost, once, and no op of
    the plain version that runs inside; the same count on the CPU and on
    meta (``logreg_grad``: B5 twice and B6 once, plus its scaling)."""
    seen = {}
    for name, call in _kernel_calls(device,
                                    torch.Generator().manual_seed(0)):
        captured = []

        def spy(n, operands, _real=cost_mod.kernel_cost):
            captured.append(_real(n, operands))
            return _real(n, operands)

        with counting() as c:
            cost_mod.kernel_cost, real = spy, cost_mod.kernel_cost
            try:
                call()
            finally:
                cost_mod.kernel_cost = real
        (nbytes, flops), = captured
        assert dict(c.ops) == {name: 1}
        assert c.hbm_bytes == nbytes and c.flops == flops
        assert c.kernel_bytes[name] == nbytes
        seen.setdefault(name, []).append((nbytes, flops))
    assert set(seen) == set(cost_mod.KERNEL_COSTS)
    X = torch.empty(64, 16, device=device)
    _, c = count(ops.logreg_grad, X, torch.empty(64, device=device),
                 torch.empty(16, device=device))
    assert c.ops["matmul"] == 2 and c.ops["margin"] == 1


def test_kernel_costs_equal_the_bytes_a_call_of_perf_md():
    """PERF.md section 6's bytes a call, counted on meta at each path's
    shape: B1 on main (8, 64, 315,904) with x 3.88 GB and on train
    (2, 2, 311,164,928) no x 24.89 GB, B2 on main 0.81 GB, B3 on spmd
    0.243 GB, B7 f32 (64, 4096, 128) causal 0.537 GB."""
    def meta(*shape):
        return torch.empty(shape, device="meta")

    b1, _ = kernel_cost("admm_worker_select_update", (
        *(meta(8, 64, 315_904) for _ in range(4)), meta(8, 64),
        meta(8), meta(8, 64, 315_904)))
    b1t, _ = kernel_cost("admm_worker_select_update", (
        *(meta(2, 2, 311_164_928) for _ in range(4)), meta(2, 2), meta(2),
        None))
    b2, _ = kernel_cost("server_prox_update", (
        meta(64, 315_904), meta(8, 64, 315_904), meta(8, 64), meta(64)))
    b3, _ = kernel_cost("prox_consensus", (
        meta(64, 315_904), meta(64, 315_904), meta(64)))
    b7, _ = kernel_cost("flash_attention", (
        meta(64, 4096, 128), meta(64, 4096, 128), meta(64, 4096, 128), True))
    for got, want in ((b1, 3.88e9), (b1t, 24.89e9), (b2, 0.81e9),
                      (b3, 0.243e9), (b7, 0.537e9)):
        assert abs(got - want) <= 0.01 * want, (got, want)


def test_remat_counts_one_more_forward_of_the_layers():
    model_cfg = get_smoke("qwen3-1.7b")
    admm = ADMMConfig(rho=20.0, gamma=0.01, max_delay=1, block_fraction=1.0,
                      num_blocks=2, seed=0)
    N, B, S = 2, 2, 16
    flops = {}
    for remat in (False, True):
        fn, args = train_step_program(model_cfg.with_(remat=remat), admm,
                                      N, B, S)
        flops[remat] = count(fn, *args)[1]
    extra = flops[True].flops - flops[False].flops
    layers = layers_forward_flops(model_cfg, N, B, S)
    assert abs(extra - layers) <= 0.05 * layers, (extra, layers)
    # the kernels are charged alike, once a step each
    for c in flops.values():
        assert c.ops["admm_worker_select_update"] == 1
        assert c.ops["server_prox_update"] == 1


def test_roofline_terms_and_peaks():
    assert peak_flops(torch.float32, tf32=False) == PEAK["fp32"] == 67e12
    assert peak_flops(torch.float32, tf32=True) == 495e12
    assert peak_flops(torch.bfloat16) == peak_flops(torch.float16) == 989e12
    r = Roofline(arch="a", shape="s", mesh="1", flops_per_device=67e12,
                 hbm_bytes_per_device=2 * HBM_BW,
                 collective_bytes={"all-reduce": 0.0}, chips=1,
                 model_flops_total=33.5e12)
    assert (r.t_compute, r.t_memory, r.bottleneck, r.step_time) == \
        (1.0, 2.0, "memory", 2.0)
    assert r.useful_flops_ratio == 0.5
    assert r.mfu_bound == pytest.approx(0.25)


def test_smoke_report_rows():
    rows = smoke_rows()
    by = {(r["shape"], r.get("variant")): r for r in rows}
    off, on = by[("train_step", "remat=False")], by[("train_step",
                                                      "remat=True")]
    assert on["flops"] > off["flops"]
    assert on["useful_flops_ratio"] < off["useful_flops_ratio"]
    assert by[("prefill", None)]["ops"]["flash_attention"] == \
        get_smoke("qwen3-1.7b").num_layers
    assert by[("epoch", None)]["kernel_bytes"]["server_prox_update"] > 0
    table = roofline_table({(r["arch"], r["shape"], r["mesh"],
                             r.get("variant", "baseline")): r for r in rows})
    assert table.count("\n") == 1 + len(rows)
    assert all(np.isfinite(r["step_time_bound_s"]) for r in rows)
