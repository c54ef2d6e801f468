#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of AsyBADMM once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  — the card (nvidia-smi name and power limit), torch and CUDA;
2. build   — nvcc builds every kernel from ``src/repro_torch/csrc``;
3. kernels — each kernel (B1, B2, B3) against its plain torch version on
   the card, at small ragged shapes and the paper path's shape (NaN
   cells among them) and at full width without x, with times (medians of
   CUDA-event windows of back-to-back calls) and bounds;
4. main    — ``ConsensusSession.flat`` at the paper's KDDa width
   (N=8 workers, M=64 blocks, 20,216,830 coordinates; the quadratic
   loss and config of ``benchmarks/kernels_bench.py``'s kdda_like case):
   10 epochs on the kernels ("auto"), then 10 on the plain "torch"
   backend with the same seed and so the same draws; z must agree and
   each kernel must have launched once per epoch;
5. paper   — sparse L1 logistic regression (eq. 22) at the size of
   ``examples/sparse_logreg_admm.py``, 600 epochs on both backends: the
   objective must fall and the trajectories agree;
6. spmd    — the SPMD epoch (``mesh=``) at the width, config and seed of
   phase 4 on a 1x1 mesh of one NCCL rank, 10 epochs: z within 1e-5 of
   phase 4's, B1 and B3 launched once per epoch and B2 never;
   after phases 4, 5 and 6, one more epoch of the path records the
   inputs each kernel was given (``kernels_on_path``): every kernel the
   path runs is held against its plain version on exactly those inputs
   and timed there;
7. spmd_ranks — 4 spawned ranks on the one card in a gloo group
   (data=2 x model=2, N=8, M=64, dim 2,097,152: split gradients on),
   5 epochs: every rank's z within 1e-5 of a single-device run, each
   rank holding only its 2 data rows, and the objective, P and the KKT
   gradient violation within 1e-5 (relative) of it; one more epoch on
   every rank holds B1 and B3 against their plain versions on that
   rank's tile inputs;
8. a ``kernels`` summary line, the card's nvidia-smi line, and the last
   line ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when there is no CUDA device.
Imports only ``repro_torch`` (from ``src/``), never JAX or ``repro``.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

import torch  # noqa: E402

KDDA_DIM = 20_216_830          # KDDa's feature count (paper §5)
KDDA_WORKERS, KDDA_BLOCKS = 8, 64
MAIN_EPOCHS = 10
PAPER_EPOCHS = 600
KERNEL_TOL = 1e-6              # max|kernel - plain| <= tol * (1 + max|plain|)
TRAJ_TOL = 1e-5                # the reference's own backend tolerance
REPS, WINDOWS = 20, 5          # kernel timing: 5 windows of 20 calls
FP32_FLOPS = 67e12             # H100 SXM, fp32 outside the tensor cores
RANKS_WORLD, RANKS_MODEL = 4, 2          # phase spmd_ranks: data=2 x model=2
RANKS_DIM = 2_097_152                    # dblk 32,768 at M=64
RANKS_EPOCHS = 5
PG_TIMEOUT_S = 300             # a collective that waits longer fails
RANKS_JOIN_S = 600             # the ranks of spmd_ranks, all together


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def memory_rate(name: str) -> float:
    """Published device-memory rate of this H100 SKU, bytes/s."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS, windows: int = WINDOWS,
            warmup: int = 3) -> float:
    """ms per call: the median over ``windows`` CUDA-event windows of
    ``reps`` back-to-back calls each, after warm-up. The launches queue
    behind each other, so a window measures the device's time rather
    than the host's work between launches (unless that is the longer)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def compare(kernel, plain) -> float:
    """max|kernel - plain| over finite entries; NaN/Inf must sit at the
    same places with the same values. Fails past the tolerance."""
    kernel, plain = kernel.float(), plain.float()
    fin = torch.isfinite(plain)
    if not torch.equal(torch.isfinite(kernel), fin):
        fail("kernel and plain versions disagree on non-finite entries")
    if not torch.equal(torch.isnan(kernel), torch.isnan(plain)):
        fail("kernel and plain versions disagree on NaN entries")
    nonfin = ~fin & ~torch.isnan(plain)
    if not torch.equal(kernel[nonfin], plain[nonfin]):
        fail("kernel and plain versions disagree on infinite entries")
    if not bool(fin.any()):
        return 0.0
    err = float((kernel[fin] - plain[fin]).abs().max())
    scale = float(plain[fin].abs().max())
    if err > KERNEL_TOL * (1.0 + scale):
        fail(f"max|kernel - plain| = {err:.3e} > {KERNEL_TOL} * (1 + {scale:.3e})")
    return err


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def worker_case(N, M, d, gen, with_x, nan=False, frac=0.5):
    dev = "cuda"
    bundles = [torch.randn((N, M, d), generator=gen, device=dev)
               for _ in range(5 if with_x else 4)]
    sel = torch.rand((N, M), generator=gen, device=dev) < frac
    rho = 0.5 + 2.0 * torch.rand((N,), generator=gen, device=dev)
    if nan:
        sel[0, 0] = True
        bundles[0][0, 0, :7] = float("nan")        # g on a selected row
        bundles[0][0, 0, 7] = float("inf")
        if M > 1:
            sel[0, M - 1] = False
            bundles[3][0, M - 1, 3] = float("nan")  # w_old on a kept row
    g, y, zt, w_old = bundles[:4]
    x_old = bundles[4] if with_x else None
    return (g, y, zt, w_old, sel, rho, x_old)


def server_case(N, M, d, gen, l1, clip, nan=False, edge_frac=0.7):
    dev = "cuda"
    z = torch.randn((M, d), generator=gen, device=dev)
    w = torch.randn((N, M, d), generator=gen, device=dev)
    edge = torch.rand((N, M), generator=gen, device=dev) < edge_frac
    if M > 1 and edge_frac < 1.0:
        edge[:, M - 1] = False                     # a block with no workers
    rho = 0.5 + 2.0 * torch.rand((N,), generator=gen, device=dev)
    rho_sum = torch.sum(torch.where(edge, rho[:, None], 0.0), dim=0)
    if nan:
        edge[0, 0] = True
        w[0, 0, :5] = float("nan")                 # reaches the sum
        if N > 1:
            edge[1, 0] = False
            w[1, 0, 5] = float("nan")              # off the edge set
        z[0, 9] = float("inf")
    return (z, w, edge, rho_sum, 0.1, l1, clip)


def bound(bytes_: int, flops: int, bw: float):
    """The least time for the work, ms, and what bounds it."""
    t_bytes, t_ops = bytes_ / bw, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def worker_bytes_flops(case):
    g, y, zt, w_old, sel, rho, x_old = case
    N, M, d = g.shape
    rows = N * M
    sel_rows = int(sel.sum())
    per_row = d * 4
    kept = 3 if x_old is not None else 2        # y, w_old[, x_old] read
    bytes_ = (kept * rows + 2 * sel_rows) * per_row   # + g, z~ on selected
    bytes_ += kept * rows * per_row                    # outputs written
    bytes_ += sel.numel() + rho.numel() * 4
    return bytes_, 5 * sel_rows * d


def server_bytes_flops(case):
    z, w, edge, rho_sum, _, _, _ = case
    N, M, d = w.shape
    edge_rows = int(edge.sum())
    bytes_ = (2 * M + edge_rows) * d * 4 + edge.numel() + rho_sum.numel() * 4
    return bytes_, (edge_rows + 8 * M) * d


def prox_case(M, d, gen, l1, clip, nan=False):
    dev = "cuda"
    z = torch.randn((M, d), generator=gen, device=dev)
    w_sum = 3.0 * torch.randn((M, d), generator=gen, device=dev)
    rho_sum = 4.0 * torch.rand((M,), generator=gen, device=dev)
    rho_sum[-1] = 0.0                              # a block with no workers
    if nan:
        w_sum[0, :5] = float("nan")
        w_sum[-1, 1] = float("inf")
        z[0, 9 % d] = float("inf")
    return (z, w_sum, rho_sum, 0.1, l1, clip)


def prox_bytes_flops(case):
    z, w_sum, rho_sum, _, _, _ = case
    M, d = z.shape
    return 3 * M * d * 4 + rho_sum.numel() * 4, 8 * M * d


PLAIN = {"admm_worker_select_update": "admm_worker_select_update_torch",
         "server_prox_update": "server_prox_update_torch",
         "prox_consensus": "prox_consensus_torch"}
COUNTS = {"admm_worker_select_update": worker_bytes_flops,
          "server_prox_update": server_bytes_flops,
          "prox_consensus": prox_bytes_flops}
# the TPU kernel each replaces, and its source
SOURCES = {
    "admm_worker_select_update": (
        "src/repro_torch/csrc/admm_update.cu",
        "src/repro/kernels/admm_update.py:136"),
    "server_prox_update": (
        "src/repro_torch/csrc/prox_update.cu",
        "src/repro/kernels/prox_update.py:117"),
    "prox_consensus": (
        "src/repro_torch/csrc/prox_update.cu",
        "src/repro/kernels/prox_update.py:69"),
}


def kernel_module(name: str):
    from repro_torch.kernels import admm_update, prox_update
    return {"admm_worker_select_update": admm_update,
            "server_prox_update": prox_update,
            "prox_consensus": prox_update}[name]


def check(name: str, case, errs) -> float:
    """max|Δ| of ``name``'s kernel against its plain version on ``case``,
    folded into ``errs``; fails past the tolerance."""
    mod = kernel_module(name)
    ks = getattr(mod, f"{name}_cuda")(*case)
    ps = getattr(mod, PLAIN[name])(*case)
    torch.cuda.synchronize()
    if isinstance(ks, torch.Tensor):
        ks, ps = (ks,), (ps,)
    err = max(compare(k, p) for k, p in zip(ks, ps))
    errs[name] = max(errs[name], err)
    return err


PROXES = ((1e-3, 0.8), (0.0, 0.8), (1e-3, 0.0), (0.0, 0.0))   # (l1, clip)


def phase_kernels(bw: float, errs):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    # ragged edge cases, and the paper path's (N=8, M=16, dblk=128)
    small = [(1, 1, 128), (3, 5, 256), (3, 8, 128), (1, 8, 256), (3, 1, 256),
             (8, 16, 128)]
    cells = 0
    for (N, M, d) in small:
        for with_x in (False, True):
            for nan in (False, True):
                check("admm_worker_select_update",
                      worker_case(N, M, d, gen, with_x, nan), errs)
                cells += 1
        for (l1, clip) in PROXES:
            for nan in (False, True):
                check("server_prox_update",
                      server_case(N, M, d, gen, l1, clip, nan), errs)
                cells += 1
    for (M, d) in sorted({(M, d) for (_, M, d) in small} | {(64, 128)}):
        for (l1, clip) in PROXES:
            for nan in (False, True):
                check("prox_consensus", prox_case(M, d, gen, l1, clip, nan),
                      errs)
                cells += 1
    emit("kernels_small", cells=cells, max_abs_err=errs)

    # full width without x (the track_x=False option, which no path below
    # drives); the paths' own inputs are checked by check_on_path
    from repro_torch.core.blocks import make_flat_blocks
    dblk = make_flat_blocks(KDDA_DIM, KDDA_BLOCKS).block_dim
    case = worker_case(KDDA_WORKERS, KDDA_BLOCKS, dblk, gen, with_x=False)
    emit("kernels_full", with_x=False,
         **measure("admm_worker_select_update", case, bw, errs))
    del case
    torch.cuda.empty_cache()


def measure(name: str, case, bw: float, errs) -> dict:
    """``name``'s kernel against its plain version on ``case``: max|Δ|
    (folded into ``errs``), both times, and the bound."""
    err = check(name, case, errs)
    mod = kernel_module(name)
    kernel, plain = getattr(mod, f"{name}_cuda"), getattr(mod, PLAIN[name])
    ms = time_ms(lambda: kernel(*case))
    plain_ms = time_ms(lambda: plain(*case))
    bytes_, flops = COUNTS[name](case)
    bound_ms, bound_by = bound(bytes_, flops, bw)
    return dict(name=name, shape=list(case[1].shape), max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bytes=bytes_, flops=flops,
                bound_ms=bound_ms, bound_by=bound_by)


@contextlib.contextmanager
def capture_inputs():
    """Inside the block, keep a copy of the arguments of each kernel's
    latest launch, by name; the launch itself goes ahead unchanged."""
    inputs, restore = {}, []
    for name in PLAIN:
        mod = kernel_module(name)
        real = getattr(mod, f"{name}_cuda")

        def wrapped(*args, _real=real, _name=name):
            inputs[_name] = tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            return _real(*args)

        setattr(mod, f"{name}_cuda", wrapped)
        restore.append((mod, f"{name}_cuda", real))
    try:
        yield inputs
    finally:
        for mod, attr, real in restore:
            setattr(mod, attr, real)


def check_on_path(path: str, inputs, names, bw: float, errs) -> dict:
    """Each kernel against its plain version on the inputs a path gave it
    in one epoch (``capture_inputs``), timed there; ``names`` are the
    kernels the path must have launched."""
    if set(inputs) != set(names):
        fail(f"{path}: kernels launched in the captured epoch: "
             f"{sorted(inputs)}, expected {sorted(names)}")
    rows = {}
    for name, case in inputs.items():
        rows[name] = measure(name, case, bw, errs)
        emit("kernels_on_path", path=path, **rows[name])
    inputs.clear()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def quad_loss(z, c):
    return 0.5 * torch.sum(torch.square(z - c))


def run_epochs(sess, epochs):
    state = sess.init()
    torch.cuda.synchronize()
    times = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        state, info = sess.step(state)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return state, times


def kdda_problem(workers=KDDA_WORKERS, dim=KDDA_DIM):
    """The kdda_like config and its centers, from seed 0."""
    from repro_torch.configs.base import ADMMConfig
    cfg = ADMMConfig(rho=2.0, gamma=0.1, max_delay=1, block_fraction=0.5,
                     num_blocks=KDDA_BLOCKS, l1_coef=1e-3, clip=1.0, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, torch.randn((workers, dim), generator=gen, device="cuda")


def expect_launches(path: str, launches, epochs: int, names) -> None:
    """``names`` launched once an epoch on ``path``, every other kernel
    never."""
    want = {k: (epochs if k in names else 0) for k in PLAIN}
    if launches != want:
        fail(f"{path}: launches {launches} in {epochs} epochs, expected "
             f"{want}")


MAIN_KERNELS = ("admm_worker_select_update", "server_prox_update")
SPMD_KERNELS = ("admm_worker_select_update", "prox_consensus")


def phase_main(bw: float, errs):
    from repro_torch.api import ConsensusSession
    from repro_torch.kernels import ops

    N, M = KDDA_WORKERS, KDDA_BLOCKS
    cfg, centers = kdda_problem()

    sess = ConsensusSession.flat(quad_loss, centers, dim=KDDA_DIM, cfg=cfg)
    if sess.spec.space.backend != "cuda":
        fail(f"'auto' resolved to {sess.spec.space.backend!r} on the card")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, times = run_epochs(sess, MAIN_EPOCHS)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches("main", launches, MAIN_EPOCHS, MAIN_KERNELS)
    z_kernel = sess.z(state).clone()
    if tuple(z_kernel.shape) != (KDDA_DIM,) or \
            not bool(torch.isfinite(z_kernel).all()):
        fail("main path z is not a finite vector of the problem's dim")
    epoch_ms = statistics.median(times[1:])
    profile = profile_epochs("main", sess, state, epoch_ms)
    with capture_inputs() as inputs:      # one more epoch, from epoch 10's state
        sess.step(state)
    del state

    plain = ConsensusSession.flat(quad_loss, centers, dim=KDDA_DIM, cfg=cfg,
                                  backend="torch")
    ops.reset_launch_counts()
    state, plain_times = run_epochs(plain, MAIN_EPOCHS)
    if any(ops.launch_counts().values()):
        fail("the torch backend launched a kernel")
    z_plain = plain.z(state)
    diff = float((z_kernel - z_plain).abs().max())
    if not torch.allclose(z_kernel, z_plain, rtol=TRAJ_TOL, atol=TRAJ_TOL):
        fail(f"main path: kernel and torch z differ by {diff:.3e}")
    result = dict(N=N, M=M, dim=KDDA_DIM,
                  dblk=sess.spec.space.blocks.block_dim,
                  epochs=MAIN_EPOCHS, launches=launches,
                  epoch_ms_median=epoch_ms,
                  epoch_ms=times, torch_epoch_ms_median=statistics.median(
                      plain_times[1:]),
                  peak_bytes=peak, z_max_abs_diff_vs_torch=diff,
                  z_max_abs=float(z_kernel.abs().max()), profile=profile,
                  card=smi_line())
    emit("main", **result)
    del state, sess, plain, centers, z_plain
    torch.cuda.empty_cache()
    return (launches, check_on_path("main", inputs, MAIN_KERNELS, bw, errs),
            z_kernel)


def profile_epochs(path: str, sess, state, epoch_ms: float, epochs: int = 3):
    """Device time by kernel over a few epochs (torch.profiler), and the
    device's idle share of an unprofiled epoch (``epoch_ms``): the
    profiler's own start-up lands in its window, so that window's wall
    time is not the epoch's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(epochs):
            state, _ = sess.step(state)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # kernel events only: an operator's entry repeats its kernels' time
        if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0:
            rows.append((ev.device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / epochs
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{path}_profile.json").write_text(json.dumps(
        {"epochs": epochs, "epoch_ms": epoch_ms,
         "by_kernel": [{"name": k, "device_ms_per_epoch": t / 1e3 / epochs,
                        "count_per_epoch": c / epochs}
                       for t, k, c in rows]}, indent=1))
    return {"epochs": epochs, "device_busy_ms_per_epoch": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / epoch_ms),
            "top": [{"name": k[:80], "device_ms": t / 1e3 / epochs,
                     "count": c / epochs} for t, k, c in rows[:8]]}


# ---------------------------------------------------------------------------
# phase 5: the paper's workload
# ---------------------------------------------------------------------------

def logreg_loss(z, d):
    X, y = d
    return torch.mean(torch.log1p(torch.exp(-y * (X @ z))))


def phase_paper(bw: float, errs):
    from repro_torch.api import ConsensusSession
    from repro_torch.configs.base import ADMMConfig
    from repro_torch.data import make_sparse_logreg
    from repro_torch.kernels import ops

    dim = 1024
    data = make_sparse_logreg(num_workers=8, samples_per_worker=96, dim=dim,
                              density=0.08, seed=0)
    # examples/sparse_logreg_admm.py's "AsyBADMM (D=2, 50% blocks)"
    cfg = ADMMConfig(rho=2.0, gamma=0.1, max_delay=2, block_fraction=0.5,
                     num_blocks=16, seed=1)
    out = {}
    for backend in ("auto", "torch"):
        sess = ConsensusSession.flat(logreg_loss, (data.X, data.y), dim=dim,
                                     cfg=cfg, support=data.support,
                                     l1_coef=1e-3, clip=1e4, backend=backend)
        state = sess.init()
        obj0 = sess.objective(state)
        ops.reset_launch_counts()
        zs = []
        t0 = time.perf_counter()
        for t in range(PAPER_EPOCHS):
            state, _ = sess.step(state)
            if (t + 1) % 100 == 0:
                zs.append(sess.z(state).clone())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[backend] = dict(
            backend=sess.spec.space.backend, objective_start=obj0,
            objective_end=sess.objective(state),
            P=float(sess.stationarity(state)["P"]),
            ms_per_epoch=1e3 * secs / PAPER_EPOCHS,
            launches=ops.launch_counts(), zs=zs)
        if backend == "auto":
            with capture_inputs() as inputs:    # one more epoch
                sess.step(state)
    k, p = out["auto"], out["torch"]
    if k["backend"] != "cuda":
        fail(f"paper workload did not run on the kernels: {k['backend']}")
    expect_launches("paper", k["launches"], PAPER_EPOCHS, MAIN_KERNELS)
    if not k["objective_end"] < k["objective_start"]:
        fail(f"objective did not fall: {k['objective_start']} -> "
             f"{k['objective_end']}")
    diff = max(float((a - b).abs().max()) for a, b in zip(k["zs"], p["zs"]))
    if not all(torch.allclose(a, b, rtol=TRAJ_TOL, atol=TRAJ_TOL)
               for a, b in zip(k["zs"], p["zs"])):
        fail(f"paper workload: kernel and torch trajectories differ by "
             f"{diff:.3e}")
    emit("paper", epochs=PAPER_EPOCHS, dim=dim, workers=8, blocks=16,
         z_max_abs_diff_vs_torch=diff,
         **{b: {key: v for key, v in r.items() if key != "zs"}
            for b, r in out.items()})
    check_on_path("paper", inputs, MAIN_KERNELS, bw, errs)


# ---------------------------------------------------------------------------
# phase 6: the SPMD epoch at full width, world size 1
# ---------------------------------------------------------------------------

def phase_spmd(bw: float, errs, z_main):
    """``ConsensusSession.flat(..., mesh=)`` on a 1x1 mesh of one NCCL
    rank at the kdda_like width, config and seed of phase ``main`` (so the
    same draws): the sharded body runs every step, and its server step is
    the plain worker reduce, an all-reduce and B3 (never B2)."""
    import torch.distributed as dist
    from repro_torch.api import ConsensusSession
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            cfg, centers = kdda_problem()
            sess = ConsensusSession.flat(quad_loss, centers, dim=KDDA_DIM,
                                         cfg=cfg, mesh=make_test_mesh(1, 1))
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            state, times = run_epochs(sess, MAIN_EPOCHS)
            launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            expect_launches("spmd", launches, MAIN_EPOCHS, SPMD_KERNELS)
            z = sess.z(state)
            diff = float((z - z_main).abs().max())
            if tuple(z.shape) != (KDDA_DIM,) or not torch.allclose(
                    z, z_main, rtol=TRAJ_TOL, atol=TRAJ_TOL):
                fail(f"spmd: z differs from phase main's by {diff:.3e}")
            epoch_ms = statistics.median(times[1:])
            profile = profile_epochs("spmd", sess, state, epoch_ms, epochs=2)
            with capture_inputs() as inputs:  # one more epoch
                sess.step(state)
            emit("spmd", world_size=1, mesh=dict(sess.spec.space.mesh.shape),
                 epochs=MAIN_EPOCHS, launches=launches,
                 epoch_ms_median=epoch_ms, epoch_ms=times, peak_bytes=peak,
                 z_max_abs_diff_vs_main=diff, profile=profile,
                 card=smi_line())
            del state, sess, centers, z
            torch.cuda.empty_cache()
            return launches, check_on_path("spmd", inputs, SPMD_KERNELS, bw,
                                           errs)
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 7: the SPMD epoch over 4 ranks on the one card
# ---------------------------------------------------------------------------

def session_measures(sess, state) -> dict:
    """The objective, P and the largest KKT violation of a state."""
    return {"objective": sess.objective(state),
            "P": float(sess.stationarity(state)["P"]),
            "kkt_grad": float(sess.kkt_violations(state)["kkt_grad"])}


def spmd_rank(rank: int, world: int, init_method: str, out_dir: str):
    """One rank of phase ``spmd_ranks`` (a spawned process on cuda:0)."""
    import torch.distributed as dist
    from repro_torch.api import ConsensusSession
    from repro_torch.core.sharded import grad_split_size
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mesh = make_test_mesh(world, RANKS_MODEL)
        cfg, centers = kdda_problem(dim=RANKS_DIM)
        sess = ConsensusSession.flat(quad_loss, centers, dim=RANKS_DIM,
                                     cfg=cfg, mesh=mesh)
        ops.reset_launch_counts()
        state, times = run_epochs(sess, RANKS_EPOCHS)
        launches = ops.launch_counts()
        z = sess.z(state).cpu()
        measures = session_measures(sess, state)
        # one more epoch: each kernel against its plain version on the
        # local-tile inputs this rank gave it (a breach fails the rank)
        with capture_inputs() as inputs:
            sess.step(state)
        torch.cuda.synchronize()
        errs = {name: 0.0 for name in PLAIN}
        shapes = {name: list(case[1].shape) for name, case in inputs.items()}
        for name, case in inputs.items():
            check(name, case, errs)
        torch.save({"z": z, "launches": launches, "epoch_ms": times,
                    "coords": dict(mesh.coords),
                    "grad_split": grad_split_size(sess.spec),
                    "tile": list(state.y.shape),
                    "data_rows": sess.data.shape[0], "measures": measures,
                    "captured": shapes, "max_abs_err": errs},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_spmd_ranks(errs):
    """4 ranks on the one card in a gloo group, data=2 x model=2, N=8:
    Nl=4 local workers split over model (Ng=2), so the split-gradient
    all_to_all routes run; B1 and B3 see local tiles and the collectives
    carry CUDA tensors. z after 5 epochs against a single-device session
    of the same config on the card; each rank holds B1 and B3 against
    their plain versions on the tile inputs of one more epoch."""
    import torch.multiprocessing as mp
    from repro_torch.api import ConsensusSession

    cfg, centers = kdda_problem(dim=RANKS_DIM)
    single = ConsensusSession.flat(quad_loss, centers, dim=RANKS_DIM, cfg=cfg)
    state, _ = run_epochs(single, RANKS_EPOCHS)
    z_single = single.z(state).cpu()
    measures_single = session_measures(single, state)
    del single, state, centers
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            spmd_rank, args=(RANKS_WORLD, f"file://{tmp}/store", tmp),
            nprocs=RANKS_WORLD, start_method="spawn", join=False)
        deadline = time.monotonic() + RANKS_JOIN_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    fail(f"spmd_ranks: the ranks did not finish within "
                         f"{RANKS_JOIN_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt")
                 for r in range(RANKS_WORLD)]
    diffs = []
    for r in ranks:
        expect_launches("spmd_ranks", r["launches"], RANKS_EPOCHS,
                        SPMD_KERNELS)
        if r["grad_split"] != 2 or r["tile"] != [4, 32, 32768] or \
                r["data_rows"] != 2:
            fail(f"spmd_ranks: rank {r['coords']} ran grad split "
                 f"{r['grad_split']} on tile {r['tile']} with "
                 f"{r['data_rows']} data rows")
        want = {"admm_worker_select_update": [4, 32, 32768],
                "prox_consensus": [32, 32768]}
        if r["captured"] != want:
            fail(f"spmd_ranks: rank {r['coords']} launched "
                 f"{r['captured']} in the captured epoch, expected {want}")
        for name, err in r["max_abs_err"].items():
            errs[name] = max(errs[name], err)
        diff = float((r["z"] - z_single).abs().max())
        if not torch.allclose(r["z"], z_single, rtol=TRAJ_TOL, atol=TRAJ_TOL):
            fail(f"spmd_ranks: rank {r['coords']} z differs from the "
                 f"single-device run by {diff:.3e}")
        diffs.append(diff)
        for k, v in measures_single.items():
            if abs(r["measures"][k] - v) > TRAJ_TOL * (1.0 + abs(v)):
                fail(f"spmd_ranks: rank {r['coords']} {k} "
                     f"{r['measures'][k]} against the single-device {v}")
    emit("spmd_ranks", world_size=RANKS_WORLD, backend="gloo",
         mesh={"data": RANKS_WORLD // RANKS_MODEL, "model": RANKS_MODEL},
         N=KDDA_WORKERS, M=KDDA_BLOCKS, dim=RANKS_DIM, epochs=RANKS_EPOCHS,
         tile=ranks[0]["tile"], launches_per_rank=ranks[0]["launches"],
         data_rows_per_rank=ranks[0]["data_rows"],
         kernels_on_tiles={name: {"shape": shape, "max_abs_err": max(
             r["max_abs_err"][name] for r in ranks)}
             for name, shape in ranks[0]["captured"].items()},
         z_max_abs_diff_vs_single=max(diffs),
         measures_single=measures_single,
         measures_rank0=ranks[0]["measures"],
         epoch_ms_median_per_rank=[statistics.median(r["epoch_ms"][1:])
                                   for r in ranks])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    bw = memory_rate(name)
    emit("device", nvidia_smi=card, name=name, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         memory_rate_bytes_per_s=bw)

    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(p.relative_to(HERE)) for p in libs.values()])

    errs = {name: 0.0 for name in PLAIN}
    phase_kernels(bw, errs)
    main_launches, main_rows, z_main = phase_main(bw, errs)
    phase_paper(bw, errs)
    spmd_launches, spmd_rows = phase_spmd(bw, errs, z_main)
    del z_main
    torch.cuda.empty_cache()
    phase_spmd_ranks(errs)

    # each kernel's numbers from the path it serves: B1 and B2 from main,
    # B3 from spmd (B1 runs on both; main is its full-width single device)
    kernels = []
    for name_, (source, replaces) in SOURCES.items():
        launches, rows = ((spmd_launches, spmd_rows)
                          if name_ == "prox_consensus"
                          else (main_launches, main_rows))
        r = rows[name_]
        kernels.append(dict(
            name=name_, route="cuda", source=source, replaces=replaces,
            launches=launches[name_], max_abs_err=errs[name_], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
