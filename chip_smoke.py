#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of AsyBADMM once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  — the card (nvidia-smi name and power limit), torch and CUDA;
2. build   — nvcc builds every kernel from ``src/repro_torch/csrc``;
3. kernels — each kernel (B1-B7) against its plain torch version on the
   card, at small ragged shapes and the paper path's shape (NaN/Inf
   cells among them; B5 and B6 in bf16 and f16 too, B5's cells reaching
   each of its five designs, B7 at the reference test's shapes in f32,
   bf16 and f16); B1 at full width without x; and B4's path:
   ``ops.admm_worker_update`` on the kdda_like worker bundle (8, 64,
   315,904), its launch counted and its inputs held against the plain
   version, with times (medians of CUDA-event windows of back-to-back
   calls) and bounds. B5 and B7 are held against float64 (they sum in
   another order than their plain versions): their error there at most
   MATMUL_RATIO times the plain version's (B7 in 16 bits row by row
   too); the others within KERNEL_TOL. Then the line ``matmul``:
   ``ops.matmul``, the package's public op, at 4096^3 in f32 (3xTF32),
   bf16 and f16 (wgmma), A stored either way, and at 4095^3 (the tiled
   design), one call a cell with its launch and design counted; each
   held to float64, its gate shown to refuse zeros, a sixteenth of K
   dropped, one K step read twice and bf16- or TF32-rounded (f32) or
   3-bit (16-bit) inputs, and timed beside ``torch.matmul``. In 16 bits
   B5 is held entry by entry too (``f64_entry_ratio``);
4. main    — ``ConsensusSession.flat`` at the paper's KDDa width
   (N=8 workers, M=64 blocks, 20,216,830 coordinates; the quadratic
   loss and config of ``benchmarks/kernels_bench.py``'s kdda_like case):
   10 epochs on the kernels ("auto"), then 10 on the plain "torch"
   backend with the same seed and so the same draws; z must agree and
   each kernel must have launched once per epoch;
5. paper   — the paper's entry points on the card: the
   "AsyBADMM (D=2, 50% blocks)" variant of
   ``repro_torch.examples.sparse_logreg_admm`` for 600 epochs on both
   backends (the trajectories must agree), then that script, the
   quickstart and the Fig. 2 convergence benchmark at their defaults:
   every variant's objective must fall on the kernels, B1 and B2 launch
   once per epoch, and the cross-check's ``ops.logreg_grad`` (B5 twice,
   B6 once) agrees with autograd; the cross-check's B5 and B6 inputs are
   held against the plain versions;
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
   ps      — ``ConsensusSession.run_ps``, the event-driven Parameter
   Server runtime, at phase 4's width and config: 6 rounds under each of
   lockfree and locked (lognormal service times), B1 launched once per
   worker compute and B2 once per block commit, both counts read from
   the run's metrics; each run's trace replayed through the vectorized
   epoch on the kernels with z bitwise equal at every round; B1 and B2
   held against their plain versions on the run's first worker compute
   (8, 64, 315,904) and first block commit (8, 1, 315,904) and timed
   there; telemetry shown inert (3 rounds, z, delays and makespan
   bitwise equal); then ``measure_costs`` on the card and Table 1 from
   those costs (p in 1, 4, 8, 16, 32, k = 320, both disciplines), the
   locked/lockfree gate at 8 workers and the skew, heavy_tail, churn
   and lossy scenarios with their gates (``ps_baseline.json``);
8. serve   — the dense model stack at qwen3-1.7b's full width (28
   layers, d_model 2048, 16 / 8 heads of 128, vocab 151,936, fp32,
   random weights from a seed): ``Model.prefill`` of 4 x 4096 tokens on
   the flash path, where B7 launches once per layer (28), and on the
   naive path (last-position logits within 2e-3 of each other); B7 on
   one layer's inputs held to float64 attention by B5's rule, the gate
   shown to refuse three faulty results (no causal mask, the last K tile
   dropped, bf16-rounded inputs), timed beside its plain version and
   ``scaled_dot_product_attention``; then ``Engine.generate`` with
   launch/serve.py's defaults (4 requests x 16-token prompts, 24 new
   tokens, greedy) through the KV-cache decode, which launches no
   kernel: decode logits within 5e-4 of the prefill's at every prompt
   position, first tokens the flash prefill's argmax wherever its top-2
   gap exceeds the measured difference; prefill and decode times, peak
   memory. Last (phase line ``serve_bf16``), the f32 weights freed, the
   same prefill in bf16 (weights of the same seed rounded to bf16),
   flash (B7's 16-bit design, 28 launches) and naive, each one's logits
   against the f32 prefill of the same rounded weights (flash within
   SERVE_BF16_RATIO times naive's error; flash through a faulty B7
   past it), with a profile; layer 0's bf16 B7 inputs checked (row by
   row too), gated against four faulty results and timed the same way,
   and the same inputs in f16;
9. logreg  — ``ops.logreg_grad`` at the size the repo declares for it
   (m = 2^20 samples, d = 2^14 features, X dense f32, 68.72 GB, filled
   on the card in row chunks): launches B5 twice and B6 once; each pass
   and the gradient are held against float64 (computed on the card in
   row chunks) by B5's rule, the gradient against autograd too, and
   each pass's gate must refuse four faulty results (zeros, a sixteenth
   of K dropped, bf16- and TF32-rounded inputs); each kernel, the
   gradient and autograd are timed, B6 also by the profiler (its device
   time per call). Runs last, with everything before
   it freed; then (line ``logreg_bf16``), that X freed, the same
   gradient on a bf16 X (34.36 GB): B5's gemv16 design twice and B6
   once, each pass and the gradient held to float64 (the plain versions
   in row chunks), each pass's gate refusing zeros, a sixteenth of K
   dropped and 3-bit inputs; timed beside ``torch.matmul`` on the bf16
   operands and bf16 autograd;
10. a ``kernels`` summary line (B5's designs each on a line of their
   own after B5's), the card's nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when there is no CUDA device.
Imports only ``repro_torch`` (from ``src/``), never JAX or ``repro``.
"""
from __future__ import annotations

import contextlib
import copy
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
# B5 against float64: max|kernel - f64| <= MATMUL_RATIO * max(max|plain -
# f64|, MATMUL_FLOOR * max|f64|), over the entries finite in float64.
# cuBLAS sums in blocks or splits K, so a correct kernel that sums in k
# order per thread reads up to ~4x its error on the small cells
MATMUL_RATIO, MATMUL_FLOOR = 8.0, 2.0 ** -22
CROSSCHECK_TOL = dict(rtol=1e-4, atol=1e-5)   # the reference's logreg_grad tolerance
LOGREG_M, LOGREG_D = 1 << 20, 1 << 14          # benchmarks/kernels_bench.py:114
LOGREG_REPS, LOGREG_WINDOWS = 3, 3             # 68 GB passes: fewer windows
F64_CHUNK = 1 << 27            # float64 elements per chunk of A in the B5 check
TRAJ_TOL = 1e-5                # the reference's own backend tolerance
REPS, WINDOWS = 20, 5          # kernel timing: 5 windows of 20 calls
FP32_FLOPS = 67e12             # H100 SXM, fp32 outside the tensor cores
TC16_FLOPS = 989e12            # H100 SXM tensor cores, dense bf16 / fp16
TF32_FLOPS = 495e12            # H100 SXM tensor cores, dense TF32
RANKS_WORLD, RANKS_MODEL = 4, 2          # phase spmd_ranks: data=2 x model=2
RANKS_DIM = 2_097_152                    # dblk 32,768 at M=64
RANKS_EPOCHS = 5
PG_TIMEOUT_S = 300             # a collective that waits longer fails
RANKS_JOIN_S = 600             # the ranks of spmd_ranks, all together
SERVE_ARCH = "qwen3-1.7b"      # launch/serve.py's default arch, full width
SERVE_BATCH, SERVE_SEQ = 4, 4096          # the prefill: 4 prompts x 4096
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 16, 24   # launch/serve.py's
FLASH_NAIVE_TOL = 2e-3         # tests/test_flash_attention.py:69
DECODE_TOL = 5e-4              # tests/test_decode_consistency.py:39
FLASH_REPS, FLASH_WINDOWS = 5, 3   # the plain version moves ~13 GB a call
# B7 in 16 bits is also held row by row (one output row of one head): a
# row's error at most MATMUL_RATIO times the plain result's error in that
# row, or times the type's unit roundoff (the output's own rounding) of
# the row's max|f64| where that is larger. The one limit over all rows is
# set by the rows of largest output (the first rows of a causal head,
# which see few keys) and lets a fault in the late rows through
HALF_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
# the bf16 prefill's last logits against the f32 prefill of the same
# (bf16-rounded) weights: the flash path's error at most this many times
# the naive path's. Both round every layer's activations to bf16 and so
# carry errors of one order; the flash path differs only in attention's
# summation order and where P is rounded. The same prefill through a
# faulty B7 (no causal mask; the last 64 keys dropped) must read past it
SERVE_BF16_RATIO = 2.0


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


def reset_peak() -> None:
    """Start a path's own peak-memory reading: release the cuBLAS
    workspace that earlier phases' products left allocated (32 MiB on
    an H100) and the cached blocks, then reset the peak."""
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def same_nonfinite(kernel, plain) -> None:
    """NaN and Inf at the same places, with the same infinities."""
    fin = torch.isfinite(plain)
    if not torch.equal(torch.isfinite(kernel), fin):
        fail("kernel and plain versions disagree on non-finite entries")
    if not torch.equal(torch.isnan(kernel), torch.isnan(plain)):
        fail("kernel and plain versions disagree on NaN entries")
    nonfin = ~fin & ~torch.isnan(plain)
    if not torch.equal(kernel[nonfin], plain[nonfin]):
        fail("kernel and plain versions disagree on infinite entries")


def compare(kernel, plain) -> float:
    """max|kernel - plain| over finite entries; NaN/Inf must sit at the
    same places with the same values. Fails past the tolerance."""
    kernel, plain = kernel.float(), plain.float()
    same_nonfinite(kernel, plain)
    fin = torch.isfinite(plain)
    if not bool(fin.any()):
        return 0.0
    err = float((kernel[fin] - plain[fin]).abs().max())
    scale = float(plain[fin].abs().max())
    if err > KERNEL_TOL * (1.0 + scale):
        fail(f"max|kernel - plain| = {err:.3e} > {KERNEL_TOL} * (1 + {scale:.3e})")
    return err


def f64_matmul(a, b, transpose_a: bool, absolute: bool = False):
    """A B in float64 on the card, A converted in chunks of its stored
    rows (never a float64 copy of all of A); with ``absolute``, |A| |B|:
    the size of the terms each entry sums."""
    def wide(t):
        t = t.double()
        return t.abs() if absolute else t

    b64 = wide(b)
    rows = max(1, F64_CHUNK // max(1, a.shape[1]))
    if transpose_a:                              # a stored (K, M)
        c = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float64,
                        device=a.device)
        for k0 in range(0, a.shape[0], rows):
            c += wide(a[k0:k0 + rows]).T @ b64[k0:k0 + rows]
        return c
    return torch.cat([wide(a[m0:m0 + rows]) @ b64
                      for m0 in range(0, a.shape[0], rows)])


def f64_err(out, exact) -> float:
    """max|out - exact| over the entries finite in ``exact`` (NaN where
    ``out`` is not finite there)."""
    fin = torch.isfinite(exact)
    return float((out.double() - exact)[fin].abs().max()) \
        if bool(fin.any()) else 0.0


def f64_limit(plain, exact) -> tuple:
    """B5's limit on a result's error against float64: MATMUL_RATIO times
    the plain fp32 result's own, or times MATMUL_FLOOR * max|exact|
    where that is larger. Returns (limit, the plain result's error)."""
    plain_err = f64_err(plain, exact)
    scale = f64_err(torch.zeros_like(exact), exact)       # max|exact|
    return MATMUL_RATIO * max(plain_err, MATMUL_FLOOR * scale), plain_err


def held_to_f64(what: str, out, plain, exact) -> dict:
    """``out`` within B5's float64 limit (``f64_limit``); fails past it."""
    limit, plain_err = f64_limit(plain, exact)
    err = f64_err(out, exact)
    if not err <= limit:
        fail(f"{what}: max|result - float64| = {err:.3e} past its limit "
             f"{limit:.3e} ({MATMUL_RATIO:g} x the plain result's "
             f"{plain_err:.3e})")
    return {"err_vs_f64": err, "plain_err_vs_f64": plain_err,
            "f64_limit": limit}


def f64_entry_ratio(out, plain, exact, scale) -> float:
    """B5's rule entry by entry (16-bit results): the largest |out - exact|
    as a multiple of MATMUL_RATIO * max(|plain - exact|, MATMUL_FLOOR *
    scale) at the same entry, ``scale`` = |A| |B| in float64 (what a
    float32 sum of the entry's terms may be off by is below it), over
    the entries finite in ``exact`` and in ``plain`` (NaN where ``out``
    is not finite there)."""
    fin = torch.isfinite(exact) & torch.isfinite(plain.double())
    err = torch.where(fin, (out.double() - exact).abs(), 0.0)
    limit = MATMUL_RATIO * torch.maximum(
        torch.where(fin, (plain.double() - exact).abs(), 0.0),
        MATMUL_FLOOR * scale)
    return float(torch.where(err == 0, 0.0, err / limit).max())


def f64_row_limits(plain, exact):
    """B7's 16-bit limit for each row (the last axis): MATMUL_RATIO times
    the plain result's error in the row, or times the type's unit
    roundoff of the row's max|exact| where that is larger (entries
    finite in ``exact`` only)."""
    fin = torch.isfinite(exact)
    plain_err = torch.where(fin, (plain.double() - exact).abs(), 0.0)
    scale = torch.where(fin, exact.abs(), 0.0).amax(-1)
    unit = HALF_ROUNDOFF[str(plain.dtype).replace("torch.", "")]
    return MATMUL_RATIO * torch.maximum(plain_err.amax(-1), unit * scale)


def f64_row_ratio(out, exact, limits) -> float:
    """The largest row error of ``out`` as a multiple of its row's limit
    (NaN where ``out`` is not finite but ``exact`` is)."""
    fin = torch.isfinite(exact)
    err = torch.where(fin, (out.double() - exact).abs(), 0.0).amax(-1)
    return float(torch.where(err == 0, 0.0, err / limits).max())


def f64_rule_errors(what: str, kernel, plain, exact,
                    by_row: bool = False, scale=None) -> dict:
    """B5's check (B7's too): NaN/Inf where the plain version has them,
    and the kernel within its float64 limit; with max|kernel - plain|.
    With ``by_row`` (B7), a 16-bit result is held row by row as well;
    with ``scale`` (B5, |A| |B| in float64), a 16-bit result is held
    entry by entry (``f64_entry_ratio``)."""
    rows = {}
    if scale is not None and plain.dtype in (torch.bfloat16, torch.float16):
        ratio = f64_entry_ratio(kernel, plain, exact, scale)
        if not ratio <= 1.0:
            fail(f"{what}: an entry's |result - float64| is {ratio:.3g} of "
                 f"its entry's limit")
        rows = {"entry_ratio": ratio}
    if by_row and plain.dtype in (torch.bfloat16, torch.float16):
        ratio = f64_row_ratio(kernel, exact, f64_row_limits(plain, exact))
        if not ratio <= 1.0:
            fail(f"{what}: a row's max|result - float64| is {ratio:.3g} "
                 f"of its row's limit")
        rows = {"row_ratio": ratio}
    kernel, plain = kernel.float(), plain.float()
    same_nonfinite(kernel, plain)
    out = held_to_f64(what, kernel, plain, exact)
    fin = torch.isfinite(plain)
    diff = float((kernel - plain).abs()[fin].max()) if bool(fin.any()) else 0.0
    return {"max_abs_err": diff, **out, **rows}


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


def bound(bytes_: int, flops: int, bw: float, rate: float = FP32_FLOPS):
    """The least time for the work, ms, and what bounds it: the bytes at
    the memory rate or the operations at ``rate``."""
    t_bytes, t_ops = bytes_ / bw, flops / rate
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


def worker_update_case(shape, dtype, rho, gen, nan=False):
    g, y, z = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    if nan:
        g.view(-1)[:3] = float("nan")
        y.view(-1)[5] = float("inf")
        z.view(-1)[7] = float("-inf")
    return (g.view(-1), y.view(-1), z.view(-1), rho)


def worker_update_bytes_flops(case):
    g = case[0]
    return 6 * g.numel() * g.element_size() + 4, 5 * g.numel()


def matmul_case(m, k, n, transpose_a, gen, nan=False):
    a = torch.randn((k, m) if transpose_a else (m, k), generator=gen,
                    device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    if nan and k > 1 and n > 2:
        a[0, 0] = float("nan")                     # a row (or column) of C
        b[1, 2] = float("inf")                     # a column of C
    return (a, b, transpose_a)


def matmul_bytes_flops(case):
    a, b, transpose_a = case
    K, N = b.shape
    M = a.shape[1] if transpose_a else a.shape[0]
    return a.element_size() * (a.numel() + b.numel() + M * N), 2 * M * N * K


def margin_case(shape, gen, nan=False):
    s = 4.0 * torch.randn(shape, generator=gen, device="cuda")
    y = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5,
                    -1.0, 1.0)
    if nan:                                        # exp overflow, and NaN
        extremes = [1e4, -1e4, 100.0, -100.0, 89.0, -89.0, float("nan")]
        n = min(len(extremes), s.numel())
        s.view(-1)[:n] = torch.tensor(extremes[:n], device="cuda")
    return (s, y)


def margin_bytes_flops(case):
    s = case[0]
    return 3 * s.element_size() * s.numel(), 5 * s.numel()


def attention_case(BH, S, hd, causal, dtype, gen, nan=False):
    q, k, v = (torch.randn((BH, S, hd), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    if nan:
        q[0, S // 2, 3] = float("nan")         # one query row
        k[-1, S // 3, 5] = float("nan")        # one key of the last head
        v[0, 63, 7] = float("inf")             # a key of the first K tile,
    return (q, k, v, causal)                   # which every row visits


def attention_pairs(S: int, T: int, causal: bool) -> int:
    """The (query, key) pairs the function needs: all S * T, or under
    causal the keys at or before each query's index."""
    if not causal:
        return S * T
    n = min(S, T)
    return n * (n + 1) // 2 + (S - n) * T


def attention_bytes_flops(case):
    """q, k, v read and the output written once; a multiply-add (2
    operations) per needed pair and channel in each of q kᵀ and p v."""
    q, k, v, causal = case[:4]
    BH, S, hd = q.shape
    bytes_ = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return bytes_, 4 * BH * attention_pairs(S, k.shape[1], causal) * hd


def tensor_core_rate(dtype) -> float:
    """The peak rate of B5's and B7's tensor-core arithmetic in ``dtype``:
    the 16-bit tensor cores, or in float32 a third of TF32's (3xTF32 runs
    three TF32 products for each float32 one)."""
    return TF32_FLOPS / 3 if dtype == torch.float32 else TC16_FLOPS


def f64_attention(q, k, v, causal=True, scale=None):
    """B7's function in float64 on the card, one head at a time, with the
    scale rounded to float32 as the kernel and the plain version take
    it."""
    S, T, hd = q.shape[1], k.shape[1], q.shape[2]
    scale = float(torch.tensor(hd ** -0.5 if scale is None else scale,
                               dtype=torch.float32))
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril()
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for h in range(q.shape[0]):
        s = (q[h].double() @ k[h].double().T) * scale
        if causal:
            s = torch.where(mask, s, -1e30)
        out[h] = torch.softmax(s, dim=-1) @ v[h].double()
    return out


def sdpa(q, k, v, causal=True, scale=None):
    """B7's function as one PyTorch call: the library yardstick, timed
    here and used nowhere in the port. On a (1, BH, S, hd) view: on the
    3-D tensors PyTorch does not take its fused attention kernels."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=causal, scale=scale)[0]


PLAIN = {"admm_worker_select_update": "admm_worker_select_update_torch",
         "server_prox_update": "server_prox_update_torch",
         "prox_consensus": "prox_consensus_torch",
         "admm_worker_update": "admm_worker_update_torch",
         "matmul": "matmul_torch",
         "margin": "margin_torch",
         "flash_attention": "flash_attention_torch"}
COUNTS = {"admm_worker_select_update": worker_bytes_flops,
          "server_prox_update": server_bytes_flops,
          "prox_consensus": prox_bytes_flops,
          "admm_worker_update": worker_update_bytes_flops,
          "matmul": matmul_bytes_flops,
          "margin": margin_bytes_flops,
          "flash_attention": attention_bytes_flops}
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
    "admm_worker_update": (
        "src/repro_torch/csrc/admm_update.cu",
        "src/repro/kernels/admm_update.py:67"),
    "matmul": (
        "src/repro_torch/csrc/logreg_grad.cu",
        "src/repro/kernels/logreg_grad.py:51"),
    "margin": (
        "src/repro_torch/csrc/logreg_grad.cu",
        "src/repro/kernels/logreg_grad.py:87"),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:65"),
    # B7's 16-bit design (wgmma), on the serve path's bf16 prefill
    "flash_attention_bf16": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:65"),
}
# one PyTorch call for the same function, where there is one
LIBRARY = {"matmul": lambda a, b, transpose_a: torch.matmul(
               a.T if transpose_a else a, b),
           "flash_attention": sdpa}


def kernel_module(name: str):
    from repro_torch.kernels import (admm_update, flash_attention, logreg,
                                     prox_update)
    return {"flash_attention": flash_attention,
            "admm_worker_select_update": admm_update,
            "admm_worker_update": admm_update,
            "server_prox_update": prox_update,
            "prox_consensus": prox_update,
            "matmul": logreg,
            "margin": logreg}[name]


def check(name: str, case, errs) -> dict:
    """``name``'s kernel against its plain version on ``case`` (the
    matmul and flash attention against float64 instead); max|Δ| folded
    into ``errs``; fails past the tolerance."""
    mod = kernel_module(name)
    ks = getattr(mod, f"{name}_cuda")(*case)
    ps = getattr(mod, PLAIN[name])(*case)
    torch.cuda.synchronize()
    if name == "matmul":
        a, b, transpose_a = case
        out = f64_rule_errors("matmul kernel", ks, ps,
                              f64_matmul(a, b, transpose_a),
                              scale=half_scale(case))
    elif name == "flash_attention":
        out = f64_rule_errors("flash attention kernel", ks, ps,
                              f64_attention(*case), by_row=True)
    else:
        if isinstance(ks, torch.Tensor):
            ks, ps = (ks,), (ps,)
        out = {"max_abs_err": max(compare(k, p) for k, p in zip(ks, ps))}
    errs[name] = max(errs[name], out["max_abs_err"])
    return out


PROXES = ((1e-3, 0.8), (0.0, 0.8), (1e-3, 0.0), (0.0, 0.0))   # (l1, clip)
FLAT_SHAPES = ((1024,), (2048,), (8, 128), (2, 8, 128), (4, 2, 128))
# the reference's four, the gradient passes' N = 1, the cross-check's,
# and for the tensor-core designs a tile multiple and a ragged shape
MATMUL_SHAPES = ((128, 128, 128), (256, 384, 128), (100, 50, 30),
                 (129, 257, 65), (129, 257, 1), (1000, 3000, 1),
                 (96, 1024, 1), (1024, 96, 1), (384, 512, 512),
                 (200, 136, 264))
# ops.matmul's line, (size, dtype, transpose_a, the design it takes): the
# tensor-core designs at 4096^3 in the three types and both layouts of
# A, and the tiled design at 4095^3, where no row is a multiple of 4
# elements (TMA's and cp.async's 16-byte strides)
MATMUL_CELLS = tuple(
    (4096, dtype, t, "tf32x3" if dtype == torch.float32 else "wgmma")
    for dtype in (torch.float32, torch.bfloat16, torch.float16)
    for t in (False, True)) + ((4095, torch.float32, False, "tiled"),
                               (4095, torch.bfloat16, True, "tiled"))
# each design's K step: its pipeline-stage fault reads one step's A and B
# tiles twice and never the next step's
DESIGN_K_STEP = {"wgmma": 64, "tf32x3": 32, "tiled": 16}
MARGIN_SHAPES = ((1, 1), (129, 1), (96, 1), (256, 128), (1000, 3))
HALF_TYPES = (torch.bfloat16, torch.float16)   # B5 and B6's 16-bit types
HALF_X = (1 << 18, 1 << 14)    # X of B5's timed bf16 passes: 8.6 GB
# the reference test's (BH, S, hd) (tests/test_flash_attention.py:21-22)
ATTENTION_SHAPES = ((2, 128, 128), (4, 256, 128), (1, 512, 256),
                    (3, 384, 128))


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
    for shape in FLAT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for rho in (0.5, 100.0):
                for nan in (False, True):
                    check("admm_worker_update",
                          worker_update_case(shape, dtype, rho, gen, nan),
                          errs)
                    cells += 1
    matmul_f64 = {"err_vs_f64": 0.0, "plain_err_vs_f64": 0.0,
                  "share_of_limit": 0.0}
    from repro_torch.kernels import ops
    ops.reset_launch_counts()          # B5's designs reached by the cells
    for (m, k, n) in MATMUL_SHAPES:
        for transpose_a in (False, True):
            for nan in (False, True):
                out = check("matmul", matmul_case(m, k, n, transpose_a, gen,
                                                  nan), errs)
                out["share_of_limit"] = (out["err_vs_f64"] / out["f64_limit"]
                                         if out["f64_limit"] else 0.0)
                for key in matmul_f64:
                    matmul_f64[key] = max(matmul_f64[key], out[key])
                cells += 1
    for shape in MARGIN_SHAPES:
        for nan in (False, True):
            check("margin", margin_case(shape, gen, nan), errs)
            cells += 1
    # B5 and B6 in the 16-bit types: f32 accumulation, one rounding
    half_errs = {"matmul": 0.0, "margin": 0.0}
    for dtype in HALF_TYPES:
        for (m, k, n) in MATMUL_SHAPES:
            for transpose_a in (False, True):
                a, b, _ = matmul_case(m, k, n, transpose_a, gen, nan=True)
                out = check("matmul", (a.to(dtype), b.to(dtype),
                                       transpose_a), half_errs)
                matmul_f64["share_of_limit"] = max(
                    matmul_f64["share_of_limit"],
                    out["err_vs_f64"] / out["f64_limit"]
                    if out["f64_limit"] else 0.0)
                cells += 1
        for shape in MARGIN_SHAPES:
            s_, y_ = margin_case(shape, gen, nan=True)
            check("margin", (s_.to(dtype), y_.to(dtype)), half_errs)
            cells += 1
    matmul_designs = ops.matmul_design_counts()      # B5's five designs
    if not all(matmul_designs.values()):
        fail(f"kernels: B5's cells reached the designs {matmul_designs}, "
             f"not each of them")
    # B7 at the reference test's shapes, causal and not, in its three
    # types (3xTF32 in f32, wgmma in bf16 and f16)
    flash_f64 = {"err_vs_f64": 0.0, "plain_err_vs_f64": 0.0,
                 "share_of_limit": 0.0}
    for (BH, S, hd) in ATTENTION_SHAPES:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                for nan in (False, True):
                    out = check("flash_attention", attention_case(
                        BH, S, hd, causal, dtype, gen, nan), errs)
                    out["share_of_limit"] = (
                        out["err_vs_f64"] / out["f64_limit"]
                        if out["f64_limit"] else 0.0)
                    for key in flash_f64:
                        flash_f64[key] = max(flash_f64[key], out[key])
                    cells += 1
    emit("kernels_small", cells=cells, max_abs_err=errs,
         max_abs_err_16_bit=half_errs, matmul_designs=matmul_designs,
         matmul_vs_float64=matmul_f64,
         flash_attention_vs_float64=flash_f64)

    # B5's two gradient passes and B6 timed in bf16 (B5 on an X of
    # HALF_X, B6 on the margin's (2^20, 1)), held against float64
    m, d = HALF_X
    X = torch.empty((m, d), dtype=torch.bfloat16, device="cuda")
    for r0 in range(0, m, F64_CHUNK // d):
        X[r0:r0 + F64_CHUNK // d] = torch.randn(
            (F64_CHUNK // d, d), generator=gen, device="cuda")
    w, v = (torch.randn((n, 1), generator=gen, device="cuda").bfloat16()
            for n in (d, m))
    s_, y_ = margin_case((LOGREG_M, 1), gen)
    emit("kernels_16_bit", dtype="bfloat16",
         matmul_Xw=measure("matmul", (X, w, False), bw, half_errs,
                           LOGREG_REPS, LOGREG_WINDOWS),
         matmul_XTv=measure("matmul", (X, v, True), bw, half_errs,
                            LOGREG_REPS, LOGREG_WINDOWS),
         margin=measure("margin", (s_.bfloat16(), y_.bfloat16()), bw,
                        half_errs))
    del X, w, v, s_, y_
    torch.cuda.empty_cache()

    # full width without x (the track_x=False option, which no path below
    # drives); the paths' own inputs are checked by check_on_path
    from repro_torch.core.blocks import make_flat_blocks
    dblk = make_flat_blocks(KDDA_DIM, KDDA_BLOCKS).block_dim
    case = worker_case(KDDA_WORKERS, KDDA_BLOCKS, dblk, gen, with_x=False)
    emit("kernels_full", with_x=False,
         **measure("admm_worker_select_update", case, bw, errs))
    del case
    torch.cuda.empty_cache()


def phase_worker_update(bw: float, errs):
    """B4's path: ``ops.admm_worker_update``, the package's unmasked
    worker update, on the kdda_like worker bundle (8, 64, 315,904) f32;
    its inputs held against the plain version and timed there."""
    from repro_torch.core.blocks import make_flat_blocks
    from repro_torch.kernels import ops

    dblk = make_flat_blocks(KDDA_DIM, KDDA_BLOCKS).block_dim
    gen = torch.Generator(device="cuda").manual_seed(7)
    g, y, z = (torch.randn((KDDA_WORKERS, KDDA_BLOCKS, dblk), generator=gen,
                           device="cuda") for _ in range(3))
    ops.reset_launch_counts()
    with capture_inputs(copy=False, names=("admm_worker_update",)) as inputs:
        x, y_new, w = ops.admm_worker_update(g, y, z, 2.0)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expect_counts("worker_update", launches, {"admm_worker_update": 1})
    if not (x.shape == w.shape == g.shape and torch.equal(y_new, -g)
            and bool(torch.isfinite(x).all() & torch.isfinite(w).all())):
        fail("worker_update: outputs are not finite (x, -g, w) of the "
             "bundle's shape")
    (case,) = inputs["admm_worker_update"]
    row = measure("admm_worker_update", case, bw, errs)
    emit("worker_update", launches=launches, **row)
    del g, y, z, x, y_new, w, case, inputs
    torch.cuda.empty_cache()
    return launches, row


def half_scale(case):
    """|A| |B| in float64 for a 16-bit B5 case (its entry-by-entry
    limit), else None."""
    a, b, transpose_a = case
    if a.dtype == torch.float32:
        return None
    return f64_matmul(a, b, transpose_a, absolute=True)


def gate_ratio(out, plain, exact, scale) -> dict:
    """A faulty B5 result's error as a multiple of B5's limit over all
    entries and, in 16 bits, entry by entry."""
    limit, _ = f64_limit(plain, exact)
    ratio = {"all_entries": f64_err(out, exact) / limit}
    if scale is not None:
        ratio["by_entry"] = f64_entry_ratio(out, plain, exact, scale)
    return ratio


def refused(ratio) -> bool:
    return any(r > 1.0 for r in ratio.values())


def phase_matmul(bw: float, errs):
    """``ops.matmul``, the package's public op, on MATMUL_CELLS: one call
    a cell on the path, its launches and designs counted; then each
    result held to float64 by B5's rule, the gate shown to refuse
    ``refused_by_gate``'s faulty results at full size, and the op timed
    beside its plain version and ``torch.matmul`` on the same
    operands."""
    from repro_torch.kernels import ops

    lg = kernel_module("matmul")
    gen = torch.Generator(device="cuda").manual_seed(4096)
    cases = [(torch.randn((n, n), generator=gen, device="cuda").to(dtype),
              torch.randn((n, n), generator=gen, device="cuda").to(dtype), t)
             for (n, dtype, t, _) in MATMUL_CELLS]
    ops.reset_launch_counts()
    outs = [ops.matmul(a, b, transpose_a=t) for (a, b, t) in cases]
    torch.cuda.synchronize()
    launches, designs = ops.launch_counts(), ops.matmul_design_counts()
    expect_counts("matmul", launches, {"matmul": len(cases)})
    want = {d: sum(c[3] == d for c in MATMUL_CELLS) for d in designs}
    if designs != want:
        fail(f"matmul: designs {designs}, expected {want}")
    rows = []
    for (n, dtype, t, design), case, out in zip(MATMUL_CELLS, cases, outs):
        a, b, _ = case
        what = f"matmul {n}^3 {str(dtype)[6:]} transpose_a={t}"
        if not (out.shape == (n, n) and out.dtype == dtype):
            fail(f"{what}: result {tuple(out.shape)} {out.dtype}")
        plain = lg.matmul_torch(*case)
        exact, scale = f64_matmul(*case), half_scale(case)
        row = f64_rule_errors(what, out, plain, exact, scale=scale)
        row["faulty_over_limit"] = refused_by_gate(
            what, case, plain, exact, scale, DESIGN_K_STEP[design])
        del plain, exact, scale
        bytes_, flops = matmul_bytes_flops(case)
        bound_ms, bound_by = bound(bytes_, flops, bw, tensor_core_rate(dtype))
        rows.append(dict(
            n=n, dtype=str(dtype)[6:], transpose_a=t, design=design,
            ms=time_ms(lambda: ops.matmul(a, b, transpose_a=t)),
            plain_ms=time_ms(lambda: lg.matmul_torch(*case)),
            library_ms=time_ms(lambda: torch.matmul(a.T if t else a, b)),
            bytes=bytes_, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            ffma_bound_ms=bound(bytes_, flops, bw)[0], **row))
    for design in set(c[3] for c in MATMUL_CELLS):
        errs[f"matmul_{design}"] = max(r["max_abs_err"] for r in rows
                                       if r["design"] == design)
    emit("matmul", launches=launches, designs=designs, cells=rows,
         card=smi_line())
    del cases, outs
    torch.cuda.empty_cache()
    return launches, designs, rows


def measure(name: str, case, bw: float, errs, reps: int = REPS,
            windows: int = WINDOWS) -> dict:
    """``name``'s kernel against its plain version on ``case``: max|Δ|
    (folded into ``errs``), both times, and the bound; for the matmul
    the plain version is ``torch.matmul``, which is also its library
    time."""
    out = check(name, case, errs)
    mod = kernel_module(name)
    kernel, plain = getattr(mod, f"{name}_cuda"), getattr(mod, PLAIN[name])
    ms = time_ms(lambda: kernel(*case), reps, windows)
    plain_ms = time_ms(lambda: plain(*case), reps, windows)
    library_ms, extra = None, {}
    if name in LIBRARY:
        call = LIBRARY[name]
        library_ms = time_ms(lambda: call(*case), reps, windows)
        extra["library_max_abs_diff_vs_plain"] = float(
            (call(*case).float() - plain(*case).float()).abs().max())
    bytes_, flops = COUNTS[name](case)
    rate = tensor_core_rate(case[0].dtype) if name == "flash_attention" \
        else FP32_FLOPS
    bound_ms, bound_by = bound(bytes_, flops, bw, rate)
    if name == "flash_attention":
        extra["dtype"] = str(case[0].dtype).replace("torch.", "")
        if case[0].dtype == torch.float32:    # the FFMA design's bound
            extra["ffma_bound_ms"] = bound(bytes_, flops, bw)[0]
    return dict(name=name, shape=list(case[1].shape),
                shapes=[list(t.shape) for t in case
                        if isinstance(t, torch.Tensor)],
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=bytes_, flops=flops, bound_ms=bound_ms,
                bound_by=bound_by, **out, **extra)


@contextlib.contextmanager
def capture_inputs(copy: bool = True, names=None, keep=None):
    """Inside the block, keep the arguments of every launch of each kernel
    (of ``names``; all by default; the first ``keep`` of each when
    given), by name in launch order: copies, or with ``copy=False`` the
    tensors themselves (inputs too large to copy, which nothing writes
    to afterwards). The launches go ahead unchanged."""
    inputs, restore = {}, []
    for name in (names or PLAIN):
        mod = kernel_module(name)
        real = getattr(mod, f"{name}_cuda")

        def wrapped(*args, _real=real, _name=name):
            kept = inputs.setdefault(_name, [])
            if keep is None or len(kept) < keep:
                kept.append(tuple(
                    a.clone() if copy and isinstance(a, torch.Tensor) else a
                    for a in args))
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
    kernels the path must have launched, once each."""
    if set(inputs) != set(names) or any(len(c) != 1 for c in inputs.values()):
        fail(f"{path}: kernels launched in the captured epoch: "
             f"{ {k: len(c) for k, c in inputs.items()} }, expected one "
             f"launch of each of {sorted(names)}")
    rows = {}
    for name, (case,) in inputs.items():
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


def expect_counts(path: str, launches, want) -> None:
    """Each kernel launched ``want[name]`` times on ``path``, every other
    kernel never."""
    full = {k: want.get(k, 0) for k in PLAIN}
    if launches != full:
        fail(f"{path}: launches {launches}, expected {full}")


def expect_launches(path: str, launches, epochs: int, names) -> None:
    """``names`` launched once an epoch on ``path``, every other kernel
    never."""
    expect_counts(path, launches, {k: epochs for k in names})


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
    reset_peak()
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


def profile_calls(path: str, run, wall_ms: float, calls: int,
                  unit: str = "epoch"):
    """Device time by kernel over ``calls`` calls of ``run`` (one epoch,
    one prefill, one decode step: a ``unit``) with torch.profiler, and
    the device's idle share of an unprofiled call (``wall_ms``): the
    profiler's own start-up lands in its window, so that window's wall
    time is not the call's. The table by kernel goes to
    ``<path>_profile.json`` in the output directory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # kernel events only: an operator's entry repeats its kernels' time
        if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0:
            rows.append((ev.device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / calls
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{path}_profile.json").write_text(json.dumps(
        {f"{unit}s": calls, f"{unit}_ms": wall_ms,
         "by_kernel": [{"name": k, f"device_ms_per_{unit}": t / 1e3 / calls,
                        f"count_per_{unit}": c / calls}
                       for t, k, c in rows]}, indent=1))
    return {f"{unit}s": calls, f"device_busy_ms_per_{unit}": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top": [{"name": k[:80], "device_ms": t / 1e3 / calls,
                     "count": c / calls} for t, k, c in rows[:8]]}


def profile_epochs(path: str, sess, state, epoch_ms: float, epochs: int = 3):
    """``profile_calls`` over ``epochs`` epochs of ``sess`` from
    ``state``."""
    held = [state]

    def run():
        held[0], _ = sess.step(held[0])

    return profile_calls(path, run, epoch_ms, epochs)


# ---------------------------------------------------------------------------
# phase 5: the paper's workload
# ---------------------------------------------------------------------------

PAPER_VARIANT = "AsyBADMM (D=2, 50% blocks)"


def phase_paper(bw: float, errs):
    """The paper's entry points on the card: one variant of
    ``examples.sparse_logreg_admm`` on both backends (same draws), then
    that script, the quickstart and the Fig. 2 benchmark at their
    defaults."""
    from repro_torch.benchmarks import convergence
    from repro_torch.examples import quickstart
    from repro_torch.examples import sparse_logreg_admm as slr
    from repro_torch.kernels import ops

    data = slr.make_data()
    cfg = slr.VARIANTS[PAPER_VARIANT]
    out = {}
    for backend in ("auto", "torch"):
        sess = slr.session_for(data, cfg, device="cuda", backend=backend)
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
    emit("paper", variant=PAPER_VARIANT, epochs=PAPER_EPOCHS,
         dim=data.X.shape[-1], workers=data.X.shape[0], blocks=cfg.num_blocks,
         z_max_abs_diff_vs_torch=diff,
         **{b: {key: v for key, v in r.items() if key != "zs"}
            for b, r in out.items()})
    check_on_path("paper", inputs, MAIN_KERNELS, bw, errs)

    entry = {}
    # examples/sparse_logreg_admm.py: three variants and the cross-check
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with capture_inputs(names=("matmul", "margin")) as cross:
        res = slr.main([])
    entry["sparse_logreg_admm_s"] = time.perf_counter() - t0
    epochs = sum(r["epochs"] for r in res["rows"])
    expect_counts("sparse_logreg_admm", ops.launch_counts(),
                  {"admm_worker_select_update": epochs,
                   "server_prox_update": epochs, "matmul": 2, "margin": 1})
    ck = res["crosscheck"]
    if not torch.allclose(ck["g_kernel"], ck["g_auto"], **CROSSCHECK_TOL):
        fail(f"sparse_logreg_admm: logreg_grad and autograd differ by "
             f"{ck['max_abs_err']:.3e}")
    entry["crosscheck_max_abs_err"] = ck["max_abs_err"]
    for row in res["rows"]:
        if row["backend"] != "cuda" or \
                not row["objective"] < row["objective_start"]:
            fail(f"sparse_logreg_admm: {row}")
    entry["sparse_logreg_admm"] = res["rows"]

    # examples/quickstart.py
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    qs = quickstart.main([])
    entry["quickstart_s"] = time.perf_counter() - t0
    expect_launches("quickstart", ops.launch_counts(), quickstart.EPOCHS,
                    MAIN_KERNELS)
    if qs["backend"] != "cuda" or \
            not qs["history"][-1]["objective"] < qs["objective_start"]:
        fail(f"quickstart: {qs}")
    entry["quickstart"] = {"P": qs["P"], "kkt": qs["kkt"],
                           "objective_start": qs["objective_start"],
                           "objective_end": qs["history"][-1]["objective"]}

    # benchmarks/convergence.py (one warm-up epoch per variant)
    ops.reset_launch_counts()
    lines = []
    t0 = time.perf_counter()
    conv = convergence.main(emit=lines.append)
    entry["convergence_s"] = time.perf_counter() - t0
    epochs = len(convergence.VARIANTS) * (convergence.EPOCHS + 1)
    expect_launches("convergence", ops.launch_counts(), epochs, MAIN_KERNELS)
    for r, (_, vcfg) in zip(conv, convergence.VARIANTS):
        start = convergence.build_session(vcfg, device="cuda")
        obj0 = start.objective(start.init())
        if r["backend"] != "cuda" or not r["trace"][-1] < obj0:
            fail(f"convergence: {r['name']} on {r['backend']}: objective "
                 f"{obj0} -> {r['trace']}")
    entry["convergence"] = lines
    emit("paper_entry_points", **entry)

    # the cross-check's own B5 and B6 launches against the plain versions
    if [len(cross.get(n, ())) for n in ("matmul", "margin")] != [2, 1]:
        fail(f"sparse_logreg_admm: cross-check launches "
             f"{ {n: len(c) for n, c in cross.items()} }")
    for name, cases in cross.items():
        for case in cases:
            emit("kernels_on_path", path="paper_crosscheck",
                 **measure(name, case, bw, errs))


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
            reset_peak()
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
        shapes = {name: [list(case[1].shape) for case in cases]
                  for name, cases in inputs.items()}
        for name, cases in inputs.items():
            for case in cases:
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
        want = {"admm_worker_select_update": [[4, 32, 32768]],
                "prox_consensus": [[32, 32768]]}
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
         kernels_on_tiles={name: {"shape": shapes[0], "max_abs_err": max(
             r["max_abs_err"][name] for r in ranks)}
             for name, shapes in ranks[0]["captured"].items()},
         z_max_abs_diff_vs_single=max(diffs),
         measures_single=measures_single,
         measures_rank0=ranks[0]["measures"],
         epoch_ms_median_per_rank=[statistics.median(r["epoch_ms"][1:])
                                   for r in ranks])


# ---------------------------------------------------------------------------
# phase 7b: the event-driven Parameter Server runtime at KDDa width
# ---------------------------------------------------------------------------

PS_ROUNDS = 6
PS_TELEMETRY_ROUNDS = 3
PS_DISCIPLINES = ("lockfree", "locked")
PS_SCENARIOS = ("skew", "heavy_tail", "churn", "lossy")


def ps_timing():
    from repro_torch.ps import CostProfile, LognormalService
    return CostProfile(t_worker=LognormalService(1.0, 0.3),
                       t_server_block=LognormalService(0.25, 0.15))


def ps_block_commits(res) -> int:
    """Block commits of a run, from its metrics: domain commits times
    the blocks a domain holds (every discipline here splits the blocks
    evenly over its domains)."""
    domains = len(res.metrics["server_busy_time"])
    return res.metrics["commits"] * KDDA_BLOCKS // domains


def ps_replay(sess_cfg, res) -> list:
    """Replay ``res``'s trace through the vectorized epoch on the
    kernels; every round's z must equal the runtime's bitwise. Returns
    the epochs' ms."""
    from repro_torch.api import ConsensusSession
    cfg, centers = sess_cfg
    rs = ConsensusSession.flat(quad_loss, centers, dim=KDDA_DIM, cfg=cfg,
                               delay_model=res.to_delay_model())
    state = rs.init()
    times = []
    for t in range(res.num_rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = rs.step(state)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        z = rs.z(state)
        if not torch.equal(z, res.z_versions[t + 1]):
            diff = float((z - res.z_versions[t + 1]).abs().max())
            fail(f"ps {res.discipline}: the replayed z differs from the "
                 f"runtime's at round {t} by {diff:.3e} (bitwise gate)")
    return times


def phase_ps(bw: float, errs):
    """``ConsensusSession.run_ps`` at the kdda_like width and config, 6
    rounds under each of lockfree and locked with lognormal service
    times: B1 once per worker compute and B2 once per block commit, both
    counts read from the run's own metrics; each run's trace replayed
    through the vectorized epoch on the kernels, z bitwise equal at every
    round; B1 and B2 held against their plain versions on the inputs of
    the run's first worker compute and first commit, and timed there;
    telemetry shown inert (z, delays and makespan bitwise equal over 3
    rounds); then Table 1 from the card's measured costs, the
    locked/lockfree gate at 8 workers and the four scenarios' gates."""
    from repro_torch.api import ConsensusSession
    from repro_torch.benchmarks import speedup
    from repro_torch.kernels import ops
    from repro_torch.ps import measure_costs

    N, M = KDDA_WORKERS, KDDA_BLOCKS
    problem = kdda_problem()
    cfg, centers = problem
    sess = ConsensusSession.flat(quad_loss, centers, dim=KDDA_DIM, cfg=cfg)
    sess.run_ps(1, timing=ps_timing())          # warm-up, not counted
    rows = None
    for disc in PS_DISCIPLINES:
        reset_peak()
        ops.reset_launch_counts()
        # the first run's first worker compute and commit are kept
        capture = (capture_inputs(names=MAIN_KERNELS, keep=1)
                   if rows is None else contextlib.nullcontext({}))
        with capture as inputs:
            t0 = time.perf_counter()
            res = sess.run_ps(PS_ROUNDS, discipline=disc,
                              timing=ps_timing(), record_z=True)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        computes = res.metrics["worker_iterations"]
        commits = ps_block_commits(res)
        expect_counts(f"ps {disc}", launches,
                      {"admm_worker_select_update": computes,
                       "server_prox_update": commits})
        if computes != N * PS_ROUNDS or commits != M * PS_ROUNDS:
            fail(f"ps {disc}: {computes} worker computes and {commits} "
                 f"block commits in {PS_ROUNDS} rounds")
        z = res.z_final
        if tuple(z.shape) != (KDDA_DIM,) or not bool(torch.isfinite(z).all()):
            fail(f"ps {disc}: z is not a finite vector of the problem's dim")
        replay_ms = ps_replay(problem, res)
        emit("ps", discipline=disc, N=N, M=M, dim=KDDA_DIM,
             rounds=res.num_rounds, wall_s=wall_s,
             wall_ms_per_round=1e3 * wall_s / res.num_rounds,
             replay_epoch_ms=replay_ms,
             replay_epoch_ms_median=statistics.median(replay_ms[1:]),
             makespan=res.makespan, stall_count=res.metrics["stall_count"],
             stall_time=res.metrics["stall_time"],
             max_served_tau=res.metrics["max_served_tau"],
             worker_computes=computes, block_commits=commits,
             launches=launches, peak_bytes=peak, replay_bitwise=True,
             losses=res.losses, card=smi_line())
        del res, z
        if rows is None:
            rows = check_on_path("ps", inputs, MAIN_KERNELS, bw, errs)
        del inputs

    # telemetry is inert: the same 3 rounds with and without it
    off = sess.run_ps(PS_TELEMETRY_ROUNDS, timing=ps_timing())
    on = sess.run_ps(PS_TELEMETRY_ROUNDS, timing=ps_timing(), telemetry=True)
    if on.makespan != off.makespan or \
            on.trace.delays.tolist() != off.trace.delays.tolist() or \
            not all(torch.equal(a, b) for a, b in zip(on.z_versions,
                                                        off.z_versions)):
        fail("ps: telemetry changed the run (z, delays or makespan)")
    spans = len(on.telemetry.spans) if on.telemetry.spans is not None else 0
    emit("ps_telemetry", rounds=PS_TELEMETRY_ROUNDS, makespan=on.makespan,
         z_bitwise=True, span_events=spans)
    del on, off

    # Table 1 from this card's costs, and the scenarios' gates
    costs = measure_costs(sess.spec, sess.data)
    del sess, centers, problem
    torch.cuda.empty_cache()
    lines = []

    def collect(line):
        lines.append(line)

    table = speedup.table1(collect, costs, device="cuda")
    gates = {"speedup_x8": speedup.smoke_gate(collect, costs, "cuda")}
    for name in PS_SCENARIOS:
        gates[name] = speedup.SCENARIOS[name](collect, smoke=True,
                                              device="cuda")
    emit("ps_table1", t_worker_us=1e6 * costs["t_worker"],
         t_server_block_us=1e6 * costs["t_server_block"],
         k=speedup.K_ITERS, rows=table, gates=gates,
         lines=[ln for ln in lines if "_hist," not in ln])
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        fail(f"ps: gates failed: {failed}: {lines}")
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 8: the model stack at qwen3-1.7b's full width, and its serving path
# ---------------------------------------------------------------------------

def refused_attention(case, plain, exact) -> dict:
    """Results a faulty B7 could return for ``case``, which its float64
    gate must refuse: no causal mask; the last 64 keys dropped; inputs
    with too few mantissa bits (f32 inputs rounded to bf16's 7, 16-bit
    inputs cut to 3); in 16 bits also K and V read one 64-key tile late
    (the first 64 keys dropped). In 16 bits the gate is B5's rule and
    the row-by-row one (``f64_row_limits``): one limit over all rows,
    set by the early rows' outputs, lets 64 lost keys of 4,096 in the
    last 64 rows through. Returns each one's error as a multiple of the
    gate's limit (the larger reading of the two rules), and in 16 bits
    each rule's reading."""
    fa = kernel_module("flash_attention")
    q, k, v, causal, scale = case
    limit, _ = f64_limit(plain, exact)
    T = k.shape[1]
    faulty = {
        "no_causal_mask": lambda: fa.flash_attention_cuda(
            q, k, v, False, scale),
        "last_K_tile_dropped": lambda: fa.flash_attention_cuda(
            q, k[:, :T - 64].contiguous(), v[:, :T - 64].contiguous(),
            causal, scale)}
    half = q.dtype != torch.float32
    if not half:
        faulty["bf16_inputs"] = lambda: fa.flash_attention_cuda(
            drop_bits(q, 16), drop_bits(k, 16), drop_bits(v, 16), causal,
            scale)
    else:
        row_limits = f64_row_limits(plain, exact)

        def cut(t):
            return drop_bits(t.float(), 20).to(t.dtype)
        faulty["inputs_3_mantissa_bits"] = lambda: fa.flash_attention_cuda(
            cut(q), cut(k), cut(v), causal, scale)
        faulty["K_V_one_tile_late"] = lambda: fa.flash_attention_cuda(
            q, k[:, 64:].contiguous(), v[:, 64:].contiguous(), causal, scale)
    ratios, by_rule = {}, {}
    for name, make in faulty.items():
        out = make()
        ratios[name] = f64_err(out, exact) / limit
        if half:
            by_rule[name] = {"all_rows": ratios[name],
                             "by_row": f64_row_ratio(out, exact, row_limits)}
            ratios[name] = max(by_rule[name].values())
        del out
        if not ratios[name] > 1.0:
            fail(f"serve: B7's float64 gate let a faulty result through "
                 f"({name}, {q.dtype}: {ratios[name]:.3g} of its limit)")
    return {"faulty_over_limit": ratios,
            **({"faulty_over_limit_by_rule": by_rule} if half else {})}


def b7_on_path(case, cfg, dtype, bw, errs) -> dict:
    """B7 on the inputs the prefill gave it at layer 0: held to float64
    by B5's rule (in 16 bits row by row too), the gate shown to refuse
    faulty results (``refused_attention``), timed beside its plain
    version and SDPA in the same dtype."""
    hd = cfg.resolved_head_dim
    if [list(t.shape) for t in case[:3]] != [
            [SERVE_BATCH * cfg.num_heads, SERVE_SEQ, hd]] * 3 or \
            case[3] is not True or case[0].dtype != dtype:
        fail(f"serve: B7 was given {[list(t.shape) for t in case[:3]]} "
             f"{case[0].dtype}, causal={case[3]}")
    row = measure("flash_attention", case, bw, errs, FLASH_REPS,
                  FLASH_WINDOWS)
    fa = kernel_module("flash_attention")
    exact = f64_attention(*case)
    row.update(refused_attention(case, fa.flash_attention_torch(*case),
                                 exact))
    return row


def serve_bf16(cfg, tokens, bw, errs) -> tuple:
    """The serve prefill in bf16: the same arch, seed and tokens, so the
    weights are the f32 draws rounded to bf16. Flash (B7 once per layer:
    the path's launches) and naive, timed; each one's last-position
    logits against the f32 prefill of the same bf16-rounded weights (the
    flash path within SERVE_BF16_RATIO times the naive path's error, and
    the flash path through a faulty B7 past it); a profile of one flash
    prefill; B7 on layer 0's bf16 inputs (``b7_on_path``), and on the
    same inputs in f16."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg16 = cfg.with_(dtype="bfloat16", param_dtype="bfloat16")
    naive16 = build_model(cfg16)
    flash16 = build_model(cfg16.with_(attn_impl="flash"))
    params16 = naive16.init(0)

    def prefill(m, params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.prefill(params, tokens, logits_mode="last")
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    reset_peak()
    ops.reset_launch_counts()
    with capture_inputs(names=("flash_attention",), keep=1) as inputs:
        flash_logits, flash_first_ms = prefill(flash16, params16)
    launches = ops.launch_counts()
    flash_peak = torch.cuda.max_memory_allocated()
    expect_counts("serve prefill (flash, bf16)", launches,
                  {"flash_attention": cfg.num_layers})
    flash_ms = [prefill(flash16, params16)[1] for _ in range(2)]
    profile = profile_calls(
        "serve_prefill_bf16", lambda: flash16.prefill(
            params16, tokens, logits_mode="last"),
        statistics.median(flash_ms), 1, "prefill")
    reset_peak()
    ops.reset_launch_counts()
    naive_logits, naive_first_ms = prefill(naive16, params16)
    expect_counts("serve prefill (naive, bf16)", ops.launch_counts(), {})
    naive_peak = torch.cuda.max_memory_allocated()
    naive_ms = [prefill(naive16, params16)[1]]

    # the flash prefill through a faulty B7 in every layer
    fa = kernel_module("flash_attention")
    real = fa.flash_attention_cuda
    faults = {
        "no_causal_mask": lambda q, k, v, causal, scale: real(
            q, k, v, False, scale),
        "last_K_tile_dropped": lambda q, k, v, causal, scale: real(
            q, k[:, :-64].contiguous(), v[:, :-64].contiguous(), causal,
            scale)}
    faulty_logits = {}
    for name_, fault in faults.items():
        fa.flash_attention_cuda = fault
        try:
            faulty_logits[name_] = flash16.prefill(params16, tokens,
                                                   logits_mode="last")
        finally:
            fa.flash_attention_cuda = real

    params32 = copy.deepcopy(params16).float()
    ref = build_model(cfg.with_(attn_impl="flash")).prefill(
        params32, tokens, logits_mode="last")
    del params32, params16
    for name_, lg in (("flash", flash_logits), ("naive", naive_logits)):
        if lg.shape != (SERVE_BATCH, 1, cfg.vocab_size) or \
                lg.dtype != torch.bfloat16 or not bool(
                    torch.isfinite(lg).all()):
            fail(f"serve: bf16 {name_} prefill logits {tuple(lg.shape)} "
                 f"{lg.dtype} are not finite bf16 last-position logits")
    flash_err = float((flash_logits.float() - ref).abs().max())
    naive_err = float((naive_logits.float() - ref).abs().max())
    if not flash_err <= SERVE_BF16_RATIO * naive_err:
        fail(f"serve: bf16 flash prefill logits {flash_err:.3e} from the "
             f"f32 prefill of the same weights, past {SERVE_BF16_RATIO:g} "
             f"x the naive path's {naive_err:.3e}")
    faulty_over_naive = {
        name_: float((lg.float() - ref).abs().max()) / naive_err
        for name_, lg in faulty_logits.items()}
    for name_, ratio in faulty_over_naive.items():
        if not ratio > SERVE_BF16_RATIO:
            fail(f"serve: the bf16 flash prefill through a faulty B7 "
                 f"({name_}) reads {ratio:.3g} x the naive path's error, "
                 f"within its limit of {SERVE_BF16_RATIO:g}")
    del flash_logits, naive_logits, faulty_logits, ref
    torch.cuda.empty_cache()

    (case,) = inputs["flash_attention"]
    row = b7_on_path(case, cfg, torch.bfloat16, bw, errs)
    # the same inputs in f16 (on no path): checked, gated and timed
    case_f16 = tuple(t.half() if isinstance(t, torch.Tensor) else t
                     for t in case)
    row_f16 = b7_on_path(case_f16, cfg, torch.float16, bw,
                         {"flash_attention": 0.0})
    del case, case_f16, inputs
    torch.cuda.empty_cache()
    return launches, row, dict(
        dtype="bfloat16", launches=launches, flash_ms=flash_ms,
        flash_first_ms=flash_first_ms, naive_ms=naive_ms,
        naive_first_ms=naive_first_ms, flash_peak_bytes=flash_peak,
        naive_peak_bytes=naive_peak, profile=profile,
        flash_err_vs_f32=flash_err, naive_err_vs_f32=naive_err,
        ratio_limit=SERVE_BF16_RATIO,
        faulty_b7_err_over_naive=faulty_over_naive,
        flash_attention_f16=row_f16)


def phase_serve(bw: float, errs):
    """The dense model stack at qwen3-1.7b's full width with random
    weights: ``Model.prefill`` of SERVE_BATCH x SERVE_SEQ tokens on the
    flash path (B7 once per layer: the path's launches) and on the naive
    path; B7 on layer 0's inputs against float64, its gate against
    faulty results, and its times; then ``Engine.generate`` with
    launch/serve.py's defaults through the KV-cache decode; last, with
    the f32 weights freed, the same prefill in bf16 (``serve_bf16``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import Engine

    cfg = get_config(SERVE_ARCH)
    model, flash = build_model(cfg), build_model(cfg.with_(attn_impl="flash"))
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ),
                           generator=gen, device="cuda")

    def prefill(m, toks, mode="last"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.prefill(params, toks, logits_mode=mode)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    # the path: the flash prefill, its launches counted, layer 0's B7
    # inputs kept
    reset_peak()
    ops.reset_launch_counts()
    with capture_inputs(names=("flash_attention",), keep=1) as inputs:
        flash_logits, flash_first_ms = prefill(flash, tokens)
    launches = ops.launch_counts()
    flash_peak = torch.cuda.max_memory_allocated()
    expect_counts("serve prefill (flash)", launches,
                  {"flash_attention": cfg.num_layers})
    flash_ms = [prefill(flash, tokens)[1] for _ in range(2)]
    flash_profile = profile_calls(
        "serve_prefill", lambda: flash.prefill(params, tokens,
                                               logits_mode="last"),
        statistics.median(flash_ms), 1, "prefill")
    reset_peak()
    ops.reset_launch_counts()
    naive_logits, naive_first_ms = prefill(model, tokens)
    expect_counts("serve prefill (naive)", ops.launch_counts(), {})
    naive_peak = torch.cuda.max_memory_allocated()
    naive_ms = [prefill(model, tokens)[1] for _ in range(2)]
    if flash_logits.shape != (SERVE_BATCH, 1, cfg.vocab_size) or not bool(
            torch.isfinite(flash_logits).all()):
        fail(f"serve: flash prefill logits {tuple(flash_logits.shape)} are "
             f"not finite last-position logits")
    flash_vs_naive = float((flash_logits - naive_logits).abs().max())
    if not flash_vs_naive < FLASH_NAIVE_TOL:
        fail(f"serve: flash and naive prefill logits differ by "
             f"{flash_vs_naive:.3e} (limit {FLASH_NAIVE_TOL})")
    del flash_logits, naive_logits

    # B7 on the path's own inputs: float64, faulty results, times
    (case,) = inputs["flash_attention"]
    row = b7_on_path(case, cfg, torch.float32, bw, errs)
    del case, inputs
    torch.cuda.empty_cache()

    # serving: launch/serve.py's defaults at full width
    engine = Engine(model, params, max_len=SERVE_PROMPT + SERVE_NEW + 8)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS,
                                                SERVE_PROMPT),
                            generator=gen, device="cuda")
    reset_peak()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    decode_launches = ops.launch_counts()
    decode_peak = torch.cuda.max_memory_allocated()
    expect_counts("serve decode", decode_launches, {})
    if res.tokens.shape != (SERVE_REQUESTS, SERVE_NEW) or \
            res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
        fail(f"serve: generated tokens {res.tokens.shape}, ids "
             f"{res.tokens.min()}..{res.tokens.max()}")

    # decode against prefill at each prompt position, timed per step
    cache = model.init_cache(SERVE_REQUESTS, engine.max_len)
    step_ms, steps = [], []
    for t in range(SERVE_PROMPT):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, prompts[:, t:t + 1], cache, t)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        steps.append(lg[:, 0])
    decoded = torch.stack(steps, dim=1)
    full, _ = prefill(model, prompts, "all")
    decode_err = float((decoded - full).abs().max())
    if not decode_err < DECODE_TOL:
        fail(f"serve: decode and prefill logits differ by {decode_err:.3e} "
             f"(limit {DECODE_TOL})")
    # the first token is the flash prefill's argmax wherever its top-2
    # gap exceeds what separates the decode's last logits from it
    last, _ = prefill(flash, prompts)
    last = last[:, -1]
    delta = float((decoded[:, -1] - last).abs().max())
    top2 = last.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > delta
    first = torch.as_tensor(res.tokens[:, 0], device="cuda")
    if not torch.equal(first[decided], last.argmax(-1)[decided]):
        fail(f"serve: first tokens {first.tolist()} against the flash "
             f"prefill's argmax {last.argmax(-1).tolist()}")
    step = statistics.median(step_ms[1:])
    held = [cache, SERVE_PROMPT]

    def one_step():        # decode further steps after the prompt
        _, held[0] = model.decode_step(params, prompts[:, :1], held[0],
                                       held[1])
        held[1] += 1

    decode_profile = profile_calls("serve_decode", one_step, step, 5,
                                   "decode_step")
    serve = dict(requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
                 max_new=SERVE_NEW, generate_s=generate_s,
                 generate_tokens_per_s=SERVE_REQUESTS * SERVE_NEW
                 / generate_s, decode_steps=SERVE_PROMPT + SERVE_NEW,
                 decode_ms_per_step=step,
                 decode_tokens_per_s=SERVE_REQUESTS / (step / 1e3),
                 launches=decode_launches, peak_bytes=decode_peak,
                 profile=decode_profile,
                 decode_vs_prefill_max_abs_err=decode_err,
                 first_token_delta=delta,
                 first_tokens_decided=int(decided.sum()),
                 tokens_req0=res.tokens[0].tolist())
    emit("serve", arch=cfg.name, params=n_params,
         weight_bytes=sum(p.numel() * p.element_size()
                          for p in params.parameters()), init_s=init_s,
         prefill=dict(batch=SERVE_BATCH, seq=SERVE_SEQ, launches=launches,
                      flash_ms=flash_ms, flash_first_ms=flash_first_ms,
                      naive_ms=naive_ms, naive_first_ms=naive_first_ms,
                      flash_peak_bytes=flash_peak, profile=flash_profile,
                      naive_peak_bytes=naive_peak,
                      flash_vs_naive_max_abs_diff=flash_vs_naive),
         flash_attention=row, serve=serve, card=smi_line())
    del params, model, flash, engine, cache, held, res, decoded, full, last
    torch.cuda.empty_cache()

    # the same prefill in bf16 (after the decode, the f32 weights freed),
    # its own B7 counted and checked
    errs16 = {"flash_attention": 0.0}
    launches16, row16, prefill16 = serve_bf16(cfg, tokens, bw, errs16)
    errs["flash_attention_bf16"] = errs16["flash_attention"]
    emit("serve_bf16", arch=cfg.name, prefill=prefill16,
         flash_attention=row16, card=smi_line())
    del tokens
    torch.cuda.empty_cache()
    return (launches, {"flash_attention": row},
            {"flash_attention_bf16": launches16["flash_attention"]},
            {"flash_attention_bf16": row16})


# ---------------------------------------------------------------------------
# phase 9: the logistic-regression gradient at its declared size
# ---------------------------------------------------------------------------

LOGREG_WORKSPACE = 8 << 30     # bytes beside X: float64 chunks, autograd


def plain_logreg_grad(X, y, w):
    """``ops.logreg_grad`` composed of the kernels' plain versions."""
    lg = kernel_module("matmul")
    m, d = X.shape
    s = lg.matmul_torch(X, w.reshape(d, 1))
    v = lg.margin_torch(s, y.reshape(m, 1))
    return lg.matmul_torch(X, v, transpose_a=True).reshape(d) / m


def autograd_logreg_grad(X, y, w):
    w = w.detach().requires_grad_(True)
    loss = torch.mean(torch.log1p(torch.exp(-y * (X @ w))))
    (g,) = torch.autograd.grad(loss, w)
    return g


def drop_bits(t, bits: int):
    """A copy of float32 ``t`` rounded to 23 - ``bits`` mantissa bits
    (16: bfloat16, 13: TF32), to nearest with ties away from zero."""
    i = t.clone().view(torch.int32)
    return ((i + (1 << (bits - 1))) & -(1 << bits)).view(torch.float32)


def rounded_product(a, b, transpose_a: bool, bits: int):
    """B5 on ``a`` and ``b`` rounded by ``drop_bits`` (``a`` a chunk of
    stored rows at a time, widened to float32 to round and narrowed back
    to its type, exactly): what a kernel with low-precision inputs would
    return. The chunks of A^T B are added in float32."""
    lg = kernel_module("matmul")
    rb = drop_bits(b.float(), bits).to(b.dtype)
    rows = F64_CHUNK // a.shape[1]
    parts = [lg.matmul_cuda(drop_bits(a[r:r + rows].float(), bits)
                            .to(a.dtype),
                            rb[r:r + rows] if transpose_a else rb,
                            transpose_a)
             for r in range(0, a.shape[0], rows)]
    if transpose_a:
        return sum(p.float() for p in parts).to(a.dtype)
    return torch.cat(parts)


def refused_by_gate(what: str, case, plain, exact, scale=None,
                    k_step=None) -> dict:
    """Results a faulty B5 could return for ``case``: zeros, the product
    with the first sixteenth of K dropped, with ``k_step``, the product
    with one K step read twice and the next never (a pipeline stage that
    holds the wrong tiles), and the product of inputs rounded to
    bfloat16 or to TF32 (float32), or cut to 3 mantissa bits (16 bits).
    B5's float64 gate must refuse each (in 16 bits over all entries or
    entry by entry); returns each one's error as a multiple of the
    limit."""
    lg = kernel_module("matmul")
    a, b, transpose_a = case
    K = b.shape[0]
    dropped = b.clone()
    dropped[:K // 16] = 0
    faulty = {"zeros": lambda: torch.zeros_like(plain),
              "sixteenth_of_K_dropped": lambda: lg.matmul_cuda(
                  a, dropped, transpose_a)}
    if k_step is not None:
        j = (K // 2) // k_step * k_step        # a step in the middle of K
        a2, b2 = a.clone(), b.clone()
        if transpose_a:
            a2[j + k_step:j + 2 * k_step] = a[j:j + k_step]
        else:
            a2[:, j + k_step:j + 2 * k_step] = a[:, j:j + k_step]
        b2[j + k_step:j + 2 * k_step] = b[j:j + k_step]
        faulty["k_step_read_twice"] = lambda: lg.matmul_cuda(a2, b2,
                                                             transpose_a)
    if a.dtype == torch.float32:
        faulty["bf16_inputs"] = lambda: rounded_product(a, b, transpose_a, 16)
        faulty["tf32_inputs"] = lambda: rounded_product(a, b, transpose_a, 13)
    else:
        faulty["3_bit_inputs"] = lambda: rounded_product(a, b, transpose_a,
                                                         20)
    ratios = {}
    for name, make in faulty.items():
        ratios[name] = gate_ratio(make(), plain, exact, scale)
        if not refused(ratios[name]):
            fail(f"{what}: B5's float64 gate let a faulty result through "
                 f"({name}: {ratios[name]} of its limit)")
    return ratios


def phase_logreg(bw: float, errs):
    """``ops.logreg_grad`` on a dense f32 X of m = 2^20 samples and
    d = 2^14 features (68.72 GB), filled on the card in row chunks:
    B5 twice and B6 once; each pass and the gradient held against
    float64 (and the gate shown to refuse faulty passes), the gradient
    against autograd; everything timed."""
    from repro_torch.kernels import ops

    lg = kernel_module("matmul")
    m, d = LOGREG_M, LOGREG_D
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    if free < 4 * m * d + LOGREG_WORKSPACE:
        fail(f"logreg: X ({m} x {d} f32) needs {4 * m * d} B and the checks "
             f"{LOGREG_WORKSPACE} B more; the card has {free} B free of "
             f"{total}")
    gen = torch.Generator(device="cuda").manual_seed(2024)
    t0 = time.perf_counter()
    X = torch.empty((m, d), device="cuda")
    rows = F64_CHUNK // d
    for r0 in range(0, m, rows):         # make_sparse_logreg's density 0.1
        chunk = X[r0:r0 + rows]
        chunk.normal_(generator=gen)
        chunk.mul_(torch.rand(chunk.shape, generator=gen, device="cuda") < 0.1)
    y = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.5,
                    -1.0, 1.0)
    w = 0.01 * torch.randn(d, generator=gen, device="cuda")
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    with capture_inputs(copy=False, names=("matmul", "margin")) as inputs:
        g = ops.logreg_grad(X, y, w)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expect_counts("logreg", launches, {"matmul": 2, "margin": 1})
    if g.shape != (d,) or not bool(torch.isfinite(g).all()):
        fail("logreg: the gradient is not a finite vector of length d")
    (pass1, pass2), (marg,) = inputs["matmul"], inputs["margin"]
    s_k, v_k = marg[0], pass2[1]       # pass 1's output, B6's output
    g_raw = lg.matmul_cuda(*pass2)     # pass 2's output, recomputed
    plain1, plain2 = lg.matmul_torch(*pass1), lg.matmul_torch(*pass2)

    # float64 on the card: pass 1 (X w), then in one sweep over X pass 2
    # on the kernel's v, and m times the exact gradient
    s64 = f64_matmul(X, w[:, None], False)
    y64 = y.double()[:, None]
    c64 = f64_matmul(X, torch.cat([v_k.double(),
                                   -y64 * torch.sigmoid(-y64 * s64)], dim=1),
                     True)
    exact2, g64 = c64[:, :1], c64[:, 1] / m
    pass1_err = f64_rule_errors("matmul kernel", s_k, plain1, s64)
    pass1_err["faulty_over_limit"] = refused_by_gate("logreg pass 1", pass1,
                                                     plain1, s64)
    pass2_err = f64_rule_errors("matmul kernel", g_raw, plain2, exact2)
    pass2_err["faulty_over_limit"] = refused_by_gate("logreg pass 2", pass2,
                                                     plain2, exact2)
    grad_err = held_to_f64("logreg_grad", g, plain_logreg_grad(X, y, w), g64)
    g_auto = autograd_logreg_grad(X, y, w)
    if not torch.allclose(g, g_auto, **CROSSCHECK_TOL):
        fail(f"logreg: kernels and autograd differ by "
             f"{float((g - g_auto).abs().max()):.3e}")
    auto_vs_f64 = f64_err(g_auto, g64)
    margin_err = check("margin", marg, errs)["max_abs_err"]
    errs["matmul"] = max(errs["matmul"], pass1_err["max_abs_err"],
                         pass2_err["max_abs_err"])
    del s64, y64, c64, exact2, g64, g_raw, plain1, plain2

    reps, windows = LOGREG_REPS, LOGREG_WINDOWS
    timed = {}
    for key, case in (("pass1", pass1), ("pass2", pass2)):
        bytes_, flops = matmul_bytes_flops(case)
        bound_ms, bound_by = bound(bytes_, flops, bw)
        timed[key] = dict(
            shapes=[list(case[0].shape), list(case[1].shape)],
            transpose_a=case[2],
            ms=time_ms(lambda: lg.matmul_cuda(*case), reps, windows, 1),
            plain_ms=time_ms(lambda: lg.matmul_torch(*case), reps, windows,
                             1),
            bytes=bytes_, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
    timed["pass1"].update(pass1_err)
    timed["pass2"].update(pass2_err)
    bytes_, flops = margin_bytes_flops(marg)
    bound_ms, bound_by = bound(bytes_, flops, bw)
    timed["margin"] = dict(
        shapes=[list(marg[0].shape)] * 2, max_abs_err=margin_err,
        ms=time_ms(lambda: lg.margin_cuda(*marg)),
        plain_ms=time_ms(lambda: lg.margin_torch(*marg)),
        bytes=bytes_, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
    timed["margin"].update(margin_device_ms("logreg", marg,
                                            timed["margin"]["ms"]))
    grad = dict(
        ms=time_ms(lambda: ops.logreg_grad(X, y, w), reps, windows, 1),
        plain_ms=time_ms(lambda: plain_logreg_grad(X, y, w), reps, windows,
                         1),
        autograd_ms=time_ms(lambda: autograd_logreg_grad(X, y, w), reps,
                            windows, 1),
        bound_ms=sum(timed[k]["bound_ms"] for k in timed),
        **grad_err, autograd_err_vs_f64=auto_vs_f64,
        max_abs_diff_vs_autograd=float((g - g_auto).abs().max()))
    peak = torch.cuda.max_memory_allocated()
    emit("logreg", m=m, d=d, x_bytes=X.numel() * 4, fill_s=fill_s,
         free_bytes_before=free, peak_bytes=peak, launches=launches,
         grad=grad, **timed, card=smi_line())
    del X, y, w, g, g_auto, s_k, v_k, pass1, pass2, marg, inputs
    torch.cuda.empty_cache()
    return launches, timed


L2_FLUSH_BYTES = 128 << 20     # over twice the H100's 50 MB L2


def margin_device_ms(path: str, case, window_ms: float) -> dict:
    """B6's own device time per call, from the profiler's kernel time
    over REPS calls (the CUDA-event window's time is set by the
    wrapper's host work between back-to-back launches): with the
    inputs left in L2 by the call before (``device_ms``), and with L2
    overwritten between calls (``device_ms_cold``), as a caller whose
    inputs come from device memory finds it."""
    lg = kernel_module("margin")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    for key, run in (("device_ms", lambda: lg.margin_cuda(*case)),
                     ("device_ms_cold",
                      lambda: (flush.zero_(), lg.margin_cuda(*case)))):
        prof = profile_calls(f"{path}_margin_{key}", run, window_ms, REPS,
                             unit="call")
        rows = [r for r in prof["top"] if "margin" in r["name"]]
        out[key] = rows[0]["device_ms"] if rows else None
    return out


def plain_pass(a, b, transpose_a: bool):
    """A gradient pass's plain version in row chunks of ``a`` (an X too
    large to widen to float32 at once): float32 products, the chunks of
    A^T B added in float32, rounded once to ``a``'s dtype."""
    rows = F64_CHUNK // a.shape[1]
    if transpose_a:
        c = torch.zeros((a.shape[1], b.shape[1]), device=a.device)
        for r in range(0, a.shape[0], rows):
            c += a[r:r + rows].float().T @ b[r:r + rows].float()
        return c.to(a.dtype)
    return torch.cat([a[r:r + rows].float() @ b.float()
                      for r in range(0, a.shape[0], rows)]).to(a.dtype)


def plain_logreg_grad_chunked(X, y, w):
    """``plain_logreg_grad`` with its passes in row chunks of X."""
    lg = kernel_module("matmul")
    m, d = X.shape
    s = plain_pass(X, w.reshape(d, 1), False)
    v = lg.margin_torch(s, y.reshape(m, 1))
    return plain_pass(X, v, True).reshape(d) / m


def phase_logreg_bf16(bw: float, errs):
    """``ops.logreg_grad`` on X of the same size in bfloat16 (34.36 GB),
    filled in row chunks on the card, after phase ``logreg`` (its X
    freed): B5's gemv16 design twice and B6 once; each pass and the
    gradient held to float64 by B5's rule (the plain versions in row
    chunks: a float32 X would not fit beside it) and each pass's gate
    shown to refuse three faulty results; the kernels, the gradient,
    ``torch.matmul`` on the same bf16 operands and bf16 autograd
    timed."""
    from repro_torch.kernels import ops

    lg = kernel_module("matmul")
    m, d, dtype = LOGREG_M, LOGREG_D, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(2025)
    reset_peak()
    free, total = torch.cuda.mem_get_info()
    if free < 2 * m * d + LOGREG_WORKSPACE:
        fail(f"logreg_bf16: X ({m} x {d} bf16) needs {2 * m * d} B and the "
             f"checks {LOGREG_WORKSPACE} B more; the card has {free} B "
             f"free of {total}")
    t0 = time.perf_counter()
    X = torch.empty((m, d), dtype=dtype, device="cuda")
    rows = F64_CHUNK // d
    chunk = torch.empty((rows, d), device="cuda")
    for r0 in range(0, m, rows):         # make_sparse_logreg's density 0.1
        chunk.normal_(generator=gen)
        chunk.mul_(torch.rand(chunk.shape, generator=gen, device="cuda") < 0.1)
        X[r0:r0 + rows] = chunk
    del chunk
    y = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.5,
                    -1.0, 1.0).to(dtype)
    w = (0.01 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    with capture_inputs(copy=False, names=("matmul", "margin")) as inputs:
        g = ops.logreg_grad(X, y, w)
    torch.cuda.synchronize()
    launches, designs = ops.launch_counts(), ops.matmul_design_counts()
    expect_counts("logreg_bf16", launches, {"matmul": 2, "margin": 1})
    if designs["gemv16"] != 2:
        fail(f"logreg_bf16: B5's designs {designs}, expected gemv16 twice")
    if g.shape != (d,) or g.dtype != dtype or not bool(
            torch.isfinite(g).all()):
        fail("logreg_bf16: the gradient is not a finite bf16 vector of "
             "length d")
    (pass1, pass2), (marg,) = inputs["matmul"], inputs["margin"]
    s_k, v_k = marg[0], pass2[1]       # pass 1's output, B6's output
    g_raw = lg.matmul_cuda(*pass2)     # pass 2's output, recomputed
    plain1, plain2 = plain_pass(*pass1), plain_pass(*pass2)

    s64 = f64_matmul(X, w[:, None], False)
    y64 = y.double()[:, None]
    c64 = f64_matmul(X, torch.cat([v_k.double(),
                                   -y64 * torch.sigmoid(-y64 * s64)], dim=1),
                     True)
    exact2, g64 = c64[:, :1], c64[:, 1] / m
    scale1, scale2 = half_scale(pass1), half_scale(pass2)
    pass1_err = f64_rule_errors("matmul kernel (bf16)", s_k, plain1, s64,
                                scale=scale1)
    pass1_err["faulty_over_limit"] = refused_by_gate(
        "logreg_bf16 pass 1", pass1, plain1, s64, scale1)
    pass2_err = f64_rule_errors("matmul kernel (bf16)", g_raw, plain2, exact2,
                                scale=scale2)
    pass2_err["faulty_over_limit"] = refused_by_gate(
        "logreg_bf16 pass 2", pass2, plain2, exact2, scale2)
    grad_err = held_to_f64("logreg_grad (bf16)", g,
                           plain_logreg_grad_chunked(X, y, w), g64)
    g_auto = autograd_logreg_grad(X, y, w)
    auto_vs_f64 = f64_err(g_auto, g64)
    margin_err = check("margin", marg, errs)["max_abs_err"]
    errs["matmul_gemv16"] = max(pass1_err["max_abs_err"],
                                pass2_err["max_abs_err"])
    del s64, y64, c64, exact2, g64, g_raw, plain1, plain2, scale1, scale2

    reps, windows = LOGREG_REPS, LOGREG_WINDOWS
    timed = {}
    for key, case in (("pass1", pass1), ("pass2", pass2)):
        a, b, t = case
        bytes_, flops = matmul_bytes_flops(case)
        bound_ms, bound_by = bound(bytes_, flops, bw)
        timed[key] = dict(
            shapes=[list(a.shape), list(b.shape)], transpose_a=t,
            design="gemv16",
            ms=time_ms(lambda: lg.matmul_cuda(*case), reps, windows, 1),
            plain_ms=time_ms(lambda: plain_pass(*case), reps, windows, 1),
            library_ms=time_ms(lambda: torch.matmul(a.T if t else a, b),
                               reps, windows, 1),
            bytes=bytes_, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
    timed["pass1"].update(pass1_err)
    timed["pass2"].update(pass2_err)
    bytes_, flops = margin_bytes_flops(marg)
    bound_ms, bound_by = bound(bytes_, flops, bw)
    timed["margin"] = dict(
        shapes=[list(marg[0].shape)] * 2, max_abs_err=margin_err,
        ms=time_ms(lambda: lg.margin_cuda(*marg)),
        plain_ms=time_ms(lambda: lg.margin_torch(*marg)),
        bytes=bytes_, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
    timed["margin"].update(margin_device_ms("logreg_bf16", marg,
                                            timed["margin"]["ms"]))
    grad = dict(
        ms=time_ms(lambda: ops.logreg_grad(X, y, w), reps, windows, 1),
        plain_ms=time_ms(lambda: plain_logreg_grad_chunked(X, y, w), reps,
                         windows, 1),
        autograd_ms=time_ms(lambda: autograd_logreg_grad(X, y, w), reps,
                            windows, 1),
        bound_ms=sum(timed[k]["bound_ms"] for k in timed),
        **grad_err, autograd_err_vs_f64=auto_vs_f64,
        max_abs_diff_vs_autograd=float((g.float() - g_auto.float())
                                       .abs().max()))
    peak = torch.cuda.max_memory_allocated()
    emit("logreg_bf16", m=m, d=d, x_bytes=X.numel() * 2, fill_s=fill_s,
         free_bytes_before=free, peak_bytes=peak, launches=launches,
         designs=designs, grad=grad, **timed, card=smi_line())
    del X, y, w, g, g_auto, s_k, v_k, pass1, pass2, marg, inputs
    torch.cuda.empty_cache()
    return launches, timed


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
    wu_launches, wu_row = phase_worker_update(bw, errs)
    mm_launches, mm_designs, mm_rows = phase_matmul(bw, errs)
    main_launches, main_rows, z_main = phase_main(bw, errs)
    phase_paper(bw, errs)
    spmd_launches, spmd_rows = phase_spmd(bw, errs, z_main)
    del z_main
    torch.cuda.empty_cache()
    phase_spmd_ranks(errs)
    phase_ps(bw, errs)
    serve_launches, serve_rows, serve16_launches, serve16_rows = \
        phase_serve(bw, errs)
    logreg_launches, logreg_rows = phase_logreg(bw, errs)
    logreg16_launches, logreg16_rows = phase_logreg_bf16(bw, errs)

    # each kernel's numbers from the path it serves: B1 and B2 from main,
    # B3 from spmd (B1 runs on both; main is its full-width single device),
    # B4 from its op on the kdda_like bundle, B5's gemv (its two passes of
    # one gradient, summed) and B6 from logreg, B5's gemv16 from the bf16
    # gradient, its tensor-core and tiled designs from the matmul line
    # (the first cell of each: f32 and bf16 with A stored (M, K), and
    # f32 at 4095^3), B7 from serve's flash prefill
    def passes_summed(rows, library_key):
        passes = [rows["pass1"], rows["pass2"]]
        out = {key: sum(r[key] for r in passes)
               for key in ("ms", "plain_ms", "bound_ms")}
        out["bound_by"] = "bytes" if all(
            r["bound_by"] == "bytes" for r in passes) else "operations"
        out["library_ms"] = sum(r[library_key] for r in passes)
        return out

    def first_cell(design):
        return next(r for r in mm_rows if r["design"] == design)

    # the f32 plain version is torch.matmul, also the library call
    logreg_kernels = {"matmul": passes_summed(logreg_rows, "plain_ms"),
                      "margin": logreg_rows["margin"]}
    matmul_designs = {
        "matmul_gemv16": (logreg16_launches["matmul"],
                          passes_summed(logreg16_rows, "library_ms")),
        **{f"matmul_{d}": (mm_designs[d], first_cell(d))
           for d in ("wgmma", "tf32x3", "tiled")}}
    paths = {"prox_consensus": (spmd_launches, spmd_rows),
             "admm_worker_update": (wu_launches, {"admm_worker_update":
                                                  wu_row}),
             "matmul": (logreg_launches, logreg_kernels),
             "margin": (logreg_launches, logreg_kernels),
             "flash_attention": (serve_launches, serve_rows),
             "flash_attention_bf16": (serve16_launches, serve16_rows)}
    kernels = []
    for name_, (source, replaces) in SOURCES.items():
        launches, rows = paths.get(name_, (main_launches, main_rows))
        r = rows[name_]
        kernels.append(dict(
            name=name_, route="cuda", source=source, replaces=replaces,
            launches=launches[name_], max_abs_err=errs[name_], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms")))
        if name_ == "matmul":           # B5's designs under B5
            kernels[-1]["design"] = "gemv"
            source, replaces = SOURCES["matmul"]
            for design_name, (n, r) in matmul_designs.items():
                kernels.append(dict(
                    name=design_name, route="cuda", source=source,
                    replaces=replaces, design=design_name[len("matmul_"):],
                    launches=n, max_abs_err=errs[design_name], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
