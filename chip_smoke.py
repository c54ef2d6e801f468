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
   B5 is held entry by entry too (``f64_entry_ratio``). Line
   ``kernels_shapes``: B2 on one block column (N, 1, 315,904) for N in
   1, 8, 17, 70 with the edge column all true, all false and mixed, NaN
   rows on and off it; B6 at lengths 1, 7, 8, 9 and 2^20 + 3 at every
   element offset of a 16-byte word (y also at another offset) in f32,
   bf16 and f16, bit for bit its plain version; each cell's bitwise
   agreement counted; and the device time of a one-element PyTorch
   kernel, the least the profiler reads for a launch. B6 at the
   gradient's (2^20, 1) in bf16 and f16 is timed with its device time
   per launch (``kernel_device_ms``);
4. main    — ``ConsensusSession.flat`` at the paper's KDDa width
   (N=8 workers, M=64 blocks, 20,216,830 coordinates; the quadratic
   loss and config of ``benchmarks/kernels_bench.py``'s kdda_like case):
   10 epochs on the kernels ("auto"), then 10 on the plain "torch"
   backend with the same seed and so the same draws; z must agree and
   each kernel must have launched once per epoch; B2 on the epoch's
   inputs also by its device time per launch (line
   ``main_server_prox``);
   autotune — B1's and B2's launches (``kernels/autotune.py``: 128-1024
   threads a block x 1, 2, 4, 8 or the occupancy API's most blocks an
   SM) swept at the kdda_like shape (8, 64, 315,904) and the pytree /
   train shape (2, 2, 311,164,928): every candidate timed by CUDA-event
   windows and its output bitwise the default launch's; each winner
   printed with its ms, the default's and the bound; the winners kept
   in memory (written to ``chiprun_out/autotune_entries.json``, never
   to the package's table); then phase 4's epochs under
   ``autotune="cached"``: z bitwise phase 4's, B1 and B2 once an epoch;
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
   and timed there; then line ``spmd_tree``: the pytree session of phase
   ``ps_tree``'s smoke tree with ``mesh=`` on the same mesh, 10 epochs,
   B1 and B3 once an epoch and B2 never, z within 1e-5 of the
   single-device tree epoch;
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
   there, B2 there also bitwise or not, by its device time per launch
   (hot, L2 cold, L2 refilled by a read, the column just rewritten) and
   with its gate shown to refuse a result that drops the last row
   reaching the sum (line ``ps_commit``); telemetry shown inert (3
   rounds, z, delays and makespan
   bitwise equal); then ``measure_costs`` on the card and Table 1 from
   those costs (p in 1, 4, 8, 16, 32, k = 320, both disciplines), the
   locked/lockfree gate at 8 workers and the skew, heavy_tail, churn,
   lossy and server_crash scenarios with their gates
   (``ps_baseline.json``); churn's, lossy's and server_crash's traces
   also replayed through the SPMD epoch on 8 gloo ranks spawned on the
   card (data 4 x model 2; ``benchmarks/spmd_replay.py``), each within
   1e-5 of the runtime's z at every round, B1 and B3 once a round on
   every rank (``ps_spmd_replays``);
   ps_durable — the runtime's durability layer at the same width,
   lockfree, 6 rounds, z recorded. Line ``ps_server_crash``: block
   servers 2 and 9 crash at sim times 2.0 and 4.0 (each after a
   committed version) and come back 1.5 later by replaying their
   write-ahead logs; against the crash-free run: 2 recoveries, every
   domain's per-round fold multiset the same, B1 once per worker
   compute, B2 once per block commit plus once per replayed block
   version, the trace replayed through the epoch on the kernels with z
   bitwise equal at every round; each recovery's host wall time (timed
   here around ``BlockServerProc.recover``), peak memory beside phase
   ``ps``'s. Line ``ps_snapshot``: a run with ``checkpoint_every=3``
   writes one snapshot (~2.9 GB) into a temporary directory; a new run
   resumes from it and must equal the uninterrupted one (z, every
   version, delays, fold logs, losses, makespan), launching B1 and B2
   once per compute and commit of its own; the snapshot's bytes, write
   and load + restore seconds; the directory is removed;
   pytree  — ``ConsensusSession.pytree`` on qwen3-1.7b's stacked
   parameter tree (the reference's ``layers`` stacked on a leading axis;
   widths in full, 6 of 28 layers: 613,182,976 f32 parameters, seed 0),
   M = 2 blocks by LPT (311,164,928 / 302,018,048: dblk 311,164,928),
   N = 2 workers, the loss 1/2 sum over leaves |p - a_i c|^2 (c the
   seed-1 tree, a = (0.5, 1.5) the batch), the kdda_like config: 5
   epochs on the kernels, then 5 on the plain backend from the same
   state; B1 (no x) and B2 once an epoch; each epoch's z, and epoch 1's
   y and w_cache, held between the backends within KERNEL_TOL; the pad
   lanes of z, y and w_cache exactly 0 after every epoch; z moved. The
   epoch ms of both, both peaks beside the reckoned 4 B x (2T + 6NT +
   NP + P), a profile of the kernel epoch split into B1, B2, the gather
   and push, the pack and unpack copies, the loss's passes and host
   gaps, and B1's and B2's device ms per launch beside their bounds;
   ps_tree — ``run_ps`` (lockfree, 6 rounds) on a pytree session of the
   qwen3-1.7b smoke config's stacked tree: B1 once per worker compute
   and B2 once per block commit, z trees at every version, the trace
   replayed through the tree epoch on the kernels with z bitwise equal;
   train   — ``ADMMTrainer`` on the same stacked tree (6 layers, N = 2,
   M = 2 by LPT, launch/train.py's defaults: rho 20, gamma 0.01, D 1,
   block fraction 1) training ``Model.loss`` on ``TokenPipeline``
   batches of 2 x 512 tokens a worker: 5 steps on the kernels, then 5 on
   the plain backend from the same state. Gates: step 0's loss equals
   ``Model.loss`` at z0 (1e-6 relative); z of the two backends after
   every step within KERNEL_TOL; losses and z finite, pads exactly 0;
   B1 and B2 once a step, and held on one more step's inputs; the
   trained z served as a ``ParamTree`` of views (``params_from_stacked``)
   gives the stacked forward's last logits within 1e-5 of their max.
   Prints step ms, tokens/s, peaks read step by step (the checks
   excluded) beside a reckoning, the step's parts each timed alone (the
   loss's forward and backward, the pack of g, gather and push) with
   B1's and B2's device ms from the profiler. Line ``train_sgd``:
   ``SGDTrainer`` + AdamW on all 28 layers, 3 steps of 4 x 512 tokens,
   step 0's loss equal to ``Model.loss``, params finite, no kernel. Line
   ``train_entry_points``: launch/train.py at its smoke defaults (admm
   and sgd, 6 steps; ``--runtime ps``, 3 rounds) and the training
   example with ``--quick``: B1 and B2 once per ADMM step (per worker
   compute and per block commit under ps), every loss finite; then
   ``--arch`` zamba2-1.2b, minicpm3-4b and whisper-medium (6 ADMM steps
   each) and whisper under ``--runtime ps`` (3 rounds);
   train_moe — ``ADMMTrainer`` on granite-moe-1b-a400m's stacked tree at
   its widths (d_model 1024, 32 experts top-8 of ff 512, vocab 49,155),
   8 of 24 layers (528,768,000 f32 parameters, seed 0), the reference's
   onehot dispatch, N = 2, M = 2 by LPT, launch/train.py's defaults,
   2 x 512 tokens a worker: 5 steps on the kernels, before each the
   plain backend's step from the same state (routing follows z, so two
   free-running trajectories part at a token's first flip). Gates: z of
   the two within KERNEL_TOL every step; step 0's loss equals
   ``Model.loss`` at z0, the router's aux loss in it; the loss and
   gradient taken twice from one state bitwise equal; B1 and B2 once a
   step and held on one more step's inputs; pads 0; losses and z
   finite. Prints the reckoned peak first (line ``train_moe_plan``),
   then step ms, tokens/s, peaks, the step's parts and the MoE layer's
   (router, dispatch, experts) each timed alone;
   train_ssm — ``ADMMTrainer`` on mamba2-370m's stacked tree at full
   width and depth (48 layers, d_model 1024, f32, seed 0) unless its
   reckoned peak passes 72 GB (the loss's ``vmap(grad)`` peak measured
   at 2 and 4 layers and extrapolated, beside the tables; then at the
   most layers under it, the cut printed in line ``train_ssm_plan``
   with the reckoning), N = 2,
   M = 2 by LPT, launch/train.py's defaults, 2 x 512 tokens a worker:
   5 steps on the kernels, before each the plain step from the same
   state. Gates: z within KERNEL_TOL every step; step 0's loss equals
   ``Model.loss`` at z0; the gradient at z0 finite; B1 and B2 once a
   step and held on one more step's inputs; pads 0; losses and z
   finite. Prints step ms, tokens/s, peaks beside the reckoning and a
   device split of the step (each part's device busy time alone under
   the profiler, the step's idle time apart);
   train_mla, train_encdec — the same on minicpm3-4b's stacked tree
   (MLA: its materialized scores under ``vmap(grad)``) and on
   whisper-medium's (its second stack, ``enc_layers``, and the batch's
   2 x 1500 x 1024 frames a worker), each at its widths in full and at
   the most layers under the 72 GB reckoning (whisper's two stacks cut
   alike), the cut printed in lines ``train_mla_plan`` and
   ``train_encdec_plan``; the reckoning counts the plain step that runs
   from the same state (its unfused update: 4 B x (2T + 9NT + NP + P));
   the three run on expandable segments (``expandable_segments``), and
   cyclic garbage and cached blocks are released before the profiled
   and the captured step, whose peaks are printed beside the loop's;
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
   serve_chunked — between them, the same 4 x 4096 prefill under
   ``attn_impl="chunked"`` (chunk 1024) and ``"qchunk"`` (2048), no
   kernel launched, each one's last logits within 2e-3 of the naive
   prefill's, a chunked with its causal mask dropped shown to read past
   that; then 1 x 32768 tokens (the reference's prefill_32k, its batch
   cut to 1) at 14 of the 28 layers through flash (B7 once a layer at
   (16, 32768, 128), layer 0's held to float64 on its first head),
   qchunk and chunked (naive's 68.7 GB scores a layer are printed as
   the reason it is not run): each one's first run at a 2-layer cut,
   then its timed run, its peak beside the reckoning printed first
   (line ``serve_chunked_plan``), and the device's idle share of the
   2-layer cut from the profiler; chunked's and qchunk's last logits
   within 2e-3 of flash's;
   serve_moe — granite-moe-1b-a400m at full width (24 layers, f32, seed
   0, ``moe_impl="scatter"``): the 4 x 4096 prefill on the flash path (B7
   once per layer: 24, the (64, 4096, 128) launch of hd 64 padded to
   128) and the naive path, their last logits within 2e-3 with the
   flash path's routing replayed into the naive one (a wrapper local to
   this script), every routing flip of the free-running pair a near-tie
   (``routing_flips``); B7 on layer 0's inputs against float64 as in
   ``serve``; the dropped share of (token, k) pairs by layer at the
   published capacity factor 1.25; ``Engine.generate`` with
   launch/serve.py's batch (B7 never in decode); decode vs prefill
   within 5e-4 on the dropless copy (capacity factor E / K), the
   prefill's routing replayed, the free decode's flips near-ties; first
   tokens the prefill's argmax where decided; a decode profile. Line
   ``serve_moe_onehot``: both dispatches' ``moe_forward`` on each
   layer's input of a 1 x 2048 prefill within KERNEL_TOL (1 + max), their
   layer ms, extra peaks and prefill ms. Line ``serve_mixtral``:
   mixtral-8x7b at its widths, 2 of 32 layers (f32, seed 0, onehot),
   a 2 x 4608 naive prefill past the 4096 window (shown to differ from
   the same prefill without it), ``Engine.generate`` 2 x (16 + 24),
   decode vs prefill on the dropless copy; no kernel launched. Line
   ``serve_chunked_window``: the same prefill under chunked and qchunk
   with the window, the naive prefill's routing replayed, within 2e-3
   of naive; a qchunk without its window mask shown to read past it;
   serve_ssm — mamba2-370m in full (48 layers, d_model 1024, f32, seed
   0): the 4 x 4096 prefill through the chunked SSD (no kernel), timed,
   profiled (the device's idle share), its peak beside the weights and
   the SSD's reckoned transients, the cumsum along the chunk timed in
   both layouts; ``Engine.generate`` with launch/serve.py's batch;
   decode vs prefill within 5e-4 at every prompt position, first tokens
   the prefill's argmax where decided; the decode cache's bytes the same
   at max_len 64 and 4096;
   serve_hybrid — zamba2-1.2b in full (38 layers, d_model 2048, 32 heads
   of 64, the shared attention block after every 6 SSM layers; f32,
   seed 0): the 4 x 4096 prefill on the flash path, B7 launched once per
   application of the shared block (6, at (128, 4096, 128): hd 64 padded
   to 128), every launch's inputs held to float64 by B5's rule and the
   first's timed beside its plain version and SDPA with its gate shown
   to refuse faulty results; the naive path, flash vs naive within
   2e-3; ``Engine.generate`` (B7 never in decode); decode vs prefill
   within 5e-4; the SSM layers' decode state the same at max_len 64 and
   4096;
   serve_mla — minicpm3-4b in full (62 layers, d_model 2560, 40 heads,
   q rank 768, kv rank 256; f32, seed 0): the 4 x 4096 prefill (its
   (4, 40, 4096, 4096) scores materialized, as the reference's MLA does
   under every attn_impl: no kernel), its peak beside the reckoning,
   profiled; under ``attn_impl="flash"`` no launch and logits bitwise
   the naive ones; ``Engine.generate`` through the absorbed decode over
   the latent cache; decode vs prefill within 5e-4; first tokens
   decided; the latent cache's bytes at max_len 64 and 4096;
   serve_encdec — whisper-medium in full (24 + 24 layers, d_model 1024,
   16 heads of 64; f32, seed 0), launch/serve.py's frames (4 x 1500 x
   1024): the 4 x 448 prefill on the flash path, B7 48 launches (24
   bidirectional in the encoder at (64, 1536, 128), 24 causal in the
   decoder at (64, 512, 128)), every launch held to float64 and the
   first of each kind timed beside its plain version and SDPA with its
   gate shown to refuse faulty results (a causal mask added to a
   bidirectional launch among them); the flash prefill within 2e-3 of
   the same path with B7's plain version; the naive path, and the
   flash-naive gap printed (ROADMAP Queue C item 3: the zero keys that
   pad 1500 to 1536 enter the encoder's softmax, so no 2e-3 gate holds
   between them); the encoder alone timed; ``Engine.generate`` on the
   flash path (B7 24 times, in the encoder; never in decode); decode vs
   prefill within 5e-4 under flash on both sides; the cross cache's
   bytes. Line ``serve_chunked_encdec``: the prefill under chunked
   (the 1500 frames' keys padded to 2048 and masked) and qchunk within
   2e-3 of naive, printed beside flash's gap; a chunked whose padded
   keys are not masked shown to read past it;
9. logreg  — ``ops.logreg_grad`` at the size the repo declares for it
   (m = 2^20 samples, d = 2^14 features, X dense f32, 68.72 GB, filled
   on the card in row chunks): launches B5 twice and B6 once; each pass
   and the gradient are held against float64 (computed on the card in
   row chunks) by B5's rule, the gradient against autograd too, and
   each pass's gate must refuse four faulty results (zeros, a sixteenth
   of K dropped, bf16- and TF32-rounded inputs); each kernel, the
   gradient and autograd are timed, B6 also by its device time per
   launch (``kernel_device_ms``), bitwise or not, its gate refusing a
   faulty tail. Runs last, with everything before
   it freed; then (line ``logreg_bf16``), that X freed, the same
   gradient on a bf16 X (34.36 GB): B5's gemv16 design twice and B6
   once, each pass and the gradient held to float64 (the plain versions
   in row chunks), each pass's gate refusing zeros, a sixteenth of K
   dropped and 3-bit inputs; timed beside ``torch.matmul`` on the bf16
   operands and bf16 autograd; B6 as in ``logreg``;
10. a ``kernels`` summary line (B5's designs each on a line of their
   own after B5's; B2 on the PS runtime's commit, B6 in bf16, B7 on
   zamba2's prefill and on whisper's encoder and decoder, and B1 and
   B2 on the train steps of mamba2, minicpm3 and whisper on lines of
   their own, with device times per launch where measured),
   the card's nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

Device times come from torch.profiler (``profile_calls``): each
kernel's device time over the launches the profiler recorded; where the
launches per call are known, a phase fails unless every launch was
recorded.

Exits non-zero without printing a result when there is no CUDA device.
Imports only ``repro_torch`` (from ``src/``), never JAX or ``repro``.
"""
from __future__ import annotations

import contextlib
import copy
import datetime
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
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


@contextlib.contextmanager
def expandable_segments():
    """Inside the block, the caching allocator maps its segments as they
    grow (``expandable_segments:True``), so a path whose peak lies near
    the card's memory cannot fail on blocks that are cached but cut to
    other sizes; the cached blocks are released on entry and exit. The
    allocated bytes, and so every peak the phases print and gate, are
    the same either way."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


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
    # masked rather than indexed: a boolean index builds an int64 index of
    # every finite entry, 6x the tensor (28 GiB on the pytree bundles)
    out = ~fin
    err = float((kernel - plain).abs_().masked_fill_(out, 0.0).max())
    scale = float(plain.abs().masked_fill_(out, 0.0).max())
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
    # y read on every row; w_old[, x_old] only where a row is not
    # selected (a selected row's outputs do not depend on them), g and z~
    # only where it is; y', w'[, x'] written on every row
    kept = 2 if x_old is not None else 1
    bytes_ = (rows + kept * (rows - sel_rows) + 2 * sel_rows) * per_row
    bytes_ += (kept + 1) * rows * per_row
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
    # B2 on the PS runtime's block commit, one column (N, 1, dblk)
    "server_prox_update_commit": (
        "src/repro_torch/csrc/prox_update.cu",
        "src/repro/kernels/prox_update.py:117"),
    # B6 in bf16, on the bf16 gradient
    "margin_bf16": (
        "src/repro_torch/csrc/logreg_grad.cu",
        "src/repro/kernels/logreg_grad.py:87"),
    # B7's 16-bit design (wgmma), on the serve path's bf16 prefill
    "flash_attention_bf16": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:65"),
    # B7 on zamba2-1.2b's prefill: the shared attention block, hd 64
    "flash_attention_hybrid": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:65"),
    # B1 and B2 on mamba2-370m's ADMM train step
    "admm_worker_select_update_ssm": (
        "src/repro_torch/csrc/admm_update.cu",
        "src/repro/kernels/admm_update.py:136"),
    "server_prox_update_ssm": (
        "src/repro_torch/csrc/prox_update.cu",
        "src/repro/kernels/prox_update.py:117"),
    # B1 and B2 on minicpm3-4b's and whisper-medium's ADMM train steps
    "admm_worker_select_update_mla": (
        "src/repro_torch/csrc/admm_update.cu",
        "src/repro/kernels/admm_update.py:136"),
    "server_prox_update_mla": (
        "src/repro_torch/csrc/prox_update.cu",
        "src/repro/kernels/prox_update.py:117"),
    "admm_worker_select_update_encdec": (
        "src/repro_torch/csrc/admm_update.cu",
        "src/repro/kernels/admm_update.py:136"),
    "server_prox_update_encdec": (
        "src/repro_torch/csrc/prox_update.cu",
        "src/repro/kernels/prox_update.py:117"),
    # B7 on whisper-medium's flash prefill, hd 64: its encoder
    # (bidirectional) and its decoder (causal)
    "flash_attention_encdec_enc": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:65"),
    "flash_attention_encdec_dec": (
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
# B2 on one block column (the PS runtime's commit): one row, a ragged and
# a whole group of 8 rows loaded together, groups past the first, and a
# second 64-bit edge mask; B6 at lengths shorter than a 16-byte word, one
# word, a word and one, and the gradient's 2^20 and 3, at every element
# offset of a 16-byte word
COLUMN_WORKERS = (1, 8, 17, 70)
COLUMN_EDGES = ("all", "none", "mixed")
MARGIN_LENGTHS = (1, 7, 8, 9, (1 << 20) + 3)
MARGIN_OFFSETS = tuple(range(8))
HALF_TYPES = (torch.bfloat16, torch.float16)   # B5 and B6's 16-bit types
HALF_X = (1 << 18, 1 << 14)    # X of B5's timed bf16 passes: 8.6 GB
# the reference test's (BH, S, hd) (tests/test_flash_attention.py:21-22)
ATTENTION_SHAPES = ((2, 128, 128), (4, 256, 128), (1, 512, 256),
                    (3, 384, 128))


def column_case(N, d, gen, edges, l1, clip, nan=False):
    """B2 on one block column (N, 1, d), the PS runtime's commit: its
    edge column all true, all false or mixed (the last worker on it, the
    first off it), with NaN in rows on and off it."""
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
        w[N - 1, 0, :5] = float("nan")             # on the edge set
        w[0, 0, 5] = float("nan")                  # off it where mixed
        z[0, 9] = float("inf")
    rho = 0.5 + 2.0 * torch.rand((N,), generator=gen, device="cuda")
    rho_sum = torch.sum(torch.where(edge, rho[:, None], 0.0), dim=0)
    return (z, w, edge, rho_sum, 0.1, l1, clip)


def margin_view(n, offset, dtype, gen, y_offset=None):
    """B6's s and y as views of n elements at ``offset`` elements into
    their buffers (y at ``y_offset`` where given: another 16-byte
    phase than s)."""
    s, y = margin_case((n + 8,), gen, nan=True)
    y_offset = offset if y_offset is None else y_offset
    return (s.to(dtype)[offset:offset + n], y.to(dtype)[y_offset:y_offset + n])


def check_cell(name: str, case, errs, tally) -> None:
    """``check`` for an elementwise kernel, and the cell counted in
    ``tally`` (``cells``, and ``bitwise`` where the kernel is the plain
    version bit for bit)."""
    mod = kernel_module(name)
    out = getattr(mod, f"{name}_cuda")(*case)
    plain = getattr(mod, PLAIN[name])(*case)
    torch.cuda.synchronize()
    errs[name] = max(errs[name], compare(out, plain))
    tally["cells"] += 1
    tally["bitwise"] += bitwise(out, plain)


def phase_kernels_shapes(errs) -> None:
    """B2 on one block column and B6 at ragged lengths and offsets (the
    shapes their designs single out), each cell against its plain
    version: bitwise where the plain version rounds as the kernel does,
    else within KERNEL_TOL (B2's plain soft threshold takes l1 / mu as
    l1 * (1 / mu), an ulp off the kernel's IEEE division)."""
    from repro_torch.core.blocks import make_flat_blocks

    gen = torch.Generator(device="cuda").manual_seed(1818)
    dblk = make_flat_blocks(KDDA_DIM, KDDA_BLOCKS).block_dim
    column = {(l1, clip): {"cells": 0, "bitwise": 0}
              for (l1, clip) in (PROXES[0], PROXES[3])}
    for N in COLUMN_WORKERS:
        for edges in COLUMN_EDGES:
            for (l1, clip), tally in column.items():
                for nan in (False, True):
                    check_cell("server_prox_update", column_case(
                        N, dblk, gen, edges, l1, clip, nan), errs, tally)
    margin = {}
    for dtype in (torch.float32,) + HALF_TYPES:
        tally = margin[str(dtype)[6:]] = {"cells": 0, "bitwise": 0}
        for n in MARGIN_LENGTHS:
            for offset in MARGIN_OFFSETS:
                check_cell("margin", margin_view(n, offset, dtype, gen),
                           errs, tally)
                if offset:                 # y at another phase than s
                    check_cell("margin", margin_view(n, offset, dtype, gen,
                                                     y_offset=0),
                               errs, tally)
    for tally in margin.values():
        if tally["bitwise"] != tally["cells"]:
            fail(f"kernels: B6 is not its plain version bit for bit in "
                 f"every cell: {margin}")
    # the least device time the profiler reads for a launch on this card:
    # one PyTorch elementwise kernel on one element
    one = torch.zeros(1, device="cuda")
    floor = profile_calls("launch_floor", lambda: one.add_(1.0),
                          time_ms(lambda: one.add_(1.0)), REPS, unit="call",
                          expect={"elementwise": 1})
    emit("kernels_shapes", column_dblk=dblk, column_workers=COLUMN_WORKERS,
         launch_floor_ms=floor["kernels"]["elementwise"][
             "device_ms_per_launch"],
         server_prox_column={f"l1={k[0]},clip={k[1]}": v
                             for k, v in column.items()},
         margin_lengths=MARGIN_LENGTHS, margin=margin,
         max_abs_err={k: errs[k] for k in ("server_prox_update", "margin")})


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
    margins = {}
    for dtype in HALF_TYPES:            # B6 at the gradient's (2^20, 1)
        case = (s_.to(dtype), y_.to(dtype))
        row = measure("margin", case, bw, half_errs)
        row.update(margin_on_path(f"kernels_{str(dtype)[6:]}", case, row))
        margins[str(dtype)[6:]] = row
    emit("kernels_16_bit", dtype="bfloat16",
         matmul_Xw=measure("matmul", (X, w, False), bw, half_errs,
                           LOGREG_REPS, LOGREG_WINDOWS),
         matmul_XTv=measure("matmul", (X, v, True), bw, half_errs,
                            LOGREG_REPS, LOGREG_WINDOWS),
         margin=margins["bfloat16"], margin_f16=margins["float16"])
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

        def wrapped(*args, _real=real, _name=name, **kw):
            kept = inputs.setdefault(_name, [])
            if keep is None or len(kept) < keep:
                kept.append(tuple(
                    a.clone() if copy and isinstance(a, torch.Tensor) else a
                    for a in args))
            return _real(*args, **kw)

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
    lg = kernel_module("server_prox_update")
    epoch_case = inputs["server_prox_update"][0]
    rows = check_on_path("main", inputs, MAIN_KERNELS, bw, errs)
    rows["server_prox_update"].update(
        bitwise=bitwise(lg.server_prox_update_cuda(*epoch_case),
                        lg.server_prox_update_torch(*epoch_case)),
        **kernel_device_ms("main_server_prox", "server_prox_kernel",
                           lambda: lg.server_prox_update_cuda(*epoch_case),
                           rows["server_prox_update"]["ms"]))
    emit("main_server_prox", **rows["server_prox_update"])
    del epoch_case
    torch.cuda.empty_cache()
    return launches, rows, z_kernel


# ---------------------------------------------------------------------------
# phase autotune: B1's and B2's launches swept on the card, then main's
# epochs under autotune="cached"
# ---------------------------------------------------------------------------

# PERF.md section 6's bounds of B1 and B2 on their paths' own inputs (main:
# half the rows selected, x tracked; pytree: no x), beside this phase's
AUTOTUNE_PATH_BOUND_MS = {
    ("worker_select_update", (8, 64, 315_904)): 1.159,
    ("worker_select_update", (2, 2, 311_164_928)): 6.688,
    ("server_prox_fused", (8, 64, 315_904)): 0.241,
    ("server_prox_fused", (2, 2, 311_164_928)): 2.972}


def phase_autotune(bw: float, z_main) -> None:
    """Both ops swept at both benchmark shapes (``autotune.SHAPES``) on
    the card: every candidate launch timed by CUDA-event windows, its
    output bitwise the default launch's (``autotune.events_scores``
    fails otherwise); each winner printed with its time, the default's,
    the bound on the sweep's inputs (every row selected, no x) and the
    path's from PERF.md; the winners kept in memory (the table file is
    not written) and beside them the kept table's entry for this card.
    Then main's kdda_like epochs under ``autotune="cached"``: z bitwise
    phase main's ("off"), B1 and B2 once an epoch."""
    import dataclasses
    from repro_torch.api import ConsensusSession
    from repro_torch.kernels import autotune, ops

    t0 = time.perf_counter()
    kind = autotune.device_kind("cuda")
    kept = {k: dict(v) for k, v in autotune.load_table(refresh=True).items()}
    entries, rows = {}, []
    for shape in autotune.SHAPES:
        for op in autotune.OPS:
            reset_peak()
            scores, default_us = autotune.events_scores(op, *shape, "cuda")
            t, b = autotune.best_launch(scores)
            key = autotune.table_key(kind, op, *shape)
            entries[key] = autotune.entry(autotune.LaunchConfig(
                t, b, scores[(t, b)], "cuda_events"))
            rows.append(dict(
                op=op, shape=list(shape), candidates=len(scores),
                bitwise=True, winner=[t, b], winner_ms=scores[(t, b)] / 1e3,
                default_ms=default_us / 1e3,
                gain=1.0 - scores[(t, b)] / default_us,
                bound_ms=1e3 * autotune.op_bytes(op, *shape) / bw,
                path_bound_ms=AUTOTUNE_PATH_BOUND_MS[(op, shape)],
                kept=kept.get(key),
                ms_by_launch={f"{lt}x{lb}": us / 1e3
                              for (lt, lb), us in sorted(scores.items())},
                peak_bytes=torch.cuda.max_memory_allocated()))
            torch.cuda.empty_cache()
    autotune.remember(entries, persist=False)
    (HERE / "chiprun_out").mkdir(exist_ok=True)
    (HERE / "chiprun_out" / "autotune_entries.json").write_text(
        json.dumps(entries, indent=2))
    sweep_s = time.perf_counter() - t0

    cfg, centers = kdda_problem()
    sess = ConsensusSession.flat(quad_loss, centers, dim=KDDA_DIM,
                                 cfg=dataclasses.replace(cfg,
                                                         autotune="cached"))
    if sess.spec.space.autotune != "cached":
        fail(f"autotune: the session runs {sess.spec.space.autotune!r}")
    launch = {op: sess.spec.space._launch(op, torch.empty(
        (KDDA_WORKERS, KDDA_BLOCKS, sess.spec.space.blocks.block_dim),
        device="cuda")) for op in autotune.OPS}
    if any(v is None for v in launch.values()):
        fail(f"autotune: the cached session's lookups missed: {launch}")
    ops.reset_launch_counts()
    state, times = run_epochs(sess, MAIN_EPOCHS)
    launches = ops.launch_counts()
    expect_launches("autotune (main, cached)", launches, MAIN_EPOCHS,
                    MAIN_KERNELS)
    z = sess.z(state)
    if not torch.equal(z.view(torch.int32), z_main.view(torch.int32)):
        fail(f"autotune: main's z under 'cached' differs from 'off' by "
             f"{float((z - z_main).abs().max()):.3e}")
    ADDED_S["autotune"] = time.perf_counter() - t0
    emit("autotune", device_kind=kind, sweep=rows, sweep_s=sweep_s,
         seconds=ADDED_S["autotune"],
         main_cached=dict(launch=launch, epochs=MAIN_EPOCHS,
                          launches=launches, z_bitwise_off=True,
                          epoch_ms_median=statistics.median(times[1:]),
                          epoch_ms=times),
         card=smi_line())
    del state, sess, centers, z
    torch.cuda.empty_cache()


# The profiler drops the device records of the first few launches in a
# window late in a long process (3-6 of 20 on the card, whatever the
# window's padding), so a window runs warm-up calls before the measured
# ones, more on each attempt, and counts only the measured ones
PROFILE_WARMUPS = (8, 32, 128)
PROFILE_PAD_S = 0.005          # host idle between the warm-up and the rest
MEASURED = "chip_smoke.measured"


def profile_window(run, calls: int, warmup: int = 0):
    """The profiler over ``warmup`` calls of ``run`` and then ``calls``
    measured ones, in one window; returns (device us, launches, name) of
    every kernel that started after the measured calls began (the
    warm-up's kernels ended before: a synchronize and PROFILE_PAD_S lie
    between), and the profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(warmup):
            run()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        with record_function(MEASURED):
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
    events = prof.events()
    t0 = min(e.time_range.start for e in events if e.name == MEASURED)
    by_name = {}
    for e in events:
        # the profiler also lays the MEASURED range (and a step's part
        # ranges) on the device's timeline; they span the kernels, they
        # are not among them
        if e.device_type == DeviceType.CUDA and e.time_range.start >= t0 \
                and e.name != MEASURED and not e.name.startswith(RANGE):
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    return sorted(((t, c, k) for k, (t, c) in by_name.items()),
                  reverse=True), prof


def missed_launches(prof, frag: str) -> dict:
    """Where a window lost launches of ``frag``: the start times (us from
    the window's first kernel launch call) of the host's launch calls
    and of the device kernels it recorded."""
    from torch.autograd import DeviceType
    evs = prof.events()
    host = sorted(e.time_range.start for e in evs
                  if e.device_type == DeviceType.CPU
                  and "LaunchKernel" in e.name)
    kern = sorted(e.time_range.start for e in evs
                  if e.device_type == DeviceType.CUDA and frag in e.name)
    t0 = host[0] if host else 0.0
    return {"host_launch_calls_us": [t - t0 for t in host],
            "kernels_us": [t - t0 for t in kern]}


RANGE = "chip_smoke.part."     # a step part's profiler range (step_ranges)
BACKWARD = "autograd::engine::evaluate_function"


def device_ms_by_range(prof, calls: int) -> dict:
    """Device ms per call of the kernels each part of a step launched:
    a kernel belongs to the innermost RANGE around the op that launched
    it, or to the loss's backward when that op ran under the autograd
    engine (whose CUDA work runs on a thread of its own, outside the
    caller's ranges); "other" for the rest of the measured calls'
    kernels that an op launched (B1 and B2, launched through ctypes and
    not by an op, are not among them)."""
    from torch.autograd import DeviceType
    t0 = min(e.time_range.start for e in prof.events() if e.name == MEASURED)
    parts = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels or \
                e.time_range.start < t0:
            continue
        label, a = "other", e
        while a is not None:
            if a.name.startswith(RANGE) or a.name.startswith(BACKWARD):
                label = a.name[len(RANGE):] if a.name.startswith(RANGE) \
                    else "loss_backward"
                break
            a = a.cpu_parent
        for k in e.kernels:
            parts[label] = parts.get(label, 0.0) + k.duration / 1e3 / calls
    return parts


def profile_calls(path: str, run, wall_ms: float, calls: int,
                  unit: str = "epoch", expect=None, warmups=PROFILE_WARMUPS,
                  by_range: bool = False):
    """Device time by kernel over ``calls`` calls of ``run`` (one epoch,
    one prefill, one decode step: a ``unit``) with torch.profiler, and
    the device's idle share of an unprofiled call (``wall_ms``): the
    profiler's own start-up lands in its window, so that window's wall
    time is not the call's. Each kernel's time per launch is its device
    time over the launches the profiler recorded. ``expect`` maps a
    fragment of a kernel's name to its launches per call: the phase
    fails unless the profiler recorded exactly ``calls`` times that many
    in one of the windows ``warmups`` warms up ever longer, and
    their times per launch are returned under ``kernels``. With
    ``by_range``, the device ms of each part of the call
    (``device_ms_by_range``) under ``by_range``. The table by kernel goes to
    ``<path>_profile.json`` in the output directory, with the windows
    that lost launches (and how: ``missed_launches``) where there were
    any."""
    expect = expect or {}
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    misses = []
    for warmup in (warmups if expect else (0,)):
        rows, prof = profile_window(run, calls, warmup)
        recorded = {frag: sum(c for _, c, k in rows if frag in k)
                    for frag in expect}
        if all(recorded[f] == n * calls for f, n in expect.items()):
            break
        misses.append({"warmup_calls": warmup, "recorded": recorded,
                       **{f: missed_launches(prof, f) for f in expect}})
    else:
        (out / f"{path}_profile_missed.json").write_text(json.dumps(
            misses, indent=1))
        fail(f"{path}: the profiler recorded launches "
             f"{[m['recorded'] for m in misses]} over {calls} calls in "
             f"{len(warmups)} windows, expected "
             f"{({f: n * calls for f, n in expect.items()})}")
    busy_ms = sum(r[0] for r in rows) / 1e3 / calls
    (out / f"{path}_profile.json").write_text(json.dumps(
        {f"{unit}s": calls, f"{unit}_ms": wall_ms, "missed": misses,
         "by_kernel": [{"name": k, "device_ms_per_launch": t / 1e3 / c,
                        f"launches_per_{unit}": c / calls,
                        f"device_ms_per_{unit}": t / 1e3 / calls}
                       for t, c, k in rows]}, indent=1))
    kernels = {}
    for frag in expect:
        t = sum(t for t, _, k in rows if frag in k)
        kernels[frag] = {"device_ms_per_launch": t / 1e3 / recorded[frag],
                         "launches": recorded[frag]}
    return {f"{unit}s": calls, f"device_busy_ms_per_{unit}": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top": [{"name": k[:80], "device_ms_per_launch": t / 1e3 / c,
                     f"launches_per_{unit}": c / calls}
                    for t, c, k in rows[:8]],
            **({"kernels": kernels} if expect else {}),
            **({"by_range": device_ms_by_range(prof, calls)}
               if by_range else {})}


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
            rows = check_on_path("spmd", inputs, SPMD_KERNELS, bw, errs)
            spmd_tree()
            return launches, rows
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
PS_SCENARIOS = ("skew", "heavy_tail", "churn", "lossy", "server_crash")


def ps_timing():
    from repro_torch.ps import CostProfile, LognormalService
    return CostProfile(t_worker=LognormalService(1.0, 0.3),
                       t_server_block=LognormalService(0.25, 0.15))


def ps_block_commits(res, blocks: int = KDDA_BLOCKS) -> int:
    """Block commits of a run, from its metrics: domain commits times
    the blocks a domain holds (every discipline here splits the blocks
    evenly over its domains)."""
    domains = len(res.metrics["server_busy_time"])
    return res.metrics["commits"] * blocks // domains


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


PS_SPMD_SCENARIOS = ("churn", "lossy", "server_crash")


def ps_spmd_replays(lines) -> dict:
    """The scenarios' 8-rank SPMD replays from their lines: each error
    within 1e-5 on the (data 4, model 2) mesh, and on every rank B1 and
    B3 launched once a round, nothing else."""
    from repro_torch.benchmarks.speedup import SPMD_TOL
    found = {}
    for line in lines:
        name, first, rest = (line.split(",", 2) + [""])[:3]
        for sc in PS_SPMD_SCENARIOS:
            if name == f"{sc}_replay_err_spmd":
                found.setdefault(sc, {}).update(err=float(first), mesh=rest)
            elif name == f"{sc}_replay_spmd_launches":
                *parts, spawn = rest.split("|")
                counts = {k: [int(n) for n in v.split("/")] for k, v in (
                    part.split("=") for part in parts)}
                found.setdefault(sc, {}).update(
                    rounds=int(first), launches_per_rank=counts,
                    spawn_s=float(spawn.split("=")[1]))
    for sc in PS_SPMD_SCENARIOS:
        r = found.get(sc, {})
        if "err" not in r or "rounds" not in r:
            fail(f"ps_table1: no SPMD replay lines for {sc}: {r}")
        if not r["err"] <= SPMD_TOL or r["mesh"] != "mesh=data4xmodel2":
            fail(f"ps_table1: {sc}'s SPMD replay error {r['err']} "
                 f"({r['mesh']}) past {SPMD_TOL}")
        want = {k: [r["rounds"]] * 8 for k in SPMD_KERNELS}
        if r["launches_per_rank"] != want:
            fail(f"ps_table1: {sc}'s ranks launched "
                 f"{r['launches_per_rank']}, expected {want}")
    ADDED_S["ps_spmd_replays"] = sum(found[sc]["spawn_s"]
                                     for sc in PS_SPMD_SCENARIOS)
    return found


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
    peaks = {}
    for disc in PS_DISCIPLINES:
        # earlier phases' reference cycles may still hold device tensors
        # until the collector runs; collect them so the peak is this run's
        gc.collect()
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
        peak = peaks[disc] = torch.cuda.max_memory_allocated()
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
            first_launches = launches
            commit = inputs["server_prox_update"][0]
            rows = check_on_path("ps", inputs, MAIN_KERNELS, bw, errs)
            rows["server_prox_update"].update(commit_on_path(commit, rows))
            emit("ps_commit", **rows["server_prox_update"])
            del commit
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
    spmd = ps_spmd_replays(lines)
    emit("ps_table1", t_worker_us=1e6 * costs["t_worker"],
         t_server_block_us=1e6 * costs["t_server_block"],
         k=speedup.K_ITERS, rows=table, gates=gates, spmd_replay=spmd,
         lines=[ln for ln in lines if "_hist," not in ln])
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        fail(f"ps: gates failed: {failed}: {lines}")
    torch.cuda.empty_cache()
    return first_launches, rows, peaks


# ---------------------------------------------------------------------------
# phase 7c: the PS runtime's durability layer at KDDa width
# ---------------------------------------------------------------------------

PS_CRASHES = ((2, 2.0), (9, 4.0))   # (block, sim time): each after version 1
PS_CRASH_DOWN = 1.5
PS_CHECKPOINT_EVERY = 3             # one snapshot in 6 rounds, at round 3


@contextlib.contextmanager
def timed_calls(module, names):
    """Host wall ms of each call of ``module``'s functions ``names``,
    with the card synchronized before and after; the wrappers live here,
    not in the package, and come off when the block ends."""
    times = {name: [] for name in names}
    real = {name: getattr(module, name) for name in names}

    def wrap(name):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    for name in names:
        setattr(module, name, wrap(name))
    try:
        yield times
    finally:
        for name in names:
            setattr(module, name, real[name])


def ps_run(sess, faults=None, **run_kw):
    """``PSRuntime`` over ``sess`` (lockfree, ``ps_timing()``, z
    recorded) for ``PS_ROUNDS`` rounds, ``run_kw`` passed to ``run``,
    with the launch counts reset before: (runtime, result, launches,
    wall seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.ps import PSRuntime
    rt = PSRuntime(sess.spec, data=sess.data, timing=ps_timing(),
                   record_z=True, faults=faults)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rt.run(PS_ROUNDS, **run_kw)
    torch.cuda.synchronize()
    return rt, res, ops.launch_counts(), time.perf_counter() - t0


def phase_ps_durable(ps_peaks) -> None:
    """The PS runtime's durability layer at the kdda_like width and
    config, lockfree, 6 rounds, lognormal service times, z recorded.
    ``ps_server_crash``: block servers 2 and 9 crash after a committed
    version and come back by WAL replay; against the crash-free run:
    2 recoveries, no fold lost or added, B1 once per worker compute and
    B2 once per block commit plus once per replayed block version, the
    trace replayed through the epoch on the kernels with z bitwise equal
    at every round. ``ps_snapshot``: a run with a snapshot at round 3,
    resumed in a new run, must equal the uninterrupted one (z, every
    version, delays, fold logs, losses, makespan), the resumed run
    launching B1 and B2 once per compute and commit of its own."""
    from repro_torch.api import ConsensusSession
    from repro_torch.benchmarks import speedup
    from repro_torch.checkpoint import load_extra
    from repro_torch.ps import FaultPlan, recovery, server

    N, M = KDDA_WORKERS, KDDA_BLOCKS
    problem = kdda_problem()
    cfg, centers = problem
    sess = ConsensusSession.flat(quad_loss, centers, dim=KDDA_DIM, cfg=cfg)
    if sess.spec.space.backend != "cuda":
        fail(f"ps_durable: 'auto' resolved to {sess.spec.space.backend!r}")
    sess.run_ps(1, timing=ps_timing())          # warm-up, not counted

    # --- server_crash: WAL replay through B2 ---
    # the crash-free run first; only its fold logs stay for the gate
    reset_peak()
    rt_ff, ff, _, ff_s = ps_run(sess)
    ff_peak = torch.cuda.max_memory_allocated()
    ff_folds = types.SimpleNamespace(domains=[
        types.SimpleNamespace(fold_log=d.fold_log) for d in rt_ff.domains])
    ff_makespan = ff.makespan
    del rt_ff, ff
    plan = FaultPlan.of(*[FaultPlan.server_crash(j, at=at, down=PS_CRASH_DOWN)
                          for j, at in PS_CRASHES])
    reset_peak()
    with timed_calls(server.BlockServerProc, ["recover"]) as timed:
        rt_cr, cr, launches, wall_s = ps_run(sess, faults=plan)
    peak = torch.cuda.max_memory_allocated()
    crashes = [e for e in cr.trace.events if e["kind"] == "server_crash"]
    recovers = [e for e in cr.trace.events if e["kind"] == "server_recover"]
    replayed = sum(e["replayed"] for e in recovers)
    computes = cr.metrics["worker_iterations"]
    commits = ps_block_commits(cr)
    wal = cr.metrics["wal"]
    if cr.metrics["server_recoveries"] != 2 or wal["replays"] != 2 \
            or len(recovers) != 2 or len(timed["recover"]) != 2:
        fail(f"ps_server_crash: {cr.metrics['server_recoveries']} "
             f"recoveries, {wal['replays']} WAL replays, expected 2")
    if any(e["version"] < 1 for e in crashes):
        fail(f"ps_server_crash: a crash landed before its domain's first "
             f"committed version: {crashes}")
    lost = speedup.lost_fold_rounds(ff_folds, rt_cr)
    if lost:
        fail(f"ps_server_crash: {lost} (domain, round) fold multisets "
             f"differ from the crash-free run's")
    if computes != N * PS_ROUNDS or commits != M * PS_ROUNDS:
        fail(f"ps_server_crash: {computes} worker computes and {commits} "
             f"block commits in {PS_ROUNDS} rounds")
    expect_counts("ps_server_crash", launches,
                  {"admm_worker_select_update": computes,
                   "server_prox_update": commits + replayed})
    z = cr.z_final
    if tuple(z.shape) != (KDDA_DIM,) or not bool(torch.isfinite(z).all()):
        fail("ps_server_crash: z is not a finite vector of the problem's dim")
    del z
    replay_ms = ps_replay(problem, cr)
    emit("ps_server_crash", N=N, M=M, dim=KDDA_DIM, rounds=PS_ROUNDS,
         crashes=[dict(block=e["block"], sid=e["sid"], at=e["time"],
                       down=PS_CRASH_DOWN, committed_versions=e["version"])
                  for e in crashes],
         recoveries=[dict(sid=e["sid"], at=e["time"],
                          versions_replayed=e["replayed"], wall_ms=ms)
                     for e, ms in zip(recovers, timed["recover"])],
         versions_replayed=replayed, wal=wal, lost_fold_rounds=lost,
         transport={k: cr.metrics["transport"][k] for k in
                    ("sent", "delivered", "retransmits", "dups_dropped")},
         worker_computes=computes, block_commits=commits, launches=launches,
         wall_s=wall_s, wall_ms_per_round=1e3 * wall_s / PS_ROUNDS,
         crash_free_wall_ms_per_round=1e3 * ff_s / PS_ROUNDS,
         makespan=cr.makespan, makespan_crash_free=ff_makespan,
         replay_bitwise=True,
         replay_epoch_ms_median=statistics.median(replay_ms[1:]),
         peak_bytes=peak, peak_bytes_crash_free=ff_peak,
         peak_bytes_ps_lockfree=ps_peaks["lockfree"],
         card=smi_line())
    del rt_cr, cr
    torch.cuda.empty_cache()

    # --- snapshot at round 3, resumed in a new run ---
    snap_dir = tempfile.mkdtemp(prefix="ps_snapshot_")
    try:
        with timed_calls(recovery, ["write_snapshot"]) as wrote:
            rt_full, full, full_launches, full_s = ps_run(
                sess, checkpoint_every=PS_CHECKPOINT_EVERY,
                checkpoint_dir=snap_dir)
        snaps = full.metrics["snapshots"]
        if [Path(p).name for p in snaps] != \
                [f"snap-{PS_CHECKPOINT_EVERY:06d}"]:
            fail(f"ps_snapshot: snapshots written {snaps}")
        path = snaps[0]
        files = {ext: Path(path + ext).stat().st_size
                 for ext in (".npz", ".json")}
        meta = load_extra(path)
        done = sum(w["rounds_done"] for w in meta["workers"])
        committed = sum(d["commits"] for d in meta["domains"])
        with timed_calls(recovery, ["load_snapshot", "resume"]) as loaded:
            rt_res, res, res_launches, res_s = ps_run(sess,
                                                      resume_from=path)
        same = dict(
            z_final=torch.equal(res.z_final, full.z_final),
            z_versions=len(res.z_versions) == len(full.z_versions)
            and all(torch.equal(a, b)
                    for a, b in zip(res.z_versions, full.z_versions)),
            delays=res.trace.delays.tolist() == full.trace.delays.tolist(),
            fold_logs=[d.fold_log for d in rt_res.domains]
            == [d.fold_log for d in rt_full.domains],
            losses=res.losses == full.losses,
            makespan=res.makespan == full.makespan)
        if not all(same.values()):
            fail(f"ps_snapshot: the resumed run differs from the "
                 f"uninterrupted one: {same}")
        own = {"admm_worker_select_update":
               res.metrics["worker_iterations"] - done,
               "server_prox_update": ps_block_commits(res) - committed}
        expect_counts("ps_snapshot resumed", res_launches, own)
        expect_counts("ps_snapshot uninterrupted", full_launches,
                      {"admm_worker_select_update": N * PS_ROUNDS,
                       "server_prox_update": M * PS_ROUNDS})
        emit("ps_snapshot", snapshot=Path(path).name, round=meta["round"],
             bytes=sum(files.values()), files=files,
             write_s=wrote["write_snapshot"][0] / 1e3,
             load_s=loaded["load_snapshot"][0] / 1e3,
             restore_s=loaded["resume"][0] / 1e3,
             uninterrupted_wall_ms_per_round=1e3 * full_s / PS_ROUNDS,
             uninterrupted_wall_ms_per_round_less_write=(
                 1e3 * full_s - wrote["write_snapshot"][0]) / PS_ROUNDS,
             resumed_rounds=PS_ROUNDS - meta["round"], resumed_wall_s=res_s,
             resumed_wall_ms_per_round=(
                 1e3 * res_s - loaded["load_snapshot"][0]
                 - loaded["resume"][0]) / (PS_ROUNDS - meta["round"]),
             resumed_launches=res_launches, uninterrupted_launches=full_launches,
             identical=same, makespan=res.makespan, card=smi_line())
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    del rt_full, full, rt_res, res, sess, centers, problem
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase pytree: ConsensusSession.pytree at Qwen3-1.7B's parameter widths
# ---------------------------------------------------------------------------

# qwen3-1.7b's stacked parameter tree, 28 layers cut to 6 with M = 2: an
# epoch holds two history tables, y and w_cache, z~ and g, B1's two
# outputs and the per-worker gradient tree, and the plain backend x, y
# and w before its selects, three N-bundles more; at 12 layers with M = 3
# that epoch needs ~82 GB of the card's 80 (measured 54.7 GB at 6)
TREE_LAYERS = 6
TREE_WORKERS, TREE_BLOCKS = 2, 2
TREE_EPOCHS = 5
TREE_SCALES = (0.5, 1.5)       # the batch: worker i's minimiser is a_i * c
TREE_BLOCK_SIZES = (311_164_928, 302_018_048)   # LPT at 6 layers, M = 2
TREE_PROFILE_EPOCHS = 2
B1_NAME, B2_NAME = "worker_select_update_kernel", "server_prox_kernel"
# the profiler's kernels by what they do in a tree epoch, first match wins
TREE_SPLIT = (("B1", (B1_NAME,)), ("B2", (B2_NAME,)),
              ("gather_and_push", ("index", "CatArray")),
              ("pack_and_unpack", ("copy", "fill")))


def tree_config():
    """The kdda_like settings at M = TREE_BLOCKS."""
    from repro_torch.configs.base import ADMMConfig
    return ADMMConfig(rho=2.0, gamma=0.1, max_delay=1, block_fraction=0.5,
                      num_blocks=TREE_BLOCKS, l1_coef=1e-3, clip=1.0, seed=0)


def tree_problem(model_cfg):
    """The stacked parameter tree of ``model_cfg`` (seed 0), the loss
    f_i(p) = 1/2 sum over leaves |p - a_i c|^2 around the seed-1 tree c
    (one shared copy: the data cost P, not N P), and the batch a, all on
    the card."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.weights import stacked_params

    params = stacked_params(model_cfg, 0, "cuda")
    c = tree_leaves(stacked_params(model_cfg, 1, "cuda"))

    def loss(p, a):
        return 0.5 * sum(torch.sum(torch.square(x - a * cx))
                         for x, cx in zip(tree_leaves(p), c))

    return params, loss, torch.tensor(TREE_SCALES, device="cuda")


def tree_session(model_cfg):
    """A pytree session of the tree problem, and its batch."""
    params, loss, a = tree_problem(model_cfg)
    return tree_like(loss, params), a


def tree_like(loss, params, **kw):
    """A pytree session of ``loss`` from ``params`` (``kw`` to
    ``pytree``): another backend, delay model or mesh on the same tree
    and the same data, with no second copy of either."""
    from repro_torch.api import ConsensusSession
    return ConsensusSession.pytree(loss, params, tree_config(),
                                   num_workers=TREE_WORKERS, **kw)


def pads_zero(layout, *tables) -> bool:
    """Every pad lane of every table (leading axes, then (M, dblk))
    exactly 0."""
    for t in tables:
        for j, used in enumerate(layout.block_sizes):
            if used < layout.block_dim and bool(
                    t[..., j, used:].count_nonzero()):
                return False
    return True


def tree_max_diff(a, b) -> float:
    from repro_torch.core.tree import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_split(path: str, epoch_ms: float) -> dict:
    """Device ms per epoch by TREE_SPLIT's groups (the rest: the loss's
    forward and backward passes and the selection), from
    ``profile_calls``' table, and the host's share of the epoch."""
    table = json.loads((HERE / "chiprun_out" / f"{path}_profile.json"
                        ).read_text())
    split = {name: 0.0 for name, _ in TREE_SPLIT}
    split["loss_passes_and_rest"] = 0.0
    for row in table["by_kernel"]:
        group = next((name for name, frags in TREE_SPLIT
                      if any(f in row["name"] for f in frags)),
                     "loss_passes_and_rest")
        split[group] += row["device_ms_per_epoch"]
    split["host_gaps"] = max(0.0, epoch_ms - sum(split.values()))
    return split


def b1_b2_rows(rows, profile) -> dict:
    """B1's and B2's rows on a tree path: their windows and bounds on the
    path's inputs (``rows``) beside the profiler's device ms."""
    kernels = {}
    for name, frag in (("admm_worker_select_update", B1_NAME),
                       ("server_prox_update", B2_NAME)):
        r = rows[name]
        dev_ms = profile["kernels"][frag]["device_ms_per_launch"]
        kernels[name] = dict(
            device_ms_per_launch=dev_ms, ms=r["ms"], plain_ms=r["plain_ms"],
            bytes=r["bytes"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            bound_share=r["bound_ms"] / dev_ms,
            max_abs_err=r["max_abs_err"])
    return kernels


def phase_pytree(bw: float, errs):
    """``ConsensusSession.pytree`` on qwen3-1.7b's stacked parameter tree
    (6 layers, f32, seed 0), M = 2 by LPT, N = 2: 5 epochs on the kernels, then 5 on the plain ``torch`` backend
    from the same state. B1 (no x) and B2 launch once an epoch; each
    epoch's z, and epoch 1's y and w_cache, are held between the two
    backends by the kernels' rule; the pad lanes of z, y and w_cache
    stay exactly 0; z moves. Prints the epoch ms of both, both peaks
    beside the reckoning, a profile of the kernel epoch split into pack
    and unpack copies, the loss's passes, B1, B2 and host gaps, and B1's
    and B2's device ms per launch beside their bounds; one more kernel
    epoch's B1 and B2 held against their plain versions on its inputs
    and timed there (``kernels_on_path``)."""
    import dataclasses
    from repro_torch.configs import qwen3_1p7b
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops

    N, M = TREE_WORKERS, TREE_BLOCKS
    model_cfg = dataclasses.replace(qwen3_1p7b.config(),
                                    num_layers=TREE_LAYERS)
    sess, a = tree_session(model_cfg)
    space, layout = sess.spec.space, sess.spec.space.layout
    if space.backend != "cuda":
        fail(f"pytree: 'auto' resolved to {space.backend!r} on the card")
    if layout.block_sizes != TREE_BLOCK_SIZES or \
            layout.block_dim != TREE_BLOCK_SIZES[0]:
        fail(f"pytree: LPT gave blocks {layout.block_sizes}, dblk "
             f"{layout.block_dim}; the reference's are {TREE_BLOCK_SIZES}")
    P = sum(int(t.numel()) for t in tree_leaves(sess.z0))
    T = M * layout.block_dim
    d = layout.block_dim

    def run(session, on_epoch):
        # earlier phases' reference cycles may still hold device tensors
        # until the collector runs; collect them so the peak is this path's
        gc.collect()
        reset_peak()
        ops.reset_launch_counts()
        state = session.init()
        torch.cuda.synchronize()
        times = []
        for t in range(TREE_EPOCHS):
            t0 = time.perf_counter()
            state, info = session.step(state, a)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            if not pads_zero(layout, state.z_hist, state.y, state.w_cache):
                fail(f"pytree {session.spec.space.backend}: a pad lane is "
                     f"not 0 after epoch {t}")
            on_epoch(t, state, info)
        return (state, times, ops.launch_counts(),
                torch.cuda.max_memory_allocated())

    z_host, first = [], {}

    def keep(t, state, info):
        z_host.append(state.z_blocks.cpu())
        if t == 0:
            first.update(y=state.y.cpu(), w_cache=state.w_cache.cpu(),
                         selected=float(info["selected_fraction"]))

    state, times, launches, peak = run(sess, keep)
    expect_launches("pytree", launches, TREE_EPOCHS, MAIN_KERNELS)
    z0 = layout.to_blocks(sess.z0)
    moved = float((state.z_blocks - z0).abs().max())
    del z0
    if not moved > 0.0 or not bool(torch.isfinite(state.z_blocks).all()):
        fail(f"pytree: z did not move or is not finite (max|z - z0| = "
             f"{moved})")
    z_tree = sess.z(state)
    if [tuple(x.shape) for x in tree_leaves(z_tree)] != \
            [tuple(x.shape) for x in tree_leaves(sess.z0)]:
        fail("pytree: z is not the params tree")
    del z_tree
    epoch_ms = statistics.median(times[1:])
    held = [state]
    del state

    def step():
        held[0], _ = sess.step(held[0], a)

    profile = profile_calls("pytree", step, epoch_ms, TREE_PROFILE_EPOCHS,
                            expect={B1_NAME: 1, B2_NAME: 1})
    split = tree_split("pytree", epoch_ms)
    # one more epoch: B1 and B2 against their plain versions on the
    # inputs it gave them, and timed there (the tensors themselves: the
    # state that epoch made is dropped, nothing writes to them)
    with capture_inputs(copy=False, names=MAIN_KERNELS, keep=1) as inputs:
        step()
    del held[0]
    torch.cuda.empty_cache()
    rows = check_on_path("pytree", inputs, MAIN_KERNELS, bw, errs)

    diffs = []

    def hold(t, state, info):
        diffs.append(compare(z_host[t].cuda(), state.z_blocks))
        if t == 0:
            for name in ("y", "w_cache"):
                errs["admm_worker_select_update"] = max(
                    errs["admm_worker_select_update"],
                    compare(first[name].cuda(), getattr(state, name)))
            errs["server_prox_update"] = max(errs["server_prox_update"],
                                             diffs[0])

    plain = tree_like(sess.spec.loss_fn, sess.z0, backend="torch")
    del sess
    state, plain_times, plain_launches, plain_peak = run(plain, hold)
    if any(plain_launches.values()):
        fail("pytree: the torch backend launched a kernel")
    params = plain.z0
    del state, plain, first["y"], first["w_cache"]
    z_host.clear()
    torch.cuda.empty_cache()

    kernels = b1_b2_rows(rows, profile)
    emit("pytree", arch=SERVE_ARCH, layers=TREE_LAYERS, N=N, M=M,
         params=P, block_sizes=list(layout.block_sizes), dblk=d,
         table_entries=T, padding_share=1.0 - P / T, epochs=TREE_EPOCHS,
         launches=launches, selected_fraction=first["selected"],
         epoch_ms=times, epoch_ms_median=epoch_ms,
         torch_epoch_ms=plain_times,
         torch_epoch_ms_median=statistics.median(plain_times[1:]),
         peak_bytes=peak, torch_peak_bytes=plain_peak,
         reckoned_peak_bytes=4 * (2 * T + 6 * N * T + N * P + P),
         z_max_abs_diff_vs_torch=diffs, z_moved_max_abs=moved,
         pads_zero=True, device_ms_per_epoch=split, profile=profile,
         kernels=kernels, card=smi_line())
    del params, a
    torch.cuda.empty_cache()
    return launches


def tree_replay_bitwise(path: str, sess, res, a) -> list:
    """Replay ``res``'s trace through the tree epoch of ``sess``'s
    problem on the kernels; every round's z tree must equal the
    runtime's bit for bit. Returns the epochs' ms."""
    from repro_torch.core.tree import tree_leaves
    rs = tree_like(sess.spec.loss_fn, sess.z0,
                   delay_model=res.to_delay_model())
    state = rs.init()
    times = []
    for t in range(res.num_rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = rs.step(state, a)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if not all(torch.equal(x, y) for x, y in zip(
                tree_leaves(rs.z(state)), tree_leaves(res.z_versions[t + 1]))):
            fail(f"{path}: the replayed z differs from the runtime's at "
                 f"round {t} by {tree_max_diff(rs.z(state), res.z_versions[t + 1]):.3e} "
                 f"(bitwise gate)")
    return times


def phase_ps_tree() -> dict:
    """``run_ps`` (lockfree, 6 rounds, lognormal service times) on a
    pytree session of the qwen3-1.7b smoke config's stacked tree, N = 2,
    M = 2: B1 once per worker compute and B2 once per block commit, z
    trees at every version; the trace replayed through the tree epoch on
    the kernels, z bitwise equal at every round."""
    from repro_torch.configs import qwen3_1p7b
    from repro_torch.kernels import ops

    model_cfg = qwen3_1p7b.smoke()
    sess, a = tree_session(model_cfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = sess.run_ps(PS_ROUNDS, timing=ps_timing(), batches=lambda t: a)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    computes = res.metrics["worker_iterations"]
    commits = ps_block_commits(res, TREE_BLOCKS)
    expect_counts("ps_tree", launches, {"admm_worker_select_update": computes,
                                        "server_prox_update": commits})
    if computes != TREE_WORKERS * PS_ROUNDS or \
            commits != TREE_BLOCKS * PS_ROUNDS:
        fail(f"ps_tree: {computes} worker computes and {commits} block "
             f"commits in {PS_ROUNDS} rounds")
    if not isinstance(res.z_final, dict) or not all(
            isinstance(v, dict) for v in res.z_versions):
        fail("ps_tree: z_final / z_versions are not params trees")
    ops.reset_launch_counts()
    replay_ms = tree_replay_bitwise("ps_tree", sess, res, a)
    expect_launches("ps_tree replay", ops.launch_counts(), PS_ROUNDS,
                    MAIN_KERNELS)
    emit("ps_tree", arch=model_cfg.name, N=TREE_WORKERS, M=TREE_BLOCKS,
         dblk=sess.spec.space.layout.block_dim, rounds=res.num_rounds,
         discipline=res.discipline, wall_ms_per_round=1e3 * wall_s
         / res.num_rounds, replay_epoch_ms=replay_ms,
         makespan=res.makespan, worker_computes=computes,
         block_commits=commits, launches=launches, replay_bitwise=True,
         losses=res.losses, card=smi_line())
    del sess, res
    return launches


def spmd_tree() -> dict:
    """The pytree session with ``mesh=`` on phase ``spmd``'s 1x1 NCCL
    mesh at the qwen3-1.7b smoke size, 10 epochs: B1 and B3 once an
    epoch, B2 never; z within 1e-5 of the single-device tree epoch."""
    from repro_torch.configs import qwen3_1p7b
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh

    model_cfg = qwen3_1p7b.smoke()
    single, a = tree_session(model_cfg)
    state = single.init()
    for _ in range(MAIN_EPOCHS):
        state, _ = single.step(state, a)
    z_single = single.z(state)
    sess = tree_like(single.spec.loss_fn, single.z0,
                     mesh=make_test_mesh(1, 1))
    ops.reset_launch_counts()
    state = sess.init()
    torch.cuda.synchronize()
    times = []
    for _ in range(MAIN_EPOCHS):
        t0 = time.perf_counter()
        state, _ = sess.step(state, a)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    launches = ops.launch_counts()
    expect_launches("spmd_tree", launches, MAIN_EPOCHS, SPMD_KERNELS)
    diff = tree_max_diff(sess.z(state), z_single)
    scale = max(float(x.abs().max()) for x in tree_leaves(z_single))
    if not diff <= TRAJ_TOL * (1.0 + scale):
        fail(f"spmd_tree: z differs from the single-device tree epoch by "
             f"{diff:.3e}")
    emit("spmd_tree", arch=model_cfg.name, world_size=1,
         mesh=dict(sess.spec.space.mesh.shape), N=TREE_WORKERS,
         M=TREE_BLOCKS, epochs=MAIN_EPOCHS, launches=launches,
         epoch_ms_median=statistics.median(times[1:]),
         z_max_abs_diff_vs_single=diff, z_max_abs=scale, card=smi_line())
    return launches


# ---------------------------------------------------------------------------
# phase train: the trainers at qwen3-1.7b width
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 6               # the pytree phase's cut
TRAIN_WORKERS, TRAIN_BLOCKS = 2, 2
TRAIN_STEPS = 5
TRAIN_BATCH, TRAIN_SEQ = 2, 512          # per worker: 2 x 512 tokens
TRAIN_PROFILE_STEPS = 2
SGD_BATCH, SGD_STEPS = 4, 3              # AdamW, all 28 layers
SERVE_LOGIT_TOL = 1e-5         # the served tree vs the stacked forward
LOSS_TOL = 1e-6                # step 0's loss vs Model.loss, relative


def train_config(**kw):
    """launch/train.py's ADMM defaults (rho 20, gamma 0.01, D 1, block
    fraction 1, random selection) at M = TRAIN_BLOCKS."""
    from repro_torch.configs.base import ADMMConfig
    return ADMMConfig(rho=20.0, gamma=0.01, max_delay=1, block_fraction=1.0,
                      num_blocks=TRAIN_BLOCKS, seed=0, **kw)


def direct_loss(model, params, batch, workers=None) -> float:
    """``Model.loss`` at ``params``, computed on its own (the mean over
    workers of each worker's batch when ``workers`` is given)."""
    with torch.no_grad():
        if workers is None:
            return float(model.loss(params, batch))
        return float(torch.stack([
            model.loss(params, {k: v[i] for k, v in batch.items()})
            for i in range(workers)]).mean())


def same_loss(path: str, got: float, want: float) -> float:
    rel = abs(got - want) / abs(want)
    if not rel <= LOSS_TOL:
        fail(f"{path}: step 0's loss {got!r} differs from Model.loss "
             f"{want!r} by {rel:.3e} relative")
    return rel


def train_parts(model, spec, packed, batch) -> dict:
    """ms of each part of one ADMM train step, each timed alone on the
    step's inputs: the gather of z~ and the push of z, the loss's forward
    (no autograd) and its backward (``worker_grads`` less the forward and
    the pack of g), the pack of g into the table (the unpack of z~ is
    views)."""
    from repro_torch.core.tree import tree_unflatten
    space, layout = spec.space, spec.space.layout
    N, M = spec.edge.shape
    delays = torch.ones((N, M), dtype=torch.int64, device="cuda")
    z_tilde = space.gather(packed.z_hist, delays)
    gather = time_ms(lambda: space.gather(packed.z_hist, delays), 5, 3)
    push = time_ms(lambda: space.push(packed.z_hist, packed.z_hist[0]), 5,
                   3)
    leaves = layout.unpack_leaves(z_tilde)
    forward = torch.func.vmap(model.loss)
    with torch.no_grad():
        fwd = time_ms(lambda: forward(
            tree_unflatten(layout.tree.treedef, leaves), batch), 3, 3, 1)
    grads = time_ms(lambda: space.worker_grads(model.loss, z_tilde, batch),
                    2, 3, 1)
    _, g = space.worker_grads(model.loss, z_tilde, batch)
    g_leaves = layout.unpack_leaves(g)
    pack = time_ms(lambda: layout.pack_leaves(g_leaves), 5, 3)
    return {"loss_forward": fwd, "loss_backward": grads - fwd - pack,
            "pack_and_unpack": pack, "gather_and_push": gather + push}


def train_split(model, spec, packed, batch, profile, step_ms) -> dict:
    """Device ms of a train step by part: ``train_parts``, and B1's and
    B2's device ms per launch from ``profile``; the idle time and the
    rest of ``step_ms``."""
    split = train_parts(model, spec, packed, batch)
    split.update(
        B1=profile["kernels"][B1_NAME]["device_ms_per_launch"],
        B2=profile["kernels"][B2_NAME]["device_ms_per_launch"],
        idle=step_ms - profile["device_busy_ms_per_epoch"])
    split["rest"] = step_ms - sum(split.values())
    return split


def phase_train(bw: float, errs):
    """``ADMMTrainer`` on qwen3-1.7b's stacked tree at full width, cut to
    TRAIN_LAYERS layers (f32, seed 0), N = 2, M = 2 by LPT, launch/train.py's
    defaults, ``TokenPipeline`` batches of 2 x 512 tokens a worker: 5
    steps on the kernels, then 5 on the plain backend from the same
    state. Gates: step 0's loss is ``Model.loss`` at z0; z of the two
    backends agree every step by the kernels' rule; losses and z finite,
    pads 0; B1 and B2 once a step; one more step's B1 and B2 held on
    their inputs; the trained z served as a ``ParamTree`` gives the
    stacked forward's last logits. Then ``SGDTrainer`` with AdamW on all
    28 layers, 3 steps of 4 x 512 tokens: step 0's loss is
    ``Model.loss``, params finite. Prints step ms, tokens/s, peaks,
    a device split of the ADMM step and B1's and B2's device ms."""
    import dataclasses
    from repro_torch.configs import qwen3_1p7b
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, params_from_stacked
    from repro_torch.models import transformer
    from repro_torch.models.weights import stacked_params
    from repro_torch.training import ADMMTrainer

    N, M = TRAIN_WORKERS, TRAIN_BLOCKS
    model_cfg = dataclasses.replace(qwen3_1p7b.config(),
                                    num_layers=TRAIN_LAYERS)
    model = build_model(model_cfg)
    params = stacked_params(model_cfg, 0, "cuda")
    pipe = TokenPipeline(vocab_size=model_cfg.vocab_size,
                         seq_len=TRAIN_SEQ + 1,
                         global_batch=N * TRAIN_BATCH, seed=0)
    batches = [pipe.batch(t, num_workers=N, device="cuda")
               for t in range(TRAIN_STEPS + 1)]
    tokens = N * TRAIN_BATCH * TRAIN_SEQ
    P = sum(int(t.numel()) for t in tree_leaves(params))

    def trainer(backend):
        return ADMMTrainer(loss_fn=model.loss,
                           admm=train_config(backend=backend),
                           num_workers=N, device="cuda")

    def run(tr, on_step):
        # the peak is the trainer's: read after each step, the checks
        # after it excluded (the peak reset after them)
        gc.collect()
        reset_peak()
        ops.reset_launch_counts()
        state = tr.init(params)
        torch.cuda.synchronize()
        times, losses, peaks = [], [], []
        for t in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, info = tr.train_step(state, batches[t])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            peaks.append(torch.cuda.max_memory_allocated())
            losses.append(float(info["loss"]))
            packed = tr._packed(tr._spec(state.params), state)
            if not pads_zero(layout, packed.z_hist, packed.y,
                             packed.w_cache):
                fail(f"train {tr.admm.backend}: a pad lane is not 0 after "
                     f"step {t}")
            if not math.isfinite(losses[-1]) or not bool(
                    torch.isfinite(packed.z_hist[0]).all()):
                fail(f"train {tr.admm.backend}: loss or z not finite at "
                     f"step {t}")
            on_step(t, packed)
            del packed
            torch.cuda.reset_peak_memory_stats()
        return state, times, losses, ops.launch_counts(), peaks

    kern = trainer("auto")
    spec = kern._spec(params)
    layout = spec.space.layout
    if spec.space.backend != "cuda":
        fail(f"train: 'auto' resolved to {spec.space.backend!r} on the card")
    if layout.block_sizes != TREE_BLOCK_SIZES:
        fail(f"train: LPT gave blocks {layout.block_sizes}; the "
             f"reference's are {TREE_BLOCK_SIZES}")
    T = M * layout.block_dim
    loss0 = direct_loss(model, params, batches[0], N)
    z_host = []
    state, times, losses, launches, peaks = run(
        kern, lambda t, packed: z_host.append(packed.z_hist[0].cpu()))
    expect_launches("train", launches, TRAIN_STEPS, MAIN_KERNELS)
    loss_rel = same_loss("train", losses[0], loss0)
    step_ms = statistics.median(times[1:])

    # the trained z served: a ParamTree of views, its last logits against
    # the stacked forward's on one worker's tokens
    tok = batches[0]["tokens"][0]
    served = params_from_stacked(model_cfg, state.params)
    with torch.no_grad():
        want = transformer.forward(state.params, tok, model_cfg,
                                   logits_mode="last")[0]
        got = model.prefill(served, tok, logits_mode="last")
    serve_diff = float((got - want).abs().max())
    serve_scale = float(want.abs().max())
    if not serve_diff <= SERVE_LOGIT_TOL * serve_scale:
        fail(f"train: the served tree's logits differ from the stacked "
             f"forward's by {serve_diff:.3e} (max |logits| "
             f"{serve_scale:.3e})")
    del served, want, got

    # the step profiled; then its parts timed alone (CUDA-event windows)
    # on the next step's inputs, as asybadmm_epoch calls them: the model's
    # own index, cat and copy kernels share names with the gather, push
    # and pack, so the profile alone cannot split them
    held = [state]
    del state

    def step():
        held[0], _ = kern.train_step(held[0], batches[TRAIN_STEPS])

    profile = profile_calls("train", step, step_ms, TRAIN_PROFILE_STEPS,
                            expect={B1_NAME: 1, B2_NAME: 1})
    split = train_split(model, spec, kern._packed(spec, held[0]),
                        batches[TRAIN_STEPS], profile, step_ms)
    with capture_inputs(copy=False, names=MAIN_KERNELS, keep=1) as inputs:
        step()
    del held[0]
    torch.cuda.empty_cache()
    rows = check_on_path("train", inputs, MAIN_KERNELS, bw, errs)

    diffs = []
    plain = trainer("torch")
    p_state, plain_times, plain_losses, plain_launches, plain_peaks = run(
        plain, lambda t, packed: diffs.append(compare(
            z_host[t].cuda(), packed.z_hist[0])))
    if any(plain_launches.values()):
        fail("train: the torch backend launched a kernel")
    del p_state
    z_host.clear()
    errs["server_prox_update"] = max(errs["server_prox_update"], max(diffs))
    del params, batches
    torch.cuda.empty_cache()

    kernels = b1_b2_rows(rows, profile)
    emit("train", arch=SERVE_ARCH, layers=TRAIN_LAYERS, N=N, M=M, params=P,
         block_sizes=list(layout.block_sizes), dblk=layout.block_dim,
         table_entries=T, steps=TRAIN_STEPS,
         tokens_per_step=tokens, launches=launches, losses=losses,
         torch_losses=plain_losses, loss0_direct=loss0,
         loss0_rel_diff=loss_rel, step_ms=times, step_ms_median=step_ms,
         tokens_per_s=tokens / step_ms * 1e3, torch_step_ms=plain_times,
         torch_step_ms_median=statistics.median(plain_times[1:]),
         torch_tokens_per_s=tokens / statistics.median(plain_times[1:])
         * 1e3,
         peak_bytes=max(peaks), torch_peak_bytes=max(plain_peaks),
         peak_bytes_by_step=peaks, torch_peak_bytes_by_step=plain_peaks,
         reckoned_peak_bytes=4 * (2 * T + 6 * N * T + N * P + P)
         + 4 * N * (3 * TRAIN_BATCH * TRAIN_SEQ + model_cfg.d_model)
         * model_cfg.vocab_size,
         z_max_abs_diff_vs_torch=diffs, served_logits_max_abs_diff=serve_diff,
         served_logits_max_abs=serve_scale, pads_zero=True,
         device_ms_per_step=split, profile=profile, kernels=kernels,
         card=smi_line())
    phase_train_sgd()
    return launches


def phase_train_sgd() -> None:
    """``SGDTrainer`` + AdamW (launch/train.py's warmup-cosine at lr
    1e-3) on qwen3-1.7b in full, 28 layers, 3 steps of 4 x 512 tokens
    of the same stream."""
    from repro_torch.configs import qwen3_1p7b
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.weights import stacked_params
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.training import SGDTrainer

    cfg = qwen3_1p7b.config()
    model = build_model(cfg)
    gc.collect()
    reset_peak()
    params = stacked_params(cfg, 0, "cuda")
    P = sum(int(t.numel()) for t in tree_leaves(params))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ + 1,
                         global_batch=SGD_BATCH, seed=0)
    batches = [pipe.batch(t, device="cuda") for t in range(SGD_STEPS)]
    loss0 = direct_loss(model, params, batches[0])
    tr = SGDTrainer(loss_fn=model.loss, optimizer=adamw(
        warmup_cosine(1e-3, SGD_STEPS // 10, SGD_STEPS)))
    state = tr.init(params)
    del params
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    times, losses = [], []
    for t in range(SGD_STEPS):
        t0 = time.perf_counter()
        state, info = tr.train_step(state, batches[t])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(info["loss"]))
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()
    expect_counts("train_sgd", launches, {})
    loss_rel = same_loss("train_sgd", losses[0], loss0)
    if not all(bool(torch.isfinite(x).all()) for x in
               tree_leaves(state.params)) or not all(
                   math.isfinite(x) for x in losses):
        fail("train_sgd: params or losses not finite")
    tokens = SGD_BATCH * TRAIN_SEQ
    step_ms = statistics.median(times[1:])
    emit("train_sgd", arch=cfg.name, layers=cfg.num_layers, params=P,
         steps=SGD_STEPS, tokens_per_step=tokens, losses=losses,
         loss0_direct=loss0, loss0_rel_diff=loss_rel, step_ms=times,
         step_ms_median=step_ms, tokens_per_s=tokens / step_ms * 1e3,
         peak_bytes=peak, launches=launches, card=smi_line())
    del state, batches
    torch.cuda.empty_cache()


def phase_train_entry_points() -> dict:
    """launch/train.py at its smoke defaults, 6 steps of each trainer and
    3 rounds of ``--runtime ps``, and the training example with
    ``--quick``: B1 and B2 once per ADMM step (per worker compute and
    block commit under ps), none for AdamW, every loss finite; then
    ``--arch zamba2-1.2b`` (the hybrid smoke), ``--arch minicpm3-4b``
    and ``--arch whisper-medium``, 6 ADMM steps each, and whisper's 3
    rounds of ``--runtime ps``."""
    import contextlib as _cl
    import io
    from repro_torch.examples import train_transformer_admm as example
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    out = {}

    def run(name, fn, want):
        ops.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with _cl.redirect_stdout(buf):
            losses = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        lines = [json.loads(x) for x in buf.getvalue().splitlines()
                 if x.startswith("{")]
        flat = [v for x in (losses.values() if isinstance(losses, dict)
                            else [losses]) for v in x]
        if not flat or not all(math.isfinite(v) for v in flat):
            fail(f"train_entry_points {name}: a loss is not finite")
        expect_counts(f"train_entry_points {name}", launches, want(lines))
        out[name] = dict(launches=launches, losses=losses, wall_s=wall)

    steps, rounds, workers, blocks = 6, 3, 4, 8     # the launcher's
    admm = ["--steps", str(steps), "--log-every", "1"]
    run("admm", lambda: train.main(admm),
        lambda lines: {k: steps for k in MAIN_KERNELS})
    run("sgd", lambda: train.main(admm + ["--trainer", "sgd"]),
        lambda lines: {})

    def ps_counts(lines):
        commits = lines[-1]["commits"]
        if commits != blocks * rounds:
            fail(f"train_entry_points ps: {commits} block commits in "
                 f"{rounds} rounds")
        return {"admm_worker_select_update": workers * rounds,
                "server_prox_update": commits}
    run("ps", lambda: train.main(["--steps", str(rounds), "--runtime", "ps",
                                  "--log-every", "1"]), ps_counts)
    # the hybrid tree (its unstacked shared block among the leaves)
    run("zamba2", lambda: train.main(admm + ["--arch", HYBRID_ARCH]),
        lambda lines: {k: steps for k in MAIN_KERNELS})
    # the MLA tree, and the enc-dec tree (its batches carry the frames)
    for name_, arch in (("minicpm3", MLA_ARCH), ("whisper", ENC_DEC_ARCH)):
        run(name_, lambda arch=arch: train.main(admm + ["--arch", arch]),
            lambda lines: {k: steps for k in MAIN_KERNELS})
    run("whisper_ps", lambda: train.main(
        ["--steps", str(rounds), "--runtime", "ps", "--log-every", "1",
         "--arch", ENC_DEC_ARCH]), ps_counts)
    quick = 30                                       # the example's --quick
    run("example", lambda: example.main(["--quick"]),
        lambda lines: {k: quick for k in MAIN_KERNELS})
    emit("train_entry_points", **out, card=smi_line())
    gc.collect()
    torch.cuda.empty_cache()
    return out


def commit_on_path(case, rows) -> dict:
    """B2 on the inputs of the PS runtime's first block commit, (N, 1,
    dblk), beside its CUDA-event window (``rows``): whether it is the
    plain version bit for bit, its device time per launch
    (``kernel_device_ms``, also with the column just rewritten, as the
    push before a commit leaves it), and how far past the gate a result
    that drops the last row reaching the column's sum reads."""
    lg = kernel_module("server_prox_update")
    z, w, edge, rho_sum, gamma, l1, clip = case
    out = lg.server_prox_update_cuda(*case)
    plain = lg.server_prox_update_torch(*case)
    # the workers whose rows reach the sum: on the edge set, and pushed
    # (a row the cache still holds as zeros adds nothing)
    edged = torch.nonzero(edge[:, 0] & (w[:, 0] != 0).any(dim=1)).flatten()
    if edged.numel() == 0:
        fail("ps: no row of the first commit's column reaches its sum")
    dropped = edge.clone()
    dropped[int(edged[-1]), 0] = False
    ratio = over_limit(lg.server_prox_update_torch(
        z, w, dropped, rho_sum, gamma, l1, clip), plain)
    if not ratio > 1.0:
        fail(f"ps: B2 without worker {int(edged[-1])}'s row reads "
             f"{ratio:.3g} of the gate's limit, not past it")
    source = w.clone()
    return dict(bitwise=bitwise(out, plain),
                faulty_dropped_worker_over_limit=ratio,
                **kernel_device_ms(
                    "ps_commit", "server_prox_kernel",
                    lambda: lg.server_prox_update_cuda(*case),
                    rows["server_prox_update"]["ms"],
                    written=lambda: w.copy_(source)))


# ---------------------------------------------------------------------------
# phase 8: the model stack at qwen3-1.7b's full width, and its serving path
# ---------------------------------------------------------------------------

def timed_prefill(model, params, tokens, mode="last", enc_frames=None,
                  **route_kw):
    """(logits, host ms) of one prefill (of an enc-dec arch: with its
    encoder over ``enc_frames``), under ``routing(**route_kw)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with routing(**route_kw):
        out = model.prefill(params, tokens, logits_mode=mode,
                            enc_frames=enc_frames)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def first_tokens_decided(path: str, tokens, decoded_last, last) -> dict:
    """The first generated tokens are the prefill's argmax wherever its
    top-2 gap exceeds what separates the decode's last logits from it
    (as phase ``serve`` holds them)."""
    delta = float((decoded_last - last).abs().max())
    top2 = last.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > delta
    first = torch.as_tensor(tokens[:, 0], device=last.device)
    if not torch.equal(first[decided], last.argmax(-1)[decided]):
        fail(f"{path}: first tokens {first.tolist()} against the "
             f"prefill's argmax {last.argmax(-1).tolist()}")
    return dict(first_token_delta=delta,
                first_tokens_decided=int(decided.sum()))


def generate_timed(path: str, engine, prompts, max_new: int,
                   enc_frames=None, want=None) -> tuple:
    """``Engine.generate`` (greedy; an enc-dec arch's encoder over
    ``enc_frames`` first), timed, its launches counted: ``want`` (none by
    default)."""
    from repro_torch.kernels import ops
    reset_peak()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new=max_new, enc_frames=enc_frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    expect_counts(f"{path} decode", launches, want or {})
    vocab = engine.model.cfg.vocab_size
    if res.tokens.shape != (prompts.shape[0], max_new) or \
            res.tokens.min() < 0 or res.tokens.max() >= vocab:
        fail(f"{path}: generated tokens {res.tokens.shape}, ids "
             f"{res.tokens.min()}..{res.tokens.max()}")
    return res, dict(requests=prompts.shape[0], prompt_len=prompts.shape[1],
                     max_new=max_new, generate_s=seconds,
                     generate_tokens_per_s=prompts.shape[0] * max_new
                     / seconds, launches=launches,
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     tokens_req0=res.tokens[0].tolist())


def refused_attention(case, plain, exact) -> dict:
    """Results a faulty B7 could return for ``case``, which its float64
    gate must refuse: no causal mask (on a bidirectional case, one
    added); the last 64 keys dropped; inputs
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
        "no_causal_mask" if causal else "causal_mask_added":
            lambda: fa.flash_attention_cuda(q, k, v, not causal, scale),
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


def b7_on_path(case, cfg, dtype, bw, errs, batch=SERVE_BATCH, seq=SERVE_SEQ,
               causal=True) -> dict:
    """B7 on the inputs the prefill gave it at one layer, (batch x heads,
    seq padded to 128, hd padded to 128): held to float64 by B5's rule
    (in 16 bits row by row too), the gate shown to refuse faulty results
    (``refused_attention``), timed beside its plain version and SDPA in
    the same dtype."""
    hd = max(128, -(-cfg.resolved_head_dim // 128) * 128)   # padded so
    if [list(t.shape) for t in case[:3]] != [
            [batch * cfg.num_heads, -(-seq // 128) * 128, hd]] * 3 or \
            case[3] is not causal or case[0].dtype != dtype:
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
        return timed_prefill(m, params, tokens)

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


# ---------------------------------------------------------------------------
# the chunked / qchunk attention impls: phase serve_chunked (qwen3-1.7b at
# 4 x 4096 and at 1 x 32768), lines serve_chunked_window (mixtral past
# its window) and serve_chunked_encdec (whisper's padded encoder keys)
# ---------------------------------------------------------------------------

CHUNKED_IMPLS = (("chunked", 1024), ("qchunk", 2048))   # (impl, attn_chunk)
# wall seconds of the phases and lines the chunked impls, the autotuner
# and the SPMD replays added, by name (printed in line ``timing``)
ADDED_S = {}
LONG_BATCH, LONG_SEQ = 1, 32_768   # the reference's prefill_32k
                                   # (configs/base.py:204), its batch of 32
                                   # cut to 1 for one card
LONG_LAYERS = 14                   # of 28: cut to keep the phases this
                                   # slice adds near 150 s (at 28 the 32k
                                   # runs take ~50 s of them)
LONG_PROFILE_LAYERS = 2            # the first run and the idle share's
                                   # profile: a cut of the stack


class DepthCut:
    """A ``ParamTree`` seen with only its first ``layers`` layers (every
    other part shared): the same widths and weights at a cut depth."""

    def __init__(self, params, layers: int):
        self.params, self.layers = params, layers

    def __getitem__(self, name):
        part = self.params[name]
        return part[:self.layers] if name == "layers" else part


@contextlib.contextmanager
def patched(module, name: str, make):
    """Inside the block ``module.name`` is ``make(the real one)``: a
    fault this script injects to show a gate refuses it."""
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def forcing(**forced):
    """``make`` for ``patched``: the real function with ``forced``
    keyword arguments."""
    def make(real):
        return lambda *a, **kw: real(*a, **{**kw, **forced})
    return make


# a fault of each impl's masks, the attention function it patches
IMPL_FAULTS = {
    "no_causal_mask": ("_sdpa_chunked", forcing(causal=False)),
    "window_mask_dropped": ("_sdpa_qchunk", forcing(window=None)),
    "pad_keys_unmasked": ("_tile_valid", forcing(keys_padded=False)),
}


def last_logits_gap(path: str, logits, ref, cfg, batch: int) -> float:
    """max|logits - ref| of two last-position prefills, the first's shape
    and finiteness checked."""
    if logits.shape != (batch, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail(f"{path}: prefill logits {tuple(logits.shape)} are not finite "
             f"last-position logits")
    return float((logits - ref).abs().max())


def impl_prefills(path: str, cfg, prefill, ref, batch: int,
                  faults=()) -> dict:
    """Each of CHUNKED_IMPLS through ``prefill(model)`` (-> logits, host
    ms): no kernel launched, its last logits within FLASH_NAIVE_TOL of
    ``ref``; a first run and a timed one, its peak; then each fault of
    ``faults`` ((impl, fault) pairs) injected, whose logits must read
    past FLASH_NAIVE_TOL."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention, build_model
    out = {}
    for impl, chunk in CHUNKED_IMPLS:
        model = build_model(cfg.with_(attn_impl=impl, attn_chunk=chunk))
        reset_peak()
        ops.reset_launch_counts()
        logits, first_ms = prefill(model)
        expect_counts(f"{path} ({impl})", ops.launch_counts(), {})
        peak = torch.cuda.max_memory_allocated()
        _, ms = prefill(model)
        gap = last_logits_gap(path, logits, ref, cfg, batch)
        if not gap < FLASH_NAIVE_TOL:
            fail(f"{path}: the {impl} prefill's last logits differ from the "
                 f"reference path's by {gap:.3e} (limit {FLASH_NAIVE_TOL})")
        out[impl] = dict(chunk=chunk, first_ms=first_ms, ms=ms,
                         peak_bytes=peak, max_abs_diff=gap)
        del logits
    for impl, fault in faults:
        name, make = IMPL_FAULTS[fault]
        model = build_model(cfg.with_(attn_impl=impl,
                                      attn_chunk=dict(CHUNKED_IMPLS)[impl]))
        with patched(attention, name, make):
            logits, _ = prefill(model)
        gap = float((logits - ref).abs().max())
        if not gap > FLASH_NAIVE_TOL:
            fail(f"{path}: the 2e-3 gate let a {impl} prefill with its "
                 f"fault {fault} through ({gap:.3e})")
        out[impl].setdefault("faulty_max_abs_diff", {})[fault] = gap
        del logits
    torch.cuda.empty_cache()
    return out


def long_prefill_reckoning(cfg, weight_bytes: int) -> dict:
    """Peak bytes reckoned for a LONG_BATCH x LONG_SEQ f32 prefill under
    each impl: the weights, one layer's activations (the residual and its
    norm, q, k, v and the attention output, the MLP's gate, up and
    product), and the impl's own: flash's GQA-expanded K/V, the three
    padded operands and B7's output; qchunk's two live (qc, T) score
    tiles (the scaled scores and the masked or softmaxed ones); chunked's
    four (1024, 1024) tiles and its running out. Naive's (S, S) scores
    alone are printed as the reason it is not run."""
    f, S = 4, LONG_BATCH * LONG_SEQ
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    base = weight_bytes + f * S * (2 * d + (nq + 2 * nkv) * hd + nq * hd
                                   + 3 * ff)
    head = f * S * nq * hd
    return {
        "flash": base + 6 * head,
        "qchunk": base + 2 * f * LONG_BATCH * nq * 2048 * LONG_SEQ + head,
        "chunked": base + 4 * f * LONG_BATCH * nq * 1024 * 1024 + 2 * head,
        "naive_scores_bytes": f * LONG_BATCH * nq * LONG_SEQ * LONG_SEQ}


def serve_long(cfg, params, weight_bytes: int, bw, errs) -> dict:
    """LONG_BATCH x LONG_SEQ tokens (the reference's prefill_32k, batch
    cut to 1) at LONG_LAYERS layers through flash (B7 once a layer at
    (16, 32768, 128); layer 0's launch held to float64 on its first
    head), qchunk and chunked. Each impl: a first run at a
    LONG_PROFILE_LAYERS-layer cut (its first use of the length; flash's
    B7 inputs captured there), then the timed run at LONG_LAYERS with
    its peak beside ``long_prefill_reckoning`` (printed first), then the
    device's idle share of the cut from the profiler; chunked's and
    qchunk's last logits within FLASH_NAIVE_TOL of flash's."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    reckoned = long_prefill_reckoning(cfg, weight_bytes)
    emit("serve_chunked_plan", batch=LONG_BATCH, seq=LONG_SEQ,
         layers=LONG_LAYERS, reckoned_peak_bytes=reckoned,
         naive=f"not run: its ({LONG_BATCH}, {cfg.num_heads}, {LONG_SEQ}, "
               f"{LONG_SEQ}) f32 scores take "
               f"{reckoned['naive_scores_bytes']} bytes a layer")
    gen = torch.Generator(device="cuda").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (LONG_BATCH, LONG_SEQ),
                           generator=gen, device="cuda")
    view = params if LONG_LAYERS == cfg.num_layers \
        else DepthCut(params, LONG_LAYERS)
    cut = DepthCut(params, LONG_PROFILE_LAYERS)
    out, flash_logits = {}, None
    for impl, chunk in (("flash", cfg.attn_chunk),) + CHUNKED_IMPLS:
        model = build_model(cfg.with_(attn_impl=impl, attn_chunk=chunk))
        with capture_inputs(names=("flash_attention",), keep=1) as inputs:
            _, first_cut_ms = timed_prefill(model, cut, tokens)
        reset_peak()
        ops.reset_launch_counts()
        logits, ms = timed_prefill(model, view, tokens)
        launches = ops.launch_counts()
        expect_counts(f"serve_chunked 32k ({impl})", launches,
                      {"flash_attention": LONG_LAYERS} if impl == "flash"
                      else {})
        peak = torch.cuda.max_memory_allocated()
        _, cut_ms = timed_prefill(model, cut, tokens)
        profile = profile_calls(
            f"serve_chunked_{impl}_32k", lambda: model.prefill(
                cut, tokens, logits_mode="last"), cut_ms, 1, "prefill")
        row = dict(chunk=chunk if impl != "flash" else None, ms=ms,
                   peak_bytes=peak, reckoned_peak_bytes=reckoned[impl],
                   launches=launches, cut_layers=LONG_PROFILE_LAYERS,
                   cut_first_ms=first_cut_ms, cut_ms=cut_ms,
                   profile=profile)
        if impl == "flash":
            flash_logits = logits
            last_logits_gap("serve_chunked 32k", logits, logits, cfg,
                            LONG_BATCH)
            (case,) = inputs.pop("flash_attention")
            one = tuple(t[:1].contiguous() if isinstance(t, torch.Tensor)
                        else t for t in case)
            del case
            row["b7_head0_vs_f64"] = check("flash_attention", one, errs)
            row["b7_shape"] = [cfg.num_heads * LONG_BATCH, LONG_SEQ, 128]
            del one
        else:
            gap = last_logits_gap("serve_chunked 32k", logits, flash_logits,
                                  cfg, LONG_BATCH)
            if not gap < FLASH_NAIVE_TOL:
                fail(f"serve_chunked: the 32k {impl} prefill's last logits "
                     f"differ from flash's by {gap:.3e} (limit "
                     f"{FLASH_NAIVE_TOL})")
            row["max_abs_diff_vs_flash"] = gap
        out[impl] = row
        del logits, inputs
        torch.cuda.empty_cache()
    del flash_logits, tokens
    return out


def phase_serve_chunked(cfg, params, tokens, naive_logits,
                        weight_bytes: int, bw, errs) -> None:
    """Phase serve's 4 x 4096 prefill under ``chunked`` (chunk 1024) and
    ``qchunk`` (2048), each held to the naive prefill's last logits at
    2e-3, a chunked without its causal mask refused; then the 1 x 32768
    prefill (``serve_long``)."""
    t0 = time.perf_counter()
    serve = impl_prefills(
        "serve_chunked", cfg, lambda m: timed_prefill(m, params, tokens),
        naive_logits, SERVE_BATCH, faults=(("chunked", "no_causal_mask"),))
    long = serve_long(cfg, params, weight_bytes, bw, errs)
    ADDED_S["serve_chunked"] = time.perf_counter() - t0
    emit("serve_chunked", arch=cfg.name, batch=SERVE_BATCH, seq=SERVE_SEQ,
         impls=serve, long=dict(batch=LONG_BATCH, seq=LONG_SEQ,
                                layers=LONG_LAYERS, impls=long),
         seconds=ADDED_S["serve_chunked"], card=smi_line())


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
        return timed_prefill(m, params, toks, mode)

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
    del flash_logits
    torch.cuda.empty_cache()
    phase_serve_chunked(cfg, params, tokens, naive_logits, 4 * n_params,
                        bw, errs)
    del naive_logits

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
    res, serve = generate_timed("serve", engine, prompts, SERVE_NEW)

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
    last, _ = prefill(flash, prompts)
    last = last[:, -1]
    serve.update(first_tokens_decided("serve", res.tokens, decoded[:, -1],
                                      last))
    step = statistics.median(step_ms[1:])
    held = [cache, SERVE_PROMPT]

    def one_step():        # decode further steps after the prompt
        _, held[0] = model.decode_step(params, prompts[:, :1], held[0],
                                       held[1])
        held[1] += 1

    serve.update(decode_steps=SERVE_PROMPT + SERVE_NEW,
                 decode_ms_per_step=step,
                 decode_tokens_per_s=SERVE_REQUESTS / (step / 1e3),
                 profile=profile_calls("serve_decode", one_step, step, 5,
                                       "decode_step"),
                 decode_vs_prefill_max_abs_err=decode_err)
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
# the MoE family: granite-moe-1b-a400m served and trained at its widths,
# mixtral-8x7b served at its widths with its sliding window
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"
MIXTRAL_ARCH = "mixtral-8x7b"
MIXTRAL_LAYERS = 2             # of 32: depth is the only cut
MIXTRAL_BATCH, MIXTRAL_SEQ = 2, 4608      # past the 4096-token window
MIXTRAL_REQUESTS = 2           # Engine.generate: 2 x (16 + 24) tokens
ONEHOT_SEQ = 2048              # onehot vs scatter on 1 x 2048 tokens
ONEHOT_REPS, ONEHOT_WINDOWS = 3, 3
TRAIN_MOE_LAYERS = 8           # of 24 (every layer alike): depth only


@contextlib.contextmanager
def routing(record=None, replay=None):
    """Inside the block every call of ``moe.route`` (one per MoE layer,
    in layer order) appends its (probs, top_e) to ``record``; with
    ``replay`` (top_e by call) the call's tokens go to the replayed
    experts instead, gated by this call's own probabilities of them,
    renormalised as the router renormalises. The check's wrapper, local
    to this script: the package routes as it always does."""
    from repro_torch.models import moe
    real = moe.route
    calls = [0]

    def wrapped(params, xt, cfg):
        probs, top_p, top_e = real(params, xt, cfg)
        if replay is not None:
            top_e = replay[calls[0]]
            top_p = probs.gather(-1, top_e)
            top_p = top_p / top_p.sum(-1, keepdim=True)
        calls[0] += 1
        if record is not None:
            record.append((probs, top_e))
        return probs, top_p, top_e

    moe.route = wrapped
    try:
        yield
    finally:
        moe.route = real


def routing_flips(ref, other, K: int) -> list:
    """By layer, between two runs over the same tokens (``ref``,
    ``other``: (probs, top_e) by layer, rows aligned): the tokens whose
    set of K experts differs, the largest router-probability difference
    between the runs, and how many flips are not near-ties. A flip is a
    near-tie when ``ref``'s K-th minus (K+1)-th probability of the token
    is at most twice the token's own largest probability difference
    between the runs: an expert can only overtake another when the two
    moved that far. Stricter than twice the layer's largest difference,
    which a token flipped in an earlier layer sets for all."""
    rows = []
    for (p, e), (q, f) in zip(ref, other):
        diff = (p - q).abs().amax(-1)
        flipped = (e.sort(-1).values != f.sort(-1).values).any(-1)
        top = p.topk(K + 1, dim=-1).values
        margin = top[:, K - 1] - top[:, K]
        n = int(flipped.sum())
        rows.append(dict(
            flips=n, not_near_tie=int((flipped & (margin > 2 * diff)).sum()),
            prob_max_abs_diff=float(diff.max()),
            flipped_max_margin=float(margin[flipped].max()) if n else None,
            flipped_max_margin_over_diff=float(
                (margin / diff)[flipped].max()) if n else None))
    return rows


def expect_near_ties(path: str, flips) -> None:
    bad = [(i, r) for i, r in enumerate(flips) if r["not_near_tie"]]
    if bad:
        fail(f"{path}: routing flips that are not near-ties, by layer: "
             f"{bad}")


def dropped_share(top_e, cfg) -> float:
    """Share of one layer's (token, k) pairs past their expert's
    capacity, from its routing: the queue positions and capacity as
    ``moe_forward`` counts them."""
    from repro_torch.models import moe
    oh = moe.one_hot(top_e.reshape(-1), cfg.moe.num_experts, torch.int64)
    pos = (torch.cumsum(oh, 0) * oh).sum(-1) - 1
    return float((pos >= moe.capacity(top_e.shape[0], cfg)).double().mean())


def dropless(cfg):
    """``cfg`` with capacity factor E / K: every queue holds every
    token."""
    import dataclasses
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def moe_decode_check(path: str, model, params, prompts) -> tuple:
    """The dropless ``model``'s decode over ``prompts``, token by token,
    against its own prefill at every position. The free-running decode
    is timed step by step and its routing held to the prefill's by the
    near-tie rule; the logits, with the prefill's routing replayed into
    each step, within DECODE_TOL (a near-tie flip moves a token's output
    by a gate's share of another expert's). Returns the report and the
    free decode's last logits."""
    B, S = prompts.shape
    pre = []
    full, _ = timed_prefill(model, params, prompts, "all", record=pre)
    cache = model.init_cache(B, S + 8)
    step_ms, free, logits = [], [], []
    for t in range(S):
        rec = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with routing(record=rec):
            lg, cache = model.decode_step(params, prompts[:, t:t + 1],
                                          cache, t)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        free.append(rec)
        logits.append(lg[:, 0])
    # a decode step's rows are the requests (b); the prefill's b * S + t
    dec = [tuple(torch.stack([free[t][layer][i] for t in range(S)], 1)
                 .reshape(B * S, -1) for i in (0, 1))
           for layer in range(len(pre))]
    flips = routing_flips(pre, dec, model.cfg.moe.top_k)
    expect_near_ties(f"{path} decode", flips)
    free_logits = torch.stack(logits, 1)
    cache = model.init_cache(B, S + 8)
    replayed = []
    for t in range(S):
        with routing(replay=[e.view(B, S, -1)[:, t] for _, e in pre]):
            lg, cache = model.decode_step(params, prompts[:, t:t + 1],
                                          cache, t)
        replayed.append(lg[:, 0])
    err = float((torch.stack(replayed, 1) - full).abs().max())
    if not err < DECODE_TOL:
        fail(f"{path}: decode and prefill logits differ by {err:.3e} with "
             f"the prefill's routing replayed (limit {DECODE_TOL})")
    report = dict(steps=S, decode_ms_per_step=statistics.median(step_ms[1:]),
                  decode_vs_prefill_max_abs_err=err,
                  free_decode_vs_prefill_max_abs_err=float(
                      (free_logits - full).abs().max()),
                  free_decode_flips=[r["flips"] for r in flips],
                  free_decode_prob_max_abs_diff=max(
                      r["prob_max_abs_diff"] for r in flips))
    return report, free_logits[:, -1]


def phase_serve_moe(bw: float, errs) -> dict:
    """granite-moe-1b-a400m at full width (24 layers, f32, seed 0) with
    ``moe_impl="scatter"``: ``Model.prefill`` of SERVE_BATCH x SERVE_SEQ
    tokens on the flash path (B7 once per layer, hd 64 padded to 128)
    and the naive path, flash vs naive with the flash path's routing
    replayed into the naive one, the free-running pair's routing flips
    held to the near-tie rule; B7 on layer 0's inputs against float64;
    the dropped share of (token, k) pairs by layer at the published
    capacity factor; ``Engine.generate`` with launch/serve.py's batch;
    decode vs prefill on the dropless copy. Then the lines
    ``serve_moe_onehot`` and ``serve_mixtral``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, moe
    from repro_torch.serving import Engine

    cfg = get_config(MOE_ARCH).with_(moe_impl="scatter")
    naive, flash = build_model(cfg), build_model(cfg.with_(attn_impl="flash"))
    gc.collect()
    reset_peak()
    t0 = time.perf_counter()
    params = naive.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ),
                           generator=gen, device="cuda")

    # the path: the flash prefill, its launches counted, layer 0's B7
    # inputs kept, each layer's routing recorded
    reset_peak()
    ops.reset_launch_counts()
    flash_route = []
    with capture_inputs(names=("flash_attention",), keep=1) as inputs:
        flash_logits, flash_first_ms = timed_prefill(
            flash, params, tokens, record=flash_route)
    launches = ops.launch_counts()
    flash_peak = torch.cuda.max_memory_allocated()
    expect_counts("serve_moe prefill (flash)", launches,
                  {"flash_attention": cfg.num_layers})
    flash_ms = [timed_prefill(flash, params, tokens)[1] for _ in range(2)]
    flash_profile = profile_calls(
        "serve_moe_prefill", lambda: flash.prefill(params, tokens,
                                                   logits_mode="last"),
        statistics.median(flash_ms), 1, "prefill")
    dropped = [dropped_share(e, cfg) for _, e in flash_route]
    # the queue cumsum on layer 0's routing as moe_forward lays it out
    # (experts first: the scan runs along the tokens) and tokens first
    tokens_first = moe.one_hot(flash_route[0][1].reshape(-1),
                               cfg.moe.num_experts, torch.int64)
    experts_first = tokens_first.T.contiguous()
    cumsum_ms = dict(
        experts_first=time_ms(lambda: torch.cumsum(experts_first, dim=-1)),
        tokens_first=time_ms(lambda: torch.cumsum(tokens_first, dim=0)))
    del tokens_first, experts_first

    # the naive path with the flash path's routing replayed, then free
    reset_peak()
    ops.reset_launch_counts()
    replayed_logits, naive_first_ms = timed_prefill(
        naive, params, tokens, replay=[e for _, e in flash_route])
    naive_peak = torch.cuda.max_memory_allocated()
    naive_route = []
    free_logits, naive_free_ms = timed_prefill(naive, params, tokens,
                                               record=naive_route)
    naive_ms = [naive_free_ms, timed_prefill(naive, params, tokens)[1]]
    expect_counts("serve_moe prefill (naive)", ops.launch_counts(), {})
    for name_, lg in (("flash", flash_logits), ("naive", free_logits)):
        if lg.shape != (SERVE_BATCH, 1, cfg.vocab_size) or not bool(
                torch.isfinite(lg).all()):
            fail(f"serve_moe: {name_} prefill logits {tuple(lg.shape)} are "
                 f"not finite last-position logits")
    flash_vs_naive = float((flash_logits - replayed_logits).abs().max())
    if not flash_vs_naive < FLASH_NAIVE_TOL:
        fail(f"serve_moe: flash and naive prefill logits differ by "
             f"{flash_vs_naive:.3e} with the routing replayed (limit "
             f"{FLASH_NAIVE_TOL})")
    flips = routing_flips(flash_route, naive_route, cfg.moe.top_k)
    expect_near_ties("serve_moe prefill", flips)
    free_diff = float((flash_logits - free_logits).abs().max())
    del flash_route, naive_route, flash_logits, replayed_logits, free_logits
    torch.cuda.empty_cache()

    # B7 on the path's own inputs: float64, faulty results, times; half
    # of each head's 128 lanes are the zero pad of hd 64
    (case,) = inputs["flash_attention"]
    row = b7_on_path(case, cfg, torch.float32, bw, errs)
    row["useful_share"] = cfg.resolved_head_dim / case[0].shape[-1]
    del case, inputs
    torch.cuda.empty_cache()

    # serving: launch/serve.py's batch; a decode step's capacity is
    # max(int(4 K / E cf), 4) = 4 = the requests, so it drops nothing
    engine = Engine(naive, params, max_len=SERVE_PROMPT + SERVE_NEW + 8)
    prompts = torch.randint(0, cfg.vocab_size,
                            (SERVE_REQUESTS, SERVE_PROMPT), generator=gen,
                            device="cuda")
    res, serve = generate_timed("serve_moe", engine, prompts, SERVE_NEW)
    lossless = dropless(cfg)
    decode, decoded_last = moe_decode_check(
        "serve_moe", build_model(lossless), params, prompts)
    last, _ = timed_prefill(build_model(lossless.with_(attn_impl="flash")),
                            params, prompts)
    serve.update(decode, **first_tokens_decided(
        "serve_moe", res.tokens, decoded_last, last[:, -1]))
    held = [naive.init_cache(SERVE_REQUESTS, engine.max_len), 0]

    def one_step():
        _, held[0] = naive.decode_step(params, prompts[:, :1], held[0],
                                       held[1])
        held[1] += 1

    serve["profile"] = profile_calls("serve_moe_decode", one_step,
                                     decode["decode_ms_per_step"], 5,
                                     "decode_step")
    del held
    emit("serve_moe", arch=cfg.name, moe_impl=cfg.moe_impl, params=n_params,
         weight_bytes=sum(p.numel() * p.element_size()
                          for p in params.parameters()), init_s=init_s,
         prefill=dict(batch=SERVE_BATCH, seq=SERVE_SEQ, launches=launches,
                      flash_ms=flash_ms, flash_first_ms=flash_first_ms,
                      naive_ms=naive_ms, naive_first_ms=naive_first_ms,
                      flash_peak_bytes=flash_peak, profile=flash_profile,
                      naive_peak_bytes=naive_peak,
                      flash_vs_naive_replayed_max_abs_diff=flash_vs_naive,
                      flash_vs_naive_free_max_abs_diff=free_diff,
                      routing_flips=[r["flips"] for r in flips],
                      routing_flips_by_layer=flips,
                      capacity_factor=cfg.moe.capacity_factor,
                      dropped_share_by_layer=dropped,
                      dropped_share=statistics.mean(dropped),
                      queue_cumsum_ms=cumsum_ms),
         flash_attention=row, serve=serve, card=smi_line())
    del engine, res, last, decoded_last
    torch.cuda.empty_cache()
    onehot = serve_moe_onehot(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mixtral = serve_mixtral()
    return dict(launches=launches, flash_attention=row, onehot=onehot,
                mixtral=mixtral)


def serve_moe_onehot(cfg, params) -> dict:
    """granite's two dispatches on 1 x ONEHOT_SEQ tokens (onehot's
    (T K, E, C) dispatch is 1.34 GB a layer here): each layer's
    ``moe_forward`` of both on the input the scatter prefill gave that
    layer, within KERNEL_TOL (1 + max|scatter|); both prefills, and the
    layer 0 call of each, timed, with its peak above what was
    allocated."""
    from repro_torch.models import build_model, moe

    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (1, ONEHOT_SEQ),
                           generator=gen, device="cuda")
    real = moe.moe_forward
    inputs = []

    def capture(p, x, c):
        inputs.append((p, x))
        return real(p, x, c)

    moe.moe_forward = capture
    try:
        build_model(cfg).prefill(params, tokens, logits_mode="last")
    finally:
        moe.moe_forward = real
    impls = {impl: cfg.with_(moe_impl=impl) for impl in ("scatter", "onehot")}
    diffs, aux_diffs = [], []
    with torch.no_grad():
        for p, x in inputs:
            (ys, auxs), (yo, auxo) = (real(p, x, c) for c in impls.values())
            scale = float(ys.abs().max())
            diff = float((yo - ys).abs().max())
            if not diff <= KERNEL_TOL * (1.0 + scale):
                fail(f"serve_moe_onehot: layer {len(diffs)}'s onehot and "
                     f"scatter outputs differ by {diff:.3e} (max "
                     f"{scale:.3e})")
            diffs.append(diff)
            aux_diffs.append(abs(float(auxo) - float(auxs)))
    out = dict(tokens=ONEHOT_SEQ, layers=len(inputs),
               max_abs_diff_by_layer=diffs, aux_abs_diff_by_layer=aux_diffs)
    p, x = inputs[0]
    for impl, c in impls.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            real(p, x, c)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        with torch.no_grad():
            layer_ms = time_ms(lambda: real(p, x, c), ONEHOT_REPS,
                               ONEHOT_WINDOWS)
        model = build_model(c)
        prefill_ms = [timed_prefill(model, params, tokens)[1]
                      for _ in range(3)]
        out[impl] = dict(layer0_ms=layer_ms, layer0_peak_extra_bytes=peak,
                         prefill_ms=prefill_ms)
    del inputs
    torch.cuda.empty_cache()
    emit("serve_moe_onehot", arch=cfg.name, **out, card=smi_line())
    return out


def serve_mixtral() -> dict:
    """mixtral-8x7b at its widths (f32, seed 0), cut to MIXTRAL_LAYERS
    layers: a naive prefill of MIXTRAL_BATCH x MIXTRAL_SEQ tokens (the
    4096-token window masks; with it, flash is never taken) with the
    reference's onehot dispatch, shown to differ from the same prefill
    without the window; ``Engine.generate`` of 2 x (16 + 24) tokens;
    decode vs prefill on the dropless copy, below the window. Launches
    none of B1-B7."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import Engine

    cfg = get_config(MIXTRAL_ARCH).with_(num_layers=MIXTRAL_LAYERS)
    model = build_model(cfg)
    gc.collect()
    reset_peak()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layer_params = sum(p.numel() for n, p in params.named_parameters()
                       if n.startswith("layers."))
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (MIXTRAL_BATCH, MIXTRAL_SEQ),
                           generator=gen, device="cuda")
    reset_peak()
    route = []
    logits, first_ms = timed_prefill(model, params, tokens, record=route)
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = [timed_prefill(model, params, tokens)[1] for _ in range(2)]
    dropped = [dropped_share(e, cfg) for _, e in route]
    replay = [e for _, e in route]
    del route
    if logits.shape != (MIXTRAL_BATCH, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail(f"serve_mixtral: prefill logits {tuple(logits.shape)} are not "
             f"finite last-position logits")
    unwindowed, _ = timed_prefill(
        build_model(cfg.with_(sliding_window=None)), params, tokens)
    window_effect = float((logits - unwindowed).abs().max())
    if not window_effect > 0.0:
        fail("serve_mixtral: the prefill past the window equals the one "
             "without it")
    del unwindowed
    # line serve_chunked_window: the loop impls with the window, the
    # naive prefill's routing replayed (a near-tie need not route alike)
    t0 = time.perf_counter()
    impls = impl_prefills(
        "serve_chunked_window", cfg,
        lambda m: timed_prefill(m, params, tokens, replay=replay), logits,
        MIXTRAL_BATCH, faults=(("qchunk", "window_mask_dropped"),))
    ADDED_S["serve_chunked_window"] = time.perf_counter() - t0
    emit("serve_chunked_window", arch=cfg.name, layers=cfg.num_layers,
         batch=MIXTRAL_BATCH, seq=MIXTRAL_SEQ, window=cfg.sliding_window,
         impls=impls, window_effect_max_abs_diff=window_effect,
         seconds=ADDED_S["serve_chunked_window"], card=smi_line())
    del logits, replay
    torch.cuda.empty_cache()
    engine = Engine(model, params, max_len=SERVE_PROMPT + SERVE_NEW + 8)
    prompts = torch.randint(0, cfg.vocab_size,
                            (MIXTRAL_REQUESTS, SERVE_PROMPT), generator=gen,
                            device="cuda")
    res, serve = generate_timed("serve_mixtral", engine, prompts, SERVE_NEW)
    lossless = build_model(dropless(cfg))
    decode, decoded_last = moe_decode_check("serve_mixtral", lossless,
                                            params, prompts)
    last, _ = timed_prefill(lossless, params, prompts)
    serve.update(decode, **first_tokens_decided(
        "serve_mixtral", res.tokens, decoded_last, last[:, -1]))
    launches = ops.launch_counts()
    expect_counts("serve_mixtral", launches, {})
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               layer_params=layer_params, params=n_params,
               weight_bytes=4 * n_params, init_s=init_s,
               moe_impl=cfg.moe_impl, window=cfg.sliding_window,
               prefill=dict(batch=MIXTRAL_BATCH, seq=MIXTRAL_SEQ,
                            ms=prefill_ms, first_ms=first_ms,
                            peak_bytes=peak,
                            capacity_factor=cfg.moe.capacity_factor,
                            dropped_share_by_layer=dropped,
                            window_effect_max_abs_diff=window_effect),
               serve=serve, launches=launches)
    emit("serve_mixtral", **out, card=smi_line())
    del params, engine, res, last, decoded_last
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_parts(model_cfg, params, N: int, batch: int, seq: int) -> dict:
    """ms of one MoE layer's parts under the train step's
    ``vmap(grad)``, each timed alone on N workers' N(0, 1) inputs of the
    step's token count and layer 0's weights (every worker's the same):
    the router (softmax and top-k), the whole ``moe_forward`` forward
    and forward + backward, and the three expert products alone on its
    (E, C, d) buffer; the dispatch (top-k, cumsum, dispatch and combine)
    is the whole less the experts. Times the layers."""
    import torch.nn.functional as F
    from repro_torch.models import moe
    L = model_cfg.num_layers
    d, E = model_cfg.d_model, model_cfg.moe.num_experts
    C = moe.capacity(batch * seq, model_cfg)
    lp = {k: v[0].expand((N,) + v.shape[1:])
          for k, v in params["layers"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn((N, batch, seq, d), generator=gen, device="cuda")
    buf = torch.randn((N, E, C, d), generator=gen, device="cuda")

    def whole(p, x):
        y, aux = moe.moe_forward(p, x, model_cfg)
        return y.sum() + aux

    def experts(p, h):
        g = F.silu(torch.einsum("ecd,edf->ecf", h, p["w_gate"]))
        g = g * torch.einsum("ecd,edf->ecf", h, p["w_up"])
        return torch.einsum("ecf,efd->ecd", g, p["w_down"]).sum()

    vm, grad = torch.func.vmap, torch.func.grad
    with torch.no_grad():
        route = time_ms(lambda: vm(lambda p, x: moe.route(
            p, x.reshape(-1, d), model_cfg))(lp, x), 5, 3)
        fwd = time_ms(lambda: vm(whole)(lp, x), 5, 3)
        exp_fwd = time_ms(lambda: vm(experts)(lp, buf), 5, 3)
    both = time_ms(lambda: vm(grad(whole, argnums=(0, 1)))(lp, x), 3, 3)
    exp_both = time_ms(lambda: vm(grad(experts, argnums=(0, 1)))(lp, buf),
                       3, 3)
    per_layer = dict(router=route, forward=fwd, forward_backward=both,
                     experts_forward=exp_fwd,
                     experts_forward_backward=exp_both,
                     dispatch_forward=fwd - exp_fwd,
                     dispatch_forward_backward=both - exp_both)
    return dict(capacity=C, per_layer_ms=per_layer,
                per_step_ms={k: L * v for k, v in per_layer.items()})


def phase_train_moe(bw: float, errs) -> dict:
    """``ADMMTrainer`` on granite-moe-1b-a400m's stacked tree at its
    widths, cut to TRAIN_MOE_LAYERS layers (f32, seed 0, the reference's
    onehot dispatch), N = 2, M = 2 by LPT, launch/train.py's defaults,
    ``TokenPipeline`` batches of 2 x 512 tokens a worker, 5 steps on the
    kernels. Before each, the plain backend's step from the same state
    (routing follows z, so two free-running trajectories part at a
    token's first flip): z within KERNEL_TOL. Gates: step 0's loss is
    ``Model.loss`` at z0 (aux in); the loss and gradient taken twice
    from one state are bitwise equal; B1 and B2 once a step and held on
    their inputs; pads 0; losses and z finite. Prints step ms, tokens/s,
    peaks beside a reckoning, and a device split of the step."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models import moe
    from repro_torch.models.weights import stacked_params
    from repro_torch.training import ADMMTrainer

    N, M = TRAIN_WORKERS, TRAIN_BLOCKS
    model_cfg = get_config(MOE_ARCH).with_(num_layers=TRAIN_MOE_LAYERS)
    model = build_model(model_cfg)
    gc.collect()
    reset_peak()
    params = stacked_params(model_cfg, 0, "cuda")
    pipe = TokenPipeline(vocab_size=model_cfg.vocab_size,
                         seq_len=TRAIN_SEQ + 1,
                         global_batch=N * TRAIN_BATCH, seed=0)
    batches = [pipe.batch(t, num_workers=N, device="cuda")
               for t in range(TRAIN_STEPS + 1)]
    tokens = N * TRAIN_BATCH * TRAIN_SEQ
    P = sum(int(t.numel()) for t in tree_leaves(params))

    def trainer(backend):
        return ADMMTrainer(loss_fn=model.loss,
                           admm=train_config(backend=backend),
                           num_workers=N, device="cuda")

    kern, plain = trainer("auto"), trainer("torch")
    spec = kern._spec(params)
    layout = spec.space.layout
    if spec.space.backend != "cuda":
        fail(f"train_moe: 'auto' resolved to {spec.space.backend!r} on the "
             f"card")
    T = M * layout.block_dim
    m = model_cfg.moe
    C = moe.capacity(TRAIN_BATCH * TRAIN_SEQ, model_cfg)
    disp_bytes = 4 * TRAIN_BATCH * TRAIN_SEQ * m.top_k * m.num_experts * C
    reckoned = (4 * (2 * T + 6 * N * T + N * P + P)
                + N * model_cfg.num_layers * disp_bytes
                + 4 * N * (3 * TRAIN_BATCH * TRAIN_SEQ + model_cfg.d_model)
                * model_cfg.vocab_size)
    emit("train_moe_plan", arch=model_cfg.name, layers=TRAIN_MOE_LAYERS,
         params=P, block_sizes=list(layout.block_sizes),
         dblk=layout.block_dim, padding=T - P, capacity=C,
         dispatch_bytes_per_layer_per_worker=disp_bytes,
         reckoned_peak_bytes=reckoned)
    loss0 = direct_loss(model, params, batches[0], N)
    state = kern.init(params)
    del params

    # the loss and gradient taken twice from one state: bitwise
    space = spec.space
    z_tilde = space.gather(kern._packed(spec, state).z_hist,
                           torch.ones((N, M), dtype=torch.int64,
                                      device="cuda"))
    first = space.worker_grads(model.loss, z_tilde, batches[0])
    second = space.worker_grads(model.loss, z_tilde, batches[0])
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail("train_moe: the loss and gradient taken twice from one state "
             "differ")
    del z_tilde, first, second
    torch.cuda.empty_cache()

    times, plain_times, losses, plain_losses, peaks, diffs = \
        [], [], [], [], [], []
    launches = {k: 0 for k in PLAIN}
    for t in range(TRAIN_STEPS):
        # the plain step from the kernel path's state before this step,
        # its z to the host while the kernel step runs
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_state, p_info = plain.train_step(state, batches[t])
        torch.cuda.synchronize()
        plain_times.append(1e3 * (time.perf_counter() - t0))
        if any(ops.launch_counts().values()):
            fail("train_moe: the torch backend launched a kernel")
        plain_losses.append(float(p_info["loss"]))
        z_plain = plain._packed(plain._spec(p_state.params),
                                p_state).z_hist[0].cpu()
        del p_state, p_info
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, info = kern.train_step(state, batches[t])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        peaks.append(torch.cuda.max_memory_allocated())
        step_launches = ops.launch_counts()
        expect_launches(f"train_moe step {t}", step_launches, 1,
                        MAIN_KERNELS)
        for k, n in step_launches.items():
            launches[k] += n
        losses.append(float(info["loss"]))
        packed = kern._packed(kern._spec(state.params), state)
        if not pads_zero(layout, packed.z_hist, packed.y, packed.w_cache):
            fail(f"train_moe: a pad lane is not 0 after step {t}")
        if not math.isfinite(losses[-1]) or not bool(
                torch.isfinite(packed.z_hist[0]).all()):
            fail(f"train_moe: loss or z not finite at step {t}")
        diffs.append(compare(packed.z_hist[0], z_plain.cuda()))
        del packed, z_plain
    loss_rel = same_loss("train_moe", losses[0], loss0)
    step_ms = statistics.median(times[1:])
    errs["server_prox_update"] = max(errs["server_prox_update"], max(diffs))

    held = [state]
    del state

    def step():
        held[0], _ = kern.train_step(held[0], batches[TRAIN_STEPS])

    profile = profile_calls("train_moe", step, step_ms, TRAIN_PROFILE_STEPS,
                            expect={B1_NAME: 1, B2_NAME: 1})
    split = train_split(model, spec, kern._packed(spec, held[0]),
                        batches[TRAIN_STEPS], profile, step_ms)
    parts = moe_parts(model_cfg, held[0].params, N, TRAIN_BATCH, TRAIN_SEQ)
    with capture_inputs(copy=False, names=MAIN_KERNELS, keep=1) as inputs:
        step()
    del held[0]
    torch.cuda.empty_cache()
    rows = check_on_path("train_moe", inputs, MAIN_KERNELS, bw, errs)
    del batches
    torch.cuda.empty_cache()

    kernels = b1_b2_rows(rows, profile)
    emit("train_moe", arch=model_cfg.name, layers=TRAIN_MOE_LAYERS, N=N, M=M,
         params=P, block_sizes=list(layout.block_sizes),
         dblk=layout.block_dim, padding=T - P, steps=TRAIN_STEPS,
         tokens_per_step=tokens, launches=launches, losses=losses,
         torch_losses_from_kernel_states=plain_losses, loss0_direct=loss0,
         loss0_rel_diff=loss_rel, step_ms=times, step_ms_median=step_ms,
         tokens_per_s=tokens / step_ms * 1e3, torch_step_ms=plain_times,
         torch_step_ms_median=statistics.median(plain_times[1:]),
         peak_bytes=max(peaks), peak_bytes_by_step=peaks,
         reckoned_peak_bytes=reckoned, z_max_abs_diff_vs_torch=diffs,
         grads_twice_bitwise=True, pads_zero=True,
         device_ms_per_step=split, moe_parts=parts, profile=profile,
         kernels=kernels, card=smi_line())
    return launches


# ---------------------------------------------------------------------------
# the SSM and hybrid families: mamba2-370m served and trained at full
# width and depth, zamba2-1.2b served at full width with its shared
# attention block through B7
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "zamba2-1.2b"
TRAIN_SSM_PEAK_LIMIT = 72e9    # the reckoned peak a train phase may reach
B7_F32_NAME = "flash_tf32_kernel"   # B7's float32 design
SSD_LIVE = 3                   # decay-sized tensors live at once in a
                               # prefill's SSD (masked exponent, decay,
                               # decay x scores)


def ssd_decay_bytes(cfg, batch: int, seq: int) -> int:
    """Bytes of one layer's (b, c, h, Q, Q) float32 decay in the chunked
    SSD scan at ``batch`` x ``seq`` tokens."""
    from repro_torch.models import ssm
    Q = min(cfg.ssm.chunk_size, seq)
    chunks = -(-seq // Q)
    return 4 * batch * chunks * ssm._dims(cfg)[1] * Q * Q


def stage_clock():
    """(seconds by stage, mark): ``mark(name)`` books the host seconds
    since the previous mark under ``name``."""
    last, out = [time.perf_counter()], {}

    def mark(name: str) -> None:
        now = time.perf_counter()
        out[name] = now - last[0]
        last[0] = now

    return out, mark


def cache_bytes(model, batch: int, max_len: int) -> dict:
    """The decode cache's bytes by part (``init_cache``'s tensors; a part
    is a dict of them, or one tensor, as enc-dec's ``cross_k``)."""
    cache = model.init_cache(batch, max_len)
    out = {part: sum(t.numel() * t.element_size() for t in (
        d.values() if isinstance(d, dict) else [d]))
           for part, d in cache.items()}
    del cache
    return out


def filled_cache(model, params, batch: int, max_len: int, enc_frames=None):
    """A decode cache; an enc-dec arch's cross K/V filled by its
    ``Engine`` from ``enc_frames`` (the encoder under the model's
    ``attn_impl``)."""
    from repro_torch.serving import Engine
    cache = model.init_cache(batch, max_len)
    if enc_frames is not None:
        cache = Engine(model, params, max_len)._fill_cross_attn(cache,
                                                                enc_frames)
    return cache


def decode_vs_prefill(path: str, model, params, prompts,
                      enc_frames=None) -> dict:
    """``decode_step`` over ``prompts`` token by token, timed step by
    step (no kernel launched), against the prefill's logits at every
    position (within DECODE_TOL); an enc-dec arch's cross K/V and
    prefill from ``enc_frames`` under the same ``attn_impl``. Returns
    the report and the decode's last logits."""
    from repro_torch.kernels import ops
    B, S = prompts.shape
    cache = filled_cache(model, params, B, S + 8, enc_frames)
    ops.reset_launch_counts()
    step_ms, steps = [], []
    for t in range(S):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, prompts[:, t:t + 1], cache, t)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        steps.append(lg[:, 0])
    expect_counts(f"{path} decode steps", ops.launch_counts(), {})
    decoded = torch.stack(steps, dim=1)
    full, _ = timed_prefill(model, params, prompts, "all", enc_frames)
    err = float((decoded - full).abs().max())
    if not err < DECODE_TOL:
        fail(f"{path}: decode and prefill logits differ by {err:.3e} "
             f"(limit {DECODE_TOL})")
    step = statistics.median(step_ms[1:])
    return dict(decode_ms_per_step=step,
                decode_tokens_per_s=B / (step / 1e3),
                decode_vs_prefill_max_abs_err=err), decoded[:, -1]


def decode_profile(path: str, model, params, prompts, max_len: int,
                   step_ms: float, enc_frames=None) -> dict:
    """The profiler over 3 decode steps past the prompt: the device's
    idle share of a step."""
    held = [filled_cache(model, params, prompts.shape[0], max_len,
                         enc_frames), prompts.shape[1]]

    def one_step():
        _, held[0] = model.decode_step(params, prompts[:, :1], held[0],
                                       held[1])
        held[1] += 1

    return profile_calls(path, one_step, step_ms, 3, "decode_step")


def serve_common(path: str, model, params, gen, prompts=None,
                 enc_frames=None, generate_launches=None) -> tuple:
    """``Engine.generate`` with launch/serve.py's batch (no kernel unless
    ``generate_launches`` says, as an enc-dec encoder's under flash), the
    decode against the prefill at every prompt position, first tokens
    the prefill's argmax where decided, a decode profile, and the decode
    cache's bytes at max_len 64 and 4096. An enc-dec arch's encoder runs
    over ``enc_frames`` in each."""
    from repro_torch.serving import Engine
    cfg = model.cfg
    engine = Engine(model, params, max_len=SERVE_PROMPT + SERVE_NEW + 8)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size,
                                (SERVE_REQUESTS, SERVE_PROMPT),
                                generator=gen, device="cuda")
    stages, mark = stage_clock()
    res, serve = generate_timed(path, engine, prompts, SERVE_NEW, enc_frames,
                                generate_launches)
    mark("generate")
    decode, decoded_last = decode_vs_prefill(path, model, params, prompts,
                                             enc_frames)
    last, _ = timed_prefill(model, params, prompts, enc_frames=enc_frames)
    serve.update(decode, **first_tokens_decided(path, res.tokens,
                                                decoded_last, last[:, -1]))
    mark("decode_vs_prefill")
    serve["profile"] = decode_profile(f"{path}_decode", model, params,
                                      prompts, engine.max_len,
                                      decode["decode_ms_per_step"],
                                      enc_frames)
    mark("decode_profile")
    serve["cache_bytes"] = {n: cache_bytes(model, SERVE_REQUESTS, n)
                            for n in (64, 4096)}
    serve["seconds_by_stage"] = stages
    return serve


def phase_serve_ssm(bw: float, errs) -> dict:
    """mamba2-370m in full (48 layers, d_model 1024, f32, seed 0): the
    SERVE_BATCH x SERVE_SEQ prefill through the chunked SSD (no kernel),
    timed and profiled, its peak beside the weights and the SSD's
    reckoned transients, the cumsum along the chunk in both layouts;
    ``Engine.generate`` with launch/serve.py's batch; decode against
    prefill at every prompt position; first tokens decided; the decode
    cache's bytes the same at max_len 64 and 4096 (a constant state)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    stages, mark = stage_clock()
    cfg = get_config(SSM_ARCH)
    model = build_model(cfg)
    gc.collect()
    reset_peak()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ),
                           generator=gen, device="cuda")
    reset_peak()
    ops.reset_launch_counts()
    logits, first_ms = timed_prefill(model, params, tokens)
    launches = ops.launch_counts()
    expect_counts("serve_ssm prefill", launches, {})
    peak = torch.cuda.max_memory_allocated()
    if logits.shape != (SERVE_BATCH, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail(f"serve_ssm: prefill logits {tuple(logits.shape)} are not "
             f"finite last-position logits")
    prefill_ms = [timed_prefill(model, params, tokens)[1] for _ in range(2)]
    mark("prefills")
    profile = profile_calls(
        "serve_ssm_prefill", lambda: model.prefill(params, tokens,
                                                   logits_mode="last"),
        statistics.median(prefill_ms), 1, "prefill")
    mark("prefill_profile")
    # the cumsum of one layer's dA along the chunk, as ssd_chunked lays
    # it out (heads outside: the innermost axis) and as the reference's
    # (b, c, Q, h) lays it (a non-innermost axis)
    from repro_torch.models import ssm
    Q, h = cfg.ssm.chunk_size, ssm._dims(cfg)[1]
    dA = -torch.rand((SERVE_BATCH, SERVE_SEQ // Q, Q, h), generator=gen,
                     device="cuda")
    heads_outer = dA.transpose(2, 3).contiguous()
    cumsum_ms = dict(
        heads_outer=time_ms(lambda: torch.cumsum(heads_outer, dim=-1)),
        positions_outer=time_ms(lambda: torch.cumsum(dA, dim=2)))
    del dA, heads_outer, logits
    torch.cuda.empty_cache()
    mark("cumsum")
    serve = serve_common("serve_ssm", model, params, gen)
    mark("serve")
    if serve["cache_bytes"][64] != serve["cache_bytes"][4096]:
        fail(f"serve_ssm: the decode cache grows with max_len: "
             f"{serve['cache_bytes']}")
    decay = ssd_decay_bytes(cfg, SERVE_BATCH, SERVE_SEQ)
    emit("serve_ssm", arch=cfg.name, layers=cfg.num_layers, params=n_params,
         weight_bytes=weight_bytes, init_s=init_s,
         prefill=dict(batch=SERVE_BATCH, seq=SERVE_SEQ, launches=launches,
                      ms=prefill_ms, first_ms=first_ms, peak_bytes=peak,
                      peak_over_weights_bytes=peak - weight_bytes,
                      ssd_decay_bytes_per_layer=decay,
                      ssd_transient_bytes_reckoned=SSD_LIVE * decay,
                      tokens_per_s=SERVE_BATCH * SERVE_SEQ
                      / statistics.median(prefill_ms) * 1e3,
                      profile=profile, cumsum_ms=cumsum_ms),
         serve=serve, seconds_by_stage=stages, card=smi_line())
    del params, model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches)


def phase_serve_hybrid(bw: float, errs) -> dict:
    """zamba2-1.2b in full (38 layers, d_model 2048, 32 heads of 64, the
    shared attention block after every 6 SSM layers; f32, seed 0): the
    SERVE_BATCH x SERVE_SEQ prefill on the flash path, where B7 launches
    once per application of the shared block (38 // 6 = 6), each
    launch's inputs held to float64 by B5's rule, layer 0's also timed
    beside its plain version and SDPA and its gate shown to refuse
    faulty results (``b7_on_path``); the naive path (no kernel), flash
    against naive; ``Engine.generate`` with launch/serve.py's batch (B7
    never in decode); decode against prefill at every prompt
    position."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    stages, mark = stage_clock()
    cfg = get_config(HYBRID_ARCH)
    naive, flash = build_model(cfg), build_model(cfg.with_(attn_impl="flash"))
    applications = cfg.num_layers // cfg.hybrid_attn_every
    gc.collect()
    reset_peak()
    t0 = time.perf_counter()
    params = naive.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ),
                           generator=gen, device="cuda")

    reset_peak()
    ops.reset_launch_counts()
    with capture_inputs(names=("flash_attention",)) as inputs:
        flash_logits, flash_first_ms = timed_prefill(flash, params, tokens)
    launches = ops.launch_counts()
    flash_peak = torch.cuda.max_memory_allocated()
    expect_counts("serve_hybrid prefill (flash)", launches,
                  {"flash_attention": applications})
    flash_ms = [timed_prefill(flash, params, tokens)[1] for _ in range(2)]
    mark("flash_prefills")
    flash_profile = profile_calls(
        "serve_hybrid_prefill", lambda: flash.prefill(params, tokens,
                                                      logits_mode="last"),
        statistics.median(flash_ms), 1, "prefill",
        expect={B7_F32_NAME: applications}, warmups=(0, 1, 2))
    mark("flash_profile")
    reset_peak()
    ops.reset_launch_counts()
    naive_logits, naive_first_ms = timed_prefill(naive, params, tokens)
    expect_counts("serve_hybrid prefill (naive)", ops.launch_counts(), {})
    naive_peak = torch.cuda.max_memory_allocated()
    naive_ms = [timed_prefill(naive, params, tokens)[1] for _ in range(2)]
    mark("naive_prefills")
    for name_, lg in (("flash", flash_logits), ("naive", naive_logits)):
        if lg.shape != (SERVE_BATCH, 1, cfg.vocab_size) or not bool(
                torch.isfinite(lg).all()):
            fail(f"serve_hybrid: {name_} prefill logits {tuple(lg.shape)} "
                 f"are not finite last-position logits")
    flash_vs_naive = float((flash_logits - naive_logits).abs().max())
    if not flash_vs_naive < FLASH_NAIVE_TOL:
        fail(f"serve_hybrid: flash and naive prefill logits differ by "
             f"{flash_vs_naive:.3e} (limit {FLASH_NAIVE_TOL})")
    del flash_logits, naive_logits
    torch.cuda.empty_cache()

    # every launch's inputs held to float64; the first's timed and its
    # gate shown to refuse faulty results; half of each head's 128 lanes
    # are the zero pad of hd 64
    cases = inputs.pop("flash_attention")
    own = {"flash_attention": 0.0}
    held = [check("flash_attention", case, own) for case in cases[1:]]
    mark("b7_held")
    row = b7_on_path(cases[0], cfg, torch.float32, bw, own)
    mark("b7_timed")
    row["useful_share"] = cfg.resolved_head_dim / cases[0][0].shape[-1]
    row["launches_held"] = len(cases)
    row["err_vs_f64_by_launch"] = [row["err_vs_f64"]] + [
        r["err_vs_f64"] for r in held]
    errs["flash_attention"] = max(errs["flash_attention"],
                                  own["flash_attention"])
    errs["flash_attention_hybrid"] = own["flash_attention"]
    del cases, held, inputs
    torch.cuda.empty_cache()

    serve = serve_common("serve_hybrid", naive, params, gen)
    mark("serve")
    ssm_state = {n: c["layers"] for n, c in serve["cache_bytes"].items()}
    if ssm_state[64] != ssm_state[4096]:
        fail(f"serve_hybrid: the SSM layers' decode state grows with "
             f"max_len: {ssm_state}")
    decay = ssd_decay_bytes(cfg, SERVE_BATCH, SERVE_SEQ)
    emit("serve_hybrid", arch=cfg.name, layers=cfg.num_layers,
         shared_block_applications=applications, params=n_params,
         weight_bytes=weight_bytes, init_s=init_s,
         prefill=dict(batch=SERVE_BATCH, seq=SERVE_SEQ, launches=launches,
                      flash_ms=flash_ms, flash_first_ms=flash_first_ms,
                      naive_ms=naive_ms, naive_first_ms=naive_first_ms,
                      flash_peak_bytes=flash_peak,
                      naive_peak_bytes=naive_peak,
                      ssd_decay_bytes_per_layer=decay,
                      ssd_transient_bytes_reckoned=SSD_LIVE * decay,
                      flash_vs_naive_max_abs_diff=flash_vs_naive,
                      profile=flash_profile),
         flash_attention=row, serve=serve, seconds_by_stage=stages,
         card=smi_line())
    del params, naive, flash, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches={"flash_attention_hybrid":
                          launches["flash_attention"]},
                rows={"flash_attention_hybrid": row})


# ---------------------------------------------------------------------------
# the MLA and enc-dec families: minicpm3-4b and whisper-medium in full
# ---------------------------------------------------------------------------

MLA_ARCH = "minicpm3-4b"
ENC_DEC_ARCH = "whisper-medium"
ENC_DEC_SEQ = 448              # whisper's decoder context: openai/whisper-
                               # medium's max_target_positions
SERVE_PEAK_LIMIT = 72e9        # the reckoned peak a serve phase may reach


def mla_prefill_reckoning(cfg, weight_bytes: int, batch: int,
                          seq: int) -> dict:
    """The peak of MLA's prefill at batch x seq: the weights, two (batch,
    heads, seq, seq) float32 score tensors live at once (the scores, and
    the softmax's output; the second product is added in place, so it
    is the second at its moment), and the MLP's three (batch, seq, d_ff)
    tensors."""
    scores = 4 * batch * cfg.num_heads * seq * seq
    mlp = 3 * 4 * batch * seq * cfg.d_ff
    return dict(batch=batch, weight_bytes=weight_bytes,
                score_bytes_per_tensor=scores, mlp_bytes=mlp,
                reckoned_peak_bytes=weight_bytes + 2 * scores + mlp)


def phase_serve_mla(bw: float, errs) -> dict:
    """minicpm3-4b in full (62 layers, d_model 2560, 40 heads, q rank
    768, kv rank 256, d_ff 6400; f32, seed 0): the SERVE_BATCH x
    SERVE_SEQ prefill (MLA materializes its (B, 40, S, S) scores as the
    reference does: no kernel), its peak beside the reckoning (which
    must stay under SERVE_PEAK_LIMIT), timed and profiled; the same prefill under ``attn_impl="flash"``: no launch,
    logits bitwise the naive ones; ``Engine.generate`` with
    launch/serve.py's batch through the absorbed decode over the latent
    cache; decode against prefill at every prompt position; first tokens
    decided; the latent cache's bytes at max_len 64 and 4096, 62 x B x
    max_len x (256 + 32) x 4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    stages, mark = stage_clock()
    cfg = get_config(MLA_ARCH)
    naive, flash = build_model(cfg), build_model(cfg.with_(attn_impl="flash"))
    gc.collect()
    reset_peak()
    t0 = time.perf_counter()
    params = naive.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    batch = SERVE_BATCH
    reckoning = mla_prefill_reckoning(cfg, weight_bytes, batch, SERVE_SEQ)
    if reckoning["reckoned_peak_bytes"] > SERVE_PEAK_LIMIT:
        fail(f"serve_mla: the prefill's reckoned peak {reckoning} passes "
             f"{SERVE_PEAK_LIMIT:.0f} B")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (batch, SERVE_SEQ),
                           generator=gen, device="cuda")
    mark("init")
    reset_peak()
    ops.reset_launch_counts()
    logits, first_ms = timed_prefill(naive, params, tokens)
    launches = ops.launch_counts()
    expect_counts("serve_mla prefill", launches, {})
    peak = torch.cuda.max_memory_allocated()
    if logits.shape != (batch, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail(f"serve_mla: prefill logits {tuple(logits.shape)} are not "
             f"finite last-position logits")
    prefill_ms = [timed_prefill(naive, params, tokens)[1] for _ in range(2)]
    mark("prefills")
    ops.reset_launch_counts()
    flash_logits, flash_ms = timed_prefill(flash, params, tokens)
    expect_counts("serve_mla prefill (flash)", ops.launch_counts(), {})
    if not bitwise(flash_logits, logits):
        fail(f"serve_mla: the flash prefill's logits are not the naive "
             f"ones bit for bit (max|diff| "
             f"{float((flash_logits - logits).abs().max()):.3e})")
    del flash_logits, logits
    mark("flash_prefill")
    profile = profile_calls(
        "serve_mla_prefill", lambda: naive.prefill(params, tokens,
                                                   logits_mode="last"),
        statistics.median(prefill_ms), 1, "prefill")
    del tokens
    torch.cuda.empty_cache()
    mark("prefill_profile")
    serve = serve_common("serve_mla", naive, params, gen)
    mark("serve")
    m = cfg.mla
    latent = {n: {"layers": cfg.num_layers * SERVE_REQUESTS * n * 4
                  * (m.kv_lora_rank + m.qk_rope_head_dim)} for n in (64, 4096)}
    if serve["cache_bytes"] != latent:
        fail(f"serve_mla: latent cache bytes {serve['cache_bytes']}, "
             f"expected {latent}")
    emit("serve_mla", arch=cfg.name, layers=cfg.num_layers, params=n_params,
         weight_bytes=weight_bytes, init_s=init_s,
         prefill=dict(batch=batch, seq=SERVE_SEQ, launches=launches,
                      ms=prefill_ms, first_ms=first_ms, flash_ms=flash_ms,
                      flash_bitwise_naive=True, peak_bytes=peak,
                      reckoning=reckoning,
                      tokens_per_s=batch * SERVE_SEQ
                      / statistics.median(prefill_ms) * 1e3,
                      profile=profile),
         serve=serve, seconds_by_stage=stages, card=smi_line())
    del params, naive, flash
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches)


@contextlib.contextmanager
def b7_plain():
    """Inside the block, B7's wrapper runs its plain version (a wrapper
    local to this script; no launch counted): the path as it runs, with
    the kernel replaced."""
    from repro_torch.kernels import flash_attention as fa
    real = fa.flash_attention_cuda

    def plain(q, k, v, causal=True, scale=None):
        return fa.flash_attention_torch(q, k, v, causal, scale)

    fa.flash_attention_cuda = plain
    try:
        yield
    finally:
        fa.flash_attention_cuda = real


def b7_launch_row(path: str, case, cfg, real_seq: int, bw, own,
                  **shape) -> dict:
    """``b7_on_path`` on one launch's inputs, with its device time per
    launch (``kernel_device_ms``) and the share of its work that is not
    padding: hd over the padded hd, times the needed (query, key) pairs
    of ``real_seq`` over those of the padded length."""
    row = b7_on_path(case, cfg, torch.float32, bw, own, **shape)
    fa = kernel_module("flash_attention")
    row.update(kernel_device_ms(path, B7_F32_NAME,
                                lambda: fa.flash_attention_cuda(*case),
                                row["ms"]))
    q, k, _, causal = case[:4]
    row["useful_share"] = (cfg.resolved_head_dim / q.shape[-1]
                           * attention_pairs(real_seq, real_seq, causal)
                           / attention_pairs(q.shape[1], k.shape[1], causal))
    return row


def phase_serve_encdec(bw: float, errs) -> dict:
    """whisper-medium in full (24 encoder + 24 decoder layers, d_model
    1024, 16 heads of 64, gelu MLP of 4096; f32, seed 0), frames of 4 x
    1500 x 1024 drawn as launch/serve.py draws them: the 4 x ENC_DEC_SEQ
    prefill on the flash path, where B7 launches 48 times (24 in the
    encoder, bidirectional, at (64, 1536, 128), then 24 causal in the
    decoder at (64, 512, 128); hd 64 and S padded to 128), every
    launch's inputs held to float64 by B5's rule, the first of each kind
    timed beside its plain version and SDPA (on the same padded,
    unmasked inputs) with its gate shown to refuse faulty results and
    its device time per launch; the flash prefill against the same path
    with B7's plain version (2e-3); the naive path (no kernel) and the
    flash-naive gap, ROADMAP Queue C item 3 (the 36 zero keys of the pad
    enter every encoder row's softmax); the encoder alone
    (``Engine._fill_cross_attn``) timed; ``Engine.generate`` with
    launch/serve.py's batch on the flash path (B7 24 times, in the
    encoder, and never in decode); decode against prefill at every
    prompt position under flash on both sides; the cross cache's bytes,
    the same at max_len 64 and 4096."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import Engine

    stages, mark = stage_clock()
    cfg = get_config(ENC_DEC_ARCH)
    naive, flash = build_model(cfg), build_model(cfg.with_(attn_impl="flash"))
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    gc.collect()
    reset_peak()
    t0 = time.perf_counter()
    params = naive.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    rng = np.random.RandomState(0)            # launch/serve.py at seed 0
    prompts = torch.as_tensor(rng.randint(
        0, cfg.vocab_size, size=(SERVE_REQUESTS, SERVE_PROMPT)),
        device="cuda")
    frames = (torch.as_tensor(rng.randn(SERVE_REQUESTS, cfg.encoder_seq_len,
                                        cfg.d_model), dtype=torch.float32)
              * 0.1).cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS, ENC_DEC_SEQ),
                           generator=gen, device="cuda")

    def prefill(model, **kw):
        return timed_prefill(model, params, tokens, enc_frames=frames, **kw)

    reset_peak()
    ops.reset_launch_counts()
    with capture_inputs(names=("flash_attention",)) as inputs:
        flash_logits, flash_first_ms = prefill(flash)
    launches = ops.launch_counts()
    flash_peak = torch.cuda.max_memory_allocated()
    expect_counts("serve_encdec prefill (flash)", launches,
                  {"flash_attention": n_enc + n_dec})
    flash_ms = [prefill(flash)[1] for _ in range(2)]
    mark("flash_prefills")
    flash_profile = profile_calls(
        "serve_encdec_prefill", lambda: flash.prefill(
            params, tokens, logits_mode="last", enc_frames=frames),
        statistics.median(flash_ms), 1, "prefill",
        expect={B7_F32_NAME: n_enc + n_dec}, warmups=(0, 1, 2))
    mark("flash_profile")
    with b7_plain():
        plain_logits, plain_ms = prefill(flash)
    flash_vs_plain = float((flash_logits - plain_logits).abs().max())
    if not flash_vs_plain < FLASH_NAIVE_TOL:
        fail(f"serve_encdec: the flash prefill and the same path with B7's "
             f"plain version differ by {flash_vs_plain:.3e} (limit "
             f"{FLASH_NAIVE_TOL})")
    del plain_logits
    reset_peak()
    ops.reset_launch_counts()
    naive_logits, naive_first_ms = prefill(naive)
    expect_counts("serve_encdec prefill (naive)", ops.launch_counts(), {})
    naive_peak = torch.cuda.max_memory_allocated()
    naive_ms = [prefill(naive)[1] for _ in range(2)]
    mark("naive_prefills")
    for name_, lg in (("flash", flash_logits), ("naive", naive_logits)):
        if lg.shape != (SERVE_REQUESTS, 1, cfg.vocab_size) or not bool(
                torch.isfinite(lg).all()):
            fail(f"serve_encdec: {name_} prefill logits {tuple(lg.shape)} "
                 f"are not finite last-position logits")
    # ROADMAP Queue C item 3: not gated, its size printed
    gap = float((flash_logits - naive_logits).abs().max())
    gap_rel = gap / float(naive_logits.abs().max())
    del flash_logits
    # line serve_chunked_encdec: chunked masks the keys that pad the
    # 1500 frames to 2048, so it computes naive's function
    t0 = time.perf_counter()
    impls = impl_prefills("serve_chunked_encdec", cfg, prefill, naive_logits,
                          SERVE_REQUESTS,
                          faults=(("chunked", "pad_keys_unmasked"),))
    ADDED_S["serve_chunked_encdec"] = time.perf_counter() - t0
    emit("serve_chunked_encdec", arch=cfg.name, frames=list(frames.shape),
         batch=SERVE_REQUESTS, seq=ENC_DEC_SEQ, impls=impls,
         flash_vs_naive_max_abs_diff=gap,
         seconds=ADDED_S["serve_chunked_encdec"], card=smi_line())
    del naive_logits
    mark("chunked_prefills")
    torch.cuda.empty_cache()

    # every launch held to float64: the encoder's 24 first
    # (bidirectional), then the decoder's 24 (causal)
    cases = inputs.pop("flash_attention")
    if [c[3] for c in cases] != [False] * n_enc + [True] * n_dec:
        fail(f"serve_encdec: B7's causal flags by launch "
             f"{[c[3] for c in cases]}")
    rows = {}
    for kind, part, real, shape in (
            ("enc", cases[:n_enc], cfg.encoder_seq_len,
             dict(seq=cfg.encoder_seq_len, causal=False)),
            ("dec", cases[n_enc:], ENC_DEC_SEQ,
             dict(seq=ENC_DEC_SEQ, causal=True))):
        own = {"flash_attention": 0.0}
        held = [check("flash_attention", case, own) for case in part[1:]]
        row = b7_launch_row(f"serve_encdec_{kind}", part[0], cfg, real, bw,
                            own, **shape)
        row["launches_held"] = len(part)
        row["err_vs_f64_by_launch"] = [row["err_vs_f64"]] + [
            r["err_vs_f64"] for r in held]
        name_ = f"flash_attention_encdec_{kind}"
        rows[name_], errs[name_] = row, own["flash_attention"]
        errs["flash_attention"] = max(errs["flash_attention"],
                                      own["flash_attention"])
        mark(f"b7_{kind}")
    del cases, part, held, inputs
    torch.cuda.empty_cache()

    # the encoder alone, as Engine.generate runs it once per batch
    max_len = SERVE_PROMPT + SERVE_NEW + 8
    encoder_ms = {}
    for name_, model in (("flash", flash), ("naive", naive)):
        engine, cache = Engine(model, params, max_len), None
        times = []
        for _ in range(3):
            cache = model.init_cache(SERVE_REQUESTS, max_len)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine._fill_cross_attn(cache, frames)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        encoder_ms[name_] = times
        del engine, cache
    mark("encoder")
    serve = serve_common("serve_encdec", flash, params, gen, prompts=prompts,
                         enc_frames=frames,
                         generate_launches={"flash_attention": n_enc})
    mark("serve")
    cross = 2 * n_dec * SERVE_REQUESTS * cfg.encoder_seq_len * \
        cfg.num_kv_heads * cfg.resolved_head_dim * 4
    for n, parts in serve["cache_bytes"].items():
        if parts["cross_k"] + parts["cross_v"] != cross:
            fail(f"serve_encdec: cross cache bytes {parts} at max_len {n}, "
                 f"expected {cross} in all")
    emit("serve_encdec", arch=cfg.name, encoder_layers=n_enc,
         decoder_layers=n_dec, params=n_params, weight_bytes=weight_bytes,
         init_s=init_s, frames=list(frames.shape),
         prefill=dict(batch=SERVE_REQUESTS, seq=ENC_DEC_SEQ,
                      launches=launches, flash_ms=flash_ms,
                      flash_first_ms=flash_first_ms,
                      b7_plain_ms=plain_ms, naive_ms=naive_ms,
                      naive_first_ms=naive_first_ms,
                      flash_peak_bytes=flash_peak,
                      naive_peak_bytes=naive_peak,
                      flash_vs_b7_plain_max_abs_diff=flash_vs_plain,
                      flash_vs_naive_max_abs_diff=gap,
                      flash_vs_naive_rel_to_max_logit=gap_rel,
                      profile=flash_profile),
         encoder_ms=encoder_ms, cross_cache_bytes=cross,
         flash_attention=rows, serve=serve, seconds_by_stage=stages,
         card=smi_line())
    del params, naive, flash, tokens, frames, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches={"flash_attention_encdec_enc": n_enc,
                          "flash_attention_encdec_dec": n_dec},
                rows=rows)


def loss_grad_peak(model_cfg, N: int, batch) -> int:
    """Bytes the loss's ``vmap(grad)`` (``TreeSpace.worker_grads``'s
    call) takes at its peak over what was allocated before it, on N
    workers' copies of ``model_cfg``'s seed-0 stacked tree and
    ``batch``."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import build_model
    from repro_torch.models.weights import stacked_params
    model = build_model(model_cfg)
    params = stacked_params(model_cfg, 0, "cuda")
    tree = tree_map(lambda t: t.expand((N,) + t.shape), params)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = torch.func.vmap(torch.func.grad_and_value(model.loss))(tree, batch)
    peak = torch.cuda.max_memory_allocated() - before
    del out, tree, params
    torch.cuda.empty_cache()
    return peak


def at_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers: the decoder's, and an enc-dec
    arch's encoder alike."""
    if cfg.is_enc_dec:
        return cfg.with_(num_layers=layers, encoder_layers=layers)
    return cfg.with_(num_layers=layers)


def train_depth_plan(full, N: int, M: int, batch) -> dict:
    """The depth to train at and its reckoned peak. The loss's
    ``vmap(grad)`` peak is measured at 2 and 4 layers and extrapolated
    by layer (an enc-dec arch's stacks cut alike, ``at_depth``):
    ``torch.func.grad`` under ``vmap`` keeps far more than the
    tensors autograd saves. The step's peak is the larger of the state
    beside the loss (z_hist, y, w_cache, z~ and the params: 4 B x (2T +
    3NT + P)) plus that peak, and the tables after it, in the plain
    step that runs from the same state as each kernel step: beside the
    state's y and w_cache, g and z~, its update's x, y and w and the
    two selected merges, 4 B x (2T + 9NT + NP + P) (the kernel step's
    fused update, ``train_moe``'s 4 B x (2T + 6NT + NP + P)). Full
    depth unless that passes TRAIN_SSM_PEAK_LIMIT; then the most layers
    under it."""
    from repro_torch.core.blocks import make_block_layout
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.weights import stacked_params
    probe = {n: loss_grad_peak(at_depth(full, n), N, batch) for n in (2, 4)}
    per_layer = (probe[4] - probe[2]) / 2
    fixed = probe[2] - 2 * per_layer

    def reckon(layers):
        meta = stacked_params(at_depth(full, layers), 0, "meta")
        P = sum(int(t.numel()) for t in tree_leaves(meta))
        T = M * make_block_layout(meta, num_blocks=M).block_dim
        loss = fixed + layers * per_layer
        return int(max(4 * (2 * T + 3 * N * T + P) + loss,
                       4 * (2 * T + 9 * N * T + N * P + P))), loss

    layers = full.num_layers
    while reckon(layers)[0] > TRAIN_SSM_PEAK_LIMIT and layers > 1:
        layers -= 1
    reckoned, loss = reckon(layers)
    return dict(layers=layers, reckoned_peak_bytes=reckoned,
                loss_grad_peak_bytes_probed={str(n): b
                                             for n, b in probe.items()},
                loss_grad_bytes_per_layer=per_layer,
                loss_grad_peak_bytes_reckoned=int(loss))


@contextlib.contextmanager
def step_ranges(space):
    """Inside the block, a train step's parts run in profiler ranges
    (RANGE + part): the gather of z~ and the push of z, the loss's
    forward (``transformer.forward``, called inside ``worker_grads``),
    and the rest of ``worker_grads`` (the unpack of z~ and the pack of
    g). Wrappers local to this script, on the space's instance and the
    module: the package runs as it always does."""
    from torch.profiler import record_function
    from repro_torch.models import transformer
    undo = []

    def wrap(obj, name, part, on_instance):
        real = getattr(obj, name)

        def wrapped(*args, **kwargs):
            with record_function(RANGE + part):
                return real(*args, **kwargs)

        if on_instance:          # the space is a frozen dataclass
            object.__setattr__(obj, name, wrapped)
            undo.append(lambda: object.__delattr__(obj, name))
        else:
            setattr(obj, name, wrapped)
            undo.append(lambda: setattr(obj, name, real))

    wrap(space, "gather", "gather_and_push", True)
    wrap(space, "push", "gather_and_push", True)
    wrap(space, "worker_grads", "pack_and_unpack", True)
    wrap(transformer, "forward", "loss_forward", False)
    try:
        yield
    finally:
        for fn in undo:
            fn()


def phase_train_ssm(bw: float, errs) -> dict:
    """``phase_train_stacked`` on mamba2-370m (line ``train_ssm``)."""
    return phase_train_stacked("train_ssm", SSM_ARCH, bw, errs)


def phase_train_stacked(path: str, arch: str, bw: float, errs) -> dict:
    """``ADMMTrainer`` on ``arch``'s stacked tree (f32, seed 0) at
    full depth unless the reckoned peak passes TRAIN_SSM_PEAK_LIMIT
    (``train_depth_plan``; then at the most layers under it, an enc-dec
    arch's two stacks alike, the cut printed in line ``<path>_plan``),
    N = 2, M = 2 by LPT, launch/train.py's defaults, ``TokenPipeline``
    batches of 2 x 512 tokens a worker (and an enc-dec arch's 2 x T_enc
    frames), 5 steps on the kernels, before each the plain backend's
    step from the same state: z within KERNEL_TOL. Gates: step 0's loss
    is ``Model.loss`` at z0; the first gradient finite; B1 and B2 once
    a step and held on their inputs; pads 0; losses and z finite.
    Prints step ms, tokens/s, peaks beside the reckoning, and a device
    split of the step. Returns B1's and B2's launches and rows under
    ``<kernel>_<path's family>`` (``train_ssm`` -> ``_ssm``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.weights import stacked_params
    from repro_torch.training import ADMMTrainer

    stages, mark = stage_clock()
    family = path[len("train_"):]
    N, M = TRAIN_WORKERS, TRAIN_BLOCKS
    full = get_config(arch)
    gc.collect()
    reset_peak()
    pipe = TokenPipeline(vocab_size=full.vocab_size, seq_len=TRAIN_SEQ + 1,
                         global_batch=N * TRAIN_BATCH, seed=0)
    enc_kw = dict(enc_frames_dim=full.d_model,
                  enc_seq_len=full.encoder_seq_len) if full.is_enc_dec else {}
    batches = [pipe.batch(t, num_workers=N, device="cuda", **enc_kw)
               for t in range(TRAIN_STEPS + 1)]
    plan = train_depth_plan(full, N, M, batches[0])
    mark("plan")
    layers, reckoned = plan["layers"], plan["reckoned_peak_bytes"]
    model_cfg = at_depth(full, layers)
    model = build_model(model_cfg)
    reset_peak()
    params = stacked_params(model_cfg, 0, "cuda")
    P = sum(int(t.numel()) for t in tree_leaves(params))
    tokens = N * TRAIN_BATCH * TRAIN_SEQ

    def trainer(backend):
        return ADMMTrainer(loss_fn=model.loss,
                           admm=train_config(backend=backend),
                           num_workers=N, device="cuda")

    kern, plain = trainer("auto"), trainer("torch")
    spec = kern._spec(params)
    layout = spec.space.layout
    if spec.space.backend != "cuda":
        fail(f"{path}: 'auto' resolved to {spec.space.backend!r} on the "
             f"card")
    T = M * layout.block_dim
    stacks = "each stack's " if full.is_enc_dec else ""
    emit(f"{path}_plan", arch=model_cfg.name,
         depth_cut=None if layers == full.num_layers
         else f"{layers} of {stacks}{full.num_layers} layers",
         params=P, block_sizes=list(layout.block_sizes),
         dblk=layout.block_dim, padding=T - P,
         **({"ssd_decay_bytes_per_layer_per_worker": ssd_decay_bytes(
             model_cfg, TRAIN_BATCH, TRAIN_SEQ)} if full.ssm else {}),
         limit_bytes=TRAIN_SSM_PEAK_LIMIT, **plan)
    loss0 = direct_loss(model, params, batches[0], N)
    state = kern.init(params)
    del params
    mark("init")

    # the first gradient, finite (the SSD's mask before the exp)
    # the first gradient, finite (the SSD's mask before the exp), and the
    # memory the loss's vmap(grad) takes beside the state
    space = spec.space
    z_tilde = space.gather(kern._packed(spec, state).z_hist,
                           torch.ones((N, M), dtype=torch.int64,
                                      device="cuda"))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g_losses, g = space.worker_grads(model.loss, z_tilde, batches[0])
    grad_peak = torch.cuda.max_memory_allocated() - before
    if not bool(torch.isfinite(g).all()) or not bool(
            torch.isfinite(g_losses).all()):
        fail(f"{path}: the loss or its gradient at z0 is not finite")
    grad_max = float(g.abs().max())
    del z_tilde, g, g_losses
    torch.cuda.empty_cache()
    mark("grad0")

    times, plain_times, losses, plain_losses, peaks, reserved, diffs = \
        [], [], [], [], [], [], []
    launches = {k: 0 for k in PLAIN}
    for t in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_state, p_info = plain.train_step(state, batches[t])
        torch.cuda.synchronize()
        plain_times.append(1e3 * (time.perf_counter() - t0))
        if any(ops.launch_counts().values()):
            fail(f"{path}: the torch backend launched a kernel")
        plain_losses.append(float(p_info["loss"]))
        z_plain = plain._packed(plain._spec(p_state.params),
                                p_state).z_hist[0].cpu()
        del p_state, p_info
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, info = kern.train_step(state, batches[t])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        peaks.append(torch.cuda.max_memory_allocated())
        reserved.append(torch.cuda.max_memory_reserved())
        step_launches = ops.launch_counts()
        expect_launches(f"{path} step {t}", step_launches, 1, MAIN_KERNELS)
        for k, n in step_launches.items():
            launches[k] += n
        losses.append(float(info["loss"]))
        packed = kern._packed(kern._spec(state.params), state)
        if not pads_zero(layout, packed.z_hist, packed.y, packed.w_cache):
            fail(f"{path}: a pad lane is not 0 after step {t}")
        if not math.isfinite(losses[-1]) or not bool(
                torch.isfinite(packed.z_hist[0]).all()):
            fail(f"{path}: loss or z not finite at step {t}")
        diffs.append(compare(packed.z_hist[0], z_plain.cuda()))
        del packed, z_plain
    mark("steps")
    loss_rel = same_loss(path, losses[0], loss0)
    step_ms = statistics.median(times[1:])
    own = {k: 0.0 for k in MAIN_KERNELS}
    own["server_prox_update"] = max(diffs)

    held = [state]
    del state, info

    def step():
        held[0], _ = kern.train_step(held[0], batches[TRAIN_STEPS])

    def release() -> int:
        """Cyclic garbage and cached blocks freed before one more step;
        the bytes still allocated (the state and the batches)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    # one step profiled, its parts in ranges: the step issues ~12,000
    # launches, and the profiler's own work grows with them
    extra = {"profile": {"allocated_before_bytes": release()}}
    with step_ranges(spec.space):
        profile = profile_calls(path, step, step_ms, 1,
                                expect={B1_NAME: 1, B2_NAME: 1},
                                warmups=(0, 1, 2), by_range=True)
    extra["profile"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    by_range = profile.pop("by_range")
    split = {part: by_range.get(part, 0.0) for part in (
        "loss_forward", "loss_backward", "pack_and_unpack",
        "gather_and_push")}
    split.update(B1=profile["kernels"][B1_NAME]["device_ms_per_launch"],
                 B2=profile["kernels"][B2_NAME]["device_ms_per_launch"])
    busy = profile["device_busy_ms_per_epoch"]
    split.update(rest=busy - sum(split.values()), idle=step_ms - busy)
    mark("profile")
    extra["capture"] = {"allocated_before_bytes": release()}
    with capture_inputs(copy=False, names=MAIN_KERNELS, keep=1) as inputs:
        step()
    extra["capture"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    del held[0]
    torch.cuda.empty_cache()
    rows = check_on_path(path, inputs, MAIN_KERNELS, bw, own)
    mark("kernels_on_path")
    for k in MAIN_KERNELS:
        errs[k] = max(errs[k], own[k])
        errs[f"{k}_{family}"] = own[k]
    del batches
    gc.collect()
    torch.cuda.empty_cache()

    kernels = b1_b2_rows(rows, profile)
    for k in MAIN_KERNELS:
        rows[k]["device_ms"] = kernels[k]["device_ms_per_launch"]
    emit(path, arch=model_cfg.name, layers=layers, N=N, M=M,
         params=P, block_sizes=list(layout.block_sizes),
         dblk=layout.block_dim, padding=T - P, steps=TRAIN_STEPS,
         tokens_per_step=tokens, launches=launches, losses=losses,
         torch_losses_from_kernel_states=plain_losses, loss0_direct=loss0,
         loss0_rel_diff=loss_rel, grad0_max_abs=grad_max, step_ms=times,
         step_ms_median=step_ms, tokens_per_s=tokens / step_ms * 1e3,
         torch_step_ms=plain_times,
         torch_step_ms_median=statistics.median(plain_times[1:]),
         peak_bytes=max(peaks), peak_bytes_by_step=peaks,
         reserved_peak_bytes=max(reserved), reckoned_peak_bytes=reckoned,
         extra_steps_bytes=extra, loss_grad_peak_over_state_bytes=grad_peak,
         z_max_abs_diff_vs_torch=diffs,
         pads_zero=True, device_ms_per_step=split, profile=profile,
         kernels=kernels, seconds_by_stage=stages, card=smi_line())
    return dict(launches={f"{k}_{family}": launches[k] for k in MAIN_KERNELS},
                rows={f"{k}_{family}": rows[k] for k in MAIN_KERNELS})


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
    timed["margin"].update(margin_on_path("logreg", marg, timed["margin"]))
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


def kernel_device_ms(path: str, kernel: str, call, window_ms: float,
                     written=None) -> dict:
    """The device time per launch of ``kernel`` (a fragment of its name
    in the profiler), which each ``call`` launches once, over REPS calls
    (the CUDA-event window, ``window_ms``, is set by the wrapper's host
    work between back-to-back launches at these sizes): ``device_ms``
    with the inputs left in L2 by the call before; ``device_ms_cold``
    with L2 overwritten between calls by a 128 MB fill, as a caller
    whose inputs come from device memory finds it (the fill leaves L2
    dirty, so the call's reads also write that back); ``device_ms_clean``
    with L2 refilled by a 128 MB read instead (nothing to write back);
    and, given ``written``, ``device_ms_written`` with ``written`` run
    before each call (inputs just written, as the PS runtime's push
    leaves a block's column). Fails unless the profiler recorded every
    launch."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    runs = {"device_ms": call,
            "device_ms_cold": lambda: (flush.zero_(), call()),
            "device_ms_clean": lambda: (flush.sum(), call())}
    if written is not None:
        runs["device_ms_written"] = lambda: (written(), call())
    out = {}
    for key, run in runs.items():
        prof = profile_calls(f"{path}_{key}", run, window_ms, REPS,
                             unit="call", expect={kernel: 1})
        out[key] = prof["kernels"][kernel]["device_ms_per_launch"]
    return out


def bitwise(kernel, plain) -> bool:
    """The same values bit for bit, NaN where the other has NaN."""
    nan = torch.isnan(plain)
    if kernel.dtype != plain.dtype or not torch.equal(torch.isnan(kernel),
                                                       nan):
        return False
    bits = {2: torch.int16, 4: torch.int32}[plain.element_size()]
    return torch.equal(kernel[~nan].view(bits), plain[~nan].view(bits))


def over_limit(out, plain) -> float:
    """A result's error as a multiple of the elementwise kernels' limit,
    KERNEL_TOL * (1 + max|plain|) over the finite entries (inf where NaN
    or Inf differ): above 1 the gate refuses it."""
    out, plain = out.float(), plain.float()
    fin = torch.isfinite(plain)
    if not (torch.equal(torch.isfinite(out), fin)
            and torch.equal(torch.isnan(out), torch.isnan(plain))):
        return float("inf")
    err = float((out[fin] - plain[fin]).abs().max())
    return err / (KERNEL_TOL * (1.0 + float(plain[fin].abs().max())))


def refused_margin_tail(case, out, plain) -> float:
    """B6's result with its last word's elements after the first (the
    tail a design that mishandles it would get wrong) written as v at
    s = 0, -y / 2: how far past the gate it reads."""
    s, y = case
    lanes = 16 // s.element_size()
    faulty = out.clone().view(-1)
    faulty[1 - lanes:] = (-0.5 * y.view(-1)[1 - lanes:].float()).to(s.dtype)
    ratio = over_limit(faulty, plain.view(-1))
    if not ratio > 1.0:
        fail(f"margin: a result with its tail written as v(s=0) reads "
             f"{ratio:.3g} of the gate's limit, not past it")
    return ratio


def margin_on_path(path: str, case, row) -> dict:
    """B6 on a path's inputs, beside its CUDA-event window (``row``):
    whether it is the plain version bit for bit, its device time per
    launch (``kernel_device_ms``), and how far past the gate a result
    with a faulty tail reads."""
    lg = kernel_module("margin")
    out, plain = lg.margin_cuda(*case), lg.margin_torch(*case)
    torch.cuda.synchronize()
    return dict(bitwise=bitwise(out, plain),
                faulty_tail_over_limit=refused_margin_tail(case, out, plain),
                **kernel_device_ms(path + "_margin", "margin_kernel",
                                   lambda: lg.margin_cuda(*case), row["ms"]))


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
    timed["margin"].update(margin_on_path("logreg_bf16", marg,
                                          timed["margin"]))
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
    start = time.perf_counter()
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
    phase_kernels_shapes(errs)
    wu_launches, wu_row = phase_worker_update(bw, errs)
    mm_launches, mm_designs, mm_rows = phase_matmul(bw, errs)
    main_launches, main_rows, z_main = phase_main(bw, errs)
    phase_autotune(bw, z_main)
    phase_paper(bw, errs)
    spmd_launches, spmd_rows = phase_spmd(bw, errs, z_main)
    del z_main
    torch.cuda.empty_cache()
    phase_spmd_ranks(errs)
    ps_launches, ps_rows, ps_peaks = phase_ps(bw, errs)
    phase_ps_durable(ps_peaks)
    phase_pytree(bw, errs)
    phase_ps_tree()
    phase_train(bw, errs)
    phase_train_entry_points()
    phase_train_moe(bw, errs)
    with expandable_segments():
        train_ssm = phase_train_ssm(bw, errs)
        train_mla = phase_train_stacked("train_mla", MLA_ARCH, bw, errs)
        train_encdec = phase_train_stacked("train_encdec", ENC_DEC_ARCH,
                                           bw, errs)
    serve_launches, serve_rows, serve16_launches, serve16_rows = \
        phase_serve(bw, errs)
    phase_serve_moe(bw, errs)
    phase_serve_ssm(bw, errs)
    hybrid = phase_serve_hybrid(bw, errs)
    phase_serve_mla(bw, errs)
    encdec = phase_serve_encdec(bw, errs)
    logreg_launches, logreg_rows = phase_logreg(bw, errs)
    logreg16_launches, logreg16_rows = phase_logreg_bf16(bw, errs)

    # each kernel's numbers from the path it serves: B1 and B2 from main,
    # B3 from spmd (B1 runs on both; main is its full-width single device),
    # B4 from its op on the kdda_like bundle, B5's gemv (its two passes of
    # one gradient, summed) and B6 from logreg, B5's gemv16 from the bf16
    # gradient, its tensor-core and tiled designs from the matmul line
    # (the first cell of each: f32 and bf16 with A stored (M, K), and
    # f32 at 4095^3), B7 from serve's flash prefill; and rows of their
    # own for B7 on zamba2's and whisper's prefills and B1 and B2 on the
    # train steps of mamba2, minicpm3 and whisper
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
    # B2 from the PS runtime's first commit, B6 in bf16 from logreg_bf16
    errs["server_prox_update_commit"] = \
        ps_rows["server_prox_update"]["max_abs_err"]
    errs["margin_bf16"] = logreg16_rows["margin"]["max_abs_err"]
    paths = {"server_prox_update_commit": (
                 {"server_prox_update_commit":
                  ps_launches["server_prox_update"]},
                 {"server_prox_update_commit": ps_rows["server_prox_update"]}),
             "margin_bf16": ({"margin_bf16": logreg16_launches["margin"]},
                             {"margin_bf16": logreg16_rows["margin"]}),
             "prox_consensus": (spmd_launches, spmd_rows),
             "admm_worker_update": (wu_launches, {"admm_worker_update":
                                                  wu_row}),
             "matmul": (logreg_launches, logreg_kernels),
             "margin": (logreg_launches, logreg_kernels),
             "flash_attention": (serve_launches, serve_rows),
             "flash_attention_bf16": (serve16_launches, serve16_rows),
             "flash_attention_hybrid": (hybrid["launches"], hybrid["rows"]),
             **{name_: (part["launches"], part["rows"])
                for part in (train_ssm, train_mla, train_encdec, encdec)
                for name_ in part["rows"]}}
    kernels = []
    for name_, (source, replaces) in SOURCES.items():
        launches, rows = paths.get(name_, (main_launches, main_rows))
        r = rows[name_]
        kernels.append(dict(
            name=name_, route="cuda", source=source, replaces=replaces,
            launches=launches[name_], max_abs_err=errs[name_], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            device_ms=r.get("device_ms"),
            device_ms_cold=r.get("device_ms_cold")))
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
    emit("timing", script_s=time.perf_counter() - start, added_s=ADDED_S,
         added_total_s=sum(ADDED_S.values()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
