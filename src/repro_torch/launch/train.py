"""End-to-end training driver, as ``repro/launch/train.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 200 --trainer admm [--workers 4] [--ckpt out/ckpt] \\
      [--device cpu]

Runs the smoke (reduced) config by default; ``--full`` takes the arch's
published widths. Both trainers run on the same token stream, so the
paper's ADMM can be compared with the synchronous AdamW baseline:
``--trainer admm`` drives ``ConsensusSession.pytree`` over the model's
stacked parameter tree (``--runtime epoch``, the vectorized epoch: on
the card B1 and B2 once a step; ``--runtime ps``, the event-driven
Parameter Server runtime: B1 per worker compute, B2 per block commit);
``--trainer sgd`` drives ``SGDTrainer`` with AdamW and a warmup-cosine
schedule. One JSON line per logged step, with the loss at full float
precision. On the card unless ``--device cpu``; ``main`` returns the
logged losses.
"""
import argparse
import contextlib
import json
import time

from ..api import ConsensusSession
from ..checkpoint import save
from ..configs import get_config, get_smoke, list_archs
from ..configs.base import ADMMConfig
from ..core.space import ConstantDelay, ParetoDelay, TraceDelay
from ..core.tree import tree_leaves
from ..data import TokenPipeline
from ..device import resolve_device
from ..models import build_model
from ..models.weights import stacked_params
from ..optim import adamw, warmup_cosine
from ..training import SGDTrainer
from .mesh import MESH_PRESETS

DELAY_MODELS = ("constant", "pareto", "trace", "uniform")


def _profiler(profile_dir):
    """``torch.profiler`` over the run, its trace written to
    ``profile_dir`` (the card's kernels too where there is one)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def run_ps_training(session, args, batches):
    """--runtime ps: drive the event-driven Parameter Server runtime
    (repro_torch.ps) instead of the vectorized epoch — real numerics
    under lock-free (or locked) block servers, bounded staleness
    enforced by stalling, optional network latency on every
    worker<->server message (an unreliable lossy transport with
    ack/retry when --drop-rate/--dup-rate/--reorder-rate are set), and
    a replayable DelayTrace out. Returns the rounds' losses."""
    timing = None
    lossy = (args.drop_rate > 0.0 or args.dup_rate > 0.0
             or args.reorder_rate > 0.0)
    if lossy:
        from ..ps import CostProfile, Transport
        timing = CostProfile(net=Transport(
            args.net_latency, args.net_jitter,
            drop_rate=args.drop_rate, dup_rate=args.dup_rate,
            reorder_rate=args.reorder_rate, ack_timeout=args.ack_timeout))
    elif args.net_latency > 0.0 or args.net_jitter > 0.0:
        from ..ps import CostProfile, NetworkModel
        timing = CostProfile(net=NetworkModel(args.net_latency,
                                              args.net_jitter))
    telemetry = None
    if args.telemetry or args.telemetry_path:
        from ..obs import Telemetry
        if args.telemetry_path:
            sink = f"{args.telemetry_path}.jsonl"
            trace_path = f"{args.telemetry_path}.trace.json"
        else:
            sink, trace_path = "stdout", None
        telemetry = Telemetry(spans=True, sink=sink,
                              trace_path=trace_path,
                              metrics_every=max(args.metrics_every, 1))
    prof = _profiler(args.profile_dir) if args.profile_dir \
        else contextlib.nullcontext()
    t0 = time.time()
    with prof:
        result = session.run_ps(
            args.steps, discipline=args.discipline, record_z=False,
            timing=timing, faults=args.faults,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            resume_from=args.resume,
            telemetry=telemetry, batches=batches)
    # the machine-readable stream carries FULL float precision — a
    # convergence analysis downstream must not eat a 4-decimal
    # truncation; rounding is for the human summary line only
    for step in range(0, args.steps, max(args.log_every, 1)):
        print(json.dumps({"round": step, "loss": result.losses[step]}),
              flush=True)
    m = result.metrics
    print(json.dumps({
        "runtime": "ps", "discipline": args.discipline,
        "rounds": args.steps, "makespan": round(result.makespan, 3),
        "final_loss": round(result.losses[-1], 4),
        "stall_count": m["stall_count"],
        "stall_time": round(m["stall_time"], 3),
        "max_served_tau": m["max_served_tau"],
        "commits": m["commits"], "pushes": m["pushes"],
        "crashes": m.get("crashes", 0), "rejoins": m.get("rejoins", 0),
        "server_recoveries": m.get("server_recoveries", 0),
        "snapshots": len(m.get("snapshots", [])),
        "elapsed_s": round(time.time() - t0, 1)}), flush=True)
    if args.telemetry_path:
        print(f"telemetry: round records in {args.telemetry_path}.jsonl, "
              f"Perfetto trace in {args.telemetry_path}.trace.json "
              f"(load at https://ui.perfetto.dev)")
    if args.profile_dir:
        print(f"torch.profiler trace in {args.profile_dir} "
              f"(view: tensorboard --logdir {args.profile_dir}, or "
              f"chrome://tracing)")
    if m.get("snapshots"):
        print(f"crash-consistent snapshots in {args.checkpoint_dir} "
              f"(resume: --runtime ps --resume {m['snapshots'][-1]})")
    if args.save_trace:
        path = result.trace.save(args.save_trace)
        print(f"delay trace saved to {path} "
              f"(replay: --delay-model trace --trace-path {path})")
    if args.ckpt:
        save(args.ckpt, result.z_final, step=args.steps)
        print(f"checkpoint saved to {args.ckpt}.npz")
    return list(result.losses)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--trainer", default="admm", choices=["admm", "sgd"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--rho", type=float, default=20.0)
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--max-delay", type=int, default=1)
    ap.add_argument("--block-fraction", type=float, default=1.0)
    ap.add_argument("--num-blocks", type=int, default=8)
    ap.add_argument("--block-selection", default="random",
                    choices=["random", "cyclic", "gauss_southwell", "zipf"])
    ap.add_argument("--zipf-a", type=float, default=1.1,
                    help="skew exponent for --block-selection zipf "
                         "(block j sampled with weight (j+1)^-a; higher "
                         "= hotter head blocks)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda"],
                    help="epoch hot-path backend: the CUDA kernels (auto "
                         "on the card) or the plain torch composition "
                         "(auto elsewhere)")
    ap.add_argument("--mesh", default="none", choices=list(MESH_PRESETS),
                    help="SPMD mesh for the sharded epoch: none (single "
                         "device), or a preset over an initialised "
                         "torch.distributed group; workers shard over "
                         "the data axes")
    ap.add_argument("--autotune", default="off",
                    choices=["off", "cached", "sweep"],
                    help="B1 / B2 launch autotuning: off (default "
                         "launches), cached (the tuned table), sweep "
                         "(measure this run's shapes first)")
    ap.add_argument("--delay-model", default="uniform",
                    choices=DELAY_MODELS,
                    help="Assumption-3 staleness: uniform U{0..D}, "
                         "constant worst-case lag D, pareto heavy-tailed "
                         "stragglers clipped at D, or trace (replay a "
                         "recorded PS-runtime trace; needs --trace-path)")
    ap.add_argument("--pareto-alpha", type=float, default=1.2,
                    help="tail exponent for --delay-model pareto "
                         "(smaller = heavier straggler tail)")
    ap.add_argument("--trace-path", default=None,
                    help="DelayTrace .npz for --delay-model trace "
                         "(recorded by --runtime ps --save-trace or "
                         "ConsensusSession.run_ps)")
    ap.add_argument("--minibatch", type=float, default=None,
                    help="incremental workers (Hong 2014): fraction of "
                         "each worker's samples drawn fresh per step")
    ap.add_argument("--runtime", default="epoch", choices=["epoch", "ps"],
                    help="epoch: the vectorized asybadmm_epoch (fast "
                         "path); ps: the event-driven Parameter Server "
                         "runtime (repro_torch.ps) — lock-free block "
                         "servers, stall-enforced bounded staleness, "
                         "delay-trace recording")
    ap.add_argument("--discipline", default="lockfree",
                    choices=["lockfree", "locked", "per_push"],
                    help="--runtime ps coordination: per-block lock-free "
                         "servers (the paper), one locked full-vector "
                         "server (the prior-work baseline), or per-block "
                         "servers paying commit work eagerly per push")
    ap.add_argument("--faults", default=None,
                    help="--runtime ps: FaultPlan JSON injecting worker "
                         "crash/rejoin, join/leave churn, slowdowns, "
                         "server commit spikes, link loss, and block-"
                         "server crashes (server_crash; recovered by "
                         "WAL replay)")
    ap.add_argument("--save-trace", default=None,
                    help="path to save the --runtime ps DelayTrace "
                         "(.npz) for later --delay-model trace replay")
    ap.add_argument("--net-latency", type=float, default=0.0,
                    help="--runtime ps: constant network latency (sim "
                         "seconds) charged on every worker<->server "
                         "message (pull responses, declarations/pushes)")
    ap.add_argument("--net-jitter", type=float, default=0.0,
                    help="--runtime ps: +/- uniform jitter around "
                         "--net-latency per message")
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="--runtime ps: probability a worker<->server "
                         "message is lost (engages the ack/retry "
                         "transport layer)")
    ap.add_argument("--dup-rate", type=float, default=0.0,
                    help="--runtime ps: probability a delivered message "
                         "arrives twice (commit-gate dedup folds it once)")
    ap.add_argument("--reorder-rate", type=float, default=0.0,
                    help="--runtime ps: probability a delivered message "
                         "is held back an extra random delay (reordered "
                         "past later traffic on the same link)")
    ap.add_argument("--ack-timeout", type=float, default=1.0,
                    help="--runtime ps: sim seconds before an unacked "
                         "message retransmits (capped exponential "
                         "backoff on retries)")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="--runtime ps: write a crash-consistent "
                         "snapshot of the full runtime every K rounds "
                         "(quiescent barrier; needs --checkpoint-dir). "
                         "A killed run resumes mid-stream with --resume, "
                         "deterministically")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for --checkpoint-every snapshots "
                         "(snap-NNNNNN.npz/.json pairs, written "
                         "atomically)")
    ap.add_argument("--resume", default=None,
                    help="--runtime ps: resume from a snapshot file (or "
                         "a directory, taking the latest snapshot) "
                         "written by --checkpoint-every; the run "
                         "continues mid-stream and its tail is "
                         "identical to the uninterrupted run's")
    ap.add_argument("--telemetry", action="store_true",
                    help="--runtime ps: turn on deterministic telemetry "
                         "(repro_torch.obs) — virtual-time span tracing "
                         "plus a per-round record stream to stdout. "
                         "Never perturbs the schedule: results are "
                         "bitwise identical with or without it")
    ap.add_argument("--telemetry-path", default=None,
                    help="--runtime ps: stream the per-round records to "
                         "PREFIX.jsonl and save the Chrome trace to "
                         "PREFIX.trace.json (loadable in Perfetto) "
                         "instead of stdout; implies --telemetry")
    ap.add_argument("--metrics-every", type=int, default=1,
                    help="--runtime ps --telemetry: emit every K-th "
                         "round's record (the final round always "
                         "emits)")
    ap.add_argument("--profile-dir", default=None,
                    help="--runtime ps: wrap the run in torch.profiler, "
                         "its trace written to DIR (tensorboard or "
                         "chrome://tracing), a wall-clock profile "
                         "orthogonal to the sim-time telemetry spans")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.runtime == "ps" and args.trainer != "admm":
        raise SystemExit("--runtime ps is the AsyBADMM Parameter Server "
                         "runtime; use --trainer admm")
    device = resolve_device(args.device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    params = stacked_params(cfg, args.seed, device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"trainer={args.trainer} device={device}")

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq + 1,
                         global_batch=args.batch, seed=args.seed)
    enc_kw = {}
    if cfg.is_enc_dec:               # the encoder's frames, in every batch
        enc_kw = dict(enc_frames_dim=cfg.d_model,
                      enc_seq_len=cfg.encoder_seq_len)

    if args.trainer == "admm":
        acfg = ADMMConfig(rho=args.rho, gamma=args.gamma,
                          max_delay=args.max_delay,
                          block_fraction=args.block_fraction,
                          num_blocks=args.num_blocks,
                          block_selection=args.block_selection,
                          zipf_a=args.zipf_a,
                          backend=args.backend,
                          mesh=args.mesh,
                          minibatch=args.minibatch,
                          autotune=args.autotune,
                          seed=args.seed)
        delay_model = None                       # uniform == config default
        if args.delay_model == "constant":
            delay_model = ConstantDelay(args.max_delay)
        elif args.delay_model == "pareto":
            delay_model = ParetoDelay(args.max_delay, alpha=args.pareto_alpha)
        elif args.delay_model == "trace":
            if args.trace_path is None:
                raise SystemExit("--delay-model trace needs --trace-path")
            delay_model = TraceDelay.load(args.trace_path)
        session = ConsensusSession.pytree(model.loss, params, acfg,
                                          num_workers=args.workers,
                                          delay_model=delay_model,
                                          device=device)

        def batches(t):
            return pipe.batch(t, num_workers=args.workers, device=device,
                              **enc_kw)

        if args.runtime == "ps":
            return run_ps_training(session, args, batches)
        state = session.init()
        step_fn = session.step_fn()
        get_params = session.z
    else:
        sched = warmup_cosine(args.lr, args.steps // 10, args.steps)
        trainer = SGDTrainer(loss_fn=model.loss, optimizer=adamw(sched))
        state = trainer.init(params)
        step_fn = trainer.train_step
        get_params = lambda st: st.params          # noqa: E731

        def batches(t):
            return pipe.batch(t, device=device, **enc_kw)
    del params
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        state, info = step_fn(state, batches(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            # machine stream: full float precision (see run_ps_training)
            losses.append(float(info["loss"]))
            print(json.dumps({"step": step, "loss": losses[-1],
                              "elapsed_s": round(time.time() - t0, 1)}),
                  flush=True)

    if args.ckpt:
        save(args.ckpt, get_params(state), step=args.steps)
        print(f"checkpoint saved to {args.ckpt}.npz")
    return losses


if __name__ == "__main__":
    main()
