"""Deterministic per-device launch autotuner for the epoch's fused kernels.

    python -m repro_torch.kernels.autotune --smoke [--device cpu]
    python -m repro_torch.kernels.autotune --sweep [--shape N,M,DBLK]

Port of ``repro/kernels/autotune.py``. The reference sweeps the Pallas
grid tile (blk_m, blk_d) of its two epoch-native fused ops; on the card
the choice is the CUDA launch of their kernels —
``admm_worker_select_update`` (B1, op key ``worker_select_update``) and
``server_prox_update`` (B2, op key ``server_prox_fused``): threads a
block in {128, 256, 512, 1024} and blocks an SM in {1, 2, 4, 8, the
occupancy API's maximum}, within 2048 resident threads an SM. The
winner is kept keyed by ``(device_kind, op, N, M, dblk, dtype)`` in the
reference's ``dev|op|N<N>|M<M>|d<dblk>|dtype`` format.

Scoring is measured, not claimed:

* **on the card**: the median of CUDA-event windows of back-to-back
  launches on seeded inputs (method ``cuda_events``), and every
  candidate's output must be bitwise the default launch's;
* **without a card**: a deterministic proxy (method ``proxy``), the
  bytes the op moves over 3.35 TB/s plus its waves (grid-stride passes
  of the whole grid over the output) times a launch overhead, on an
  H100's 132 SMs. Pure arithmetic: the same winner on every machine.

Ties break as in the reference: the score, then the larger launch
(threads, then blocks an SM).

Both kernels are grid-stride loops in which one thread computes each
output element in one fixed order (B2 sums over the workers in order
n = 0..N-1), so the launch never changes a bit of the output: a tuned
launch is bitwise the default one.

Winners are kept in ``tuned.json`` beside this file (the port's own
table, with the H100's measured entries and the ``cpu`` proxy entries
for the benchmark shapes; ``REPRO_TORCH_KERNELS_TUNED`` overrides the
path).

The knob: ``ADMMConfig(autotune="off" | "cached" | "sweep")``, threaded
through ``make_spec`` / ``ConsensusSession`` / ``launch.train
--autotune``. "off" launches with the kernels' defaults; "cached" looks
the launch up in this table at each B1 / B2 dispatch (the default on a
miss); "sweep" measures the session's shapes once in ``make_spec``,
keeps the winners, then behaves like "cached".
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device

LANE = 128
OPS = ("worker_select_update", "server_prox_fused")
MODES = ("off", "cached", "sweep")
THREADS = (128, 256, 512, 1024)
BLOCKS_PER_SM = (1, 2, 4, 8)
RESIDENT_THREADS = 2048          # an SM's resident threads (sm_90)
#: the benchmark shapes the table covers: kdda_like's (N, M, dblk) and
#: the pytree / train phases' (qwen3-1.7b's stacked tree at 6 layers)
SHAPES = ((8, 64, 315_904), (2, 2, 311_164_928))

#: proxy constants: an H100 SXM's memory rate, SMs, and the cost of one
#: wave of the grid over the output
_BYTES_PER_US = 3.35e6
_PROXY_SMS = 132
_WAVE_US = 1.0
#: the timing of a candidate on the card: windows of back-to-back calls
_REPS, _WINDOWS, _WARMUP = 5, 3, 2

_TABLE_ENV = "REPRO_TORCH_KERNELS_TUNED"
_SCHEMA = ("entries: {device_kind|op|N<N>|M<M>|d<dblk>|<dtype>: "
           "{threads, blocks_per_sm, score_us, method}}")


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    threads: int
    blocks_per_sm: int
    score_us: float
    method: str                     # "cuda_events" | "proxy"

    @property
    def launch(self) -> Tuple[int, int]:
        return self.threads, self.blocks_per_sm


def default_table_path() -> pathlib.Path:
    env = os.environ.get(_TABLE_ENV)
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parent / "tuned.json"


def device_kind(device: DeviceLike = "cpu") -> str:
    """The table's device key: the card's name with spaces as ``_`` (e.g.
    ``NVIDIA_H100_80GB_HBM3``), or ``cpu``."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev).strip().replace(" ", "_")


def table_key(dev: str, op: str, N: int, M: int, d: int,
              dtype: str = "float32") -> str:
    return f"{dev}|{op}|N{N}|M{M}|d{d}|{dtype}"


# ---------------------------------------------------------------------------
# table persistence (module-level cache; session sweeps merge into it)
# ---------------------------------------------------------------------------

_table_cache: Optional[Dict[str, dict]] = None


def load_table(path: Optional[pathlib.Path] = None,
               refresh: bool = False) -> Dict[str, dict]:
    global _table_cache
    if _table_cache is not None and not refresh and path is None:
        return _table_cache
    p = path or default_table_path()
    try:
        with open(p) as f:
            entries = dict(json.load(f).get("entries", {}))
    except (OSError, ValueError):
        entries = {}
    if path is None:
        _table_cache = entries
    return entries


def save_table(entries: Dict[str, dict],
               path: Optional[pathlib.Path] = None) -> bool:
    """Merge ``entries`` into the kept table (best effort: a read-only
    checkout keeps them in the in-memory cache only)."""
    global _table_cache
    merged = dict(load_table(path))
    merged.update(entries)
    if path is None:
        _table_cache = merged
    p = path or default_table_path()
    try:
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            json.dump({"_schema": _SCHEMA,
                       "entries": {k: merged[k] for k in sorted(merged)}},
                      f, indent=2)
            f.write("\n")
        return True
    except OSError:
        return False


def valid_launch(threads: int, blocks_per_sm: int) -> bool:
    """A launch both kernels take: a block size they are built for, at
    least one block an SM, at most an SM's resident threads."""
    return (threads in THREADS and blocks_per_sm >= 1
            and threads * blocks_per_sm <= RESIDENT_THREADS)


def lookup(op: str, N: int, M: int, d: int, dtype: str = "float32",
           dev: Optional[str] = None) -> Optional[LaunchConfig]:
    """The kept winner for this exact (device, op, shape) key, or None."""
    entry = load_table().get(
        table_key(dev or device_kind(), op, N, M, d, dtype))
    if not entry:
        return None
    return LaunchConfig(threads=int(entry["threads"]),
                        blocks_per_sm=int(entry["blocks_per_sm"]),
                        score_us=float(entry.get("score_us", 0.0)),
                        method=str(entry.get("method", "proxy")))


def lookup_tile(op: str, N: int, M: int, d: int, dtype: str = "float32",
                dev: Optional[str] = None) -> Optional[Tuple[int, int]]:
    """(threads, blocks per SM) for the kernel's dispatch; None on a miss
    or a stale entry that names a launch the kernels do not take (the
    default launch applies)."""
    cfg = lookup(op, N, M, d, dtype, dev)
    if cfg is None or not valid_launch(cfg.threads, cfg.blocks_per_sm):
        return None
    return cfg.launch


# ---------------------------------------------------------------------------
# candidates + scoring
# ---------------------------------------------------------------------------

def occupancy(op: str, threads: int, device) -> int:
    """The most blocks of ``threads`` an SM of the card holds at once of
    ``op``'s kernel (B1 without x, as the sweep runs it)."""
    from . import admm_update, prox_update
    if op == "worker_select_update":
        return admm_update.admm_worker_select_update_occupancy(
            threads, False, device)
    return prox_update.server_prox_update_occupancy(threads, device)


def launch_candidates(op: str, N: int, M: int, d: int,
                      device: DeviceLike = "cpu") -> List[Tuple[int, int]]:
    """The launches to score: threads x blocks an SM in BLOCKS_PER_SM and,
    on a card, the occupancy API's maximum, within RESIDENT_THREADS."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if d % LANE != 0:
        raise ValueError(f"autotune sweep requires lane-aligned d "
                         f"(d % {LANE} == 0), got d={d}")
    dev = torch.device(device)
    out = set()
    for threads in THREADS:
        per_sm = list(BLOCKS_PER_SM)
        if dev.type == "cuda":
            per_sm.append(occupancy(op, threads, dev))
        out.update((threads, b) for b in per_sm if valid_launch(threads, b))
    return sorted(out)


def op_bytes(op: str, N: int, M: int, d: int) -> int:
    """Bytes the op moves on the sweep's inputs (every row selected):
    B1 reads g, y, z~ and writes y', w'; B2 reads w_cache and z and
    writes z'; both read their masks and penalties."""
    if op == "worker_select_update":
        return 5 * N * M * d * 4 + N * M + 4 * N
    return (N + 2) * M * d * 4 + N * M + 4 * M


def waves(op: str, N: int, M: int, d: int, threads: int,
          blocks_per_sm: int, sms: int = _PROXY_SMS) -> int:
    """Grid-stride passes of the whole grid over the op's float4s."""
    items = (N * M if op == "worker_select_update" else M) * (d // 4)
    return max(1, math.ceil(items / (threads * blocks_per_sm * sms)))


def proxy_score_us(op: str, N: int, M: int, d: int, threads: int,
                   blocks_per_sm: int) -> float:
    """Deterministic off-card score: the bandwidth floor plus a launch
    overhead per wave."""
    return (op_bytes(op, N, M, d) / _BYTES_PER_US
            + waves(op, N, M, d, threads, blocks_per_sm) * _WAVE_US)


def op_inputs(op: str, N: int, M: int, d: int, device,
              with_x: bool = False, seed: int = 0):
    """Seeded inputs of ``op`` at (N, M, d) on ``device``, every row
    selected and every edge on (the reference's sweep inputs)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def t():
        return torch.randn((N, M, d), generator=gen, device=device)

    if op == "worker_select_update":
        sel = torch.ones((N, M), dtype=torch.bool, device=device)
        rho = torch.full((N,), 2.0, device=device)
        x = t() if with_x else None
        return (t(), t(), t(), t(), sel, rho, x)
    z = torch.randn((M, d), generator=gen, device=device)
    return (z, t(), torch.ones((N, M), dtype=torch.bool, device=device),
            torch.full((M,), 6.0, device=device), 0.01, 0.001, 1.0)


def run_op(op: str, args, launch=None):
    """One launch of ``op``'s CUDA kernel at ``launch`` (None: its
    default)."""
    from . import admm_update, prox_update
    if op == "worker_select_update":
        return admm_update.admm_worker_select_update_cuda(*args, launch)
    return (prox_update.server_prox_update_cuda(*args, launch),)


def same_bits(a, b) -> bool:
    """Every output bitwise equal (NaN payloads included)."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def events_score_us(fn, reps: int = _REPS, windows: int = _WINDOWS,
                    warmup: int = _WARMUP) -> float:
    """us per call: the median of CUDA-event windows of ``reps``
    back-to-back calls, after ``warmup`` calls."""
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
        times.append(1e3 * start.elapsed_time(end) / reps)
    return statistics.median(times)


def best_launch(scores: Dict[Tuple[int, int], float]) -> Tuple[int, int]:
    """The winner of scores by launch: the least score, then the larger
    launch (threads, then blocks an SM)."""
    return min(scores, key=lambda c: (scores[c], -c[0], -c[1]))


def events_scores(op: str, N: int, M: int, d: int, device="cuda"
                  ) -> Tuple[Dict[Tuple[int, int], float], float]:
    """us per launch of every candidate of ``op`` at (N, M, d) and of its
    default launch, by CUDA events on seeded inputs; raises unless each
    candidate's output is bitwise the default launch's."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("cuda_events scoring needs a CUDA device")
    args = op_inputs(op, N, M, d, dev)
    base = run_op(op, args)
    scores = {}
    for launch in launch_candidates(op, N, M, d, dev):
        out = run_op(op, args, launch)
        if not same_bits(out, base):
            raise RuntimeError(
                f"autotune: launch {launch} changed {op}'s output at "
                f"({N}, {M}, {d}): a launch must be bitwise inert")
        del out
        scores[launch] = events_score_us(lambda: run_op(op, args, launch))
    default_us = events_score_us(lambda: run_op(op, args))
    return scores, default_us


def sweep_op(op: str, N: int, M: int, d: int, dtype: str = "float32",
             measure: Optional[str] = None,
             device: DeviceLike = "cpu") -> LaunchConfig:
    """Score every candidate launch of ``op`` at (N, M, d); with
    ``cuda_events`` (the default on a card) each candidate's output must
    be bitwise the default launch's, or this raises."""
    if dtype != "float32":
        raise ValueError(f"the fused epoch kernels run in float32, got "
                         f"{dtype}")
    dev = torch.device(device)
    if measure is None:
        measure = "cuda_events" if dev.type == "cuda" else "proxy"
    if measure == "proxy":
        scores = {c: proxy_score_us(op, N, M, d, *c)
                  for c in launch_candidates(op, N, M, d, dev)}
    elif measure == "cuda_events":
        scores, _ = events_scores(op, N, M, d, dev)
    else:
        raise ValueError(f"unknown measure {measure!r}; expected "
                         f"'cuda_events' or 'proxy'")
    t, b = best_launch(scores)
    return LaunchConfig(t, b, scores[(t, b)], measure)


def entry(cfg: LaunchConfig) -> dict:
    """A table entry of a winner."""
    return {"threads": cfg.threads, "blocks_per_sm": cfg.blocks_per_sm,
            "score_us": round(cfg.score_us, 3), "method": cfg.method}


def remember(entries: Dict[str, dict], persist: bool = False) -> None:
    """Merge ``entries`` into the cached table, and into its file when
    ``persist``."""
    if persist:
        save_table(entries)
    else:
        load_table().update(entries)


def sweep_shapes(shapes: Iterable[Tuple[int, int, int]],
                 dtype: str = "float32", measure: Optional[str] = None,
                 persist: bool = True,
                 device: DeviceLike = "cpu") -> Dict[str, dict]:
    """Sweep both ops over (N, M, dblk) shapes on ``device``; merge the
    winners into the cached table (and its file when ``persist``)."""
    dev = device_kind(device)
    entries = {table_key(dev, op, N, M, d, dtype): entry(sweep_op(
        op, N, M, d, dtype, measure=measure, device=device))
        for (N, M, d) in shapes for op in OPS}
    remember(entries, persist)
    return entries


def sweep_for_space(N: int, M: int, d: int, mesh=None,
                    dtype: str = "float32", persist: bool = True,
                    device: DeviceLike = "cuda") -> None:
    """The sweep a "sweep" session runs once, in ``make_spec``: the
    epoch's shape, and under a mesh the local (N / data, M / model)
    shard shape the kernels see."""
    shapes = [(N, M, d)]
    if mesh is not None:
        from ..launch.mesh import model_axis_size, num_workers
        dsz, msz = num_workers(mesh), model_axis_size(mesh)
        if N % dsz == 0 and M % msz == 0:
            local = (max(N // dsz, 1), max(M // msz, 1), d)
            if local != shapes[0]:
                shapes.append(local)
    sweep_shapes(shapes, dtype=dtype, persist=persist, device=device)


def resolve_autotune(mode: Optional[str]) -> str:
    mode = "off" if mode in (None, "") else str(mode)
    if mode not in MODES:
        raise ValueError(f"unknown autotune mode {mode!r}; "
                         f"expected one of {MODES}")
    return mode


# ---------------------------------------------------------------------------
# CLI: --smoke validates the kept table; --sweep regenerates entries
# ---------------------------------------------------------------------------

def parse_key(key: str) -> Tuple[str, str, int, int, int, str]:
    parts = key.split("|")
    if len(parts) != 6 or [p[:1] for p in parts[2:5]] != ["N", "M", "d"]:
        raise ValueError(f"malformed key {key!r}")
    N, M, d = (int(parts[i][1:]) for i in (2, 3, 4))
    return parts[0], parts[1], N, M, d, parts[5]


def smoke(shapes: List[Tuple[int, int, int]], device) -> int:
    """Every kept entry names a known op and a launch the kernels take;
    this device's proxy entries are what the proxy sweep picks; the
    benchmark shapes have entries for this device; on a card, every
    candidate launch of both kernels on a small case (NaN and Inf among
    its inputs) is bitwise the default launch (on the CPU the ops run
    their plain versions, which have no launch)."""
    dev = torch.device(device)
    kind = device_kind(dev)
    entries = load_table(refresh=True)
    for key, e in entries.items():
        try:
            kdev, op, N, M, d, dtype = parse_key(key)
        except ValueError as err:
            raise SystemExit(f"[autotune] {err}")
        if op not in OPS:
            raise SystemExit(f"[autotune] unknown op in key {key!r}")
        t, b = int(e["threads"]), int(e["blocks_per_sm"])
        if not valid_launch(t, b):
            raise SystemExit(f"[autotune] invalid launch ({t}, {b}) for "
                             f"{key}")
        if kdev == kind and e.get("method") == "proxy":
            want = sweep_op(op, N, M, d, dtype, measure="proxy", device=dev)
            if want.launch != (t, b):
                raise SystemExit(
                    f"[autotune] stale winner for {key}: table ({t}, {b}) "
                    f"vs proxy sweep {want.launch}; rerun --sweep")
    inert = "plain versions on the CPU: no launch to vary"
    if dev.type == "cuda":
        N, M, d = 3, 5, 256
        for op in OPS:
            args = op_inputs(op, N, M, d, dev, with_x=True)
            for t in args[:4]:
                if t.is_floating_point() and t.dim() >= 2:
                    t.view(-1)[:3] = torch.tensor(
                        [float("nan"), float("inf"), -float("inf")])
            base = run_op(op, args)
            for launch in launch_candidates(op, N, M, d, dev):
                if not same_bits(run_op(op, args, launch), base):
                    raise SystemExit(f"[autotune] launch {launch} changed "
                                     f"{op}'s output: a launch must be "
                                     f"bitwise inert")
        inert = "every launch bitwise the default"
    misses = [s for s in shapes for op in OPS
              if lookup_tile(op, *s, dev=kind) is None]
    if misses:
        raise SystemExit(f"[autotune] the table misses {kind} entries for "
                         f"{sorted(set(misses))}; rerun --sweep")
    print(f"[autotune] smoke ok: {len(entries)} kept entries valid, "
          f"{inert}, entries for {len(shapes)} benchmark shapes on {kind}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="validate the kept table")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep the benchmark shapes and keep the winners")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="N,M,DBLK",
                    help="extra shape(s) to sweep / validate")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shapes = list(SHAPES)
    for s in args.shape:
        N, M, d = (int(x) for x in s.split(","))
        shapes.append((N, M, d))
    if args.sweep:
        entries = sweep_shapes(shapes, device=dev)
        for k in sorted(entries):
            e = entries[k]
            print(f"[autotune] {k}: threads={e['threads']} "
                  f"blocks_per_sm={e['blocks_per_sm']} "
                  f"({e['method']} {e['score_us']} us)")
        return 0
    return smoke(shapes, dev)


if __name__ == "__main__":
    raise SystemExit(main())
