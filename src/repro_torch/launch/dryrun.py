"""Dry run of the port: build every (arch x input-shape) program at full
width over the production meshes and count it — FLOPs, HBM bytes,
collective bytes, ops and peak memory — with no card and no process
group.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod [--arch A] \
      [--shape S] [--variant V] [--layers L] [--out out.jsonl] [--append]

The rows go to ``--out`` (``experiments/dryrun_torch.jsonl`` in the
working directory), which is written anew unless ``--append``.
``--layers`` cuts each model's depth (never a width), for a quick look.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles
each program on 512 fake XLA host devices and reads
``compiled.memory_analysis()`` and the HLO. The port has no HLO and no
GSPMD: it runs what ONE rank of the mesh runs, on the meta device (shapes,
no data), over ``launch/mesh.py::make_abstract_mesh`` (rank 0's view,
with no process group), under the cost counter (``analysis/cost.py``:
it charges the hand-written kernels at their dispatch and tracks the
live storages for the peak). Nothing is allocated on a card, and
``XLA_FLAGS`` is never touched. The meshes: ``pod`` (data=16, model=16)
and ``multipod`` (pod=2, data=16, model=16).

Shapes map to the port's programs (the row's ``program``):

  train_4k    -> "spmd_epoch": one shard of the SPMD epoch that
                 ``ADMMTrainer(mesh=...)`` runs (``core/sharded.py``:
                 ``per_shard_cost_program``), in bf16 with remat, on the
                 card's program (``backend="cuda"``: B1 and B3 charged as
                 kernels), with ``admm_config(mesh)``. The variants
                 ``baseline`` and ``sharded_epoch`` both run it: the
                 reference's ``baseline`` is a GSPMD-partitioned trainer
                 step the port has no counterpart for (the row says
                 ``"reference_program": "gspmd"``);
  train_4k with ``cyclic``
              -> "block_round": one shard of ``train_step_block``'s round
                 of block 0 (``core/sharded.py::block_round_body``);
  prefill_32k, decode_32k, long_500k
              -> "replica": the port serves a whole model per card, so a
                 rank runs ``Model.prefill`` / ``decode_step`` on its
                 share of the batch (``batch_specs(worker_axis=False)``:
                 B over the data axes where it divides, else all of B);
                 the model axis replicates; no collectives. The port has
                 no tensor parallelism, so ``fits`` says which models a
                 card cannot serve whole.

long_500k is skipped for pure full-attention archs.

A row holds the reference's ``Roofline.row()`` keys (the roofline of one
H100, ``analysis/roofline.py``) and ``collectives`` (bytes by kind, with
``total``), ``op_counts`` (the counter's ops by name, the kernels by
their B-names), ``memory`` (``per_device_state_bytes``: the state and
inputs one rank holds, from the local shapes; ``spec_argument_bytes``:
the reference's arguments placed by ``launch/shardings.py``'s rules, its
``argument_size_in_bytes`` up to XLA's padding; ``peak_bytes``: the
counter's peak of live storage), ``fits`` (peak within the card's
memory), ``layout_padding`` (a train program's share of padding in the
packed block table), ``program``, ``ignored_tokens`` (variant tokens
that change nothing in the port), ``layers`` (the depth counted) and
``build_s`` / ``count_s`` in place of ``compile_s``. The reference's
HLO-only keys ``xla_cost_analysis``, ``hlo_bytes`` and
``collectives_unscaled`` have no counterpart.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional

import torch

from ..analysis.cost import arg_tensors, count
from ..analysis.roofline import CARD_MEMORY_BYTES, Roofline, model_flops
from ..configs import INPUT_SHAPES, get_config, list_archs
from ..configs.base import ADMMConfig
from ..core.sharded import (consensus_state_specs, local_tile,
                            per_shard_block_round_program,
                            per_shard_cost_program)
from ..core.space import init_consensus_state
from ..core.tree import tree_flatten
from ..device import seeded_generator
from ..models import build_model, weights
from ..training.trainer import ADMMTrainer
from . import shardings as sh
from .mesh import P, data_axes, make_abstract_mesh, num_workers

DTYPE = "bfloat16"

#: the kernels by their ids (B1-B7) in PERF.md's table of kernels
KERNEL_IDS = {"admm_worker_select_update": "B1", "server_prox_update": "B2",
              "prox_consensus": "B3", "admm_worker_update": "B4",
              "matmul": "B5", "margin": "B6", "flash_attention": "B7"}

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def abstract_mesh(mesh_name: str, rank: int = 0):
    """Rank ``rank``'s view of a production mesh, with no process group."""
    shape, axes = MESHES[mesh_name]
    return make_abstract_mesh(shape, axes, rank)


def spec_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of ``tree``'s tensors placed by ``specs`` (a spec
    tree of the same structure): the sum over leaves of the local
    shape's elements times the element size."""
    leaves, treedef = tree_flatten(tree)
    placed, spec_def = tree_flatten(specs, is_leaf=sh.is_spec)
    if spec_def != treedef:
        raise ValueError(f"specs {spec_def} do not match the tree {treedef}")
    return sum(math.prod(sh.shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves, placed) if isinstance(t, torch.Tensor))


def held_bytes(args) -> int:
    """The bytes of the state and inputs a program holds: the sum of its
    argument tensors' ``nbytes``."""
    return sum(t.nbytes for t in arg_tensors(args))


# ---------------------------------------------------------------------------
# inputs: full shapes and their placement, and one rank's rows
# ---------------------------------------------------------------------------

def _batch(cfg, lead, device="meta", seed: int = 0):
    """tokens / labels of shape ``lead`` (int32), and for enc-dec the
    stub frontend's frames ``lead[:-1] + (T_enc, d)`` in ``cfg.dtype``;
    values drawn from ``seed`` off the meta device."""
    dev = torch.device(device)
    if dev.type == "meta":
        def ints():
            return torch.empty(lead, dtype=torch.int32, device=dev)
    else:
        gen = seeded_generator(dev, seed)

        def ints():
            return torch.randint(0, cfg.vocab_size, lead, generator=gen,
                                 dtype=torch.int32, device=dev)
    batch = {"tokens": ints(), "labels": ints()}
    if cfg.is_enc_dec:
        shape = tuple(lead[:-1]) + (cfg.encoder_seq_len, cfg.d_model)
        frames = torch.empty(shape, dtype=cfg.torch_dtype(), device=dev)
        if dev.type != "meta":
            frames.normal_(generator=gen)
        batch["enc_frames"] = frames
    return batch


def input_specs(cfg, shape, mesh, *, worker_axis: bool,
                batch_over_model: bool = False):
    """Training / prefill batch for one input shape at its full size, on
    meta: (batch, its specs), as the reference places it."""
    daxes = data_axes(mesh)
    N = num_workers(mesh)
    B, S = shape.global_batch, shape.seq_len
    if worker_axis:
        assert B % N == 0, (B, N)
        lead = (N, B // N, S)
        ms = mesh.shape.get("model", 1)
        if batch_over_model and (B // N) % ms == 0:
            spec = P(daxes, "model", None)
        else:
            spec = P(daxes, None, None)
    else:
        lead = (B, S)
        spec = P(daxes, None) if B % N == 0 else P(None, None)
    batch = _batch(cfg, lead)
    specs = {"tokens": spec, "labels": spec}
    if cfg.is_enc_dec:
        nd = batch["enc_frames"].dim()
        specs["enc_frames"] = P(*((daxes,) + (None,) * (nd - 1)))
    return batch, specs


def admm_config(mesh) -> ADMMConfig:
    """Paper-faithful baseline: block-wise consensus with bounded delay 1,
    full block sweep per round, a block server a model shard."""
    return ADMMConfig(rho=100.0, gamma=0.01, max_delay=1,
                      block_fraction=1.0, num_blocks=mesh.shape["model"])


# ---------------------------------------------------------------------------
# the programs — each build_* returns a Program ready to count
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Program:
    """One rank's program: ``fn(*args)``, what it is, and what it
    placed."""
    fn: Callable
    args: tuple
    name: str                           # spmd_epoch | block_round | replica
    dtype: torch.dtype
    spec_argument_bytes: int
    used: frozenset                     # the variant tokens it honoured
    layout_padding: Optional[float] = None
    reference_program: Optional[str] = None


_ATTN_TOKENS = ("chunked_attn", "qchunk_attn")


def _apply_cfg_variants(cfg, tokens):
    if "chunked_attn" in tokens:
        cfg = cfg.with_(attn_impl="chunked", attn_chunk=1024)
    if "qchunk_attn" in tokens:
        cfg = cfg.with_(attn_impl="qchunk", attn_chunk=2048)
    if "moe_scatter" in tokens:
        cfg = cfg.with_(moe_impl="scatter")
    if "no_remat" in tokens:
        cfg = cfg.with_(remat=False)
    for t in tokens:
        if t.startswith("ssm_chunk_") and cfg.ssm is not None:
            cfg = cfg.with_(ssm=dataclasses.replace(
                cfg.ssm, chunk_size=int(t.rsplit("_", 1)[1])))
    return cfg


def _cfg_tokens_used(cfg, tokens, *, train: bool) -> set:
    """The config tokens of ``tokens`` that change a program of ``cfg``:
    an attention impl where the arch reaches ``gqa_forward`` (MLA
    ignores it, an SSM has none), the MoE dispatch on an MoE arch, the
    SSD chunk on an SSM arch, remat in training."""
    used = set()
    if cfg.arch_type != "ssm" and cfg.mla is None:
        used |= tokens & set(_ATTN_TOKENS)
    if cfg.moe is not None and "moe_scatter" in tokens:
        used.add("moe_scatter")
    if train and "no_remat" in tokens:
        used.add("no_remat")
    if cfg.ssm is not None:
        used |= {t for t in tokens if t.startswith("ssm_chunk_")}
    return used


def layout_padding(layout) -> float:
    """1 - (param elements / (M x dblk)): the packed table's padding."""
    return 1.0 - sum(layout.block_sizes) / (layout.num_blocks
                                             * layout.block_dim)


def train_program(cfg, mesh, acfg: ADMMConfig, batch: int, seq: int, *,
                  cyclic: bool = False, device="meta", data=None,
                  workers: Optional[int] = None, backend=None,
                  seed: int = 0):
    """(fn, args, spec): one shard of the port's train step for ``cfg``
    as given (its dtype and remat), ``acfg``, ``batch`` x ``seq`` tokens
    a worker, on ``mesh``'s rank view: the SPMD epoch
    (``per_shard_cost_program``), or with ``cyclic`` the block round of
    block 0. ``workers`` (N) defaults to one a data shard, as the
    reference's dry run trains; ``backend`` to the card's program
    (``"cuda"``) on the card and on meta, else ``"torch"``. Local tiles on ``device`` (meta: shapes
    only; elsewhere the weights and tokens from ``seed``); ``data`` (all
    N workers' rows or the rank's) replaces the drawn batch. The
    reckoning under :func:`build_train`'s bf16 override."""
    dev = torch.device(device)
    model = build_model(cfg)
    params = (model.param_specs() if dev.type == "meta"
              else weights.stacked_params(cfg, seed, dev))
    if backend is None:
        backend = "cuda" if dev.type in ("cuda", "meta") else "torch"
    trainer = ADMMTrainer(loss_fn=model.loss,
                          admm=dataclasses.replace(acfg, backend=backend),
                          num_workers=workers or num_workers(mesh),
                          mesh=mesh,
                          device=dev)
    spec = trainer._spec(params)
    if data is None:
        data = _batch(cfg, (local_tile(spec).Ng, batch, seq), dev, seed)
    if cyclic:
        fn, args = per_shard_block_round_program(spec, data, params)
    else:
        fn, args = per_shard_cost_program(spec, data, z0=params)
    return fn, args, spec


def build_train(cfg, shape, mesh, variant: str = "baseline") -> Program:
    """train_4k: the SPMD epoch's shard (or, ``cyclic``, the block
    round's) in bf16 with remat; the reference's arguments placed by
    ``admm_state_specs`` over the trainer's params-shaped state
    (``sharded_epoch``: ``consensus_state_specs`` over the packed
    state) and ``input_specs``."""
    tokens = set(variant.split("+"))
    cfg = _apply_cfg_variants(cfg.with_(dtype=DTYPE, param_dtype=DTYPE,
                                        remat=True), tokens)
    used = _cfg_tokens_used(cfg, tokens, train=True)
    acfg = admm_config(mesh)
    cyclic = "cyclic" in tokens
    if "sync" in tokens or cyclic:
        acfg = dataclasses.replace(acfg, max_delay=0)
        used |= tokens & {"sync", "cyclic"}
    N = num_workers(mesh)
    B, S = shape.global_batch, shape.seq_len
    fn, args, spec = train_program(cfg, mesh, acfg, B // N, S, cyclic=cyclic)

    # the reference's arguments and their placement
    model = build_model(cfg)
    params = model.param_specs()
    if "sharded_epoch" in tokens and not cyclic:
        used.add("sharded_epoch")
        flat = ADMMTrainer(loss_fn=model.loss, admm=acfg, num_workers=N,
                           device="meta")._spec(params)
        state = init_consensus_state(flat, params)
        state_bytes = spec_bytes(state, consensus_state_specs(spec, state),
                                 mesh)
        batch, bspec = input_specs(cfg, shape, mesh, worker_axis=True)
        reference = "sharded_epoch"
    else:
        mode = "fsdp" if "fsdp" in tokens else "tp"
        ep = "expert_parallel" in tokens and cfg.moe is not None
        used |= tokens & ({"fsdp"} | ({"expert_parallel"} if ep else set()))
        state = ADMMTrainer(loss_fn=model.loss, admm=acfg, num_workers=N,
                            device="meta").init(params, cyclic=cyclic)
        state_bytes = spec_bytes(
            state, sh.admm_state_specs(state, mesh, mode=mode,
                                       expert_parallel=ep), mesh)
        bom = "batch_over_model" in tokens
        used |= tokens & {"batch_over_model"}
        batch, bspec = input_specs(cfg, shape, mesh, worker_axis=True,
                                   batch_over_model=bom)
        reference = "gspmd"
    return Program(
        fn=fn, args=args, name="block_round" if cyclic else "spmd_epoch",
        dtype=cfg.torch_dtype(),
        spec_argument_bytes=state_bytes + spec_bytes(batch, bspec, mesh),
        used=frozenset(used), layout_padding=layout_padding(
            spec.space.layout), reference_program=reference)


def build_train_epoch(cfg, shape, mesh, variant: str = "sharded_epoch"
                      ) -> Program:
    """``sharded_epoch``: the same program as ``baseline`` in the port
    (the SPMD epoch is the port's one distributed train step); the
    reference's arguments are the packed state under
    ``consensus_state_specs``."""
    tokens = set(variant.split("+")) | {"sharded_epoch"}
    return build_train(cfg, shape, mesh, "+".join(sorted(tokens)))


def replica_batch(shape, mesh) -> int:
    """A rank's share of a serving batch: B over the data axes where it
    divides, else all of B (``batch_specs(worker_axis=False)``)."""
    N = num_workers(mesh)
    B = shape.global_batch
    return B // N if B % N == 0 and B >= N else B


def build_prefill(cfg, shape, mesh, variant: str = "baseline") -> Program:
    tokens = set(variant.split("+"))
    cfg = _apply_cfg_variants(cfg.with_(dtype=DTYPE, param_dtype=DTYPE),
                              tokens)
    used = _cfg_tokens_used(cfg, tokens, train=False)
    model = build_model(cfg)
    mode = "fsdp" if "fsdp" in tokens else "tp"
    ep = "expert_parallel" in tokens and cfg.moe is not None
    used |= tokens & ({"fsdp"} | ({"expert_parallel"} if ep else set()))
    stacked = model.param_specs()
    pbytes = spec_bytes(stacked, sh.param_specs(
        stacked, mesh, mode=mode, expert_parallel=ep), mesh)
    batch, bspec = input_specs(cfg, shape, mesh, worker_axis=False)
    del bspec["labels"], batch["labels"]
    logits_mode = "last" if "last_logits" in tokens else "all"
    used |= tokens & {"last_logits"}

    params = model.init(0, "meta")
    local = _batch(cfg, (replica_batch(shape, mesh), shape.seq_len))
    args = (params, local["tokens"])
    if cfg.is_enc_dec:
        args += (local["enc_frames"],)

    def prefill(p, t, enc_frames=None):
        return model.prefill(p, t, enc_frames=enc_frames,
                             logits_mode=logits_mode)

    return Program(fn=prefill, args=args, name="replica",
                   dtype=cfg.torch_dtype(),
                   spec_argument_bytes=pbytes + spec_bytes(batch, bspec, mesh),
                   used=frozenset(used))


def build_decode(cfg, shape, mesh) -> Program:
    """One decode step against a full cache (the last position), every
    variant token ignored as the reference's ``build_decode`` ignores
    them."""
    cfg = cfg.with_(dtype=DTYPE, param_dtype=DTYPE)
    model = build_model(cfg)
    stacked = model.param_specs()
    B, S = shape.global_batch, shape.seq_len
    cache_full = model.init_cache(B, S, "meta")
    daxes = data_axes(mesh)
    N = num_workers(mesh)
    token_full = torch.empty((B, 1), dtype=torch.int32, device="meta")
    tok_spec = P(daxes, None) if B % N == 0 else P(None, None)
    nbytes = (spec_bytes(stacked, sh.param_specs(stacked, mesh), mesh)
              + spec_bytes(cache_full, sh.cache_specs_tree(cache_full, mesh,
                                                           B), mesh)
              + spec_bytes((token_full,), (tok_spec,), mesh)
              + 4)                                      # pos, an int32
    del cache_full
    b = replica_batch(shape, mesh)
    args = (model.init(0, "meta"),
            torch.empty((b, 1), dtype=torch.int32, device="meta"),
            model.init_cache(b, S, "meta"), S - 1)
    return Program(fn=model.decode_step, args=args, name="replica",
                   dtype=cfg.torch_dtype(), spec_argument_bytes=nbytes,
                   used=frozenset())


def cut_depth(cfg, layers: Optional[int]):
    """``cfg`` with every stack (the decoder's and, in an enc-dec, the
    encoder's) cut to at most ``layers`` layers; as it is when None.
    Widths are kept: a quick sweep's rows are full-width rows of a
    shallower model."""
    if layers is None:
        return cfg
    cut = {"num_layers": min(layers, cfg.num_layers)}
    if cfg.is_enc_dec:
        cut["encoder_layers"] = min(layers, cfg.encoder_layers)
    return cfg.with_(**cut)


def build(arch: str, shape_name: str, mesh, variant: str = "baseline",
          layers: Optional[int] = None) -> Program:
    cfg = cut_depth(get_config(arch), layers)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        if "sharded_epoch" in variant.split("+"):
            return build_train_epoch(cfg, shape, mesh, variant)
        return build_train(cfg, shape, mesh, variant)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, variant)
    return build_decode(cfg, shape, mesh)


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 500k decode requires sub-quadratic "
                "attention")
    return None


# ---------------------------------------------------------------------------
# analysis of one counted program
# ---------------------------------------------------------------------------

def analyze(arch: str, shape_name: str, mesh_name: str, mesh,
            program: Program, cost, elapsed: Dict[str, float],
            variant: str = "baseline") -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    chips = math.prod(mesh.shape.values())
    coll = {k: int(v) for k, v in cost.collective_bytes.items()}
    coll["total"] = int(sum(cost.collective_bytes.values()))
    rl = Roofline.from_cost(cost, arch=arch, shape=shape_name,
                            mesh=mesh_name, chips=chips,
                            dtype=program.dtype,
                            model_flops_total=model_flops(cfg, shape))
    row = rl.row()
    ops = {KERNEL_IDS.get(k, k): int(n) for k, n in cost.ops.items()}
    for b in KERNEL_IDS.values():
        ops.setdefault(b, 0)
    tokens = [t for t in variant.split("+") if t and t != "baseline"]
    memory = {"per_device_state_bytes": held_bytes(program.args),
              "spec_argument_bytes": int(program.spec_argument_bytes),
              "peak_bytes": int(cost.peak_bytes)}
    row.update({
        "collectives": coll, "op_counts": ops, "memory": memory,
        "fits": memory["peak_bytes"] <= CARD_MEMORY_BYTES,
        "layout_padding": program.layout_padding,
        "program": program.name,
        "ignored_tokens": sorted(t for t in tokens
                                 if t not in program.used),
        "build_s": elapsed["build"], "count_s": elapsed["count"],
    })
    if program.reference_program is not None:
        row["reference_program"] = program.reference_program
    return row


def run_one(arch: str, shape_name: str, mesh_name: str,
            variant: str = "baseline", layers: Optional[int] = None
            ) -> Dict[str, Any]:
    """The row of one (arch, shape, mesh, variant); ``layers`` cuts the
    depth (:func:`cut_depth`; the row's ``layers`` is the depth
    counted)."""
    mesh = abstract_mesh(mesh_name)
    reason = skip_reason(arch, shape_name)
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "variant": variant}
    if reason:
        return dict(base, status="skipped", reason=reason)
    t0 = time.perf_counter()
    program = build(arch, shape_name, mesh, variant, layers)
    t1 = time.perf_counter()
    with (torch.no_grad() if program.name == "replica"
          else contextlib.nullcontext()):
        _, cost = count(program.fn, *program.args)
    t2 = time.perf_counter()
    row = analyze(arch, shape_name, mesh_name, mesh, program, cost,
                  {"build": t1 - t0, "count": t2 - t1}, variant)
    row.update(base, layers=cut_depth(get_config(arch), layers).num_layers,
               status="ok")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun_torch.jsonl",
                    help="JSON lines, one row each; written anew unless "
                         "--append")
    ap.add_argument("--append", action="store_true",
                    help="add the rows to --out instead of replacing it")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch to at most this many layers a "
                         "stack (full width; a quick sweep)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_fail = 0
    with open(args.out, "a" if args.append else "w") as f:
        for mesh_name in meshes:
            for arch in archs:
                for shape_name in shapes:
                    tag = (f"{arch} x {shape_name} x {mesh_name} "
                           f"[{args.variant}]")
                    t0 = time.perf_counter()
                    try:
                        row = run_one(arch, shape_name, mesh_name,
                                      args.variant, args.layers)
                    except Exception as e:
                        n_fail += 1
                        row = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "variant": args.variant,
                               "status": "error", "error": repr(e),
                               "traceback": traceback.format_exc()[-3000:]}
                    row["wall_s"] = time.perf_counter() - t0
                    f.write(json.dumps(row) + "\n")
                    f.flush()
                    status = row["status"]
                    extra = (f" {row['program']} bottleneck="
                             f"{row['bottleneck']} t=({row['t_compute_s']:.2e},"
                             f"{row['t_memory_s']:.2e},"
                             f"{row['t_collective_s']:.2e})s peak="
                             f"{row['memory']['peak_bytes'] / 1e9:.2f}GB"
                             if status == "ok" else
                             row.get("reason", row.get("error", "")))
                    print(f"[{status:7s}] {tag:60s} {row['wall_s']:6.1f}s "
                          f"{extra}", flush=True)
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
