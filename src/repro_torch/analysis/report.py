"""Cost rows and their tables, the counterpart of
``repro/analysis/report.py``.

    PYTHONPATH=src python -m repro_torch.analysis.report
    PYTHONPATH=src python -m repro_torch.analysis.report \
        --path experiments/dryrun_torch.jsonl --table dryrun --mesh pod

With no ``--path`` it counts four smoke programs of the port on the meta
device and prints one JSON row each, then their table: the flat epoch
(the card's program: B1 + B2) at a small width, the ADMM train step of
the qwen3 smoke model with ``remat`` off and on, and its flash prefill
(B7 once a layer). With ``--path`` it renders the rows of the port's dry
run (``launch/dryrun.py``) as the roofline or the dry-run table.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from .cost import count
from .roofline import Roofline


def fmt_bytes(b):
    if b >= 1 << 30:
        return f"{b / (1 << 30):.1f}G"
    if b >= 1 << 20:
        return f"{b / (1 << 20):.1f}M"
    return f"{b / 1024:.0f}K"


def load(path, variant=None):
    """The rows of a dry run's JSON lines by (arch, shape, mesh,
    variant), the last row of a key winning; only ``variant``'s if
    given."""
    rows = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            key = (r["arch"], r["shape"], r["mesh"],
                   r.get("variant", "baseline"))
            rows[key] = r
    if variant is not None:
        rows = {k: v for k, v in rows.items() if k[3] == variant}
    return rows


def roofline_table(rows, mesh="1"):
    out = ["| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | bottleneck "
           "| useful_flops | MFU bound | coll bytes/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m, _v), r in sorted(rows.items()):
        if m != mesh:
            continue
        if r.get("status", "ok") != "ok":
            out.append(f"| {arch} | {shape} | — | — | — | {r['status']} "
                       f"| — | — | — |")
            continue
        uf = r.get("useful_flops_ratio")
        mfu = r.get("mfu_bound")
        uf_s = f"{uf:.3f}" if uf is not None else "—"
        mfu_s = f"{mfu:.3f}" if mfu is not None else "—"
        out.append(
            f"| {arch} | {shape} | {r['t_compute_s']:.2e} | "
            f"{r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} | "
            f"**{r['bottleneck']}** | {uf_s} | {mfu_s} | "
            f"{fmt_bytes(r['collective_bytes_per_device'])} |")
    return "\n".join(out)


def dryrun_table(rows, mesh):
    """The dry run's rows on ``mesh``: per-device FLOPs, HBM bytes,
    collective bytes, the state one rank holds, the reference's placed
    arguments, the counted peak and whether it fits one card, and the
    seconds the count took (the reference's table has compile seconds
    there)."""
    out = ["| arch | shape | status | program | flops/dev | HBM bytes/dev "
           "| coll bytes/dev | state bytes/dev | arg bytes/dev (specs) "
           "| peak | fits | count (s) |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m, _v), r in sorted(rows.items()):
        if m != mesh:
            continue
        if r["status"] != "ok":
            out.append(f"| {arch} | {shape} | {r['status']} | — | — | — | "
                       f"— | — | — | — | — | — |")
            continue
        mem = r["memory"]
        out.append(
            f"| {arch} | {shape} | ok | {r['program']} | "
            f"{r['flops_per_device']:.2e} | "
            f"{fmt_bytes(r['hbm_bytes_per_device'])} | "
            f"{fmt_bytes(r['collective_bytes_per_device'])} | "
            f"{fmt_bytes(mem['per_device_state_bytes'])} | "
            f"{fmt_bytes(mem['spec_argument_bytes'])} | "
            f"{fmt_bytes(mem['peak_bytes'])} | "
            f"{'yes' if r['fits'] else '**no**'} | {r['count_s']:.1f} |")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# programs on the meta device: (fn, args) to count
# ---------------------------------------------------------------------------

def epoch_program(N: int, M: int, dim: int, cfg):
    """``main``'s epoch (``ConsensusSession.flat`` on the quadratic loss,
    x tracked) as the card runs it, on meta: (fn, args)."""
    from ..api import ConsensusSession
    from ..core.space import asybadmm_epoch, init_consensus_state

    def quad(z, c):
        return 0.5 * torch.sum(torch.square(z - c))

    data = torch.empty((N, dim), device="meta")
    sess = ConsensusSession.flat(quad, data, dim=dim, cfg=cfg,
                                 backend="cuda", device="meta")
    return asybadmm_epoch, (sess.spec, init_consensus_state(sess.spec),
                            sess.data)


def train_step_program(model_cfg, admm, N: int, batch: int, seq: int):
    """One ``ADMMTrainer.train_step`` of ``model_cfg`` (its ``remat``
    as set) on the card's program (``admm`` on the "cuda" backend), on
    meta: (fn, args). The batch is ``batch`` x ``seq`` tokens a
    worker."""
    from ..models import build_model
    from ..training import ADMMTrainer
    model = build_model(model_cfg)
    params = model.param_specs()
    tr = ADMMTrainer(loss_fn=model.loss,
                     admm=dataclasses.replace(admm, backend="cuda"),
                     num_workers=N, device="meta")
    state = tr.init(params)
    tokens = torch.zeros((N, batch, seq), dtype=torch.int64, device="meta")
    data = {"tokens": tokens, "labels": tokens}
    if model_cfg.is_enc_dec:
        data["enc_frames"] = torch.empty(
            (N, batch, model_cfg.encoder_seq_len, model_cfg.d_model),
            device="meta")
    return tr.train_step, (state, data)


def layers_forward_flops(model_cfg, N: int, batch: int, seq: int) -> float:
    """FLOPs of one forward of the layer stack under ``vmap`` over N
    workers, counted on meta: L times the last-position forward at L
    layers less the same forward at L - 1. The yardstick of what
    ``remat=True`` adds to a train step (one more forward of the
    layers)."""
    from ..models import build_model, transformer

    def forward(cfg):
        params = torch.utils._pytree.tree_map(
            lambda t: torch.empty((N,) + tuple(t.shape), dtype=t.dtype,
                                  device="meta"),
            build_model(cfg).param_specs())
        tokens = torch.zeros((N, batch, seq), dtype=torch.int64,
                             device="meta")
        fn = torch.func.vmap(lambda p, t: transformer.forward(
            p, t, cfg, logits_mode="last")[0])
        with torch.no_grad():
            return count(fn, params, tokens)[1].flops

    L = model_cfg.num_layers
    return L * (forward(model_cfg) - forward(model_cfg.with_(
        num_layers=L - 1)))


def prefill_program(model_cfg, batch: int, seq: int):
    """``Model.prefill`` of ``batch`` x ``seq`` tokens (last logits), on
    meta: (fn, args)."""
    from ..models import build_model
    model = build_model(model_cfg)
    params = model.init(0, "meta")
    tokens = torch.zeros((batch, seq), dtype=torch.int64, device="meta")

    def prefill(p, t):
        with torch.no_grad():
            return model.prefill(p, t, logits_mode="last")

    return prefill, (params, tokens)


def smoke_rows():
    """The smoke programs' rows."""
    from ..configs import INPUT_SHAPES, get_smoke
    from ..configs.base import ADMMConfig
    from .roofline import model_flops
    rows = []
    cfg = ADMMConfig(rho=2.0, gamma=0.1, max_delay=1, block_fraction=0.5,
                     num_blocks=8, l1_coef=1e-3, clip=1.0, seed=0)
    fn, args = epoch_program(4, 8, 8 * 1024, cfg)
    _, cost = count(fn, *args)
    rows.append(dict(Roofline.from_cost(cost, arch="flat", shape="epoch",
                                        tf32=False).row(), **cost.row()))
    model_cfg = get_smoke("qwen3-1.7b")
    admm = ADMMConfig(rho=20.0, gamma=0.01, max_delay=1, block_fraction=1.0,
                      num_blocks=2, seed=0)
    N, B, S = 2, 2, 16
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=S,
                                global_batch=N * B)
    for remat in (False, True):
        fn, args = train_step_program(model_cfg.with_(remat=remat), admm, N,
                                      B, S)
        _, cost = count(fn, *args)
        rows.append(dict(Roofline.from_cost(
            cost, arch=model_cfg.name, shape="train_step",
            tf32=False, model_flops_total=model_flops(model_cfg, shape)
        ).row(), variant=f"remat={remat}", **cost.row()))
    fn, args = prefill_program(model_cfg.with_(attn_impl="flash"), 2, 128)
    _, cost = count(fn, *args)
    rows.append(dict(Roofline.from_cost(cost, arch=model_cfg.name,
                                        shape="prefill", tf32=False).row(),
                     **cost.row()))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default=None,
                    help="a dry run's JSON lines; none: the smoke rows")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--table", default="roofline",
                    choices=["roofline", "dryrun"])
    ap.add_argument("--mesh", default="pod")
    args = ap.parse_args(argv)
    if args.path is not None:
        rows = load(args.path, args.variant)
        print(roofline_table(rows, args.mesh) if args.table == "roofline"
              else dryrun_table(rows, args.mesh))
        return rows
    rows = smoke_rows()
    for r in rows:
        print(json.dumps(r))
    print(roofline_table({(r["arch"], r["shape"], r["mesh"],
                           r.get("variant", "baseline")): r for r in rows}))
    return rows


if __name__ == "__main__":
    main()
