"""Driver of ADMM training: ``training/trainer.py::ADMMTrainer.
train_step`` (``Model.loss`` differentiated under ``torch.func`` for
every worker, then the pytree epoch on the packed block table: B1 and
B2 on the card) per step.

Set-up draws the weights and ``distinct_batches`` token batches from
the seed, builds the trainer and runs its first ``checked_steps`` steps
through the same call and feed the window uses (step t takes batch t
mod K, so these steps' rows all differ); from them it keeps each step's
loss, the first gradient as the ADMM update got it (-y after step 1:
y' = -g) by worker and leaf, and the norm of each leaf's change over
the checked steps. The window steps the same trainer on. The check runs
``reference/admm_tree.py`` over ``reference/mla_transformer.py`` for
the same steps from the same inputs, after the program's state is
freed, and compares the losses, the gradient norms and the change.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, Tuple

import torch

from ..counts import train as train_counts
from ..harness import check, inputs, trace, traffic, window
from ..harness.cell import Outcome
from ..reference import admm_tree, mla_transformer
from . import common

Path = Tuple[str, ...]

# A leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone; its change is not compared.
STILL_LEAF = 1e-3


def settings(cell) -> dict:
    s = dict(cell.config["admm"])
    s.update(cell.params.get("admm", {}))
    return s


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` for the configuration file's sizes."""
    from repro_torch.configs.base import MLAConfig, ModelConfig
    if cfg["hidden_act"] != "silu" or cfg["tie_word_embeddings"]:
        raise ValueError("admm_train runs an untied SwiGLU MLA decoder")
    return ModelConfig(
        name=cfg["name"], arch_type="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        mla=MLAConfig(q_lora_rank=cfg["q_lora_rank"],
                      kv_lora_rank=cfg["kv_lora_rank"],
                      qk_nope_head_dim=cfg["qk_nope_head_dim"],
                      qk_rope_head_dim=cfg["qk_rope_head_dim"],
                      v_head_dim=cfg["v_head_dim"]),
        norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        tie_embeddings=False, act="swiglu", dtype=cfg["torch_dtype"],
        param_dtype=cfg["torch_dtype"])


def leaf(tree, path: Path):
    for key in path:
        tree = tree[key]
    return tree


def same_layout(tree, specs, paths) -> None:
    """The benchmark's weight tree has the port's names and shapes."""
    for p in paths:
        if tuple(leaf(tree, p).shape) != tuple(leaf(specs, p).shape):
            raise ValueError(f"{'.'.join(p)}: {tuple(leaf(tree, p).shape)} "
                             f"vs the port's {tuple(leaf(specs, p).shape)}")


def run(run):
    from repro_torch.configs.base import ADMMConfig
    from repro_torch.models import build_model
    from repro_torch.training import ADMMTrainer

    cfg, params, dev = run.cell.config, run.cell.params, run.device
    common.set_precision(cfg)
    common.reset_peak(dev)
    s = settings(run.cell)
    N, M = int(s["num_workers"]), int(s["num_blocks"])
    checked = int(params["checked_steps"])
    model = build_model(model_config(cfg))
    shapes = mla_transformer.param_shapes(cfg)
    paths = sorted(shapes)
    weights = inputs.weights(shapes, run.seed, dev)
    same_layout(weights, model.param_specs(), paths)
    batches = traffic.token_batches(params, cfg["vocab_size"], N, run.seed,
                                    dev)
    trainer = ADMMTrainer(
        loss_fn=model.loss, num_workers=N, device=dev,
        admm=ADMMConfig(rho=s["rho"], gamma=s["gamma"],
                        max_delay=s["max_delay"],
                        block_fraction=s["block_fraction"], num_blocks=M,
                        l1_coef=s["l1_coef"], clip=s["clip"],
                        block_selection=s["block_selection"],
                        seed=run.seed))
    state = trainer.init(weights)
    del weights

    # the checked steps, through the window's own call and feed
    losses, first_norms = [], None
    for t in range(checked):
        state, info = trainer.train_step(state, traffic.batch(batches, t))
        losses.append(float(info["loss"]))
        if t == 0:
            first_norms = [[float(torch.linalg.vector_norm(
                leaf(state.y, p)[i])) for p in paths] for i in range(N)]
    z0 = inputs.weights(shapes, run.seed, dev)
    change = [float(torch.linalg.vector_norm(
        leaf(state.params, p) - leaf(z0, p))) for p in paths]
    del z0, info
    common.free(dev)

    held, window_losses = [state], []
    del state

    def step(k):
        held[0], out = trainer.train_step(
            held[0], traffic.batch(batches, checked + k))
        window_losses.append(out["loss"])

    window.sync(dev)
    setup_peak = common.peak_bytes(dev)
    with trace.profiled(run.trace, run.trace_path) as traced:
        win = window.run(step, run.seconds, dev)
    peak = common.peak_bytes(dev)
    setup_s = win.start_wall - run.t_start
    alloc = common.allocator_counts(dev)
    failed = common.non_finite(window_losses)
    del held, trainer, window_losses
    common.free(dev)
    summary = (trace.summarize(traced.trace, win.steps)
               if traced.trace is not None else None)

    t0 = time.perf_counter()
    want = reference_steps(cfg, s, run.seed, params, N, checked, dev)
    reference_s = time.perf_counter() - t0
    gaps = step_gaps({"losses": losses, "first_norms": first_norms,
                      "change": change}, want)

    counts = train_counts.step(cfg, N, M, int(params["sequences_per_worker"]),
                               int(params["seq_len"]))
    e2e = {"setup_s": setup_s,
           "train_tokens_per_s": counts["tokens"] * win.steps / win.seconds,
           "peak_mem_gb": None if peak is None else peak / 1e9}
    return Outcome(end_to_end=e2e, counts=counts,
                   checks=check.checks(gaps, run.cell.limits),
                   attempted=win.steps, failed=failed,
                   memory_peak_bytes=peak, window=win, summary=summary,
                   notes={"setup_peak_bytes": setup_peak, **alloc,
                          "window_steps": win.steps, "window_s": win.seconds,
                          "losses": losses,
                          "reference_losses": want["losses"],
                          "leaves_compared": sum(still_rule(
                              want["first_norms"])),
                          "reference_s": reference_s})


def step_gaps(got, want) -> dict:
    """``loss_gap``, ``grad_gap``, ``change_gap`` of the checked steps
    (``reference_steps``' keys on both sides)."""
    return {"loss_gap": check.loss_gap(got["losses"], want["losses"]),
            "grad_gap": max(check.norm_gap(g, w) for g, w in zip(
                got["first_norms"], want["first_norms"])),
            "change_gap": check.norm_gap(got["change"], want["change"],
                                         still_rule(want["first_norms"]))}


def still_rule(first_norms):
    """Which leaves' change is compared: those whose reference gradient
    is at least STILL_LEAF of the median leaf's on some worker."""
    keep = None
    for norms in first_norms:
        median = statistics.median(norms)
        row = [n >= STILL_LEAF * median for n in norms]
        keep = row if keep is None else [a or b for a, b in zip(keep, row)]
    return keep


def reference_steps(cfg, s, seed, params, workers, steps, dev,
                    round_tf32: bool = False, alter=None):
    """The reference's losses, first gradient norms [worker][leaf] and
    change norms [leaf] over ``steps`` steps, from the same weights and
    batches, redrawn from the seed. ``round_tf32`` makes it the control;
    ``alter(t, i, tokens, labels)`` plants a fault in the batch it
    reads."""
    shapes = mla_transformer.param_shapes(cfg)
    paths = sorted(shapes)
    tree = inputs.weights(shapes, seed, dev)
    z0 = {p: leaf(tree, p) for p in paths}
    batches = traffic.token_batches(params, cfg["vocab_size"], workers, seed,
                                    dev)
    edge = torch.ones((workers, int(s["num_blocks"])), dtype=torch.bool)

    def loss_grad(t, i, z):
        b = traffic.batch(batches, t)
        tokens, labels = b["tokens"][i], b["labels"][i]
        if alter is not None:
            tokens, labels = alter(t, i, tokens, labels)
        leaves = {p: z[p].detach().requires_grad_(True) for p in paths}
        value = mla_transformer.loss(leaves, tokens, labels, cfg,
                                     round_tf32=round_tf32)
        grads = torch.autograd.grad(value, [leaves[p] for p in paths])
        return value.detach(), dict(zip(paths, grads))

    losses, first_norms, z = admm_tree.run(z0, loss_grad, s, seed, steps,
                                           workers, edge)
    change = [float(torch.linalg.vector_norm(z[p] - z0[p])) for p in paths]
    return {"losses": losses,
            "first_norms": [[norms[p] for p in paths]
                            for norms in first_norms],
            "change": change}
