"""End-to-end driver: train a ~100M-parameter transformer with the
block-wise asynchronous consensus trainer for a few hundred steps, a
port of ``examples/train_transformer_admm.py``:

    PYTHONPATH=src python -m repro_torch.examples.train_transformer_admm \\
        [--steps 300] [--quick] [--device cpu]

The ADMM side goes through ``repro_torch.api.ConsensusSession`` pytree
mode (the generic Algorithm 1 step the flat driver uses; on the card B1
and B2 once a step); it is compared against the synchronous AdamW
baseline on the same deterministic token stream (both learn a synthetic
bigram language). On the card unless ``--device cpu``; ``main`` returns
both losses at every step.
"""
import argparse
import json
import time

from ..api import ConsensusSession
from ..configs.base import ADMMConfig, ModelConfig
from ..core.tree import tree_leaves
from ..data import TokenPipeline
from ..device import resolve_device
from ..models import build_model
from ..models.weights import stacked_params
from ..optim import adamw, warmup_cosine
from ..training import SGDTrainer


def model_100m() -> ModelConfig:
    """~110M params: a qwen3-family dense decoder."""
    return ModelConfig(
        name="demo-100m", arch_type="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32000,
        head_dim=64, qk_norm=True, tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--quick", action="store_true",
                    help="tiny model + 30 steps (CI-sized)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--block-selection", default="random",
                    choices=["random", "cyclic", "gauss_southwell"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_100m()
    if args.quick:
        cfg = cfg.with_(num_layers=2, d_model=128, num_heads=4,
                        num_kv_heads=2, d_ff=256, vocab_size=1024)
        args.steps = min(args.steps, 30)
        args.seq = 32

    model = build_model(cfg)
    params = stacked_params(cfg, 0, device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name} ({n/1e6:.1f}M params) on {device}")

    # data uses a reduced working vocabulary so the bigram structure is
    # learnable within a few hundred steps (the model vocab is unchanged)
    data_vocab = min(cfg.vocab_size, 512)
    pipe = TokenPipeline(vocab_size=data_vocab, seq_len=args.seq + 1,
                         global_batch=args.batch, seed=0, branch=2)

    # ---- AsyBADMM consensus session (the paper's technique) ----
    admm = ConsensusSession.pytree(
        model.loss, params,
        ADMMConfig(rho=8.0, gamma=0.01, max_delay=1, block_fraction=0.5,
                   num_blocks=8, block_selection=args.block_selection),
        num_workers=args.workers, device=device)
    st_admm = admm.init()
    admm_step = admm.step_fn()

    # ---- AdamW data-parallel baseline ----
    sgd = SGDTrainer(loss_fn=model.loss,
                     optimizer=adamw(warmup_cosine(3e-4, args.steps // 10,
                                                   args.steps)))
    st_sgd = sgd.init(params)

    losses = {"admm_loss": [], "adamw_loss": []}
    t0 = time.time()
    for step in range(args.steps):
        b_admm = pipe.batch(step, num_workers=args.workers, device=device)
        b_sgd = pipe.batch(step, device=device)
        st_admm, info_a = admm_step(st_admm, b_admm)
        st_sgd, info_s = sgd.train_step(st_sgd, b_sgd)
        losses["admm_loss"].append(float(info_a["loss"]))
        losses["adamw_loss"].append(float(info_s["loss"]))
        if step % max(args.steps // 15, 1) == 0 or step == args.steps - 1:
            print(json.dumps({
                "step": step,
                "admm_loss": round(losses["admm_loss"][-1], 4),
                "adamw_loss": round(losses["adamw_loss"][-1], 4),
                "consensus_residual":
                    round(admm.consensus_residual(st_admm), 5),
                "elapsed_s": round(time.time() - t0, 1),
            }), flush=True)
    return losses


if __name__ == "__main__":
    main()
