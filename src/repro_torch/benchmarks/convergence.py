"""Paper Fig. 2 analogue: AsyBADMM convergence on sparse logistic
regression (synthetic KDDa-like data), sync vs async at several delay
bounds, plus the stationarity metric P (Theorem 1.3).

    python -m repro_torch.benchmarks.convergence [--epochs 600] [--device cpu]

CSV columns: name, us_per_call (per-epoch wall time), derived
(final objective | final P). Port of ``benchmarks/convergence.py``: the
same five variants and rows. The time window ends in
``torch.cuda.synchronize()`` on the card, where the reference blocks on
its arrays.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List

import torch

from ..api import ConsensusSession
from ..configs.base import ADMMConfig
from ..data import make_sparse_logreg
from ..device import DeviceLike

EPOCHS = 600
EVAL_EVERY = 100

VARIANTS = [
    ("fig2_sync_D0", ADMMConfig(rho=2.0, gamma=0.0, max_delay=0,
                                block_fraction=1.0, num_blocks=16)),
    ("fig2_async_D2", ADMMConfig(rho=2.0, gamma=0.1, max_delay=2,
                                 block_fraction=0.5, num_blocks=16, seed=1)),
    ("fig2_async_D4", ADMMConfig(rho=2.0, gamma=0.1, max_delay=4,
                                 block_fraction=0.5, num_blocks=16, seed=2)),
    ("fig2_async_D8", ADMMConfig(rho=2.0, gamma=0.2, max_delay=8,
                                 block_fraction=0.5, num_blocks=16, seed=3)),
    ("fig2_fullvec_async", ADMMConfig(rho=2.0, gamma=0.1, max_delay=2,
                                      block_fraction=1.0, num_blocks=1,
                                      seed=4)),
]


def loss_fn(z, d):
    X, y = d
    return torch.mean(torch.log1p(torch.exp(-y * (X @ z))))


def build_session(cfg: ADMMConfig, num_workers: int = 8, dim: int = 512,
                  samples: int = 64, seed: int = 0,
                  device: DeviceLike = None) -> ConsensusSession:
    data = make_sparse_logreg(num_workers=num_workers,
                              samples_per_worker=samples, dim=dim,
                              density=0.1, seed=seed)
    return ConsensusSession.flat(
        loss_fn, (data.X, data.y), dim=dim, cfg=cfg, support=data.support,
        l1_coef=1e-3, clip=1e4, device=device)


def _sync(sess: ConsensusSession) -> None:
    if sess.spec.device.type == "cuda":
        torch.cuda.synchronize(sess.spec.device)


def run_one(sess: ConsensusSession, epochs: int = EPOCHS,
            eval_every: int = EVAL_EVERY):
    """(us per epoch, objective every ``eval_every`` epochs, final P)."""
    state = sess.init()
    step = sess.step_fn()
    state, _ = step(state, sess.data)        # warm-up, as the reference's compile step
    _sync(sess)
    t0 = time.perf_counter()
    trace = []
    for t in range(epochs):
        state, _ = step(state, sess.data)
        if (t + 1) % eval_every == 0:
            trace.append(sess.objective(state))
    _sync(sess)
    dt = (time.perf_counter() - t0) / epochs
    P = float(sess.stationarity(state)["P"])
    return dt * 1e6, trace, P


def main(emit: Callable[[str], None] = print, epochs: int = EPOCHS,
         device: DeviceLike = None,
         eval_every: int = EVAL_EVERY) -> List[Dict]:
    """Run the five variants, emitting one CSV row each; returns their
    numbers (name, us_per_call, trace, P, backend)."""
    results = []
    for name, cfg in VARIANTS:
        sess = build_session(cfg, device=device)
        us, trace, P = run_one(sess, epochs, eval_every)
        emit(f"{name},{us:.1f},obj={trace[-1]:.4f};P={P:.3e};"
             f"trace={'|'.join(f'{x:.3f}' for x in trace)}")
        results.append({"name": name, "us_per_call": us, "trace": trace,
                        "P": P, "backend": sess.spec.space.backend})
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(epochs=args.epochs, device=args.device,
         eval_every=min(EVAL_EVERY, args.epochs))
