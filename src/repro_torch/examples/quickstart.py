"""Quickstart: solve a sparse logistic regression with AsyBADMM.

    python -m repro_torch.examples.quickstart [--device cpu]

Builds the paper's general-form consensus problem (eq. 4) on synthetic
sparse data through ``repro_torch.api.ConsensusSession``, runs the
block-wise asynchronous algorithm (Alg. 1), and checks the KKT
conditions of Theorem 1 at the solution. Runs on the card (the CUDA
kernels) unless the device says otherwise. Port of
``examples/quickstart.py``: the same data, config and epochs, the same
printed lines.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from ..api import ConsensusSession
from ..configs.base import ADMMConfig
from ..data import make_sparse_logreg
from ..device import DeviceLike

DIM = 512
EPOCHS = 600
EVAL_EVERY = 100
# bounded delay 2, each worker updates half its blocks; h(z) of eq. 22
CFG = ADMMConfig(rho=2.0, gamma=0.1, max_delay=2, block_fraction=0.5,
                 num_blocks=32, l1_coef=1e-3, clip=1e4)


def loss_fn(z, d):
    X, y = d
    return torch.mean(torch.log1p(torch.exp(-y * (X @ z))))


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = None) -> Dict:
    """Run the quickstart and print its lines; returns the edge density,
    the eval history, P and the KKT violations. ``--device`` in ``argv``
    overrides ``device``; both None means ``cuda``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = args.device if args.device is not None else device

    # data: 8 workers, each touching only part of the feature space
    data = make_sparse_logreg(num_workers=8, samples_per_worker=48, dim=DIM,
                              density=0.02, locality=0.8, seed=0)
    session = ConsensusSession.flat(loss_fn, (data.X, data.y), dim=DIM,
                                    cfg=CFG, support=data.support,
                                    device=device)   # sparse edge set E

    density = float(session.spec.edge.float().mean())
    print(f"edge density |E|/(N·M) = {density:.2f}")

    state, history = session.run(num_epochs=EPOCHS, eval_every=EVAL_EVERY)

    for h in history:
        print(f"epoch {h['epoch']:4d}  objective {h['objective']:.4f}")

    P = float(session.stationarity(state)["P"])
    print("stationarity P =", P)
    kkt = {k: float(v) for k, v in session.kkt_violations(state).items()}
    for k, v in kkt.items():
        print(f"{k:15s} = {v:.2e}")
    return {"edge_density": density, "history": history, "P": P,
            "kkt": kkt, "backend": session.spec.space.backend,
            "objective_start": session.objective(session.init())}


if __name__ == "__main__":
    main()
