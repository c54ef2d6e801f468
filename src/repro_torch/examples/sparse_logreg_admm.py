"""Paper §5 reproduction: sparse L1 logistic regression (eq. 22) on
synthetic KDDa-like data — sync vs async vs full-vector, with the
logistic-gradient kernels cross-checked against autograd.

    python -m repro_torch.examples.sparse_logreg_admm [--dim 1024] [--device cpu]

Port of ``examples/sparse_logreg_admm.py``: the same flags, data,
variants and printed table. The cross-check holds ``ops.logreg_grad``
(on the card: the matmul and margin kernels) against
``torch.autograd.grad`` of the same loss.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from ..api import ConsensusSession
from ..configs.base import ADMMConfig
from ..data import SparseLogRegData, make_sparse_logreg
from ..device import DeviceLike, resolve_device
from ..kernels import ops

VARIANTS = {
    "sync (block, D=0)": ADMMConfig(rho=2.0, gamma=0.0, max_delay=0,
                                    block_fraction=1.0, num_blocks=16),
    "AsyBADMM (D=2, 50% blocks)": ADMMConfig(rho=2.0, gamma=0.1,
                                             max_delay=2,
                                             block_fraction=0.5,
                                             num_blocks=16, seed=1),
    "full-vector async (M=1)": ADMMConfig(rho=2.0, gamma=0.1,
                                          max_delay=2,
                                          block_fraction=1.0,
                                          num_blocks=1, seed=2),
}


def loss_fn(z, d):
    X, y = d
    return torch.mean(torch.log1p(torch.exp(-y * (X @ z))))


def make_data(dim: int = 1024, workers: int = 8,
              samples: int = 96) -> SparseLogRegData:
    return make_sparse_logreg(num_workers=workers, samples_per_worker=samples,
                              dim=dim, density=0.08, seed=0)


def session_for(data: SparseLogRegData, cfg: ADMMConfig, *,
                device: DeviceLike = None,
                backend: Optional[str] = None) -> ConsensusSession:
    return ConsensusSession.flat(
        loss_fn, (data.X, data.y), dim=data.X.shape[-1], cfg=cfg,
        support=data.support, l1_coef=1e-3, clip=1e4, backend=backend,
        device=device)


def crosscheck(data: SparseLogRegData, device: DeviceLike = None) -> Dict:
    """``ops.logreg_grad`` against autograd on worker 0's data at w = 0."""
    dev = resolve_device(device)
    X0 = torch.as_tensor(data.X[0], device=dev)
    y0 = torch.as_tensor(data.y[0], device=dev)
    w = torch.zeros(X0.shape[1], device=dev)
    g_kernel = ops.logreg_grad(X0, y0, w)
    w_auto = w.clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(loss_fn(w_auto, (X0, y0)), w_auto)
    return {"g_kernel": g_kernel, "g_auto": g_auto,
            "max_abs_err": float((g_kernel - g_auto).abs().max())}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the cross-check and the three variants, printing the table;
    returns {"crosscheck": ..., "rows": [one dict per variant]}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--samples", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = make_data(args.dim, args.workers, args.samples)

    check = crosscheck(data, dev)
    kernel = "kernel" if dev.type == "cuda" else "plain"
    print(f"{kernel} logreg_grad vs autograd: max|Δ| = "
          f"{check['max_abs_err']:.2e}")

    print(f"\n{'variant':30s} {'epochs':>6s} {'objective':>10s} "
          f"{'P':>10s} {'s/epoch':>8s}")
    rows = []
    for name, cfg in VARIANTS.items():
        sess = session_for(data, cfg, device=dev)
        objective_start = sess.objective(sess.init())
        _sync(dev)
        t0 = time.perf_counter()
        state, hist = sess.run(args.epochs, eval_every=args.epochs)
        _sync(dev)
        dt = (time.perf_counter() - t0) / args.epochs
        P = float(sess.stationarity(state)["P"])
        print(f"{name:30s} {args.epochs:6d} {hist[-1]['objective']:10.4f} "
              f"{P:10.2e} {dt:8.4f}")
        rows.append({"name": name, "epochs": args.epochs,
                     "objective": hist[-1]["objective"], "P": P,
                     "s_per_epoch": dt, "objective_start": objective_start,
                     "backend": sess.spec.space.backend})
    return {"crosscheck": check, "rows": rows}


if __name__ == "__main__":
    main()
