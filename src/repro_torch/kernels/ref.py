"""Plain torch oracles for the kernel entry points — the reference's
``repro/kernels/ref.py`` in torch, in its unfused form
(``y' = y + rho*(x - z~)``, the worker sum as one ``torch.sum``, the
logistic gradient as two products around the margin).
"""
from __future__ import annotations

import torch


def admm_worker_update_ref(g, y, z_tilde, rho):
    """Fused eqs. (11)+(12)+(9): returns (x, y_new, w). ``rho`` is a
    scalar or any tensor broadcastable against the buffers."""
    x = z_tilde - (g + y) / rho
    y_new = y + rho * (x - z_tilde)      # == -g
    w = rho * x + y_new
    return x, y_new, w


def admm_worker_select_update_ref(g, y, z_tilde, w_old, sel, rho_vec,
                                  x_old=None):
    """Worker update + Alg. 1 sel-masked merges in one op.

    g, y, z_tilde, w_old [, x_old]: (N, M, dblk); sel: (N, M) bool;
    rho_vec: (N,). Returns (y', w'[, x'])."""
    rho = rho_vec.reshape(-1, 1, 1)
    x, y_new, w = admm_worker_update_ref(g, y, z_tilde, rho)
    keep = sel[..., None]
    y_out = torch.where(keep, y_new, y)
    w_out = torch.where(keep, w, w_old)
    if x_old is None:
        return y_out, w_out
    return y_out, w_out, torch.where(keep, x, x_old)


def prox_consensus_ref(z_tilde, w_sum, rho_sum, gamma: float,
                       l1: float, clip: float):
    """Fused eq. (13) with h = l1*|.|_1 + box(clip).
    z_tilde, w_sum: (M, d); rho_sum: (M, 1)."""
    mu = gamma + rho_sum
    v = (gamma * z_tilde + w_sum) / mu
    if l1 > 0:
        v = torch.sign(v) * torch.clamp_min(torch.abs(v) - l1 / mu, 0.0)
    if clip > 0:
        v = torch.clamp(v, -clip, clip)
    return v


def server_prox_update_ref(z_cur, w_cache, edge, rho_sum, gamma: float,
                           l1: float, clip: float):
    """Edge-masked worker reduction + eq. (13) in one op.

    z_cur: (M, d); w_cache: (N, M, d); edge: (N, M) bool; rho_sum: (M,)."""
    w_sum = torch.sum(torch.where(edge[..., None], w_cache, 0.0), dim=0)
    return prox_consensus_ref(z_cur, w_sum, rho_sum.reshape(-1, 1),
                              gamma, l1, clip)


def logreg_margin_ref(X, y, w):
    """v = -y * sigmoid(-y * (X @ w)) — per-sample dloss/dmargin."""
    s = X @ w
    return -y * torch.sigmoid(-y * s)


def logreg_grad_ref(X, y, w):
    """grad of mean_i log(1+exp(-y_i x_i.w)) wrt w (eq. 22 smooth part)."""
    m = X.shape[0]
    v = logreg_margin_ref(X, y, w)
    return (X.T @ v) / m
