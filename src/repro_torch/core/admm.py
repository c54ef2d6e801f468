"""AsyBADMM update equations (paper §3) as pure functions on tensors.

Key identity exploited throughout (appendix eq. 25): after worker i
updates block j at epoch t,

    y_ij^{t+1} = -grad_j f_i(z~^t)

so (11)+(12)+(9) collapse to one fused elementwise pass:

    x^{t+1} = z~ - (g + y)/rho
    y^{t+1} = -g
    w^{t+1} = rho*x^{t+1} + y^{t+1} = rho*z~ - 2g - y

The functions here keep the reference's unfused form (``y + rho*(x -
z~)``, equal to ``-g`` up to rounding), which is what the ``torch``
backend computes; the CUDA kernel writes ``-g`` as the reference's
Pallas kernel does.
"""
from __future__ import annotations

from typing import Tuple


def worker_update(g, y, z_tilde, rho):
    """Eqs. (11), (12), (9). Returns (x_new, y_new, w_new)."""
    x_new = z_tilde - (g + y) / rho
    y_new = y + rho * (x_new - z_tilde)          # == -g
    w_new = rho * x_new + y_new                  # == rho*z_tilde - 2g - y
    return x_new, y_new, w_new


def server_update(z_tilde, w_sum, rho_sum, gamma, prox):
    """Eq. (13): z <- prox_h^mu((gamma*z~ + sum_i w~_ij) / (gamma + sum rho_i))
    with mu = gamma + rho_sum."""
    mu = gamma + rho_sum
    v = (gamma * z_tilde + w_sum) / mu
    return prox(v, mu)


def theorem1_feasible(rho: float, gamma: float, L: float, T_delay: int,
                      n_workers_per_block: int, n_blocks_per_worker: int
                      ) -> Tuple[bool, float, float]:
    """Check the Theorem 1 hyper-parameter conditions (17)/(18) for the
    homogeneous case (rho_i = rho, L_ij = L, T_ij = T).  Returns
    (feasible, alpha, beta)."""
    Nj = n_workers_per_block
    alpha = (gamma + rho
             - Nj * (0.5 + 1.0 / rho) * (L ** 2) * (T_delay + 1) ** 2
             - Nj * (4 * L + rho + 1) * (T_delay ** 2) / 2.0)
    beta = (rho - 4 * L) / (2 * max(n_blocks_per_worker, 1))
    return bool(alpha > 0 and beta > 0), float(alpha), float(beta)
