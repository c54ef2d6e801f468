"""Proximal operators for the regularizer h(z) = sum_j h_j(z_j).

The paper's experiment uses h(z) = lambda*||z||_1 with the box constraint
||z||_inf <= C (eq. 22); prox_h^mu under a box is soft-threshold followed
by clipping (both separable, so the composition is exact).

``make_prox`` builds the (prox, h_value) pair consumed by the server
update (eq. 13) and the stationarity metric (eqs. 14-15). NaN passes
through every operator here, as it does through ``jnp.maximum`` and
``jnp.clip`` in the reference, so the divergence watchdog still sees it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


def soft_threshold(v, thresh):
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - thresh, 0.0)


def prox_l1(v, lam, mu):
    """argmin_u lam*|u|_1 + mu/2 ||v-u||^2  = soft_threshold(v, lam/mu)."""
    return soft_threshold(v, lam / mu)


def prox_box(v, clip):
    return torch.clamp(v, -clip, clip)


def prox_l2(v, lam, mu):
    """h = lam/2 ||u||^2 -> shrink by mu/(mu+lam)."""
    return v * (mu / (mu + lam))


def prox_group_lasso(v, lam, mu, group_size: int):
    """h = lam * sum_g ||u_g||_2 over contiguous groups."""
    d = v.shape[-1]
    vp = F.pad(v, (0, (-d) % group_size))
    g = vp.reshape(vp.shape[:-1] + (-1, group_size))
    norms = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    scale = torch.clamp_min(1.0 - (lam / mu) / torch.clamp_min(norms, 1e-12),
                            0.0)
    return (g * scale).reshape(vp.shape)[..., :d]


class Regularizer(NamedTuple):
    """h(z) and its prox. ``prox(v, mu)`` solves
    argmin_u h(u) + mu/2 ||v - u||^2 subject to the box constraint.

    ``fusable`` marks the prox as belonging to the l1+box family the
    fused server kernel implements natively; anything else (l2
    shrinkage, group lasso, custom callables) keeps the server step on
    the plain torch path.
    """
    prox: Callable
    value: Callable
    l1_coef: float
    clip: Optional[float]
    fusable: bool = False


def make_prox(l1_coef: float = 0.0, clip: Optional[float] = None,
              l2_coef: float = 0.0) -> Regularizer:
    def prox(v, mu):
        u = v
        if l2_coef > 0.0:
            u = prox_l2(u, l2_coef, mu)
        if l1_coef > 0.0:
            u = prox_l1(u, l1_coef, mu)
        if clip is not None:
            u = prox_box(u, clip)
        return u

    def value(z):
        h = torch.zeros((), dtype=torch.float32, device=z.device)
        if l1_coef > 0.0:
            h = h + l1_coef * torch.sum(torch.abs(z))
        if l2_coef > 0.0:
            h = h + 0.5 * l2_coef * torch.sum(torch.square(z))
        return h

    # clip=0.0 means the degenerate box {0} here, but the kernel's
    # clip-parameter encodes 0.0 as "no box" — keep that case off the kernel
    return Regularizer(prox=prox, value=value, l1_coef=l1_coef, clip=clip,
                       fusable=(l2_coef == 0.0
                                and (clip is None or clip > 0.0)))
