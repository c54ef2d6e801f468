"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``): ``moe_forward`` in both dispatches
(``onehot``, ``scatter``), dropless and with drops, its gradient under
``torch.func.grad`` and ``vmap`` against ``jax.grad``.

The weights are the reference's ``init_moe`` draws carried across as
numpy arrays, and the tokens come from a numpy seed. Tolerances: y
within 1e-5 of max|y| (the port's parity tolerance), aux within 1e-6
relative, each gradient within 1e-5 (1 + max|g|).

Routing is discrete: a token whose k-th and (k+1)-th router
probabilities were within the packages' rounding of each other could
pick another expert in each, and the outputs would differ by far more
than the tolerance. Every test asserts the smallest such margin of its
inputs (``MIN_MARGIN``, some 10^4 times the float32 rounding of a
probability); measured: 3.9e-4 at least.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import moe as ref_moe
from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_leaves
from repro_torch.models import moe

ARCHS = ["granite-moe-1b-a400m", "mixtral-8x7b"]
IMPLS = ["onehot", "scatter"]
Y_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-5
MIN_MARGIN = 1e-4


def _configs(arch, **overrides):
    """(reference config, port config) of the smoke, with ``moe`` fields
    from ``overrides["moe"]`` (a dict) and the rest as given."""
    moe_kw = overrides.pop("moe", {})
    rcfg, cfg = ref_smoke(arch), get_smoke(arch)
    rcfg = rcfg.with_(moe=rcfg.moe.__class__(**{
        **rcfg.moe.__dict__, **moe_kw}), **overrides)
    cfg = cfg.with_(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, **moe_kw}),
                    **overrides)
    return rcfg, cfg


def _params(rcfg, seed=0):
    """The reference's ``init_moe`` draws, as numpy arrays."""
    return jax.tree.map(np.asarray,
                        ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg))


def _x(cfg, B=2, S=24, seed=1):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)


def _torch(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _margin(params, x, K):
    """The smallest gap between a token's K-th and (K+1)-th router
    probabilities (float64)."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ \
        params["router"].astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    p = -np.sort(-p, axis=-1)
    return float((p[:, K - 1] - p[:, K]).min())


def _dropped(params, x, cfg):
    """Share of the (token, k) pairs past their expert's capacity."""
    xt = torch.as_tensor(x).reshape(-1, cfg.d_model)
    _, _, top_e = moe.route(_torch(params), xt, cfg)
    flat = top_e.reshape(-1)
    oh = moe.one_hot(flat, cfg.moe.num_experts, torch.int64)
    pos = (torch.cumsum(oh, 0) * oh).sum(-1) - 1
    return float((pos >= moe.capacity(xt.shape[0], cfg)).double().mean())


@pytest.mark.parametrize("capacity_factor", [None, 1.0])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, impl, capacity_factor):
    """The smoke's own capacity factor (4.0: dropless) and 1.0, where
    pairs are dropped."""
    kw = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    rcfg, cfg = _configs(arch, moe=kw, moe_impl=impl)
    params, x = _params(rcfg), _x(cfg)
    assert _margin(params, x, cfg.moe.top_k) > MIN_MARGIN
    dropped = _dropped(params, x, cfg)
    if capacity_factor is None:
        assert dropped == 0.0
    else:
        assert dropped > 0.0
    ry, raux = ref_moe.moe_forward(jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(x), rcfg)
    y, aux = moe.moe_forward(_torch(params), torch.as_tensor(x), cfg)
    ry = np.asarray(ry)
    assert y.shape == ry.shape and y.dtype == torch.float32
    assert float(np.abs(y.numpy() - ry).max()) <= Y_TOL * np.abs(ry).max()
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(raux), rtol=AUX_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatches_agree(arch):
    """onehot and scatter compute the same function, drops included."""
    _, cfg = _configs(arch, moe={"capacity_factor": 1.0})
    params, x = _torch(_params(_configs(arch)[0])), torch.as_tensor(
        _x(cfg, seed=3))
    a, aux_a = moe.moe_forward(params, x, cfg.with_(moe_impl="onehot"))
    b, aux_b = moe.moe_forward(params, x, cfg.with_(moe_impl="scatter"))
    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert float(aux_a) == float(aux_b)


def test_capacity_is_the_reference_expression():
    """max(int(T K / E cf), 4), evaluated in the reference's order."""
    _, cfg = _configs("granite-moe-1b-a400m")
    for T in (1, 2, 5, 48, 1000):
        for cf in (1.0, 1.25, 4.0):
            c = cfg.with_(moe=cfg.moe.__class__(**{
                **cfg.moe.__dict__, "capacity_factor": cf}))
            assert moe.capacity(T, c) == max(int(T * 2 / 4 * cf), 4)


def _scalar_fns(rcfg, cfg, w):
    def ref_f(params, x):
        y, aux = ref_moe.moe_forward(params, x, rcfg)
        return jnp.sum(y * w) + aux

    wt = torch.as_tensor(w)

    def f(params, x):
        y, aux = moe.moe_forward(params, x, cfg)
        return torch.sum(y * wt) + aux
    return ref_f, f


def _grad_close(g, rg):
    for a, b in zip(tree_leaves(g), jax.tree.leaves(rg)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_TOL * (1.0 + float(np.abs(b).max())), err


@pytest.mark.parametrize("capacity_factor", [None, 1.0])
@pytest.mark.parametrize("impl", IMPLS)
def test_grad_and_vmap_match_reference(impl, capacity_factor):
    """The gradient of sum(y * w) + aux in the params and x: under
    ``torch.func.grad`` against ``jax.grad``; under ``vmap(grad)`` over
    two workers' params and tokens (as the trainer calls the loss)
    against each worker's ``jax.grad``."""
    kw = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    rcfg, cfg = _configs("granite-moe-1b-a400m", moe=kw, moe_impl=impl)
    w = np.random.RandomState(5).randn(2, 24, cfg.d_model).astype(np.float32)
    ref_f, f = _scalar_fns(rcfg, cfg, w)
    ref_grad = jax.grad(ref_f, argnums=(0, 1))
    grad = torch.func.grad(f, argnums=(0, 1))
    params = [_params(rcfg, s) for s in (0, 1)]
    xs = [_x(cfg, seed=s) for s in (1, 2)]
    refs = []
    for p, x in zip(params, xs):
        assert _margin(p, x, cfg.moe.top_k) > MIN_MARGIN
        if capacity_factor is not None:
            assert _dropped(p, x, cfg) > 0.0
        refs.append(ref_grad(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
        _grad_close(grad(_torch(p), torch.as_tensor(x)), refs[-1])
    both = {k: torch.stack([torch.as_tensor(p[k]) for p in params])
            for k in params[0]}
    g = torch.func.vmap(grad)(both, torch.as_tensor(np.stack(xs)))
    for i, rg in enumerate(refs):
        _grad_close(({k: v[i] for k, v in g[0].items()}, g[1][i]), rg)


def test_one_hot_batches_under_vmap():
    """The comparison one-hot is ``F.one_hot``'s function, and batches
    under ``vmap``."""
    idx = torch.tensor([[0, 3, 1], [2, 2, 0]])
    out = torch.func.vmap(lambda i: moe.one_hot(i, 4, torch.float32))(idx)
    assert torch.equal(out, torch.nn.functional.one_hot(idx, 4).float())


def test_init_moe_has_the_reference_shapes():
    rcfg, cfg = _configs("mixtral-8x7b")
    ref = _params(rcfg)
    gen = torch.Generator().manual_seed(0)
    ours = moe.init_moe(gen, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in ours.values())
    # the router's scale is 0.02, the experts' 1/sqrt(fan-in)
    assert 0.015 < float(ours["router"].std()) < 0.025
    d, ff = cfg.d_model, cfg.moe.expert_ff
    assert abs(float(ours["w_up"].std()) * d ** 0.5 - 1.0) < 0.05
    assert abs(float(ours["w_down"].std()) * ff ** 0.5 - 1.0) < 0.05
    meta = moe.init_moe(None, cfg, "meta")
    assert all(v.device.type == "meta" for v in meta.values())
