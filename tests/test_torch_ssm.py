"""The port's SSM layer (``repro_torch.models.ssm``) and the SSM and
hybrid families of its model stack against the reference's
(``repro.models.ssm``, ``repro.models.transformer``): ``ssd_chunked``
(S a multiple of the chunk, not a multiple, below it; with and without
an initial state; its gradient), ``_causal_conv`` with and without a
state, ``mamba2_forward`` with its cache carried across a split
prefill, ``mamba2_decode`` steps, the ``init_mamba2`` tree, the gated
RMSNorm, and a hybrid whose layers do not fill its last group (a ``rem``
tail: 3 layers, the shared block after every 2).

Inputs come from numpy seeds; the reference's weights cross as numpy
arrays. Tolerances: outputs and states within 1e-5 of max|reference|
(the port's parity tolerance), losses within 1e-6 relative, gradients
within 1e-5 (1 + max|g|), the port's decode against its own prefill
within the reference's 5e-4 (``tests/test_decode_consistency.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_leaves
from repro_torch.models import (build_model, params_from_numpy,
                                stacked_from_numpy, stacked_params)
from repro_torch.models import ssm
from repro_torch.models.layers import rmsnorm_gated

PARITY = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
DECODE_TOL = 5e-4
ARCHS = ["mamba2-370m", "zamba2-1.2b"]
# a hybrid whose 3 layers leave a tail of 1 after the one group of 2
REM = dict(num_layers=3, hybrid_attn_every=2)


# the reference jitted (its eager dispatch dominates these small shapes)
REF_SSD = jax.jit(ref_ssm.ssd_chunked, static_argnums=5)
REF_CONV = jax.jit(ref_ssm._causal_conv, static_argnums=2)
REF_FORWARD = jax.jit(ref_ssm.mamba2_forward, static_argnums=2,
                      static_argnames="return_cache")
REF_DECODE = jax.jit(ref_ssm.mamba2_decode, static_argnums=2)


def _close(out, ref, tol=PARITY):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, np.abs(ref).max())


def _grad_close(g, rg):
    g = g.numpy() if isinstance(g, torch.Tensor) else g
    rg = np.asarray(rg)
    assert np.isfinite(g).all()
    err = float(np.abs(g - rg).max())
    assert err <= GRAD_TOL * (1.0 + float(np.abs(rg).max())), err


def _ssd_inputs(b, l, h, p, n, seed=0, state=False):
    """The SSD scan's inputs as the layer makes them: dt from a softplus
    (positive), A = -exp(A_log) (negative)."""
    r = np.random.RandomState(seed)
    x = r.randn(b, l, h, p).astype(np.float32)
    dt = np.log1p(np.exp(r.randn(b, l, h) - 1.0)).astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    B = r.randn(b, l, n).astype(np.float32)
    C = r.randn(b, l, n).astype(np.float32)
    s0 = r.randn(b, h, n, p).astype(np.float32) if state else None
    return x, dt, A, B, C, s0


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("l,chunk", [(64, 16), (40, 16), (11, 16)],
                         ids=["multiple", "ragged", "below"])
def test_ssd_chunked_matches_reference(l, chunk, state):
    args = _ssd_inputs(2, l, 4, 8, 6, state=state)
    ry, rs = REF_SSD(*map(_j, args[:5]), chunk, _j(args[5]))
    y, s = ssm.ssd_chunked(*map(_t, args[:5]), chunk, _t(args[5]))
    assert y.dtype == s.dtype == torch.float32
    _close(y, ry)
    _close(s, rs)


def test_ssd_pads_neither_decay_nor_feed_the_state():
    """40 positions in chunks of 16 (8 pads) give the state and outputs
    of chunks of 8 (no pad) and of one sequential recurrence."""
    x, dt, A, B, C, _ = map(_t, _ssd_inputs(1, 40, 3, 4, 5, seed=3))
    y16, s16 = ssm.ssd_chunked(x, dt, A, B, C, 16)
    y8, s8 = ssm.ssd_chunked(x, dt, A, B, C, 8)
    state = torch.zeros((1, 3, 5, 4), dtype=torch.float64)
    ys = []
    for t in range(40):
        dA = torch.exp(dt[:, t].double() * A.double())
        dtx = x[:, t].double() * dt[:, t, :, None].double()
        state = state * dA[:, :, None, None] + \
            B[:, t, None, :, None].double() * dtx[:, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t].double(), state))
    seq = torch.stack(ys, 1)
    for y, s in ((y16, s16), (y8, s8)):
        _close(y, seq.numpy())
        _close(s, state.numpy())


@pytest.mark.parametrize("l", [40, 11])
def test_ssd_gradient_matches_jax_and_is_finite(l):
    """The gradient of a weighted sum of y and the final state, with
    respect to every input: the mask applied before the exp keeps the
    masked exponents' cotangents 0, not inf * 0."""
    args = _ssd_inputs(2, l, 4, 8, 6, seed=1, state=True)
    r = np.random.RandomState(2)
    wy = r.randn(2, l, 4, 8).astype(np.float32)
    ws = r.randn(2, 4, 6, 8).astype(np.float32)

    def rloss(*a):
        y, s = ref_ssm.ssd_chunked(*a[:5], 16, a[5])
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    def loss(*a):
        y, s = ssm.ssd_chunked(*a[:5], 16, a[5])
        return torch.sum(y * torch.as_tensor(wy)) + \
            torch.sum(s * torch.as_tensor(ws))

    rgrads = jax.jit(jax.grad(rloss, argnums=tuple(range(6))))(
        *map(_j, args))
    grads = torch.func.grad(loss, argnums=tuple(range(6)))(*map(_t, args))
    for g, rg in zip(grads, rgrads):
        _grad_close(g, rg)


def _layer(arch="mamba2-370m", seed=0, **overrides):
    """(reference config, port config, the reference's init_mamba2
    draws as numpy arrays, the same as tensors)."""
    rcfg = ref_smoke(arch).with_(**overrides)
    cfg = get_smoke(arch).with_(**overrides)
    rp = jax.tree.map(np.asarray,
                      ref_ssm.init_mamba2(jax.random.PRNGKey(seed), rcfg))
    return rcfg, cfg, rp, {k: torch.as_tensor(np.array(v))
                           for k, v in rp.items()}


def _u(cfg, B=2, L=24, seed=1):
    return np.random.RandomState(seed).randn(B, L, cfg.d_model).astype(
        np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rcfg, cfg, rp, p = _layer()
    conv_dim = ssm._dims(cfg)[2]
    r = np.random.RandomState(4)
    xbc = r.randn(2, 9, conv_dim).astype(np.float32)
    state = r.randn(2, cfg.ssm.conv_width - 1, conv_dim).astype(
        np.float32) if with_state else None
    rout, rstate = REF_CONV(rp, jnp.asarray(xbc), rcfg, _j(state))
    out, new_state = ssm._causal_conv(p, torch.as_tensor(xbc), cfg,
                                      _t(state))
    _close(out, rout)
    np.testing.assert_array_equal(new_state.numpy(), np.asarray(rstate))


def test_init_mamba2_has_the_reference_tree():
    rcfg, cfg, rp, _ = _layer()
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_mamba2(gen, cfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == \
        {k: (v.shape, torch.float32) for k, v in rp.items()}
    for name in ("conv_b", "A_log", "D", "dt_bias", "norm_w"):
        np.testing.assert_allclose(p[name].numpy(), rp[name], rtol=1e-6)
    # the draws: N(0, 1/d) for w_in, N(0, 1/d_inner) for w_out, N(0, 0.01)
    # for conv_w
    d_inner = ssm._dims(cfg)[0]
    for name, std in (("w_in", cfg.d_model ** -0.5),
                      ("w_out", d_inner ** -0.5), ("conv_w", 0.1)):
        assert abs(float(p[name].std()) / std - 1.0) < 0.1, name
    again = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_rmsnorm_gated_matches_reference():
    r = np.random.RandomState(5)
    x, gate = r.randn(2, 7, 64).astype(np.float32), \
        r.randn(2, 7, 64).astype(np.float32)
    w = (1.0 + 0.1 * r.randn(64)).astype(np.float32)
    _close(rmsnorm_gated(torch.as_tensor(x), torch.as_tensor(w),
                         torch.as_tensor(gate), 1e-5),
           ref_layers.rmsnorm_gated(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(gate), 1e-5))


@pytest.mark.parametrize("L", [24, 13])
def test_mamba2_forward_matches_reference(L):
    rcfg, cfg, rp, p = _layer()
    u = _u(cfg, L=L)
    rout, rcache = REF_FORWARD(rp, jnp.asarray(u), rcfg, return_cache=True)
    out, cache = ssm.mamba2_forward(p, torch.as_tensor(u), cfg,
                                    return_cache=True)
    _close(out, rout)
    for name in ("conv", "ssm"):
        _close(cache[name], rcache[name])
    assert cache["ssm"].dtype == torch.float32


def test_split_prefill_with_the_cache_carried_equals_the_whole():
    """Positions 0-16 then 17-39 (the second part starting inside a
    chunk), the first's conv and SSM states carried: the outputs and
    final states of the whole prefill, in both packages."""
    rcfg, cfg, rp, p = _layer()
    u = torch.as_tensor(_u(cfg, L=40))
    whole, wcache = ssm.mamba2_forward(p, u, cfg, return_cache=True)
    a, acache = ssm.mamba2_forward(p, u[:, :17], cfg, return_cache=True)
    b, bcache = ssm.mamba2_forward(p, u[:, 17:], cfg, return_cache=True,
                                   init_cache=acache)
    _close(torch.cat([a, b], 1), whole.numpy())
    for name in ("conv", "ssm"):
        _close(bcache[name], wcache[name].numpy())
    _, racache = REF_FORWARD(rp, jnp.asarray(u[:, :17].numpy()), rcfg,
                              return_cache=True)
    rb = REF_FORWARD(rp, jnp.asarray(u[:, 17:].numpy()), rcfg,
                     init_cache=racache)
    _close(b, rb)


def test_mamba2_decode_steps_match_reference():
    """10 one-token steps from a prefilled cache: outputs at every step,
    the cache written in place (the same tensors come back)."""
    rcfg, cfg, rp, p = _layer()
    u = _u(cfg, L=18)
    _, rcache = REF_FORWARD(rp, jnp.asarray(u[:, :8]), rcfg,
                            return_cache=True)
    _, cache = ssm.mamba2_forward(p, torch.as_tensor(u[:, :8]), cfg,
                                  return_cache=True)
    cache = {k: v.clone() for k, v in cache.items()}
    slots = dict(cache)
    for t in range(8, 18):
        ry, rcache = REF_DECODE(rp, jnp.asarray(u[:, t:t + 1]), rcfg,
                                rcache)
        y, cache = ssm.mamba2_decode(p, torch.as_tensor(u[:, t:t + 1]),
                                     cfg, cache)
        assert all(cache[k] is slots[k] for k in slots)
        _close(y, ry)
        for name in ("conv", "ssm"):
            _close(cache[name], rcache[name])


# ---------------------------------------------------------------------------
# the hybrid with a tail, through the model stack
# ---------------------------------------------------------------------------

def _pair(arch="zamba2-1.2b", **overrides):
    rmodel = ref_build(ref_smoke(arch).with_(**overrides))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(arch).with_(**overrides))
    return rmodel, rparams, model, jax.tree.map(np.asarray, rparams)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_hybrid_with_a_tail_prefill_matches_reference(attn_impl):
    rmodel, rparams, model, tree = _pair(**REM, attn_impl=attn_impl)
    params = params_from_numpy(model.cfg, tree, "cpu")
    tok = np.random.RandomState(1).randint(0, 512, (2, 40))
    _close(model.prefill(params, torch.as_tensor(tok)),
           jax.jit(rmodel.prefill)(rparams, jnp.asarray(tok)))


def test_hybrid_with_a_tail_decode_matches_reference_and_prefill():
    """12 decode steps: logits and every cache tensor against the
    reference's (the shared block's one application cached once, the
    tail layer's SSM state too), and against the port's own prefill."""
    rmodel, rparams, model, tree = _pair(**REM)
    params = params_from_numpy(model.cfg, tree, "cpu")
    B, S = 2, 12
    tok = np.random.RandomState(2).randint(0, 512, (B, S))
    specs = model.cache_specs(B, S + 4)
    rspecs = rmodel.cache_specs(B, S + 4)
    assert {part: {k: v[0] for k, v in spec.items()}
            for part, spec in specs.items()} == \
        {part: {k: v.shape for k, v in spec.items()}
         for part, spec in rspecs.items()}
    assert specs["shared_attn"]["k"][0][0] == 1
    rcache = rmodel.init_cache(B, S + 4)
    cache = model.init_cache(B, S + 4, "cpu")
    full = model.prefill(params, torch.as_tensor(tok))
    rdecode = jax.jit(rmodel.decode_step)
    for t in range(S):
        rlg, rcache = rdecode(rparams, jnp.asarray(tok[:, t:t + 1]), rcache,
                              jnp.int32(t))
        lg, cache = model.decode_step(params, torch.as_tensor(
            tok[:, t:t + 1]), cache, t)
        _close(lg, rlg)
        assert float((lg[:, 0] - full[:, t]).abs().max()) < DECODE_TOL
    for part in ("layers", "shared_attn"):
        for name, t in cache[part].items():
            _close(t, rcache[part][name])


def test_hybrid_with_a_tail_loss_and_grads_match_reference():
    rmodel, rparams, model, tree = _pair(**REM)
    params = stacked_from_numpy(model.cfg, tree, "cpu")
    r = np.random.RandomState(3)
    tok = r.randint(0, 512, (2, 25))
    rb = {"tokens": jnp.asarray(tok[:, :-1]),
          "labels": jnp.asarray(tok[:, 1:])}
    tb = {"tokens": torch.as_tensor(tok[:, :-1]),
          "labels": torch.as_tensor(tok[:, 1:])}
    rloss, rgrad = jax.jit(jax.value_and_grad(rmodel.loss))(rparams, rb)
    np.testing.assert_allclose(float(model.loss(params, tb)), float(rloss),
                               rtol=LOSS_TOL)
    for g, rg in zip(tree_leaves(model.grad_fn()(params, tb)),
                     jax.tree.leaves(rgrad)):
        _grad_close(g, rg)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_is_constant_in_max_len(arch):
    """The SSM layers' decode state does not grow with max_len (the
    hybrid's shared-block K/V cache does); the conv state takes the
    compute dtype, the SSM state float32 in every dtype."""
    cfg = get_smoke(arch).with_(dtype="bfloat16")
    model = build_model(cfg)
    a, b = model.cache_specs(3, 64), model.cache_specs(3, 4096)
    assert a["layers"] == b["layers"]
    assert a["layers"]["conv"][1] == torch.bfloat16
    assert a["layers"]["ssm"][1] == torch.float32
    if cfg.arch_type == "hybrid":
        assert b["shared_attn"]["k"][0][2] == 4096
    else:
        assert set(a) == {"layers"}


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_params_are_model_init_stacked(arch):
    """``stacked_params`` holds ``Model.init``'s draws (the hybrid's
    shared block drawn after the layers, as ``init`` draws it), and
    ``shared_attn`` is not stacked."""
    cfg = get_smoke(arch).with_(**(REM if arch == "zamba2-1.2b" else {}))
    stacked = stacked_params(cfg, 3, "cpu")
    per_layer = build_model(cfg).init(3, "cpu")
    for i in range(cfg.num_layers):
        for name, value in stacked["layers"]["mamba"].items():
            assert torch.equal(value[i],
                               per_layer["layers"][i]["mamba"][name]), name
    if cfg.arch_type == "hybrid":
        for (n, a), (_, b) in zip(
                sorted(per_layer["shared_attn"].named_parameters()),
                sorted((k, v) for k, v in _named(stacked["shared_attn"]))):
            assert torch.equal(a, b), n
        assert stacked["shared_attn"]["attn"]["w_q"].dim() == 2


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_ssm_loss_under_vmap_matches_per_worker_losses():
    """``vmap(grad_and_value(loss))`` over a leading worker axis, as
    ``TreeSpace.worker_grads`` calls it: each worker's loss and gradient
    equal those taken on its own (the chunk scan's loop and the padded
    tail under vmap)."""
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    cfg = get_smoke("mamba2-370m")
    model = build_model(cfg)
    per = [stacked_params(cfg, seed, "cpu") for seed in (0, 1)]
    leaves, treedef = tree_flatten(per[0])
    both = tree_unflatten(treedef, [torch.stack(pair) for pair in zip(
        leaves, tree_leaves(per[1]))])
    tok = torch.as_tensor(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 2, 21)))
    batch = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
    g, losses = torch.func.vmap(torch.func.grad_and_value(model.loss))(
        both, batch)
    for i in range(2):
        b = {k: v[i] for k, v in batch.items()}
        torch.testing.assert_close(losses[i], model.loss(per[i], b),
                                   rtol=1e-6, atol=0)
        for a, ref in zip(tree_leaves(g), tree_leaves(
                model.grad_fn()(per[i], b))):
            assert bool(torch.isfinite(a).all())
            torch.testing.assert_close(a[i], ref, rtol=1e-5, atol=1e-6)
