"""The port's MLA (``repro_torch.models.attention``'s ``_mla_q``,
``_mla_latent``, ``mla_forward``, ``mla_decode``, ``mla_cache_spec``)
against the reference's, on minicpm3-4b's smoke config: one layer's
attention weights drawn by the reference (``init_attention``, threefry)
and carried across as numpy, the same seeded inputs through both.

Tolerance: 1e-5 of max|reference output| (the port's parity
tolerance). The decode is the absorbed path over the latent cache in
both packages, held against the reference's decode; the decode against
the port's own prefill at the reference's 5e-4
(``tests/test_decode_consistency.py``). Measured here: the
projections within 2.1e-7 of max|out|, the prefill 6.6e-7 (S = 40),
the decode 6.1e-7, decode against prefill 4.1e-7.
The full model's prefill, decode, loss and gradient ride in the shared
tests (``test_torch_models.py``, ``test_torch_model_loss.py``,
``test_torch_serving.py``), its block layout at full width in
``test_torch_encdec.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import attention as rattn
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import build_model, params_from_numpy

ARCH = "minicpm3-4b"
PARITY = 1e-5


def _layer(seed=0):
    """(reference cfg, its attention params, port cfg, the same as
    tensors)."""
    rcfg = ref_smoke(ARCH)
    rp = rattn.init_attention(jax.random.PRNGKey(seed), rcfg)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in rp.items()}
    return rcfg, rp, get_smoke(ARCH), tp


def _x(cfg, B=2, S=13, seed=1):
    x = np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    return (jnp.asarray(x), jnp.asarray(pos, jnp.int32), torch.as_tensor(x),
            torch.as_tensor(pos.copy()))


def _close(out, ref, tol=PARITY):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, np.abs(ref).max())


def test_cross_attention_init_is_gqa_under_mla():
    """``init_attention(cross=True)`` draws GQA weights even on an MLA
    config, as the reference's does (the model tests hold the MLA
    tree's names and shapes)."""
    rcfg, cfg = ref_smoke(ARCH), get_smoke(ARCH)
    cross = attn.init_attention(torch.Generator().manual_seed(0), cfg,
                                cross=True)
    assert {k: tuple(v.shape) for k, v in cross.items()} == {
        k: v.shape for k, v in rattn.init_attention(
            jax.random.PRNGKey(0), rcfg, cross=True).items()}
    assert "w_q" in cross and "w_uk" not in cross


@pytest.mark.parametrize("part", ["_mla_q", "_mla_latent"])
def test_projections_match_reference(part):
    """The query (its rope half rotated in full: MLA takes no
    ``rope_fraction``) and the latent (the one shared rope head roped
    as (B, S, 1, r) and squeezed)."""
    rcfg, rp, cfg, tp = _layer()
    rx, rpos, x, pos = _x(cfg)
    ref = getattr(rattn, part)(rp, rx, rcfg, rpos)
    out = getattr(attn, part)(tp, x, cfg, pos)
    for a, b in zip(out, ref):
        _close(a, b)


def test_scale_is_the_reference_float32_value():
    for cfg in (get_smoke(ARCH), get_config(ARCH)):
        m = cfg.mla
        ref = 1.0 / jnp.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        assert attn._mla_scale(m) == float(ref)


@pytest.mark.parametrize("S", [1, 13, 40])
def test_mla_forward_matches_reference(S):
    rcfg, rp, cfg, tp = _layer()
    rx, rpos, x, pos = _x(cfg, S=S)
    _close(attn.mla_forward(tp, x, cfg, pos),
           jax.jit(rattn.mla_forward, static_argnums=2)(rp, rx, rcfg, rpos))


def test_mla_forward_gradient_matches_reference():
    """The in-place scale and mask of the scores are steps autograd
    differentiates: the gradient of a scalar of the output against
    ``jax.grad``'s, for every weight and the input."""
    rcfg, rp, cfg, tp = _layer()
    rx, rpos, x, pos = _x(cfg)
    w = np.random.RandomState(7).randn(2, 13, cfg.d_model).astype(
        np.float32)

    def rloss(p, xx):
        return jnp.sum(rattn.mla_forward(p, xx, rcfg, rpos) * w)

    rg = jax.jit(jax.grad(rloss, argnums=(0, 1)))(rp, rx)
    g = torch.func.grad(lambda p, xx: torch.sum(
        attn.mla_forward(p, xx, cfg, pos) * torch.as_tensor(w)),
        argnums=(0, 1))(tp, x)
    for name in rp:
        _close(g[0][name], rg[0][name])
    _close(g[1], rg[1])


def test_mla_decode_matches_reference():
    """10 absorbed decode steps into a cache of 12 (the reference's
    scores q_abs . c_kv, with q_abs = q_nope W_uk, W_uk as (rank, nq,
    nope)), then 3 past its end, where both write the last slot: each
    step's output and the whole cache at the end."""
    rcfg, rp, cfg, tp = _layer()
    B, T, steps = 2, 12, 15
    rx, _, x, _ = _x(cfg, B=B, S=steps)
    specs = attn.mla_cache_spec(cfg, B, T)
    rspecs = rattn.mla_cache_spec(rcfg, B, T)
    assert {k: s for k, (s, _) in specs.items()} == \
        {k: s.shape for k, s in rspecs.items()}
    cache = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in specs.items()}
    rcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in rspecs.items()}
    rdecode = jax.jit(rattn.mla_decode, static_argnums=2)
    for t in range(steps):
        ref, rcache = rdecode(rp, rx[:, t:t + 1], rcfg, rcache, jnp.int32(t))
        out, new = attn.mla_decode(tp, x[:, t:t + 1], cfg, cache, t)
        assert new["c_kv"] is cache["c_kv"]          # written in place
        _close(out, ref)
    for name in cache:
        _close(cache[name], rcache[name])


def test_mla_decode_matches_own_prefill():
    """The absorbed decode, token by token, against the materialized
    prefill of the same layer (the reference's 5e-4 of
    ``tests/test_decode_consistency.py``, relative to max|out| here)."""
    _, _, cfg, tp = _layer()
    _, _, x, pos = _x(cfg)
    full = attn.mla_forward(tp, x, cfg, pos)
    cache = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in
             attn.mla_cache_spec(cfg, 2, 16).items()}
    steps = [attn.mla_decode(tp, x[:, t:t + 1], cfg, cache, t)[0]
             for t in range(x.shape[1])]
    err = float((torch.cat(steps, dim=1) - full).abs().max())
    assert err <= 5e-4 * float(full.abs().max())


def test_flash_impl_reaches_no_kernel_and_changes_nothing():
    """MLA materializes its scores whatever ``attn_impl`` says, as the
    reference's ``mla_forward`` does: under ``flash`` the prefill
    launches nothing and its logits are the naive path's bit for bit."""
    rcfg = ref_smoke(ARCH)
    from repro.models import build_model as ref_build
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke(ARCH)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    tok = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 20)))
    naive = build_model(cfg).prefill(params, tok)
    ops.reset_launch_counts()
    flash = build_model(cfg.with_(attn_impl="flash")).prefill(params, tok)
    assert not any(ops.launch_counts().values())
    assert torch.equal(naive, flash)
