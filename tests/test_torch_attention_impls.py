"""The port's ``chunked`` and ``qchunk`` attention impls against the
reference's (``repro/models/attention.py::_sdpa_chunked`` /
``_sdpa_qchunk``):

* the functions on numpy-seeded inputs: causal and not, a sliding
  window, GQA groups 1, 2 and 4, S a multiple of the chunk, not a
  multiple, and less than it;
* their gradients against ``jax.grad`` (a seeded cotangent);
* ``Model.prefill`` under each impl on the qwen3, mixtral (its window
  passed), zamba2 (the shared block) and whisper (frames through the
  bidirectional encoder, whose padded keys ``chunked`` masks) smokes,
  the reference's weights carried across;
* ``Model.loss`` and its gradient under each impl on the qwen3 smoke,
  through ``torch.func.vmap(grad)``, as the ADMM trainer takes it.

Tolerance: 1e-5 * (1 + max|reference|), the port's parity tolerance.
Measured: the functions within 1.2e-7, their gradients within 2.1e-7,
the prefills within 9.3e-7, the losses and their gradients within
2.6e-7 of (1 + max|reference|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import attention as rattn
from repro.models import build_model as ref_build
from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import (attention, build_model, params_from_numpy,
                                stacked_from_numpy)

PARITY = 1e-5
IMPLS = ("chunked", "qchunk")
CHUNK = 8
# (B, S, nq, nkv, hd, causal, window): groups 1, 2, 4; S = 16 a multiple
# of the chunk, 13 not, 5 less than it
CASES = [(2, 16, 2, 2, 16, True, None), (1, 13, 4, 2, 16, True, None),
         (2, 5, 4, 1, 8, True, None), (1, 13, 4, 2, 16, False, None),
         (2, 5, 2, 2, 8, False, None), (1, 21, 4, 2, 8, True, 4),
         (1, 16, 8, 2, 8, False, 6)]


def _close(out, ref, tol=PARITY):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * (1.0 + float(np.abs(ref).max())), err


def _qkv(B, S, nq, nkv, hd, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, S, nq, hd).astype(np.float32),
            r.randn(B, S, nkv, hd).astype(np.float32),
            r.randn(B, S, nkv, hd).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("impl", IMPLS)
def test_sdpa_impl_matches_reference(impl, case):
    B, S, nq, nkv, hd, causal, window = case
    q, k, v = _qkv(B, S, nq, nkv, hd)
    kw = dict(causal=causal, window=window, chunk=CHUNK)
    ref = getattr(rattn, f"_sdpa_{impl}")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nq, nkv, **kw)
    out = getattr(attention, f"_sdpa_{impl}")(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), nq, nkv,
        **kw)
    assert out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("case", [CASES[1], CASES[6]], ids=str)
@pytest.mark.parametrize("impl", IMPLS)
def test_sdpa_impl_gradient_matches_jax_grad(impl, case):
    B, S, nq, nkv, hd, causal, window = case
    q, k, v = _qkv(B, S, nq, nkv, hd, seed=3)
    ct = np.random.RandomState(4).randn(B, S, nq * hd).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=CHUNK)
    rfn = getattr(rattn, f"_sdpa_{impl}")
    rgrads = jax.grad(lambda a, b, c: jnp.sum(
        rfn(a, b, c, nq, nkv, **kw) * ct), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    fn = getattr(attention, f"_sdpa_{impl}")
    grads = torch.func.grad(lambda a, b, c: torch.sum(
        fn(a, b, c, nq, nkv, **kw) * torch.as_tensor(ct)), argnums=(0, 1, 2))(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v))
    for g, rg in zip(grads, rgrads):
        _close(g, rg)


def _frames(cfg, B, T, seed=2):
    return (np.random.RandomState(seed).randn(B, T, cfg.d_model)
            * 0.1).astype(np.float32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b",
                                  "zamba2-1.2b", "whisper-medium"])
def test_prefill_under_impl_matches_reference(arch, impl):
    """40 tokens (past mixtral's 32-token window), chunks of 16: the
    last tile ragged; whisper's 20 frames pad the encoder's keys to 32."""
    kw = dict(attn_impl=impl, attn_chunk=16)
    rmodel = ref_build(ref_smoke(arch).with_(**kw))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(arch).with_(**kw))
    params = params_from_numpy(model.cfg, jax.tree.map(np.asarray, rparams),
                               "cpu")
    tok = np.random.RandomState(1).randint(0, model.cfg.vocab_size, (2, 40))
    enc = _frames(model.cfg, 2, 20) if model.cfg.is_enc_dec else None
    ref = rmodel.prefill(rparams, jnp.asarray(tok), enc_frames=None
                         if enc is None else jnp.asarray(enc))
    out = model.prefill(params, torch.as_tensor(tok), enc_frames=None
                        if enc is None else torch.as_tensor(enc))
    _close(out, ref)


def _loss_pair(impl):
    kw = dict(attn_impl=impl, attn_chunk=8)
    rmodel = ref_build(ref_smoke("qwen3-1.7b").with_(**kw))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke("qwen3-1.7b").with_(**kw))
    params = stacked_from_numpy(model.cfg, jax.tree.map(np.asarray, rparams),
                                "cpu")
    return rmodel, rparams, model, params


def _batch(cfg, lead=(), seed=1):
    tok = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                              lead + (2, 21))
    return {"tokens": tok[..., :-1], "labels": tok[..., 1:]}


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_gradient_under_impl_match_reference(impl):
    """``Model.loss`` and its gradient on two workers' batches through
    ``vmap(grad_and_value)``, as ``TreeSpace.worker_grads`` (the ADMM
    trainer) differentiates it: each worker's loss and gradient the
    reference's on its own batch."""
    rmodel, rparams, model, params = _loss_pair(impl)
    batch = _batch(model.cfg, lead=(2,), seed=5)
    tree = tree_map(lambda t: t.expand((2,) + tuple(t.shape)), params)
    grads, losses = torch.func.vmap(torch.func.grad_and_value(model.loss))(
        tree, {k: torch.as_tensor(v) for k, v in batch.items()})
    rlosses, rgrads = jax.vmap(jax.value_and_grad(rmodel.loss),
                               in_axes=(None, 0))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(losses, rlosses, tol=1e-6)
    for g, rg in zip(tree_leaves(grads), jax.tree.leaves(rgrads)):
        _close(g, rg)
