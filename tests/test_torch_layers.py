"""The port's layer primitives (``repro_torch.models.layers``) against the
reference's (``repro.models.layers``) on the same seeded numpy inputs,
at 1e-6: the functions are elementwise or short reductions in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as rl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-6, atol=1e-6)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 7, 4, 32)])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rmsnorm_matches_reference(shape, eps):
    x, w = _rand(*shape, seed=1, scale=3.0), _rand(shape[-1], seed=2)
    out = tl.rmsnorm(torch.as_tensor(x), torch.as_tensor(w), eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        rl.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps)), **TOL)


def test_rmsnorm_computes_in_float32_and_casts_back():
    x, w = _rand(4, 64, seed=3), _rand(64, seed=4)
    out = tl.rmsnorm(torch.as_tensor(x).bfloat16(), torch.as_tensor(w))
    assert out.dtype == torch.bfloat16
    ref = rl.rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("theta", [10000.0, 1e6])
@pytest.mark.parametrize("head_dim", [32, 128])
def test_apply_rope_matches_reference(fraction, theta, head_dim):
    """Interleaved pairs (x[0::2], x[1::2]); partial RoPE rotates the
    first int(head_dim * fraction) channels."""
    x = _rand(2, 40, 4, head_dim, seed=5)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    pos[1] += 17
    out = tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta,
                        fraction)
    ref = rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if fraction < 1.0:        # the tail channels pass through untouched
        rot = int(head_dim * fraction)
        np.testing.assert_array_equal(out.numpy()[..., rot:], x[..., rot:])


@pytest.mark.parametrize("head_dim,fraction", [(32, 1.0), (32, 0.5),
                                               (30, 0.5), (128, 0.25)])
def test_rope_freqs_match_reference(head_dim, fraction):
    inv, rot = tl.rope_freqs(head_dim, 10000.0, fraction)
    rinv, rrot = rl.rope_freqs(head_dim, 10000.0, fraction)
    assert rot == rrot
    np.testing.assert_allclose(inv.numpy(), np.asarray(rinv), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    d, ff = 64, 96
    names = ("w_gate", "w_up", "w_down") if act == "swiglu" \
        else ("w_up", "w_down")
    shapes = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    p = {n: _rand(*shapes[n], seed=i, scale=d ** -0.5)
         for i, n in enumerate(names)}
    x = _rand(3, 5, d, seed=9)
    out = tl.mlp({n: torch.as_tensor(a) for n, a in p.items()},
                 torch.as_tensor(x), act)
    ref = rl.mlp({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                 act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("q_len,kv_len,offset,window",
                         [(5, 5, 0, None), (1, 12, 7, None), (4, 9, 5, None),
                          (6, 6, 0, 3), (1, 16, 10, 4)])
def test_causal_mask_matches_reference(q_len, kv_len, offset, window):
    out = tl.causal_mask(q_len, kv_len, offset, window)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(rl.causal_mask(q_len, kv_len, offset,
                                               window)))


def test_cross_entropy_matches_reference():
    logits = _rand(2, 6, 50, seed=11, scale=3.0)
    labels = np.random.RandomState(12).randint(0, 50, (2, 6))
    mask = (np.random.RandomState(13).rand(2, 6) < 0.7).astype(np.float32)
    for m in (None, mask):
        out = tl.cross_entropy(torch.as_tensor(logits), torch.as_tensor(
            labels), None if m is None else torch.as_tensor(m))
        ref = rl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_inits_draw_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 256, 512, torch.float32)
    e = tl.embed_init(gen, 1000, 64, torch.float32)
    assert w.shape == (256, 512) and e.shape == (1000, 64)
    assert abs(float(w.std()) - 256 ** -0.5) < 0.01 * 256 ** -0.5 * 5
    assert abs(float(e.std()) - 0.02) < 0.02 * 0.05
    assert abs(float(w.mean())) < 1e-3 and abs(float(e.mean())) < 1e-3
