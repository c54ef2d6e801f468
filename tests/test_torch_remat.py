"""``remat=True`` on the stacked tree (``models/transformer.py``'s
``_Remat``) against the reference's ``jax.checkpoint``-ed layer scans,
for every arch's smoke config (the port's seeded stacked tree handed to
the reference as numpy leaves: both packages' trees have the same names
and shapes; numpy-seeded tokens, fp32):

* the loss and every gradient leaf of ``jax.value_and_grad`` with
  ``remat=True``, within 1e-6 relative and 1e-5 (1 + max|g|);
* the port's ``remat=False`` loss and gradient (the recompute reads the
  same inputs, so they agree to rounding);
* ``vmap(grad_and_value)`` over 2 workers, as ``TreeSpace.worker_grads``
  calls the loss: worker 0 (the reference's params and batch) against
  the reference, and both workers against ``remat=False`` under vmap.

Measured (CPU): the loss bitwise ``remat=False``'s on every smoke, the
gradients within 8.4e-7 of it (6.7e-8 on mamba2, 3.0e-8 on whisper);
against the reference within the tolerances of
``tests/test_torch_model_loss.py``.

A second derivative through a checkpointed layer raises (its backward
pulls the cotangent back unrecorded) rather than miss the layer's term.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import build_model as ref_build
from repro_torch.configs import get_smoke, list_archs
from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.models import build_model, stacked_params

LOSS_TOL = 1e-6
GRAD_TOL = 1e-5


def _batch(cfg, seed, lead=()):
    r = np.random.RandomState(seed)
    tok = r.randint(0, cfg.vocab_size, lead + (2, 17))
    batch = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
    if cfg.is_enc_dec:
        batch["enc_frames"] = (r.randn(*lead, 2, cfg.encoder_seq_len,
                                       cfg.d_model) * 0.1).astype(np.float32)
    return batch


def _close(got, want, tol=GRAD_TOL):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        err = float(np.abs(a - b).max())
        assert err <= tol * (1.0 + float(np.abs(b).max())), err


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_remat_loss_and_grads_match_reference(arch):
    rmodel = ref_build(ref_smoke(arch).with_(remat=True))
    cfg = get_smoke(arch)
    remat, plain = (build_model(cfg.with_(remat=flag))
                    for flag in (True, False))
    params = stacked_params(cfg, 0, "cpu")
    rparams = tree_map(lambda t: jax.numpy.asarray(t.numpy()), params)
    nb = _batch(cfg, seed=1)
    rloss, rgrad = jax.jit(jax.value_and_grad(rmodel.loss))(
        rparams, jax.tree.map(jax.numpy.asarray, nb))
    rgrad = [np.asarray(g) for g in jax.tree.leaves(rgrad)]
    tb = {k: torch.as_tensor(v) for k, v in nb.items()}

    g, loss = torch.func.grad_and_value(remat.loss)(params, tb)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_TOL)
    _close(tree_leaves(g), rgrad)
    g_plain, loss_plain = torch.func.grad_and_value(plain.loss)(params, tb)
    np.testing.assert_allclose(float(loss), float(loss_plain),
                               rtol=LOSS_TOL)
    _close(tree_leaves(g), tree_leaves(g_plain))

    # two workers under vmap(grad): worker 0 holds the reference's params
    # and batch, worker 1 a perturbed copy and other tokens
    leaves, treedef = tree_flatten(params)
    both = tree_unflatten(treedef, [torch.stack([t, t * 1.01])
                                    for t in leaves])
    other = _batch(cfg, seed=2)
    wb = {k: torch.stack([tb[k], torch.as_tensor(other[k])]) for k in tb}
    grads, losses = torch.func.vmap(torch.func.grad_and_value(remat.loss))(
        both, wb)
    np.testing.assert_allclose(float(losses[0]), float(rloss), rtol=LOSS_TOL)
    _close([t[0] for t in tree_leaves(grads)], rgrad)
    p_grads, p_losses = torch.func.vmap(
        torch.func.grad_and_value(plain.loss))(both, wb)
    np.testing.assert_allclose(losses.numpy(), p_losses.numpy(),
                               rtol=LOSS_TOL)
    _close(tree_leaves(grads), tree_leaves(p_grads))


def test_remat_refuses_a_second_derivative():
    """A backward taken with ``create_graph=True`` and a ``grad`` of a
    ``grad`` raise at the checkpointed layer; a single ``torch.func.grad``
    (which runs its backward with grad enabled) and a plain
    ``backward`` do not."""
    cfg = get_smoke("qwen3-1.7b")
    model = build_model(cfg.with_(remat=True))
    params = stacked_params(cfg, 0, "cpu")
    tb = {k: torch.as_tensor(v) for k, v in _batch(cfg, seed=1).items()}
    want = torch.func.grad(build_model(cfg).loss)(params, tb)
    _close(tree_leaves(torch.func.grad(model.loss)(params, tb)),
           tree_leaves(want))

    tracked = tree_map(lambda t: t.clone().requires_grad_(), params)
    model.loss(tracked, tb).backward()
    _close([t.grad for t in tree_leaves(tracked)], tree_leaves(want))
    with pytest.raises(RuntimeError, match="second derivatives"):
        torch.autograd.grad(model.loss(tracked, tb), tree_leaves(tracked),
                            create_graph=True)

    def grad_norm(p):
        g = torch.func.grad(model.loss)(p, tb)
        return sum(torch.sum(t * t) for t in tree_leaves(g))

    with pytest.raises(RuntimeError, match="second derivatives"):
        torch.func.grad(grad_norm)(params)
