"""``repro_torch.optim`` against ``repro.optim``: SGD (plain, momentum,
Nesterov), AdamW (with and without weight decay, under a warmup-cosine
schedule) and the schedules themselves, on the qwen3-1.7b smoke tree
with the same gradients from a numpy seed, 5 updates
(``tests/test_trainer.py::test_optimizers_quadratic`` runs in
``test_torch_trainer.py``).

Tolerance 1e-6 (1 + max|ref|) on every update and state leaf: both
packages take the same float32 steps (AdamW's bias corrections in
float32 too); measured at most 2.2e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import build_model as ref_build
from repro.optim import adamw as ref_adamw
from repro.optim import apply_updates as ref_apply
from repro.optim import constant as ref_constant
from repro.optim import sgd as ref_sgd
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_leaves
from repro_torch.models import stacked_from_numpy
from repro_torch.optim import (adamw, apply_updates, constant, sgd,
                               warmup_cosine)

TOL = 1e-6
STEPS = 5


def _close(out, ref):
    for a, b in zip(tree_leaves(out), jax.tree.leaves(ref)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        err = float(np.abs(a.float().numpy() - b.astype(np.float32)).max())
        assert err <= TOL * (1.0 + float(np.abs(b).max())), err


CASES = {       # each builds its optimizer from one package's names
    "sgd": lambda m: m.sgd(0.05),
    "sgd_momentum": lambda m: m.sgd(0.05, momentum=0.8),
    "sgd_nesterov": lambda m: m.sgd(0.05, momentum=0.8, nesterov=True),
    "sgd_schedule": lambda m: m.sgd(m.warmup_cosine(0.1, 2, STEPS),
                                    momentum=0.5),
    "adamw": lambda m: m.adamw(3e-3),
    "adamw_decay_schedule": lambda m: m.adamw(
        m.warmup_cosine(3e-3, 2, STEPS, floor=1e-4), weight_decay=0.01),
}


class _Ref:
    sgd, adamw, warmup_cosine = ref_sgd, ref_adamw, ref_warmup_cosine


class _Port:
    sgd, adamw, warmup_cosine = sgd, adamw, warmup_cosine


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_reference(case):
    make = CASES[case]
    rcfg, cfg = ref_smoke("qwen3-1.7b"), get_smoke("qwen3-1.7b")
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    params = stacked_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                                "cpu")
    ropt, opt = make(_Ref), make(_Port)
    rstate, state = ropt.init(rparams), opt.init(params)
    r = np.random.RandomState(11)
    for _ in range(STEPS):
        g = [(r.randn(*np.shape(x)) * 0.1).astype(np.float32)
             for x in jax.tree.leaves(rparams)]
        rg = jax.tree.unflatten(jax.tree.structure(rparams),
                                [jnp.asarray(a) for a in g])
        tg = jax.tree.unflatten(jax.tree.structure(rparams),
                                [torch.as_tensor(a) for a in g])
        rupd, rstate = ropt.update(rg, rstate, rparams)
        upd, state = opt.update(tg, state, params)
        _close(upd, rupd)
        rparams, params = ref_apply(rparams, rupd), apply_updates(params,
                                                                  upd)
        _close(params, rparams)
    assert state["step"] == int(rstate["step"]) == STEPS
    for key in ("mu", "m", "v"):
        if key in rstate:
            _close(state[key], rstate[key])


def test_schedules_match_reference():
    for args in ((1e-3, 10, 100), (3e-4, 0, 50), (0.1, 5, 5),
                 (2e-3, 3, 30, 1e-4)):
        ref, out = ref_warmup_cosine(*args), warmup_cosine(*args)
        for step in range(0, 110):
            np.testing.assert_allclose(out(step), float(ref(step)),
                                       rtol=TOL, atol=0)
        assert isinstance(out(3), float)
    assert constant(0.5)(7) == ref_constant(0.5)(7) == 0.5


def test_apply_updates_keeps_leaf_dtypes():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.zeros(2),
                                                             None]}
    upd = {"a": torch.full((3,), 0.5), "b": [torch.ones(2), None]}
    out = apply_updates(params, upd)
    assert out["a"].dtype == torch.bfloat16 and out["b"][1] is None
    assert torch.equal(out["a"], torch.full((3,), 1.5, dtype=torch.bfloat16))
    assert torch.equal(params["a"], torch.ones(3, dtype=torch.bfloat16))
    state = adamw(0.1).init(params)
    assert state["m"]["a"].dtype == torch.float32

