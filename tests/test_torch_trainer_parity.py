"""``repro_torch.training`` against ``repro.training`` on the qwen3-1.7b
smoke model, its weights carried across by ``stacked_from_numpy``, the
same token batches from a numpy seed, fp32 (the reference jitted):

* ``ADMMTrainer.train_step`` for 5 steps at ``block_fraction=1,
  max_delay=0`` (no draws), and at ``block_fraction=0.5, max_delay=1``
  with the reference's own delays and selections (its key chain,
  ``epoch_keys``) replayed in the port; z, y, w_cache, the loss and
  ``consensus_residual`` at every step within 1e-5 (the port's parity
  tolerance);
* ``train_step_block`` (the Gauss-Seidel round) for 5 steps with every
  read one step stale in both packages (a constant delay, patched into
  each trainer's ``sample_delay_model``: the reference's trainer takes
  no delay model), no minibatch;
* ``SGDTrainer`` with AdamW for 5 steps;
* ``train_step`` for 3 steps of the granite-moe smoke (the router's
  auxiliary loss in the loss) at ``block_fraction=1, max_delay=0``;
* ``train_step`` for 3 steps of the mamba2 and zamba2 smokes with the
  reference's draws (``block_fraction=0.5, max_delay=1``): the hybrid's
  unstacked ``shared_attn`` leaves packed in the reference's leaf order;
  and of the minicpm3 (MLA) and whisper (enc-dec: its second stack,
  ``enc_layers``, and the batch's ``enc_frames`` per worker) smokes;
* what the port adds: the spec built once per tree, a step's state
  packed back with no copy, defaults to the card.

Measured: z within 3e-7 of the reference's over 5 ADMM steps (AdamW:
see ``ADAM_OUTLIERS``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.configs.base import ADMMConfig as RConfig
from repro.core import space as rspace
from repro.models import build_model as ref_build
from repro.optim import adamw as ref_adamw
from repro.training import ADMMTrainer as RTrainer
from repro.training import SGDTrainer as RSGDTrainer
from repro.training import trainer as rtrainer_mod
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ADMMConfig
from repro_torch.core import sharded as sharded_mod
from repro_torch.core import space
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import build_model, stacked_from_numpy
from repro_torch.optim import adamw
from repro_torch.training import ADMMTrainer, SGDTrainer
from repro_torch.training import trainer as trainer_mod

TOL = 1e-5
STEPS = 5
N, M = 4, 4
ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module")
def models():
    rmodel = ref_build(ref_smoke(ARCH))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(ARCH))
    params = stacked_from_numpy(model.cfg, jax.tree.map(np.asarray, rparams),
                                "cpu")
    return rmodel, rparams, model, params


def _batches(workers=N, per=2, S=16, steps=STEPS, seed=2):
    r = np.random.RandomState(seed)
    for _ in range(steps):
        shape = (workers, per, S + 1) if workers else (per, S + 1)
        tok = r.randint(0, 512, shape)
        b = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
        yield ({k: jnp.asarray(v) for k, v in b.items()},
               {k: torch.as_tensor(v) for k, v in b.items()})


def _arch_batches(cfg, steps, seed=2):
    """``_batches`` for ``cfg``: (N, 2, 16) tokens from its vocabulary,
    and an enc-dec arch's (N, 2, T_enc, d) ``enc_frames``."""
    r = np.random.RandomState(seed)
    for _ in range(steps):
        tok = r.randint(0, cfg.vocab_size, (N, 2, 17))
        b = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
        if cfg.is_enc_dec:
            b["enc_frames"] = (r.randn(N, 2, cfg.encoder_seq_len, cfg.d_model)
                               * 0.1).astype(np.float32)
        yield ({k: jnp.asarray(v) for k, v in b.items()},
               {k: torch.as_tensor(v) for k, v in b.items()})


def _close(out, ref, tol=TOL):
    for a, b in zip(tree_leaves(out), jax.tree.leaves(ref)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        err = float(np.abs(a.numpy() - b).max())
        assert err <= tol * (1.0 + float(np.abs(b).max())), err


def _trainers(models, **kw):
    rmodel, rparams, model, params = models
    cfg = dict(rho=5.0, gamma=0.01, num_blocks=M, **kw)
    return (RTrainer(loss_fn=rmodel.loss, admm=RConfig(**cfg), num_workers=N),
            ADMMTrainer(loss_fn=model.loss, admm=ADMMConfig(**cfg),
                        num_workers=N, device="cpu"))


def _run_and_compare(rt, tt, rparams, params, steps=STEPS, batches=None):
    rs, ts = rt.init(rparams), tt.init(params)
    rstep = jax.jit(rt.train_step)
    for rb, tb in batches or _batches(steps=steps):
        rs, rinfo = rstep(rs, rb)
        ts, tinfo = tt.train_step(ts, tb)
        for name in ("z_hist", "y", "w_cache"):
            _close(getattr(ts, name), getattr(rs, name))
        np.testing.assert_allclose(float(tinfo["loss"]), float(rinfo["loss"]),
                                   rtol=TOL)
        assert float(tinfo["selected_fraction"]) == \
            float(rinfo["selected_fraction"])
        np.testing.assert_allclose(float(tt.consensus_residual(ts)),
                                   float(rt.consensus_residual(rs)),
                                   rtol=TOL, atol=TOL)
    assert ts.step == int(rs.step) == steps
    return ts


def test_train_step_matches_reference(models):
    rt, tt = _trainers(models, max_delay=0, block_fraction=1.0)
    ts = _run_and_compare(rt, tt, models[1], models[3])
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(ts.params), tree_leaves(models[3])))
    assert moved > 0.0


def test_moe_train_step_matches_reference():
    """granite-moe's smoke (the onehot dispatch, the reference's
    default): its weights carried across, 3 draw-free steps; z, y,
    w_cache, the loss and the residual at 1e-5."""
    arch = "granite-moe-1b-a400m"
    rmodel = ref_build(ref_smoke(arch))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(arch))
    params = stacked_from_numpy(model.cfg, jax.tree.map(np.asarray, rparams),
                                "cpu")
    rt, tt = _trainers((rmodel, rparams, model, params), max_delay=0,
                       block_fraction=1.0)
    _run_and_compare(rt, tt, rparams, params, steps=3)


def _reference_draws(cfg, steps=STEPS):
    """The delays and selections of the reference trainer's epochs: its
    state's key chain (``PRNGKey(seed)``, split per epoch by
    ``epoch_keys``), its delay model and its random selector."""
    rng = jax.random.PRNGKey(cfg.seed)
    delays, sels = [], []
    edge = jnp.ones((N, M), bool)
    for t in range(steps):
        rng, r_delay, r_sel, _ = rspace.epoch_keys(rng, None)
        delays.append(np.asarray(rspace.sample_delay_model(
            rspace.UniformDelay(cfg.max_delay), r_delay, N, M, t)))
        ctx = rspace.SelectorContext(
            rng=r_sel, edge=edge, t=jnp.int32(t),
            block_fraction=cfg.block_fraction, grad_sqnorm=None)
        sels.append(np.asarray(rspace.BLOCK_SELECTORS["random"](ctx)))
    return np.stack(delays), torch.as_tensor(np.stack(sels))


def test_train_step_with_the_reference_draws(models, monkeypatch):
    rt, tt = _trainers(models, max_delay=1, block_fraction=0.5, seed=3)
    delays, sels = _reference_draws(rt.admm)
    assert delays.any() and not sels.all()         # both draws matter
    monkeypatch.setattr(trainer_mod, "make_spec", functools.partial(
        space.make_spec, delay_model=space.TraceDelay(delays),
        selector=lambda ctx: sels[ctx.t] & ctx.edge))
    _run_and_compare(rt, tt, models[1], models[3])


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_train_step_with_the_reference_draws(arch, monkeypatch):
    """The SSM and hybrid smokes, their weights carried across, 3 steps
    with the reference's delays and selections: the block layout of
    their trees is the reference's (zamba2's ``shared_attn`` leaves
    sorted in among the stacked ones), and z, y, w_cache, the loss and
    the residual agree at 1e-5."""
    rmodel = ref_build(ref_smoke(arch))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(arch))
    params = stacked_from_numpy(model.cfg, jax.tree.map(np.asarray, rparams),
                                "cpu")
    rt, tt = _trainers((rmodel, rparams, model, params), max_delay=1,
                       block_fraction=0.5, seed=3)
    delays, sels = _reference_draws(rt.admm, steps=3)
    monkeypatch.setattr(trainer_mod, "make_spec", functools.partial(
        space.make_spec, delay_model=space.TraceDelay(delays),
        selector=lambda ctx: sels[ctx.t] & ctx.edge))
    rlayout = rt._spec(rparams).space.layout
    layout = tt._spec(params).space.layout      # cached: built patched
    for field in ("block_ids", "leaf_offsets", "leaf_shapes",
                  "block_sizes", "block_dim"):
        assert getattr(layout, field) == getattr(rlayout, field), field
    _run_and_compare(rt, tt, rparams, params, steps=3)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-medium"])
def test_mla_and_encdec_train_step_with_the_reference_draws(arch,
                                                            monkeypatch):
    """The MLA and enc-dec smokes, their weights carried across, 3 steps
    with the reference's delays and selections: the block layout of
    their trees is the reference's (whisper's ``enc_layers`` and
    ``enc_norm`` sorted in after ``embed``), each worker's
    ``enc_frames`` reach its loss under ``vmap``, and z, y, w_cache, the
    loss and the residual agree at 1e-5."""
    rmodel = ref_build(ref_smoke(arch))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(arch))
    params = stacked_from_numpy(model.cfg, jax.tree.map(np.asarray, rparams),
                                "cpu")
    rt, tt = _trainers((rmodel, rparams, model, params), max_delay=1,
                       block_fraction=0.5, seed=3)
    delays, sels = _reference_draws(rt.admm, steps=3)
    monkeypatch.setattr(trainer_mod, "make_spec", functools.partial(
        space.make_spec, delay_model=space.TraceDelay(delays),
        selector=lambda ctx: sels[ctx.t] & ctx.edge))
    rlayout = rt._spec(rparams).space.layout
    layout = tt._spec(params).space.layout
    for field in ("block_ids", "leaf_offsets", "leaf_shapes",
                  "block_sizes", "block_dim"):
        assert getattr(layout, field) == getattr(rlayout, field), field
    _run_and_compare(rt, tt, rparams, params, steps=3,
                     batches=_arch_batches(model.cfg, 3))


def test_train_step_block_matches_reference(models, monkeypatch):
    """The static Gauss-Seidel round, block ``step % M``, every read one
    step stale: z ring and duals per leaf, the loss and the active share
    of leaves."""
    monkeypatch.setattr(rtrainer_mod, "sample_delay_model",
                        lambda dm, key, n, m, t: jnp.ones((n, m), jnp.int32))
    # the port's round draws in core/sharded.py (block_round_body)
    monkeypatch.setattr(sharded_mod, "sample_delay_model",
                        lambda dm, gen, n, m, t: torch.ones(
                            (n, m), dtype=torch.int64))
    rt, tt = _trainers(models, max_delay=1, block_fraction=1.0)
    rs, ts = rt.init(models[1], cyclic=True), tt.init(models[3], cyclic=True)
    assert ts.w_cache == () and rs.w_cache == ()
    rstep = jax.jit(rt.train_step_block, static_argnums=2)
    for i, (rb, tb) in enumerate(_batches()):
        rs, rinfo = rstep(rs, rb, i % M)
        ts, tinfo = tt.train_step_block(ts, tb, i % M)
        _close(ts.z_hist, rs.z_hist)
        _close(ts.y, rs.y)
        np.testing.assert_allclose(float(tinfo["loss"]), float(rinfo["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(tinfo["selected_fraction"]),
                                   float(rinfo["selected_fraction"]),
                                   rtol=1e-6)
    assert ts.step == STEPS
    with pytest.raises(ValueError, match="cyclic=True"):
        tt.train_step(ts, tb)
    with pytest.raises(ValueError, match="cyclic=True"):
        tt.consensus_residual(ts)


ADAM_LR = 1e-3
# AdamW divides each gradient entry by its own RMS: its first step is
# -lr g / (|g| + eps), so an entry whose gradient sits at rounding level
# takes a step anywhere in [-lr, lr] in either package, and keeps the
# difference. The moments are linear in g and held at TOL; the params at
# TOL on all but ADAM_OUTLIERS of the entries (measured: 6 of 65,536 in
# the worst leaf, 2.2e-5 off) and every entry within 2 lr a step
ADAM_OUTLIERS = 1e-3


def test_sgd_trainer_adamw_matches_reference(models):
    rmodel, rparams, model, params = models
    rt = RSGDTrainer(loss_fn=rmodel.loss, optimizer=ref_adamw(ADAM_LR))
    tt = SGDTrainer(loss_fn=model.loss, optimizer=adamw(ADAM_LR))
    rs, ts = rt.init(rparams), tt.init(params)
    rstep = jax.jit(rt.train_step)
    for step, (rb, tb) in enumerate(_batches(workers=0, per=4)):
        rs, rinfo = rstep(rs, rb)
        ts, tinfo = tt.train_step(ts, tb)
        np.testing.assert_allclose(float(tinfo["loss"]), float(rinfo["loss"]),
                                   rtol=1e-6)
        _close(ts.opt_state["m"], rs.opt_state["m"])
        _close(ts.opt_state["v"], rs.opt_state["v"])
        for a, b in zip(tree_leaves(ts.params), jax.tree.leaves(rs.params)):
            d = np.abs(a.numpy() - np.asarray(b))
            assert float(d.max()) <= 2 * ADAM_LR * (step + 1)
            off = d > TOL * (1.0 + float(np.abs(np.asarray(b)).max()))
            assert off.mean() <= ADAM_OUTLIERS, (int(off.sum()), d.size)
    assert ts.step == int(rs.step) == STEPS


def test_state_packs_back_without_a_copy(models):
    """A state ``train_step`` returned is views of the epoch's tables, and
    the next step takes those tables as they are; a state whose leaves
    are copies (a restored checkpoint) is packed by a copy and gives the
    same step. The spec is built once per tree."""
    _, tt = _trainers(models, max_delay=1, block_fraction=1.0)
    state = tt.init(models[3])
    spec = tt._spec(state.params)
    layout = spec.space.layout
    batches = list(_batches(steps=2))
    state, _ = tt.train_step(state, batches[0][1])
    assert tt._spec(state.params) is spec and len(tt._specs) == 1
    packed = tt._packed(spec, state)
    for name in ("z_hist", "y", "w_cache"):
        table = getattr(packed, name)
        leaf = tree_leaves(getattr(state, name))[0]
        assert table.data_ptr() == leaf._base.data_ptr()
        assert torch.equal(table, layout.to_blocks(getattr(state, name)))
    copied = type(state)(*[
        tree_map(torch.clone, v) if isinstance(v, dict) else v
        for v in state])
    assert tt._packed(spec, copied).z_hist.data_ptr() != \
        packed.z_hist.data_ptr()
    a, _ = tt.train_step(state, batches[1][1])
    b, _ = tt.train_step(copied, batches[1][1])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


def test_trainer_defaults_to_the_card(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = ADMMTrainer(loss_fn=models[2].loss, admm=ADMMConfig(num_blocks=M),
                     num_workers=N)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.init(models[3])
