"""The reference's trainer tests, run on the port (``device="cpu"``):
``tests/test_trainer.py``'s eight cases, ``tests/test_system.py::
test_transformer_admm_train_and_serve`` (the trained state served
through ``params_from_stacked``), ``tests/test_resume_and_distributed.py
::test_admm_state_checkpoint_resume`` through ``repro_torch.checkpoint``
(here exact: the port's draws follow from the seed and the step), and
``tests/test_models_smoke.py::test_one_admm_train_step`` for the four
dense archs, the two MoE archs, the SSM arch and the hybrid arch the
port has. The token stream is the port's
``TokenPipeline``: the reference's bigram language, batches drawn by a
torch generator, so the losses differ from the reference's runs while
the thresholds are the reference's own.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_step, restore, save
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ADMMConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import TokenPipeline
from repro_torch.models import build_model, params_from_stacked
from repro_torch.models.weights import stacked_params
from repro_torch.optim import adamw, apply_updates, sgd
from repro_torch.serving import Engine
from repro_torch.training import ADMMTrainer, SGDTrainer

DENSE_ARCHS = ["qwen3-1.7b", "chatglm3-6b", "qwen1.5-32b", "chameleon-34b"]
MOE_ARCHS = ["mixtral-8x7b", "granite-moe-1b-a400m"]
SSM_ARCHS = ["mamba2-370m", "zamba2-1.2b"]


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke("qwen3-1.7b")
    model = build_model(cfg)
    params = stacked_params(cfg, 0, "cpu")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=33,
                         global_batch=8, seed=0, branch=2)
    return cfg, model, params, pipe


def _admm(model, workers=4, **kw):
    return ADMMTrainer(loss_fn=model.loss, admm=ADMMConfig(**kw),
                       num_workers=workers, device="cpu")


def _batch(pipe, i, workers=None):
    if workers:
        return pipe.batch(i, num_workers=workers, device="cpu")
    return pipe.batch(i, device="cpu")


def test_admm_loss_decreases(setup):
    cfg, model, params, pipe = setup
    tr = _admm(model, rho=5.0, gamma=0.01, max_delay=0, block_fraction=1.0,
               num_blocks=4)
    state = tr.init(params)
    losses = []
    for i in range(30):
        state, info = tr.train_step(state, _batch(pipe, i, 4))
        losses.append(float(info["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_admm_async_loss_decreases(setup):
    cfg, model, params, pipe = setup
    tr = _admm(model, rho=5.0, gamma=0.1, max_delay=2, block_fraction=0.5,
               num_blocks=4, seed=3)
    state = tr.init(params)
    losses = []
    for i in range(40):
        state, info = tr.train_step(state, _batch(pipe, i, 4))
        losses.append(float(info["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_sgd_baseline_decreases(setup):
    cfg, model, params, pipe = setup
    tr = SGDTrainer(loss_fn=model.loss, optimizer=adamw(3e-3))
    state = tr.init(params)
    losses = []
    for i in range(30):
        state, info = tr.train_step(state, _batch(pipe, i))
        losses.append(float(info["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_consensus_residual_decreases(setup):
    cfg, model, params, pipe = setup
    tr = _admm(model, rho=5.0, gamma=0.01, max_delay=1, block_fraction=1.0,
               num_blocks=4)
    state = tr.init(params)
    state, _ = tr.train_step(state, _batch(pipe, 0, 4))
    early = float(tr.consensus_residual(state))
    for i in range(1, 25):
        state, _ = tr.train_step(state, _batch(pipe, i, 4))
    late = float(tr.consensus_residual(state))
    assert np.isfinite(early) and np.isfinite(late)
    assert late < max(early, 1.0)   # dispersion does not blow up


def test_admm_trainer_matches_flat_math():
    """The pytree trainer must agree with hand-rolled ADMM on a convex
    quadratic (single block, sync): f_i(p) = ||p - c_i||^2 / 2."""
    centers = torch.tensor([[1.0, 2.0], [3.0, -1.0]])

    def loss_fn(p, batch):
        return 0.5 * torch.sum(torch.square(p["w"] - batch))

    tr = ADMMTrainer(loss_fn=loss_fn,
                     admm=ADMMConfig(rho=4.0, gamma=0.0, max_delay=0,
                                     block_fraction=1.0, num_blocks=1),
                     num_workers=2, device="cpu")
    state = tr.init({"w": torch.zeros(2)})
    z = torch.zeros(2)
    y = torch.zeros((2, 2))
    for i in range(20):
        state, _ = tr.train_step(state, centers)
        g = z[None] - centers            # grad at z per worker
        x = z[None] - (g + y) / 4.0
        y = y + 4.0 * (x - z[None])
        w = 4.0 * x + y
        z = w.sum(0) / 8.0
    np.testing.assert_allclose(state.params["w"].numpy(), z.numpy(),
                               rtol=1e-5, atol=1e-6)
    # consensus optimum of sum ||p-c_i||^2/2 is the centroid
    np.testing.assert_allclose(state.params["w"].numpy(),
                               centers.mean(0).numpy(), atol=0.05)


def test_checkpoint_roundtrip(tmp_path, setup):
    cfg, model, params, pipe = setup
    path = str(tmp_path / "ckpt")
    save(path, params, step=7)
    restored = restore(path, tree_map(lambda a: a, params))
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        assert torch.equal(a, b)
    assert load_step(path) == 7


def test_optimizers_quadratic():
    def loss(p):
        return torch.sum(torch.square(p["x"] - 3.0))
    for opt in (sgd(0.05, momentum=0.8), adamw(0.3)):
        params = {"x": torch.zeros(4)}
        state = opt.init(params)
        for _ in range(120):
            upd, state = opt.update(torch.func.grad(loss)(params), state,
                                    params)
            params = apply_updates(params, upd)
        assert float(loss(params)) < 1e-2


def test_block_step_honors_minibatch(setup):
    """The statically-specialized Gauss-Seidel path subsamples worker
    batches when ADMMConfig.minibatch is set (like the generic epoch),
    and stays deterministic per seed."""
    cfg, model, params, pipe = setup

    def make(minibatch):
        tr = _admm(model, rho=5.0, gamma=0.01, max_delay=0,
                   block_fraction=1.0, num_blocks=4, minibatch=minibatch)
        state = tr.init(params)
        out = []
        for i in range(3):
            state, info = tr.train_step_block(state, _batch(pipe, i, 4),
                                              i % 4)
            out.append(float(info["loss"]))
        return out
    full, mini = make(None), make(0.5)
    assert all(np.isfinite(mini))
    assert mini != full                 # subsampling actually engaged
    assert mini == make(0.5)            # seeded draw, reproducible


def test_transformer_admm_train_and_serve():
    """tests/test_system.py: the loss drops, and the consensus params
    serve (viewed as a ``ParamTree``, no copy)."""
    cfg = get_smoke("qwen3-1.7b")
    model = build_model(cfg)
    params = stacked_params(cfg, 0, "cpu")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=33,
                         global_batch=8, seed=0, branch=2)
    tr = _admm(model, rho=5.0, gamma=0.01, max_delay=1, block_fraction=1.0,
               num_blocks=4)
    state = tr.init(params)
    losses = []
    for i in range(25):
        state, info = tr.train_step(state, _batch(pipe, i, 4))
        losses.append(float(info["loss"]))
    assert losses[-1] < losses[0]

    served = params_from_stacked(cfg, state.params)
    engine = Engine(model, served, max_len=16)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 4))
    res = engine.generate(prompts, max_new=4)
    assert res.tokens.shape == (2, 4)
    assert np.isfinite(losses).all()
    # the served tree is the trained one: its prefill is the stacked
    # forward's
    tok = torch.as_tensor(prompts)
    torch.testing.assert_close(model.prefill(served, tok),
                               model.prefill(state.params, tok),
                               rtol=0, atol=1e-6)


def test_admm_state_checkpoint_resume(tmp_path):
    """tests/test_resume_and_distributed.py: training 10 steps straight
    == training 5, checkpointing the FULL ADMM state (z ring, duals, w
    cache, step), restoring, training 5 — exactly, as the port's draws
    follow from the seed and the restored step."""
    cfg = get_smoke("qwen3-1.7b")
    model = build_model(cfg)
    params = stacked_params(cfg, 0, "cpu")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=17,
                         global_batch=8, seed=0)
    tr = _admm(model, rho=5.0, gamma=0.05, max_delay=1, block_fraction=0.5,
               num_blocks=4)

    straight = tr.init(params)
    for i in range(10):
        straight, _ = tr.train_step(straight, _batch(pipe, i, 4))

    half = tr.init(params)
    for i in range(5):
        half, _ = tr.train_step(half, _batch(pipe, i, 4))
    path = str(tmp_path / "admm_ckpt")
    save(path, half._asdict(), step=5)
    resumed = type(half)(**restore(path, half._asdict()))
    assert int(resumed.step) == 5
    for i in range(5, 10):
        resumed, _ = tr.train_step(resumed, _batch(pipe, i, 4))

    for a, b in zip(tree_leaves(straight.params),
                    tree_leaves(resumed.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS
                         + ["minicpm3-4b", "whisper-medium"])
def test_one_admm_train_step(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = stacked_params(cfg, 0, "cpu")
    tr = _admm(model, workers=2, rho=50.0, gamma=0.01, max_delay=1,
               block_fraction=0.5, num_blocks=4)
    state = tr.init(params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=17,
                         global_batch=4, seed=0)
    enc_kw = dict(enc_frames_dim=cfg.d_model,
                  enc_seq_len=cfg.encoder_seq_len) if cfg.is_enc_dec else {}
    state, info = tr.train_step(state, pipe.batch(0, num_workers=2,
                                                  device="cpu", **enc_kw))
    assert np.isfinite(float(info["loss"]))
    for leaf in tree_leaves(state.params):
        assert bool(torch.isfinite(leaf).all()), arch
