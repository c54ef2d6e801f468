"""The port's serving engine (``repro_torch.serving.Engine``) and serve
launcher against the reference's, with the reference's params carried
across: greedy tokens equal the reference engine's on the prompts of
``tests/test_serving.py``, for each of the reference's ten archs (four
dense, two MoE, the SSM, the hybrid, MLA, and whisper with the same
frame embeddings through its encoder); plus determinism, EOS masking,
temperature sampling and the launcher on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import build_model as ref_build
from repro.serving import Engine as RefEngine
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serving import Engine

ARCHS = ["qwen3-1.7b", "chatglm3-6b", "qwen1.5-32b", "chameleon-34b",
         "mixtral-8x7b", "granite-moe-1b-a400m", "mamba2-370m",
         "zamba2-1.2b", "minicpm3-4b", "whisper-medium"]
# tests/test_serving.py:19 and :31 — (seed, shape, max_len, max_new)
PROMPTS = [(0, (2, 6), 32, 4), (1, (3, 5), 24, 6)]


def _frames(cfg, batch, seed):
    """An enc-dec arch's frame embeddings, as launch/serve.py draws
    them; None otherwise."""
    if not cfg.is_enc_dec:
        return None
    return (np.random.RandomState(seed + 100).randn(
        batch, cfg.encoder_seq_len, cfg.d_model) * 0.1).astype(np.float32)


def _engines(arch, max_len):
    rcfg = ref_smoke(arch)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke(arch)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                               "cpu")
    return (RefEngine(rmodel, rparams, max_len=max_len),
            Engine(build_model(cfg), params, max_len=max_len))


@pytest.mark.parametrize("seed,shape,max_len,max_new", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference_engine(arch, seed, shape, max_len,
                                              max_new):
    ref_engine, engine = _engines(arch, max_len)
    prompts = np.random.RandomState(seed).randint(
        0, engine.model.cfg.vocab_size, shape)
    enc = _frames(engine.model.cfg, shape[0], seed)
    ops.reset_launch_counts()
    res = engine.generate(prompts, max_new=max_new, enc_frames=enc)
    assert ops.launch_counts()["flash_attention"] == 0
    assert res.tokens.shape == (shape[0], max_new) and res.steps == max_new
    ref = ref_engine.generate(prompts, max_new=max_new, enc_frames=enc)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    assert res.tokens.dtype == ref.tokens.dtype == np.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_first_token_is_prefill_argmax(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 6))
    enc = _frames(cfg, 2, 0)
    res = Engine(model, params, max_len=32).generate(prompts, max_new=4,
                                                     enc_frames=enc)
    logits = model.prefill(
        params, torch.as_tensor(prompts), logits_mode="last",
        enc_frames=None if enc is None else torch.as_tensor(enc))
    np.testing.assert_array_equal(res.tokens[:, 0],
                                  logits[:, -1].argmax(-1).numpy())


def test_generation_deterministic():
    cfg = get_smoke("qwen3-1.7b")
    model = build_model(cfg)
    e = Engine(model, model.init(0, "cpu"), max_len=24)
    prompts = np.random.RandomState(1).randint(0, cfg.vocab_size, (3, 5))
    np.testing.assert_array_equal(e.generate(prompts, max_new=6).tokens,
                                  e.generate(prompts, max_new=6).tokens)


def test_temperature_sampling_runs_and_repeats_per_seed():
    cfg = get_smoke("chatglm3-6b")
    model = build_model(cfg)
    e = Engine(model, model.init(0, "cpu"), max_len=16)
    prompts = np.zeros((2, 4), np.int64)
    a = e.generate(prompts, max_new=8, temperature=0.8, seed=3).tokens
    assert a.shape == (2, 8)
    assert a.min() >= 0 and a.max() < cfg.vocab_size
    np.testing.assert_array_equal(
        a, e.generate(prompts, max_new=8, temperature=0.8, seed=3).tokens)
    assert not np.array_equal(
        a, e.generate(prompts, max_new=8, temperature=0.8, seed=4).tokens)


def test_eos_masks_finished_requests():
    """After a request emits eos_id it emits only eos_id, as the
    reference's activity mask does."""
    arch = "qwen3-1.7b"
    ref_engine, engine = _engines(arch, 32)
    prompts = np.random.RandomState(0).randint(0, 512, (2, 6))
    free = engine.generate(prompts, max_new=6).tokens
    eos = int(free[0, 1])
    res = engine.generate(prompts, max_new=6, eos_id=eos)
    row = list(res.tokens[0])
    assert row[:2] == list(free[0, :2])
    assert all(t == eos for t in row[1:])
    np.testing.assert_array_equal(
        res.tokens, ref_engine.generate(prompts, max_new=6,
                                        eos_id=eos).tokens)


def test_enc_frames_wait_for_the_enc_dec_slice():
    """Frames given to an arch with no encoder are refused, on every
    arch but whisper; whisper takes them (float64 frames as float32, as
    JAX takes them)."""
    for arch in ARCHS[:-1]:
        cfg = get_smoke(arch)
        model = build_model(cfg)
        e = Engine(model, model.init(0, "cpu"), max_len=16)
        with pytest.raises(ValueError, match="no encoder"):
            e.generate(np.zeros((1, 2), np.int64), max_new=2,
                       enc_frames=np.zeros((1, 4, cfg.d_model)))
    cfg = get_smoke("whisper-medium")
    model = build_model(cfg)
    e = Engine(model, model.init(0, "cpu"), max_len=16)
    frames = _frames(cfg, 1, 0)
    np.testing.assert_array_equal(
        e.generate(np.zeros((1, 2), np.int64), max_new=3,
                   enc_frames=frames.astype(np.float64)).tokens,
        e.generate(np.zeros((1, 2), np.int64), max_new=3,
                   enc_frames=torch.as_tensor(frames)).tokens)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "chameleon-34b",
                                  "mixtral-8x7b", "granite-moe-1b-a400m",
                                  "mamba2-370m", "zamba2-1.2b",
                                  "minicpm3-4b", "whisper-medium"])
def test_serve_launcher_on_the_cpu(arch, capsys):
    """The launcher's tokens are the engine's on its seeded prompts (and
    for whisper the frames it draws after them, as the reference's
    launcher does)."""
    res = serve.main(["--arch", arch, "--device", "cpu"])
    assert res.tokens.shape == (4, 24)
    out = capsys.readouterr().out
    assert "generated 96 tokens" in out and "req1:" in out
    cfg = get_smoke(arch)
    model = build_model(cfg)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, (4, 16))
    enc = None
    if cfg.is_enc_dec:
        enc = torch.as_tensor(rng.randn(4, cfg.encoder_seq_len, cfg.d_model),
                              dtype=torch.float32) * 0.1
    again = Engine(model, model.init(0, "cpu"), max_len=48).generate(
        prompts, max_new=24, enc_frames=enc)
    np.testing.assert_array_equal(res.tokens, again.tokens)
