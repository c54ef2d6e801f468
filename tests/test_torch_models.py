"""The port's dense model stack (``repro_torch.models``) against the
reference's (``repro.models``) for each of the four dense archs at their
smoke configs. The reference's params (``model.init(PRNGKey(0))``) are
carried across by ``params_from_numpy``, so both compute the same
function on the same seeded tokens.

Tolerance: 1e-5 of max|reference logits|, the parity tolerance of the
port (the reference's between its own backends). Measured max|Δ| on
the four archs: at most 1.4e-6 of max|ref| for prefill, naive and flash.
The port's own decode-vs-prefill check uses the reference's 5e-4
(``tests/test_decode_consistency.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import build_model as ref_build
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.configs.base import MLAConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.models import build_model, params_from_numpy

ARCHS = ["qwen3-1.7b", "chatglm3-6b", "qwen1.5-32b", "chameleon-34b"]
PARITY = 1e-5


def _pair(arch, **overrides):
    """(reference model, its params, port model, the same params)."""
    rcfg = ref_smoke(arch).with_(**overrides)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke(arch).with_(**overrides)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                               "cpu")
    return rmodel, rparams, build_model(cfg), params


def _tokens(cfg, B=2, S=40, seed=1):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0,
                                         cfg.vocab_size))


def _close(out, ref, tol=PARITY):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(out) - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, np.abs(ref).max())


def test_the_port_has_the_four_dense_archs():
    assert sorted(list_archs()) == sorted(ARCHS)
    for arch in ARCHS:
        assert get_config(arch) == get_config(arch).with_()
        ref = ref_smoke(arch)
        ours = get_smoke(arch)
        assert {f: getattr(ours, f) for f in ours.__dataclass_fields__} == \
            {f: getattr(ref, f) for f in ref.__dataclass_fields__}
    with pytest.raises(KeyError, match="Queue A item 11"):
        get_config("mixtral-8x7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_match_reference(arch):
    from repro.configs import get_config as ref_config
    ref, ours = ref_config(arch), get_config(arch)
    for f in ref.__dataclass_fields__:
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.param_count() == ref.param_count()
    assert ours.torch_dtype() == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_tree(arch):
    """``Model.init`` draws a tree of the reference's names and shapes."""
    rcfg, cfg = ref_smoke(arch), get_smoke(arch)
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    ref_shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        name = ".".join(p.key for p in path)
        if name.startswith("layers."):
            for i in range(cfg.num_layers):
                ref_shapes[f"layers.{i}.{name[7:]}"] = leaf.shape[1:]
        else:
            ref_shapes[name] = leaf.shape
    params = build_model(cfg).init(0, "cpu")
    assert {n: tuple(p.shape) for n, p in params.named_parameters()} == \
        {n: tuple(s) for n, s in ref_shapes.items()}
    assert not any(p.requires_grad for p in params.parameters())
    again = build_model(cfg).init(0, "cpu")
    for a, b in zip(params.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, attn_impl):
    rmodel, rparams, model, params = _pair(arch, attn_impl=attn_impl)
    tok = _tokens(model.cfg)
    ops.reset_launch_counts()
    out = model.prefill(params, torch.as_tensor(tok))
    assert ops.launch_counts()["flash_attention"] == 0    # CPU: plain
    assert out.shape == (2, 40, model.cfg.vocab_size)
    _close(out.numpy(), rmodel.prefill(rparams, jnp.asarray(tok)))
    last = model.prefill(params, torch.as_tensor(tok), logits_mode="last")
    assert last.shape == (2, 1, model.cfg.vocab_size)
    _close(last.numpy(), rmodel.prefill(rparams, jnp.asarray(tok),
                                        logits_mode="last"))


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_prefill_matches_naive(arch):
    """The reference's own bound between the two paths
    (``tests/test_flash_attention.py``): 2e-3."""
    _, _, model, params = _pair(arch)
    tok = torch.as_tensor(_tokens(model.cfg))
    naive = model.prefill(params, tok)
    flash = build_model(model.cfg.with_(attn_impl="flash")).prefill(params,
                                                                    tok)
    assert float((naive - flash).abs().max()) < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """12 ``decode_step`` calls against the reference's, logits at each
    step and the K/V cache at the end."""
    rmodel, rparams, model, params = _pair(arch)
    B, S = 2, 12
    tok = _tokens(model.cfg, B, S)
    rcache = rmodel.init_cache(B, S + 4)
    cache = model.init_cache(B, S + 4, "cpu")
    rdecode = jax.jit(rmodel.decode_step)
    for t in range(S):
        rlg, rcache = rdecode(rparams, jnp.asarray(tok[:, t:t + 1]), rcache,
                              jnp.int32(t))
        lg, cache = model.decode_step(params, torch.as_tensor(
            tok[:, t:t + 1]), cache, t)
        assert lg.shape == (B, 1, model.cfg.vocab_size)
        _close(lg.numpy(), rlg)
    for name in ("k", "v"):
        _close(cache["layers"][name].numpy(), rcache["layers"][name])


def test_decode_past_the_cache_length_matches_reference():
    """Decode steps at and past the cache length against the reference's:
    its ``dynamic_update_slice`` clamps the write of the new K/V to the
    last slot while the mask keeps the true position. qwen3-1.7b, B = 2,
    a cache of 4 and 7 steps: steps 4-6 write past the end."""
    rmodel, rparams, model, params = _pair("qwen3-1.7b")
    B, T, steps = 2, 4, 7
    tok = _tokens(model.cfg, B, steps)
    rcache = rmodel.init_cache(B, T)
    cache = model.init_cache(B, T, "cpu")
    rdecode = jax.jit(rmodel.decode_step)
    for t in range(steps):
        rlg, rcache = rdecode(rparams, jnp.asarray(tok[:, t:t + 1]), rcache,
                              jnp.int32(t))
        lg, cache = model.decode_step(params, torch.as_tensor(
            tok[:, t:t + 1]), cache, t)
        _close(lg.numpy(), rlg)
    for name in ("k", "v"):
        _close(cache["layers"][name].numpy(), rcache["layers"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_prefill(arch):
    """The port's decode path against its own prefill, token by token,
    within the reference's 5e-4 (``tests/test_decode_consistency.py``)."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    B, S = 2, 12
    tok = torch.as_tensor(_tokens(cfg, B, S))
    ref = model.prefill(params, tok)
    cache = model.init_cache(B, S + 4, "cpu")
    errs = []
    for t in range(S):
        lg, cache = model.decode_step(params, tok[:, t:t + 1], cache, t)
        errs.append(float((lg[:, 0] - ref[:, t]).abs().max()))
    assert max(errs) < 5e-4, f"{arch}: max err {max(errs)}"


def test_cache_specs_match_reference():
    rcfg, cfg = ref_smoke("qwen3-1.7b"), get_smoke("qwen3-1.7b")
    rspec = ref_build(rcfg).cache_specs(3, 20)["layers"]
    spec = build_model(cfg).cache_specs(3, 20)["layers"]
    for name in ("k", "v"):
        assert spec[name][0] == rspec[name].shape
        assert spec[name][1] == torch.float32
    cache = build_model(cfg).init_cache(3, 20, "cpu")
    assert cache["layers"]["k"].shape == rspec["k"].shape
    assert not bool(cache["layers"]["k"].any())


def test_other_families_and_impls_name_the_roadmap_item():
    cfg = get_smoke("qwen3-1.7b")
    tok = torch.zeros((1, 8), dtype=torch.int64)
    params = build_model(cfg).init(0, "cpu")
    for impl in ("chunked", "qchunk"):
        with pytest.raises(NotImplementedError, match="Queue A item 11"):
            build_model(cfg.with_(attn_impl=impl)).prefill(params, tok)
    moe = cfg.with_(arch_type="moe", moe=MoEConfig(4, 2, 64))
    mla = cfg.with_(mla=MLAConfig(32, 32, 16, 16, 16))
    for other in (moe, mla, cfg.with_(arch_type="ssm"),
                  cfg.with_(encoder_layers=2)):
        with pytest.raises(NotImplementedError, match="Queue A item 11"):
            build_model(other).init(0, "cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        build_model(cfg).prefill(params, tok, enc_frames=torch.zeros(1))


def test_params_from_numpy_checks_the_tree():
    rcfg, cfg = ref_smoke("qwen3-1.7b"), get_smoke("qwen3-1.7b")
    tree = jax.tree.map(np.asarray, ref_build(rcfg).init(
        jax.random.PRNGKey(0)))
    params_from_numpy(cfg, tree, "cpu")
    del tree["layers"]["attn"]["q_norm"]
    with pytest.raises(RuntimeError, match="q_norm"):
        params_from_numpy(cfg, tree, "cpu")
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_numpy(cfg.with_(num_layers=3), jax.tree.map(
            np.asarray, ref_build(rcfg).init(jax.random.PRNGKey(0))), "cpu")


def test_model_entry_points_default_to_the_card():
    model = build_model(get_smoke("qwen3-1.7b"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 4)


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "chatglm3-6b"])
def test_bf16_prefill_within_twice_the_reference_error(arch, impl):
    """The bf16 prefill that phase ``serve`` drives on the card, here on
    the CPU (the flash path through B7's plain version): the port's and
    the reference's bf16 prefills of the same bf16-rounded weights, each
    held against the reference's f32 prefill of those weights. The
    port's error must be at most twice the reference's, plus half a bf16
    ulp of the largest logit (the logits' own rounding, which both pay).
    Measured: 0.011-0.014 (qwen3) and 0.049-0.052 (chatglm3) against the
    reference's 0.014 and 0.059."""
    rcfg = ref_smoke(arch)
    rmodel = ref_build(rcfg)
    rparams16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                             rmodel.init(jax.random.PRNGKey(0)))
    weights = jax.tree.map(lambda a: np.array(a.astype(jnp.float32)),
                           rparams16)
    tok = _tokens(rcfg)
    exact = np.asarray(rmodel.prefill(jax.tree.map(jnp.asarray, weights),
                                      jnp.asarray(tok)))
    bf16 = dict(dtype="bfloat16", param_dtype="bfloat16")
    ref16 = np.asarray(ref_build(rcfg.with_(**bf16)).prefill(
        rparams16, jnp.asarray(tok)).astype(jnp.float32))
    cfg = get_smoke(arch).with_(attn_impl=impl, **bf16)
    params = params_from_numpy(cfg, weights, "cpu").to(torch.bfloat16)
    ops.reset_launch_counts()
    out = build_model(cfg).prefill(params, torch.as_tensor(tok))
    assert ops.launch_counts()["flash_attention"] == 0
    assert out.dtype == torch.bfloat16
    ref_err = float(np.abs(ref16 - exact).max())
    err = float(np.abs(out.float().numpy() - exact).max())
    assert err <= 2 * ref_err + 2.0 ** -8 * float(np.abs(exact).max()), (
        err, ref_err)
