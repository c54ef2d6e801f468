"""The port's model stack (``repro_torch.models``) against the
reference's (``repro.models``) for each of the reference's ten archs at
their smoke configs: the four dense GQA archs, the two MoE archs, the
SSM arch, the hybrid arch, MLA (minicpm3-4b) and enc-dec
(whisper-medium, its encoder fed the same seeded frame embeddings).
The reference's params (``model.init(PRNGKey(0))``) are carried across
by ``params_from_numpy``, so both compute the same function on the same
seeded tokens.

Tolerance: 1e-5 of max|reference logits|, the parity tolerance of the
port (the reference's between its own backends). Measured max|Δ| on
the six dense and MoE archs: at most 1.4e-6 of max|ref| for prefill,
naive and flash; mamba2 7.7e-7, zamba2 1.3e-6; minicpm3 and whisper
(naive and flash) within 1e-6 (``test_torch_mla.py``,
``test_torch_encdec.py``).
The port's own decode-vs-prefill check uses the reference's 5e-4
(``tests/test_decode_consistency.py``). The MoE smokes are dropless
(capacity factor 4.0 = E / K), so a prefill and a token-by-token decode
route alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.configs import list_archs as ref_archs
from repro.models import build_model as ref_build
from repro.serving import Engine as RefEngine
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.configs.base import MLAConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serving import Engine

DENSE_ARCHS = ["qwen3-1.7b", "chatglm3-6b", "qwen1.5-32b", "chameleon-34b"]
MOE_ARCHS = ["mixtral-8x7b", "granite-moe-1b-a400m"]
SSM_ARCHS = ["mamba2-370m", "zamba2-1.2b"]
MLA_ARCHS = ["minicpm3-4b"]
ENC_DEC_ARCHS = ["whisper-medium"]
ARCHS = DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS + MLA_ARCHS + ENC_DEC_ARCHS
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


def _enc(cfg, B=2, seed=2):
    """An enc-dec arch's frame embeddings (B, T_enc, d_model) as
    ``tests/test_decode_consistency.py`` scales them; None otherwise."""
    if not cfg.is_enc_dec:
        return None
    return (np.random.RandomState(seed).randn(
        B, cfg.encoder_seq_len, cfg.d_model) * 0.1).astype(np.float32)


def _both(enc):
    """(the frames for the reference, for the port)."""
    if enc is None:
        return None, None
    return jnp.asarray(enc), torch.as_tensor(enc)


def _filled_caches(rmodel, rparams, model, params, B, T, enc):
    """Both packages' decode caches of (B, T), an enc-dec arch's cross
    K/V filled from ``enc`` by its ``Engine``."""
    rcache, cache = rmodel.init_cache(B, T), model.init_cache(B, T, "cpu")
    if enc is not None:
        renc, tenc = _both(enc)
        rcache = RefEngine(rmodel, rparams, T)._fill_cross_attn(rcache, renc)
        cache = Engine(model, params, T)._fill_cross_attn(cache, tenc)
    return rcache, cache


def _cache_tensors(cache, prefix=""):
    """A cache's tensors by dotted name (parts of specs or tensors)."""
    out = {}
    for name, value in cache.items():
        if isinstance(value, dict):
            out.update(_cache_tensors(value, f"{prefix}{name}."))
        else:
            out[prefix + name] = value
    return out


def _close(out, ref, tol=PARITY):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(out) - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, np.abs(ref).max())


def test_the_port_has_the_four_dense_archs():
    """All ten of the reference's archs, in its order: the four dense
    archs, the two MoE archs, the SSM arch, the hybrid arch, MLA and
    enc-dec, each smoke config equal to the reference's field by field;
    an unknown arch names the port's list."""
    assert list_archs() == ref_archs()
    assert sorted(list_archs()) == sorted(ARCHS)
    for arch in ARCHS:
        assert get_config(arch) == get_config(arch).with_()
        ref = ref_smoke(arch)
        ours = get_smoke(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for get in (get_config, get_smoke):
        with pytest.raises(KeyError, match="whisper-medium"):
            get("whisper-large")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_match_reference(arch):
    from repro.configs import get_config as ref_config
    ref, ours = ref_config(arch), get_config(arch)
    mine = dataclasses.asdict(ours)
    for f, value in dataclasses.asdict(ref).items():
        assert mine[f] == value, f
    assert ours.param_count() == ref.param_count()
    assert ours.param_count(active_only=True) == \
        ref.param_count(active_only=True)
    assert ours.torch_dtype() == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_tree(arch):
    """``Model.init`` draws a tree of the reference's names and shapes."""
    rcfg, cfg = ref_smoke(arch), get_smoke(arch)
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    depths = {"layers": cfg.num_layers, "enc_layers": cfg.encoder_layers}
    ref_shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        name = ".".join(p.key for p in path)
        stack, _, rest = name.partition(".")
        if stack in depths and rest:
            for i in range(depths[stack]):
                ref_shapes[f"{stack}.{i}.{rest}"] = leaf.shape[1:]
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
    renc, enc = _both(_enc(model.cfg))
    ops.reset_launch_counts()
    tok = torch.as_tensor(tok.copy())
    out = model.prefill(params, tok, enc_frames=enc)
    assert ops.launch_counts()["flash_attention"] == 0    # CPU: plain
    assert out.shape == (2, 40, model.cfg.vocab_size)
    _close(out.numpy(), rmodel.prefill(rparams, jnp.asarray(tok.numpy()),
                                       enc_frames=renc))
    last = model.prefill(params, tok, enc_frames=enc, logits_mode="last")
    assert last.shape == (2, 1, model.cfg.vocab_size)
    _close(last.numpy(), rmodel.prefill(rparams, jnp.asarray(tok.numpy()),
                                        enc_frames=renc, logits_mode="last"))


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a not in ENC_DEC_ARCHS])
def test_flash_prefill_matches_naive(arch):
    """The reference's own bound between the two paths
    (``tests/test_flash_attention.py``): 2e-3. Not on whisper, whose
    flash encoder lets the zero keys that pad T_enc to 128 into its
    softmax (ROADMAP Queue C item 3): ``test_torch_encdec.py`` holds
    that gap to the reference's."""
    _, _, model, params = _pair(arch)
    tok = torch.as_tensor(_tokens(model.cfg))
    naive = model.prefill(params, tok)
    flash = build_model(model.cfg.with_(attn_impl="flash")).prefill(params,
                                                                    tok)
    assert float((naive - flash).abs().max()) < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """12 ``decode_step`` calls against the reference's, logits at each
    step and every cache tensor at the end (K/V; MLA's latent c_kv and
    k_rope; the SSM layers' conv and SSM states; the hybrid's
    shared-block K/V; whisper's cross K/V, filled from its encoder by
    each package's ``Engine``)."""
    rmodel, rparams, model, params = _pair(arch)
    B, S = 2, 12
    tok = _tokens(model.cfg, B, S)
    rcache, cache = _filled_caches(rmodel, rparams, model, params, B, S + 4,
                                   _enc(model.cfg, B))
    rdecode = jax.jit(rmodel.decode_step)
    for t in range(S):
        rlg, rcache = rdecode(rparams, jnp.asarray(tok[:, t:t + 1]), rcache,
                              jnp.int32(t))
        lg, cache = model.decode_step(params, torch.as_tensor(
            tok[:, t:t + 1]), cache, t)
        assert lg.shape == (B, 1, model.cfg.vocab_size)
        _close(lg.numpy(), rlg)
    tensors, rtensors = _cache_tensors(cache), _cache_tensors(rcache)
    assert set(tensors) == set(rtensors)
    for name, t in tensors.items():
        _close(t.numpy(), rtensors[name])


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


def test_decode_past_the_window_matches_reference():
    """A reference defect kept for parity (ROADMAP Queue C): mixtral's
    cache is allocated window-sized (32 slots in the smoke), and every
    write at a position past it lands in the last slot, clamped, so
    decode past the window leaves the prefill. 40 tokens decoded one by
    one into a cache asked for 64: the port's logits equal the
    reference's within 1e-5 of their max at every position; both agree
    with the full prefill through position 31 (5e-4) and leave it from
    position 32 on (measured: 3.2e-2 of max|logits| at 32, 0.28 at 33,
    0.77 at 39, in both packages)."""
    rmodel, rparams, model, params = _pair("mixtral-8x7b")
    steps = 40
    tok = _tokens(model.cfg, 1, steps)
    rcache = rmodel.init_cache(1, 64)
    cache = model.init_cache(1, 64, "cpu")
    assert cache["layers"]["k"].shape[2] == model.cfg.sliding_window == 32
    rdecode = jax.jit(rmodel.decode_step)
    rfull = np.asarray(rmodel.prefill(rparams, jnp.asarray(tok)))[0]
    full = model.prefill(params, torch.as_tensor(tok))[0].numpy()
    rerr, err = [], []
    for t in range(steps):
        rlg, rcache = rdecode(rparams, jnp.asarray(tok[:, t:t + 1]), rcache,
                              jnp.int32(t))
        lg, cache = model.decode_step(params, torch.as_tensor(
            tok[:, t:t + 1]), cache, t)
        _close(lg.numpy(), rlg)
        scale = float(np.abs(rfull[t]).max())
        rerr.append(float(np.abs(np.asarray(rlg)[0, 0] - rfull[t]).max())
                    / scale)
        err.append(float(np.abs(lg[0, 0].numpy() - full[t]).max()) / scale)
    for e in (rerr, err):
        assert max(e[:32]) < 5e-4
        assert min(e[32:]) > 1e-2, e[32:]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_prefill(arch):
    """The port's decode path against its own prefill, token by token,
    within the reference's 5e-4 (``tests/test_decode_consistency.py``)."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    B, S = 2, 12
    tok = torch.as_tensor(_tokens(cfg, B, S))
    enc = _both(_enc(cfg, B))[1]
    ref = model.prefill(params, tok, enc_frames=enc)
    cache = model.init_cache(B, S + 4, "cpu")
    if enc is not None:
        cache = Engine(model, params, S + 4)._fill_cross_attn(cache, enc)
    errs = []
    for t in range(S):
        lg, cache = model.decode_step(params, tok[:, t:t + 1], cache, t)
        errs.append(float((lg[:, 0] - ref[:, t]).abs().max()))
    assert max(errs) < 5e-4, f"{arch}: max err {max(errs)}"


@pytest.mark.parametrize("max_len", [20, 64])
@pytest.mark.parametrize("arch", ["qwen3-1.7b"] + MOE_ARCHS + SSM_ARCHS
                         + MLA_ARCHS + ENC_DEC_ARCHS)
def test_cache_specs_match_reference(arch, max_len):
    """mixtral's cache is its window long (32 slots in the smoke) once
    max_len passes it, as the reference allocates it; the SSM layers'
    conv and SSM states, the hybrid's shared-block K/V, MLA's latent
    cache and whisper's top-level cross K/V (T_enc long whatever
    max_len) take the reference's shapes and dtypes."""
    rcfg, cfg = ref_smoke(arch), get_smoke(arch)
    rspecs = _cache_tensors(ref_build(rcfg).cache_specs(3, max_len))
    specs = _cache_tensors(build_model(cfg).cache_specs(3, max_len))
    cache = _cache_tensors(build_model(cfg).init_cache(3, max_len, "cpu"))
    assert set(specs) == set(rspecs) == set(cache)
    for name, (shape, dt) in specs.items():
        assert shape == rspecs[name].shape
        assert str(dt) == f"torch.{rspecs[name].dtype}"
        assert cache[name].shape == shape and cache[name].dtype == dt
        assert not bool(cache[name].any())
    if cfg.sliding_window is not None:
        assert cache["layers.k"].shape[2] == min(max_len, cfg.sliding_window)


def test_other_families_and_impls_name_the_roadmap_item():
    """The impls still missing, ``chunked`` / ``qchunk`` (on a dense, a
    MoE, the hybrid and the enc-dec arch), name ROADMAP Queue A item 11
    step 6; MLA takes no attention impl (the reference's ``mla_forward``
    reads none), so under them it computes the naive logits. SSM,
    hybrid, MLA and enc-dec configs made from a dense one build and
    run, enc-dec with its frames (and not without them); frames given to
    an arch with no encoder are refused."""
    tok = torch.zeros((1, 8), dtype=torch.int64)
    frames = torch.zeros((1, 16, 128))
    cfg = get_smoke("minicpm3-4b")
    params = build_model(cfg).init(0, "cpu")
    naive = build_model(cfg).prefill(params, tok)
    for impl in ("chunked", "qchunk"):
        assert torch.equal(build_model(cfg.with_(attn_impl=impl)).prefill(
            params, tok), naive)
    for arch in ("qwen3-1.7b", "mixtral-8x7b", "zamba2-1.2b",
                 "whisper-medium"):
        cfg = get_smoke(arch)
        params = build_model(cfg).init(0, "cpu")
        enc = frames if cfg.is_enc_dec else None
        for impl in ("chunked", "qchunk"):
            with pytest.raises(NotImplementedError,
                               match="Queue A item 11 step 6"):
                build_model(cfg.with_(attn_impl=impl)).prefill(
                    params, tok, enc_frames=enc)
    cfg = get_smoke("qwen3-1.7b")
    mla = cfg.with_(mla=MLAConfig(32, 32, 16, 16, 16))
    ssm = cfg.with_(arch_type="ssm", ssm=SSMConfig(16))
    hybrid = cfg.with_(arch_type="hybrid", ssm=SSMConfig(16),
                       hybrid_attn_every=2)
    enc_dec = cfg.with_(arch_type="audio", encoder_layers=2,
                        encoder_seq_len=16)
    for family in (ssm, hybrid, mla, enc_dec):
        model = build_model(family)
        params = model.init(0, "cpu")
        enc = frames if family.is_enc_dec else None
        out = model.prefill(params, tok, enc_frames=enc)
        assert out.shape == (1, 8, cfg.vocab_size)
        assert bool(torch.isfinite(out).all())
    assert len(build_model(mla).init(0, "cpu")["layers"][0]["attn"]
               ["w_uk"].shape) == 2
    with pytest.raises(ValueError, match="needs enc_frames"):
        build_model(enc_dec).prefill(build_model(enc_dec).init(0, "cpu"), tok)
    with pytest.raises(ValueError, match="no encoder"):
        build_model(cfg).prefill(build_model(cfg).init(0, "cpu"), tok,
                                 enc_frames=frames)
    with pytest.raises(ValueError, match="arch_type"):
        build_model(cfg.with_(arch_type="retnet")).init(0, "cpu")


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
