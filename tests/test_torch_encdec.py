"""The port's encoder-decoder family (whisper-medium) against the
reference's at its smoke config (T_enc = 16 frames, not a multiple of
128), and the two new stacked trees (whisper's, minicpm3-4b's) at full
width:

* ``cross_attn_forward`` and ``encode_cross_kv`` on one layer's GQA
  weights drawn by the reference, and ``gqa_forward(causal=False)``,
  naive and flash (the reference's Pallas kernel in interpret mode, the
  port's B7 through its plain version on the CPU);
* the encoder (``transformer.encode``) and the cross K/V each decoder
  layer takes from it (``Engine._fill_cross_attn``), naive and flash;
* ROADMAP Queue C item 3, a reference defect kept for parity: the flash
  encoder pads T_enc to 128 with zero keys that no mask hides, so every
  encoder row's softmax takes 112 terms of exp(0 - m) here. Flash and
  naive are different functions in both packages, and the port's gap is
  the reference's; at T_enc = 128 (no pad) they agree within the
  reference's 2e-3;
* greedy tokens of ``Engine.generate`` with frames on the flash path;
* the weights both ways with ``enc_layers`` (``params_from_numpy``,
  ``stacked_from_numpy``, ``stacked_params``);
* the block layouts of both trees at full width (shapes only), bitwise
  the reference's, their leaves in JAX's sorted order.

Tolerance: 1e-5 of max|reference output| (the port's parity tolerance).
Measured: the cross K/V bitwise, cross-attention within 2.8e-7, the
encoder 6.5e-7 (naive) and 5.7e-7 (flash); the flash-naive gap of the
encoder output 0.90 of its max in both packages, 0.81 of max|logits| at
the logits, the two packages' gaps within 7.9e-7 of each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke as ref_smoke
from repro.core import blocks as rblocks
from repro.models import attention as rattn
from repro.models import build_model as ref_build
from repro.models import transformer as rtransformer
from repro.serving import Engine as RefEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import blocks, tree
from repro_torch.kernels import ops
from repro_torch.models import (attention, build_model, params_from_numpy,
                                stacked_from_numpy, stacked_params,
                                transformer)
from repro_torch.serving import Engine

ARCH = "whisper-medium"
PARITY = 1e-5
FLASH_NAIVE_TOL = 2e-3         # tests/test_flash_attention.py:69


def _close(out, ref, tol=PARITY):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, np.abs(ref).max())


def _frames(cfg, B=2, seed=2):
    return (np.random.RandomState(seed).randn(
        B, cfg.encoder_seq_len, cfg.d_model) * 0.1).astype(np.float32)


def _pair(**overrides):
    """(reference model, its params, port model, the same params)."""
    rmodel = ref_build(ref_smoke(ARCH).with_(**overrides))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(ARCH).with_(**overrides))
    params = params_from_numpy(model.cfg, jax.tree.map(np.asarray, rparams),
                               "cpu")
    return rmodel, rparams, model, params


def _ref_encoder(rparams, frames, cfg):
    """The reference's encoder, as its ``forward`` runs it."""
    pos = jnp.broadcast_to(jnp.arange(frames.shape[1])[None],
                           frames.shape[:2])
    x = frames
    for i in range(cfg.encoder_layers):
        lp = jax.tree.map(lambda a: a[i], rparams["enc_layers"])
        x, _ = rtransformer._dense_layer_fwd(lp, x, cfg, pos, causal=False)
    return rtransformer.rmsnorm(x, rparams["enc_norm"], cfg.norm_eps)


def test_cross_attention_matches_reference():
    rcfg, cfg = ref_smoke(ARCH), get_smoke(ARCH)
    rp = rattn.init_attention(jax.random.PRNGKey(3), rcfg, cross=True)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in rp.items()}
    r = np.random.RandomState(4)
    x = r.randn(2, 7, cfg.d_model).astype(np.float32)
    enc = r.randn(2, cfg.encoder_seq_len, cfg.d_model).astype(np.float32)
    rkv = rattn.encode_cross_kv(rp, jnp.asarray(enc), rcfg)
    kv = attention.encode_cross_kv(tp, torch.as_tensor(enc), cfg)
    for a, b in zip(kv, rkv):
        _close(a, b)
    _close(attention.cross_attn_forward(tp, torch.as_tensor(x), kv, cfg),
           rattn.cross_attn_forward(rp, jnp.asarray(x), rkv, rcfg))


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_bidirectional_self_attention_matches_reference(impl):
    """``gqa_forward(causal=False)``: no mask on the naive path, B7
    without its causal mask on the flash path (the zero keys of the pad
    from 16 to 128 in the softmax, in both packages)."""
    rcfg = ref_smoke(ARCH).with_(attn_impl=impl)
    cfg = get_smoke(ARCH).with_(attn_impl=impl)
    rp = rattn.init_attention(jax.random.PRNGKey(5), rcfg)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in rp.items()}
    x = _frames(cfg, seed=6)
    pos = np.broadcast_to(np.arange(x.shape[1])[None], x.shape[:2]).copy()
    ops.reset_launch_counts()
    out = attention.gqa_forward(tp, torch.as_tensor(x), cfg,
                                torch.as_tensor(pos), causal=False)
    assert ops.launch_counts()["flash_attention"] == 0     # CPU: plain
    _close(out, rattn.gqa_forward(rp, jnp.asarray(x), rcfg, jnp.asarray(pos),
                                  causal=False))


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_encoder_and_cross_kv_match_reference(impl):
    """The encoder over the frames (``transformer.encode``), and each
    decoder layer's cross K/V that ``Engine._fill_cross_attn`` writes
    into the cache, against the reference's."""
    rmodel, rparams, model, params = _pair(attn_impl=impl)
    frames = _frames(model.cfg)
    _close(transformer.encode(params, torch.as_tensor(frames), model.cfg),
           _ref_encoder(rparams, jnp.asarray(frames), rmodel.cfg))
    rcache = RefEngine(rmodel, rparams, 8)._fill_cross_attn(
        rmodel.init_cache(2, 8), jnp.asarray(frames))
    cache = Engine(model, params, 8)._fill_cross_attn(
        model.init_cache(2, 8, "cpu"), torch.as_tensor(frames))
    for name in ("cross_k", "cross_v"):
        _close(cache[name], rcache[name])
    assert not bool(cache["layers"]["k"].any())


def test_flash_encoder_pads_keys_as_the_reference_does():
    """ROADMAP Queue C item 3 on the CPU. At T_enc = 16 the flash
    encoder is not the naive one (the 112 zero keys of the pad enter
    every row's softmax): the gap of the encoder output and of the
    logits is far past 2e-3 in both packages, and the port's gap is the
    reference's. At T_enc = 128 (no pad) the two paths agree within
    the reference's 2e-3."""
    tok = np.random.RandomState(7).randint(0, 512, (2, 10))
    gaps, rgaps, scales = {}, {}, {}
    for seq in (16, 128):
        outs, routs = {}, {}
        for impl in ("naive", "flash"):
            rmodel, rparams, model, params = _pair(attn_impl=impl,
                                                   encoder_seq_len=seq)
            frames = _frames(model.cfg)
            outs[impl] = model.prefill(params, torch.as_tensor(tok),
                                       enc_frames=torch.as_tensor(frames))
            routs[impl] = np.asarray(rmodel.prefill(
                rparams, jnp.asarray(tok), enc_frames=jnp.asarray(frames)))
            _close(outs[impl], routs[impl])
        gaps[seq] = (outs["flash"] - outs["naive"]).numpy()
        rgaps[seq] = routs["flash"] - routs["naive"]
        scales[seq] = float(np.abs(routs["naive"]).max())
    assert float(np.abs(rgaps[16]).max()) > 0.1 * scales[16]
    assert float(np.abs(gaps[16] - rgaps[16]).max()) <= PARITY * scales[16]
    for g in (gaps[128], rgaps[128]):
        assert float(np.abs(g).max()) < FLASH_NAIVE_TOL


def test_flash_generate_matches_reference_engine():
    """Greedy tokens of ``Engine.generate`` with frames on the flash path
    (the encoder through B7's plain version, once; the decode steps
    naive), equal to the reference engine's (its encoder through the
    Pallas kernel in interpret mode)."""
    rmodel, rparams, model, params = _pair(attn_impl="flash")
    prompts = np.random.RandomState(8).randint(0, 512, (2, 5))
    frames = _frames(model.cfg, seed=9)
    ops.reset_launch_counts()
    res = Engine(model, params, 16).generate(prompts, max_new=6,
                                             enc_frames=frames)
    assert ops.launch_counts()["flash_attention"] == 0     # CPU: plain
    ref = RefEngine(rmodel, rparams, 16).generate(prompts, max_new=6,
                                                  enc_frames=frames)
    np.testing.assert_array_equal(res.tokens, ref.tokens)


def test_weights_round_trip_with_enc_layers():
    """The reference's tree, ``enc_layers`` stacked on
    ``encoder_layers``, into a ``ParamTree`` (each encoder layer a module
    of the ``enc_layers`` list) and into the stacked dict, bitwise;
    a tree stacked on the wrong depth is refused."""
    rcfg, cfg = ref_smoke(ARCH), get_smoke(ARCH)
    tree_np = jax.tree.map(np.asarray, ref_build(rcfg).init(
        jax.random.PRNGKey(0)))
    params = params_from_numpy(cfg, tree_np, "cpu")
    assert len(params["enc_layers"]) == cfg.encoder_layers
    for i in range(cfg.encoder_layers):
        np.testing.assert_array_equal(
            params["enc_layers"][i]["attn"]["w_q"].numpy(),
            tree_np["enc_layers"]["attn"]["w_q"][i])
        np.testing.assert_array_equal(
            params["layers"][i]["cross"]["w_k"].numpy(),
            tree_np["layers"]["cross"]["w_k"][i])
    stacked = stacked_from_numpy(cfg, tree_np, "cpu")
    for a, b in zip(tree.tree_leaves(stacked), jax.tree.leaves(tree_np)):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="enc_layers.*stacked layers"):
        params_from_numpy(cfg.with_(encoder_layers=3), tree_np, "cpu")
    with pytest.raises(ValueError, match="enc_layers"):
        stacked_from_numpy(cfg.with_(encoder_layers=3), tree_np, "cpu")


def test_stacked_params_are_model_init_stacked():
    """``stacked_params(cfg, seed)`` holds ``Model.init(seed)``'s values
    for both stacks, in the reference's names and leaf order."""
    cfg = get_smoke(ARCH)
    stacked = stacked_params(cfg, 3, "cpu")
    init = build_model(cfg).init(3, "cpu")
    for stack, depth in (("layers", cfg.num_layers),
                         ("enc_layers", cfg.encoder_layers)):
        for i in range(depth):
            for name, value in init[stack][i].named_parameters():
                leaf = stacked[stack]
                for part in name.split("."):
                    leaf = leaf[part]
                assert torch.equal(leaf[i], value), (stack, name)
    assert torch.equal(stacked["enc_norm"], init["enc_norm"])
    rshapes = jax.eval_shape(ref_build(ref_smoke(ARCH)).init,
                             jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in tree.tree_leaves(stacked)] == \
        [x.shape for x in jax.tree.leaves(rshapes)]


@pytest.mark.parametrize("arch,m", [("whisper-medium", 2),
                                    ("whisper-medium", 8),
                                    ("minicpm3-4b", 2), ("minicpm3-4b", 8)])
def test_full_width_stacked_tree_layout_matches_reference(arch, m):
    """The two trees at their full widths and depths (shapes only:
    ``jax.eval_shape`` against ``meta`` tensors): the LPT assignment,
    offsets and block sizes bitwise the reference's; whisper's leaves in
    JAX's sorted order (``enc_layers`` and ``enc_norm`` between
    ``embed`` and ``final_norm``; within a decoder layer ``attn``,
    ``cross``, ``mlp``, the norms), minicpm3's MLA leaves sorted within
    ``attn``. The trees hold 810,987,520 and 4,261,902,848 parameters:
    ``param_count`` (810,960,896 and 4,261,836,800) leaves out the
    norms' vectors."""
    rshapes = jax.eval_shape(ref_build(ref_config(arch)).init,
                             jax.random.PRNGKey(0))
    meta = stacked_params(get_config(arch), 0, "meta")
    layout = blocks.make_block_layout(meta, num_blocks=m)
    rlayout = rblocks.make_block_layout(rshapes, num_blocks=m)
    for field in ("block_ids", "leaf_offsets", "leaf_shapes", "leaf_dtypes",
                  "block_leaves", "block_sizes", "block_dim"):
        assert getattr(layout, field) == getattr(rlayout, field), field
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rshapes)[0]]
    tops = list(dict.fromkeys(n.split("]")[0] + "]" for n in names))
    if arch == "whisper-medium":
        assert tops == ["['embed']", "['enc_layers']", "['enc_norm']",
                        "['final_norm']", "['layers']", "['lm_head']"]
        dec = list(dict.fromkeys(n.split("]")[1] + "]" for n in names
                                 if n.startswith("['layers']")))
        assert dec == ["['attn']", "['cross']", "['mlp']", "['norm1']",
                       "['norm2']", "['norm_cross']"]
        assert sum(int(np.prod(s)) for s in layout.leaf_shapes) == \
            810_987_520
    else:
        attn = [n.split("]")[2][2:-1] for n in names
                if n.startswith("['layers']['attn']")]
        assert attn == ["kv_norm", "q_norm", "w_dkv", "w_dq", "w_o", "w_uk",
                        "w_uq", "w_uv"]
        assert sum(int(np.prod(s)) for s in layout.leaf_shapes) == \
            4_261_902_848
    assert [tuple(t.shape) for t in tree.tree_leaves(meta)] == \
        [tuple(x.shape) for x in jax.tree.leaves(rshapes)]
