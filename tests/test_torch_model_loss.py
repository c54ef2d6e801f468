"""The training half of the port's model stack against the reference's:
``cross_entropy``, ``Model.loss`` and ``grad_fn`` on the stacked tree,
and the weights carried both ways (``models/weights.py``).

The reference's params (``model.init(PRNGKey(0))``) cross by
``stacked_from_numpy``, so both packages differentiate the same function
on the same seeded tokens (fp32, TF32 off on the CPU). Tolerances: the
loss within 1e-6 relative, each gradient leaf within 1e-5 (1 +
max|g|), the port's parity tolerance (the reference's between its own
backends). Measured on the four dense smokes: loss at most 1.4e-7
relative, gradients at most 7.4e-7 (1 + max|g|); on the two MoE smokes
(both dispatches, the router's auxiliary loss in the sum): loss 1.4e-7,
gradients 5.8e-7; on the SSM and hybrid smokes: loss 1.5e-7, gradients
1.7e-7 (mamba2); on minicpm3 (MLA): loss 0 relative, gradients 6.8e-7;
on whisper (enc-dec, the batch's ``enc_frames`` through the encoder):
loss 7.0e-8, gradients 1.7e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import build_model as ref_build
from repro.models.layers import cross_entropy as ref_cross_entropy
from repro.models.transformer import forward as ref_forward
from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.models import (build_model, params_from_numpy,
                                params_from_stacked, stacked_from_numpy,
                                stacked_params)
from repro_torch.models import transformer
from repro_torch.models.layers import cross_entropy
from repro_torch.serving import Engine

DENSE_ARCHS = ["qwen3-1.7b", "chatglm3-6b", "qwen1.5-32b", "chameleon-34b"]
MOE_ARCHS = ["mixtral-8x7b", "granite-moe-1b-a400m"]
SSM_ARCHS = ["mamba2-370m", "zamba2-1.2b"]
ARCHS = DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS + ["minicpm3-4b",
                                                "whisper-medium"]
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5


def _pair(arch, **overrides):
    """(reference model, its params, port model, the same stacked tree)."""
    rmodel = ref_build(ref_smoke(arch).with_(**overrides))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(arch).with_(**overrides))
    params = stacked_from_numpy(model.cfg, jax.tree.map(np.asarray, rparams),
                                "cpu")
    return rmodel, rparams, model, params


def _batch(cfg, B=2, S=24, seed=1, mask=False, lead=()):
    """A numpy-seeded batch of (*lead, B, S) tokens as both packages'
    arrays, with an enc-dec arch's ``enc_frames`` (*lead, B, T_enc, d)."""
    r = np.random.RandomState(seed)
    tok = r.randint(0, cfg.vocab_size, lead + (B, S + 1))
    batch = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
    if mask:
        batch["label_mask"] = (r.rand(B, S) < 0.7).astype(np.float32)
    if cfg.is_enc_dec:
        batch["enc_frames"] = (r.randn(*lead, B, cfg.encoder_seq_len,
                                       cfg.d_model) * 0.1).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _grad_close(g, rg):
    for a, b in zip(tree_leaves(g), jax.tree.leaves(rg)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_TOL * (1.0 + float(np.abs(b).max())), err


@pytest.mark.parametrize("mask", [False, True])
def test_cross_entropy_matches_reference(mask):
    r = np.random.RandomState(3)
    logits = (r.randn(3, 7, 50) * 4).astype(np.float32)
    labels = r.randint(0, 50, (3, 7))
    lm = (r.rand(3, 7) < 0.5).astype(np.float32) if mask else None
    ref = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if lm is None else jnp.asarray(lm))
    out = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                        None if lm is None else torch.as_tensor(lm))
    assert out.dtype == torch.float32 and out.shape == ()
    np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL)
    # an all-zero mask divides by max(sum, 1), not by zero
    if mask:
        zero = cross_entropy(torch.as_tensor(logits),
                             torch.as_tensor(labels), torch.zeros(3, 7))
        assert float(zero) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rmodel, rparams, model, params = _pair(arch)
    rb, tb = _batch(model.cfg)
    rloss, rgrad = jax.value_and_grad(rmodel.loss)(rparams, rb)
    loss = model.loss(params, tb)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_TOL)
    _grad_close(model.grad_fn()(params, tb), rgrad)


@pytest.mark.parametrize("impl", ["onehot", "scatter"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_carries_the_aux_loss(arch, impl):
    """``Model.loss`` of a MoE arch is the cross-entropy plus the layers'
    router load-balance terms, summed in layer order: the aux equals the
    reference's (1e-6 relative) and is not zero; the loss and gradient
    match the reference's in each dispatch."""
    rmodel, rparams, model, params = _pair(arch, moe_impl=impl)
    rb, tb = _batch(model.cfg)
    rlogits, raux = ref_forward(rparams, rb["tokens"], rmodel.cfg)
    logits, aux = transformer.forward(params, tb["tokens"], model.cfg)
    assert float(raux) > 0.0
    np.testing.assert_allclose(float(aux), float(raux), rtol=LOSS_TOL)
    with torch.no_grad():
        ce = cross_entropy(logits, tb["labels"])
        np.testing.assert_allclose(float(model.loss(params, tb)),
                                   float(ce + aux), rtol=0, atol=0)
    rloss, rgrad = jax.value_and_grad(rmodel.loss)(rparams, rb)
    np.testing.assert_allclose(float(model.loss(params, tb)), float(rloss),
                               rtol=LOSS_TOL)
    _grad_close(model.grad_fn()(params, tb), rgrad)


def test_loss_with_a_label_mask_matches_reference():
    rmodel, rparams, model, params = _pair("qwen3-1.7b")
    rb, tb = _batch(model.cfg, mask=True)
    rloss, rgrad = jax.value_and_grad(rmodel.loss)(rparams, rb)
    np.testing.assert_allclose(float(model.loss(params, tb)), float(rloss),
                               rtol=LOSS_TOL)
    _grad_close(model.grad_fn()(params, tb), rgrad)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "zamba2-1.2b", "minicpm3-4b",
                                  "whisper-medium"])
def test_loss_under_vmap_matches_per_worker_losses(arch):
    """``TreeSpace.worker_grads`` calls the loss as
    ``vmap(grad_and_value(loss))`` over a leading worker axis: each
    worker's loss and gradient equal the loss taken on its own (for
    granite-moe through top-k, the cumsum and the dispatch; for zamba2
    through the SSD scan and the shared block; for minicpm3 through
    MLA's in-place scale and mask; for whisper with each worker's own
    ``enc_frames`` through the encoder and ``enc_layers``)."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    per = [stacked_params(cfg, seed, "cpu") for seed in (0, 1)]
    leaves, treedef = tree_flatten(per[0])
    both = tree_unflatten(treedef, [torch.stack(pair) for pair in zip(
        leaves, tree_leaves(per[1]))])
    _, batch = _batch(cfg, B=2, S=16, seed=4, lead=(2,))
    g, losses = torch.func.vmap(torch.func.grad_and_value(model.loss))(
        both, batch)
    for i in range(2):
        b = {k: v[i] for k, v in batch.items()}
        torch.testing.assert_close(losses[i], model.loss(per[i], b),
                                   rtol=1e-6, atol=0)
        for a, ref in zip(tree_leaves(g), tree_leaves(
                model.grad_fn()(per[i], b))):
            torch.testing.assert_close(a[i], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_forward_matches_paramtree_prefill(arch):
    """The training forward (stacked tree, layers unbound once) and the
    inference forward (``ParamTree``) of the same weights compute the
    same logits."""
    _, rparams, model, stacked = _pair(arch)
    tree = params_from_numpy(model.cfg, jax.tree.map(np.asarray, rparams),
                             "cpu")
    _, tb = _batch(model.cfg, S=20, seed=5)
    tok, enc = tb["tokens"], tb.get("enc_frames")
    ref = model.prefill(tree, tok, enc_frames=enc)
    out = model.prefill(stacked, tok, enc_frames=enc)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-6 * scale
    last = model.prefill(stacked, tok, enc_frames=enc, logits_mode="last")
    assert float((last - ref[:, -1:]).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "zamba2-1.2b", "minicpm3-4b",
                                  "whisper-medium"])
def test_params_from_stacked_views_the_tree_and_serves_it(arch):
    """``params_from_stacked`` copies no weight: every parameter is a
    view of a stacked leaf (a write to the stacked tree shows through),
    and the ``Engine`` serves it as it serves ``Model.init``'s tree (for
    granite-moe the (L, E, d, ff) expert stacks too; for zamba2 the
    SSM layers and the unstacked shared block; for minicpm3 the MLA
    weights; for whisper the encoder's ``enc_layers`` too, served with
    frames)."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    stacked = stacked_params(cfg, 0, "cpu")
    tree = params_from_stacked(cfg, stacked)
    init = model.init(0, "cpu")      # the same draws, per layer
    assert [n for n, _ in tree.named_parameters()] == \
        [n for n, _ in init.named_parameters()]
    for (_, a), (_, b) in zip(tree.named_parameters(),
                              init.named_parameters()):
        assert torch.equal(a, b) and not a.requires_grad
    group, name = ("mamba", "w_in") if cfg.ssm is not None else \
        ("attn", "w_uk") if cfg.mla is not None else ("attn", "w_q")
    w = stacked["layers"][group][name]
    assert tree["layers"][1][group][name].data_ptr() == w[1].data_ptr()
    assert tree["embed"].data_ptr() == stacked["embed"].data_ptr()
    if cfg.arch_type == "hybrid":
        assert tree["shared_attn"]["attn"]["w_q"].data_ptr() == \
            stacked["shared_attn"]["attn"]["w_q"].data_ptr()
    if cfg.moe is not None:
        w_up = stacked["layers"]["moe"]["w_up"]
        assert tree["layers"][1]["moe"]["w_up"].data_ptr() == \
            w_up[1].data_ptr()
    if cfg.is_enc_dec:
        for stack, sub in (("enc_layers", "attn"), ("layers", "cross")):
            w_k = stacked[stack][sub]["w_k"]
            assert tree[stack][1][sub]["w_k"].data_ptr() == \
                w_k[1].data_ptr()
        with pytest.raises(ValueError, match="enc_layers: 2 stacked"):
            params_from_stacked(cfg.with_(encoder_layers=3), stacked)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 4))
    enc = _batch(cfg, B=2, seed=6)[1].get("enc_frames")
    a = Engine(model, tree, max_len=16).generate(prompts, max_new=4,
                                                 enc_frames=enc)
    b = Engine(model, init, max_len=16).generate(prompts, max_new=4,
                                                 enc_frames=enc)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    w[1].add_(1.0)
    assert torch.equal(tree["layers"][1][group][name], w[1])
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_stacked(cfg.with_(num_layers=3), stacked)


def test_stacked_from_numpy_keeps_dtypes_and_checks_the_tree():
    rcfg = ref_smoke("qwen3-1.7b").with_(param_dtype="bfloat16")
    rparams = jax.tree.map(np.asarray,
                           ref_build(rcfg).init(jax.random.PRNGKey(0)))
    cfg = get_smoke("qwen3-1.7b").with_(param_dtype="bfloat16")
    params = stacked_from_numpy(cfg, rparams, "cpu")
    for a, b in zip(tree_leaves(params), jax.tree.leaves(rparams)):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      b.view(np.int16))
    bad = dict(rparams, embed=rparams["embed"][:-1])
    with pytest.raises(ValueError, match="embed: shape"):
        stacked_from_numpy(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="names"):
        stacked_from_numpy(cfg, dict(rparams, extra=rparams["embed"]),
                           "cpu")


def test_param_specs_are_the_reference_shapes_on_meta():
    for arch in ARCHS:
        rspecs = ref_build(ref_smoke(arch)).param_specs()
        specs = build_model(get_smoke(arch)).param_specs()
        assert all(t.device.type == "meta" for t in tree_leaves(specs))
        assert [tuple(t.shape) for t in tree_leaves(specs)] == \
            [s.shape for s in jax.tree.leaves(rspecs)]
        assert [str(t.dtype).replace("torch.", "")
                for t in tree_leaves(specs)] == \
            [str(s.dtype) for s in jax.tree.leaves(rspecs)]


def _saved_bytes(model, params, batch):
    """Bytes of the activations autograd saves for the backward of
    ``model.loss`` (tensors that are not views of a parameter)."""
    total = [0]
    leaves, treedef = tree_flatten(params)
    live = tree_unflatten(treedef, [t.detach().requires_grad_()
                                    for t in leaves])
    weights = {t.untyped_storage().data_ptr() for t in tree_leaves(live)}

    def pack(t):
        if t.untyped_storage().data_ptr() not in weights:
            total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(live, batch)
    return total[0]


def test_remat_on_the_stacked_tree_matches_plain():
    """``remat=True`` trains on the stacked tree: the loss and gradient
    equal ``remat=False``'s, and autograd saves less (each layer keeps
    only its inputs and recomputes the rest in the backward; the
    reference's parity is ``tests/test_torch_remat.py``)."""
    cfg = get_smoke("qwen3-1.7b").with_(remat=True)
    model, plain = build_model(cfg), build_model(cfg.with_(remat=False))
    _, tb = _batch(cfg)
    params = stacked_params(cfg, 0, "cpu")
    g, loss = torch.func.grad_and_value(model.loss)(params, tb)
    g_plain, loss_plain = torch.func.grad_and_value(plain.loss)(params, tb)
    np.testing.assert_allclose(float(loss), float(loss_plain), rtol=LOSS_TOL)
    for a, b in zip(tree_leaves(g), tree_leaves(g_plain)):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_TOL)
    assert _saved_bytes(model, params, tb) < \
        0.5 * _saved_bytes(plain, params, tb)
    # inference on the ParamTree ignores it, as the reference's does
    assert model.prefill(model.init(0, "cpu"), tb["tokens"]).shape == \
        (2, 24, cfg.vocab_size)
