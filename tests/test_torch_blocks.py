"""The port's leaf modules against the reference's: block tables, the
edge set, the data generators (exactly), and the prox / ADMM algebra
and the staleness ring buffer (at 1e-6)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admm as radmm
from repro.core import async_sim as rasync
from repro.core import blocks as rblocks
from repro.core import prox as rprox
from repro.data import TokenPipeline as RTokenPipeline
from repro.data import make_sparse_logreg as r_make_sparse_logreg
from repro_torch.core import admm, async_sim, blocks, prox
from repro_torch.data import TokenPipeline, make_sparse_logreg

TOL = 1e-6


#: Layouts with both kinds of padding, with blocks wholly past ``dim``
#: ((9, 8): blocks 5-7; (5, 4): block 3) and with none ((512, 4)).
FLAT_LAYOUTS = [(20, 4), (100, 3), (512, 8), (1000, 7), (129, 1), (300, 16),
                (9, 8), (5, 4), (512, 4)]


@functools.lru_cache(maxsize=None)
def _flat_reference(dim, M):
    """Six vectors and six tables of the layout, with the reference's
    pack of the vectors and unpack of the tables (one trace a layout)."""
    rb = rblocks.make_flat_blocks(dim, M)
    v = np.random.RandomState(dim).randn(6, dim).astype(np.float32)
    table = np.random.RandomState(1).randn(6, M, rb.block_dim).astype(
        np.float32)
    return (v, np.asarray(rb.to_blocks(jnp.asarray(v))),
            table, np.asarray(rb.from_blocks(jnp.asarray(table))))


@pytest.mark.parametrize("dim,M,lead", [
    pytest.param(dim, M, lead, id=f"{dim}-{M}" if lead == (3,)
                 else f"{dim}-{M}-lead{len(lead)}")
    for dim, M in FLAT_LAYOUTS for lead in [(3,), (), (2, 3)]])
def test_flat_blocks_match_reference(dim, M, lead, monkeypatch):
    """The codec, element for element the reference's, under leading
    axes (), (3,) and (2, 3). The pack is run a second time with its
    allocation poisoned with NaN, so a pad lane it fails to write shows;
    it never shares its input's storage, and the unpack is contiguous
    wherever the layout pads."""
    tb, rb = blocks.make_flat_blocks(dim, M), rblocks.make_flat_blocks(dim, M)
    assert (tb.dim, tb.num_blocks, tb.block_dim, tb.used_dim) == \
        (rb.dim, rb.num_blocks, rb.block_dim, rb.used_dim)
    assert tb.block_dim % blocks.LANE == 0
    mask = tb.padding_mask()
    np.testing.assert_array_equal(mask, rb.padding_mask())
    pads = not mask.all()
    n = int(np.prod(lead, dtype=np.int64))
    v, ref_packed, table, ref_unpacked = (
        a[:n].reshape(lead + a.shape[1:]) for a in _flat_reference(dim, M))
    vt = torch.as_tensor(v)
    packed = tb.to_blocks(vt)
    np.testing.assert_array_equal(packed.numpy(), ref_packed)
    assert not packed.numpy()[..., ~mask].any()
    assert packed.untyped_storage().data_ptr() != \
        vt.untyped_storage().data_ptr()
    unpacked = tb.from_blocks(packed)
    np.testing.assert_array_equal(unpacked.numpy(), v)
    assert unpacked.is_contiguous() or not pads
    np.testing.assert_array_equal(
        tb.from_blocks(torch.as_tensor(table)).numpy(), ref_unpacked)

    new_empty = torch.Tensor.new_empty
    monkeypatch.setattr(torch.Tensor, "new_empty",
                        lambda self, *a, **k: new_empty(self, *a, **k)
                        .fill_(float("nan")))
    poisoned = tb.to_blocks(vt).numpy()
    assert (poisoned[..., ~mask] == 0).all()
    np.testing.assert_array_equal(poisoned, ref_packed)
    np.testing.assert_array_equal(
        tb.from_blocks(torch.as_tensor(poisoned)).numpy(), v)


def test_lane_rounding_and_used_dim_check():
    for n in (0, 1, 127, 128, 129, 315888):
        assert blocks.round_up_to_lane(n) == rblocks.round_up_to_lane(n)
    with pytest.raises(ValueError, match="used_dim"):
        blocks.FlatBlocks(dim=10, num_blocks=1, block_dim=128, used_dim=129)


@pytest.mark.parametrize("dim,M", [(512, 8), (100, 3), (1000, 7)])
def test_edge_set_from_support_matches_reference(dim, M):
    support = np.random.RandomState(dim).rand(4, dim) < 0.02
    tb, rb = blocks.make_flat_blocks(dim, M), rblocks.make_flat_blocks(dim, M)
    np.testing.assert_array_equal(
        blocks.edge_set_from_support(support, tb),
        rblocks.edge_set_from_support(support, rb))


def test_sparse_logreg_data_identical():
    kw = dict(num_workers=4, samples_per_worker=32, dim=512, density=0.1,
              seed=3)
    t, r = make_sparse_logreg(**kw), r_make_sparse_logreg(**kw)
    for field in ("X", "y", "support", "w_true"):
        a, b = getattr(t, field), getattr(r, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_token_pipeline_table_and_batches():
    kw = dict(vocab_size=64, seq_len=17, global_batch=8, seed=5)
    p = TokenPipeline(**kw)
    np.testing.assert_array_equal(p.table(), RTokenPipeline(**kw)._table())
    a, b = p.batch(3, device="cpu"), p.batch(3, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], p.batch(4, device="cpu")["tokens"])
    assert a["tokens"].shape == (8, 16)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    table = torch.as_tensor(p.table())
    toks = torch.cat([a["tokens"], a["labels"][:, -1:]], dim=1)
    for s in range(1, toks.shape[1]):          # every step follows the table
        assert bool((table[toks[:, s - 1]] == toks[:, s, None]).any(1).all())
    split = p.batch(3, num_workers=4, device="cpu")
    assert torch.equal(split["tokens"].reshape(8, 16), a["tokens"])


def test_prox_operators_match_reference():
    rng = np.random.RandomState(0)
    v = (3 * rng.randn(5, 40)).astype(np.float32)
    mu = (0.5 + rng.rand(5, 1)).astype(np.float32)
    tv, tmu, jv, jmu = torch.as_tensor(v), torch.as_tensor(mu), \
        jnp.asarray(v), jnp.asarray(mu)
    pairs = [
        (prox.soft_threshold(tv, 0.7), rprox.soft_threshold(jv, 0.7)),
        (prox.prox_l1(tv, 0.3, tmu), rprox.prox_l1(jv, 0.3, jmu)),
        (prox.prox_box(tv, 1.5), rprox.prox_box(jv, 1.5)),
        (prox.prox_l2(tv, 0.4, tmu), rprox.prox_l2(jv, 0.4, jmu)),
        (prox.prox_group_lasso(tv, 0.5, 1.3, 6),
         rprox.prox_group_lasso(jv, 0.5, 1.3, 6)),
    ]
    for kw in [dict(l1_coef=1e-2, clip=0.8), dict(l1_coef=0.0, clip=None),
               dict(l1_coef=0.1, clip=0.0, l2_coef=0.5)]:
        t, r = prox.make_prox(**kw), rprox.make_prox(**kw)
        assert t.fusable == r.fusable
        pairs.append((t.prox(tv, tmu), r.prox(jv, jmu)))
        pairs.append((t.value(tv), r.value(jv)))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_fusable_rule():
    """clip=0.0 (the degenerate box) and any l2 term stay off the kernel,
    whose clip parameter reads 0.0 as "no box"."""
    assert prox.make_prox(1e-3, 1.0).fusable
    assert prox.make_prox(1e-3, None).fusable
    assert not prox.make_prox(1e-3, 0.0).fusable
    assert not prox.make_prox(1e-3, 1.0, l2_coef=0.5).fusable


def test_admm_algebra_matches_reference():
    rng = np.random.RandomState(1)
    g, y, zt = (rng.randn(3, 4, 128).astype(np.float32) for _ in range(3))
    rho = (0.5 + rng.rand(3, 1, 1)).astype(np.float32)
    for a, b in zip(admm.worker_update(*map(torch.as_tensor, (g, y, zt, rho))),
                    radmm.worker_update(*map(jnp.asarray, (g, y, zt, rho)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    z, ws = rng.randn(4, 128).astype(np.float32), \
        rng.randn(4, 128).astype(np.float32)
    rs = (1 + rng.rand(4, 1)).astype(np.float32)
    tp, rp = prox.make_prox(1e-2, 0.5), rprox.make_prox(1e-2, 0.5)
    np.testing.assert_allclose(
        admm.server_update(torch.as_tensor(z), torch.as_tensor(ws),
                           torch.as_tensor(rs), 0.1, tp.prox).numpy(),
        np.asarray(radmm.server_update(jnp.asarray(z), jnp.asarray(ws),
                                       jnp.asarray(rs), 0.1, rp.prox)),
        rtol=TOL, atol=TOL)
    for args in [(100.0, 0.01, 1.0, 2, 4, 3), (2.0, 0.1, 0.5, 1, 8, 16),
                 (1.0, 0.0, 1.0, 0, 1, 1)]:
        assert admm.theorem1_feasible(*args) == radmm.theorem1_feasible(*args)


def test_history_ring_buffer_matches_reference():
    rng = np.random.RandomState(2)
    hist = rng.randn(3, 5, 128).astype(np.float32)
    new = rng.randn(5, 128).astype(np.float32)
    delays = rng.randint(0, 3, size=(4, 5))
    np.testing.assert_array_equal(
        async_sim.push_history(torch.as_tensor(hist),
                               torch.as_tensor(new)).numpy(),
        np.asarray(rasync.push_history(jnp.asarray(hist), jnp.asarray(new))))
    np.testing.assert_array_equal(
        async_sim.gather_delayed(torch.as_tensor(hist),
                                 torch.as_tensor(delays)).numpy(),
        np.asarray(rasync.gather_delayed(jnp.asarray(hist),
                                         jnp.asarray(delays))))
    one = async_sim.push_history(torch.as_tensor(hist[:1]),
                                 torch.as_tensor(new))
    np.testing.assert_array_equal(one.numpy(), new[None])
