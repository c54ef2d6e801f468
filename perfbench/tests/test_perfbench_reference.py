"""The plain references against the port's plain backend at tiny sizes
(the CPU runs no kernel: the port's ``auto`` backend is its plain torch
composition here), and the counts against hand counts."""
import math

import numpy as np
import pytest
import torch

from conftest import TINY_MLA, dry_run, tiny_cell
from perfbench.counts import flat as flat_counts
from perfbench.counts import train as train_counts
from perfbench.harness import inputs, traffic
from perfbench.reference import admm_tree, draws, mla_transformer


@pytest.mark.parametrize("name", ["kdda-8w64b.all_edges",
                                  "kdda-8w64b.band_edges"])
def test_flat_reference_follows_the_port(name):
    line, out = dry_run(name, seconds=0.2)
    assert line["correct"], line["checked"]
    assert out.attempted > 10 and out.failed == 0


@pytest.mark.parametrize("sequences", [2, 1])
def test_train_reference_follows_the_port(sequences):
    name = "minicpm3-4b-l6.admm_2x512"
    line, out = dry_run(name, seconds=0.2, sequences_per_worker=sequences)
    assert line["correct"], line["checked"]
    assert out.notes["leaves_compared"] == len(
        mla_transformer.param_shapes(tiny_cell(name).config))


def test_mla_loss_and_gradient_match_model_loss():
    from perfbench.drivers.admm_train import model_config
    from repro_torch.models import build_model
    cfg = tiny_cell("minicpm3-4b-l6.admm_2x512").config
    shapes = mla_transformer.param_shapes(cfg)
    paths = sorted(shapes)
    tree = inputs.weights(shapes, 5, "cpu")
    ids = torch.randint(0, cfg["vocab_size"], (3, 17),
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    model = build_model(model_config(cfg))
    g_port, l_port = torch.func.grad_and_value(model.loss)(tree, batch)
    leaves = {p: admm_tree_leaf(tree, p).detach().requires_grad_(True)
              for p in paths}
    l_ref = mla_transformer.loss(leaves, batch["tokens"], batch["labels"],
                                 cfg)
    g_ref = torch.autograd.grad(l_ref, [leaves[p] for p in paths])
    l_ref = float(l_ref.detach())
    assert abs(float(l_port) - l_ref) <= 1e-6 * abs(l_ref)
    for p, g in zip(paths, g_ref):
        got = admm_tree_leaf(g_port, p)
        assert float(torch.max(torch.abs(got - g))) <= 1e-5 * (
            1 + float(torch.max(torch.abs(g)))), p


def admm_tree_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -1.0 - 2.0 ** -12, 3.0e38])
    r = mla_transformer.tf32(x)
    assert r.tolist()[:4] == [1.0, 1.0, 1.0 + 4 * 2.0 ** -11, -1.0]
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_draws_are_the_ports(seed):
    from repro_torch.core.async_sim import sample_delays, select_blocks
    from repro_torch.device import seeded_generator
    edge = traffic.edges({"kind": "band", "width": 3, "stride": 2}, 5, 8,
                         "cpu")
    for t in (0, 1, 17):
        want = sample_delays(seeded_generator("cpu", seed, t, 0), 5, 8, 2)
        assert torch.equal(draws.delays("cpu", seed, t, 5, 8, 2), want)
        for frac in (0.25, 0.5, 1.0):
            want = select_blocks(seeded_generator("cpu", seed, t, 1), edge,
                                 frac)
            assert torch.equal(draws.selection("cpu", seed, t, edge, frac),
                               want)


@pytest.mark.parametrize("cfg", [TINY_MLA, None])
def test_lpt_blocks_are_the_ports(cfg):
    from perfbench.drivers.admm_train import model_config
    from repro_torch.core.blocks import make_block_layout, make_tree_blocks
    from repro_torch.models import build_model
    full = tiny_cell("minicpm3-4b-l6.admm_2x512").config
    if cfg is None:
        from perfbench.harness import manifest
        full = manifest.load_cell("minicpm3-4b-l6.admm_2x512").config
    specs = build_model(model_config(full)).param_specs()
    shapes = mla_transformer.param_shapes(full)
    sizes = [math.prod(shapes[p][0]) for p in sorted(shapes)]
    for M in (2, 3, 8):
        blocks = make_tree_blocks(specs, M)
        assert admm_tree.lpt_blocks(sizes, M) == list(blocks.leaf_block_ids)
        assert train_counts.table_dblk(full, M) == make_block_layout(
            specs, blocks).block_dim


def test_flat_counts_by_hand():
    # N = 2, M = 4, all edges, half selected: k = 2 a worker
    c = flat_counts.epoch([[True] * 4] * 2, 0.5, 128, True)
    row = 128 * 4
    assert c["selected_pairs"] == 4 and c["edge_pairs"] == 8
    assert c["b1_bytes"] == 6 * 8 * row
    assert c["b2_bytes"] == (8 + 2 * 4) * row
    # z~ 4 blocks + c 4 + y 4 + stale w 4 + writes 3 * 4 + z 4
    assert c["step_bytes"] == 32 * row
    # a band of 2 of 4 blocks: k = 2 takes every edge block
    band = [[True, True, False, False], [False, True, True, False]]
    c = flat_counts.epoch(band, 0.5, 128, False)
    assert c["selected_pairs"] == 4 and c["edge_pairs"] == 4
    assert c["b1_bytes"] == (5 * 4 + 4 * 4) * row
    assert c["step_bytes"] == (3 + 4 + 4 + 0 + 2 * 4 + 4) * row


def test_train_counts_by_hand():
    from perfbench.drivers.admm_train import model_config
    cfg = tiny_cell("minicpm3-4b-l6.admm_2x512").config
    d, L, V, ql, kvl = 128, 2, 512, 48, 32
    per_layer = (d * ql + ql * 4 * (16 + 8) + d * (kvl + 8)
                 + kvl * 4 * (16 + 16) + 4 * 16 * d + 3 * d * 256)
    assert train_counts.matmul_params(cfg) == L * per_layer + d * V
    norms = L * (2 * d + ql + kvl) + d
    assert train_counts.params(cfg) == L * per_layer + 2 * d * V + norms
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import build_model
    specs = build_model(model_config(cfg)).param_specs()
    assert train_counts.params(cfg) == sum(t.numel()
                                           for t in tree_leaves(specs))
    pairs = 16 * 17 // 2
    attn = 3 * 2 * 4 * pairs * (16 + 8 + 16) * L * 4
    assert train_counts.attention_flops(cfg, 4, 16) == attn
    c = train_counts.step(cfg, 2, 2, 2, 16)
    assert c["step_flops"] == 6 * (L * per_layer + d * V) * 64 + attn
    assert c["step_bytes"] == 8 * train_counts.params(cfg) * 4


def test_inputs_are_the_seeds():
    a = inputs.centers(3, 2, 10, "cpu")
    assert torch.equal(a, inputs.centers(3, 2, 10, "cpu"))
    assert not torch.equal(a, inputs.centers(4, 2, 10, "cpu"))
    shapes = {("a",): ((4, 3), ("dense", 4)), ("b", "c"): ((5,), ("ones",))}
    tree = inputs.weights(shapes, 2**31 + 3, "cpu")
    assert torch.equal(tree["b"]["c"], torch.ones(5))
    assert np.isclose(float(tree["a"].std()), 0.5, atol=0.5)
