"""The port's checkpoint files (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), on the CPU.

(a) the format interchanges both ways: a checkpoint the port writes
    loads through the reference's ``load_arrays`` / ``load_extra`` /
    ``load_step`` / ``restore``, and one the reference writes restores in
    the port, for f32, f16, int32 and bool leaves in nested dict, list,
    tuple and namedtuple trees; both packages write the same keys, leaf
    bytes and manifests;
(b) ``restore`` matches leaves by key (the reference flattens dicts in
    sorted key order, torch in insertion order) and returns tensors with
    the like tree's dtype and device;
(c) bf16 leaves are written as the reference writes them, and refused
    on restore, as the reference refuses them;
(d) torn halves, a missing payload, a corrupt manifest, a missing leaf
    and a shape mismatch raise the reference's errors, naming the file
    and the leaf; saves leave no temp files behind
    (``tests/test_ps_recovery.py:329-388``).
"""
import collections
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as rck
from repro_torch import checkpoint as tck

Pair = collections.namedtuple("Pair", "lo hi")
_r = np.random.RandomState(5)


def _leaves():
    return {"f32": _r.randn(2, 3).astype(np.float32),
            "f16": _r.randn(4).astype(np.float16),
            "i32": _r.randint(-9, 9, (3, 2)).astype(np.int32),
            "bool": _r.rand(5) > 0.5}


def _tree(case, lv):
    """One tree shape over the leaves ``lv`` (numpy arrays)."""
    if case == "nested_dict":
        return {"b": {"y": lv["f16"], "x": lv["f32"]},
                "a": {"k": {"m": lv["i32"]}, "flag": lv["bool"]}}
    if case == "list":
        return [lv["f32"], [lv["f16"], lv["i32"]], lv["bool"]]
    if case == "tuple":
        return (lv["bool"], (lv["i32"], (lv["f16"],)), lv["f32"])
    if case == "namedtuple":
        return {"p": Pair(lv["f32"], lv["f16"]),
                "q": Pair(lv["i32"], Pair(lv["bool"], lv["f32"]))}
    if case == "mixed":
        return {"z": [Pair(lv["f32"], (lv["bool"],))],
                "c": ({"w": lv["i32"]}, lv["f16"])}
    raise ValueError(case)


CASES = ["nested_dict", "list", "tuple", "namedtuple", "mixed"]
EXTRA = {"clock": 1.25, "rng": {"s": [1, 2]}, "name": "run"}


def _map(tree, fn):
    """The same tree with every numpy leaf mapped (dicts, lists, tuples
    and namedtuples rebuilt as they were)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _torch_tree(tree):
    return _map(tree, torch.as_tensor)


def _jax_tree(tree):
    return _map(tree, jnp.asarray)


def _expected(case):
    """{key: numpy leaf} as the reference keys them."""
    tree = _tree(case, LEAVES)
    return {k: np.asarray(v)
            for k, v in rck.checkpoint._flatten_with_paths(tree).items()}


LEAVES = _leaves()


def _assert_same_arrays(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# (a) the format interchanges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_port_checkpoint_loads_in_reference(tmp_path, case):
    path = str(tmp_path / "port")
    tck.save(path, _torch_tree(_tree(case, LEAVES)), step=7, extra=EXTRA)
    _assert_same_arrays(rck.load_arrays(path), _expected(case))
    assert rck.load_extra(path) == EXTRA
    assert rck.load_step(path) == 7
    like = _jax_tree(_map(_tree(case, LEAVES), np.zeros_like))
    back = rck.restore(path, like)
    got = {k: np.asarray(v) for k, v in
           rck.checkpoint._flatten_with_paths(back).items()}
    _assert_same_arrays(got, _expected(case))


@pytest.mark.parametrize("case", CASES)
def test_reference_checkpoint_restores_in_port(tmp_path, case):
    path = str(tmp_path / "ref")
    rck.save(path, _jax_tree(_tree(case, LEAVES)), step=3, extra=EXTRA)
    like = _torch_tree(_map(_tree(case, LEAVES), np.zeros_like))
    back = tck.restore(path, like)
    flat_like = tck.checkpoint._flatten_with_paths(like)
    flat = tck.checkpoint._flatten_with_paths(back)
    assert list(flat) == list(flat_like)          # the like tree's order
    assert type(back) is type(like)
    _assert_same_arrays({k: v.numpy() for k, v in flat.items()},
                        _expected(case))
    assert all(v.dtype == flat_like[k].dtype for k, v in flat.items())
    _assert_same_arrays(tck.load_arrays(path), _expected(case))
    assert tck.load_extra(path) == EXTRA
    assert tck.load_step(path) == 3


@pytest.mark.parametrize("case", CASES)
def test_both_packages_write_the_same_checkpoint(tmp_path, case):
    """Same keys, leaf bytes and manifest (leaf order aside: the
    reference flattens dicts in sorted key order)."""
    rp, tp = str(tmp_path / "ref"), str(tmp_path / "port")
    rck.save(rp, _jax_tree(_tree(case, LEAVES)), step=1, extra=EXTRA)
    tck.save(tp, _torch_tree(_tree(case, LEAVES)), step=1, extra=EXTRA)
    _assert_same_arrays(tck.load_arrays(tp), rck.load_arrays(rp))
    with open(rp + ".json") as f:
        ref_manifest = json.load(f)
    with open(tp + ".json") as f:
        port_manifest = json.load(f)
    assert port_manifest == ref_manifest


# ---------------------------------------------------------------------------
# (b) restore: by key, into the like tree's dtype and device
# ---------------------------------------------------------------------------

def test_restore_matches_leaves_by_key_not_position(tmp_path):
    """The reference writes dict leaves in sorted key order; a torch like
    tree built in another insertion order still gets each leaf back
    under its own key."""
    path = str(tmp_path / "ck")
    a, b = np.arange(3, dtype=np.float32), -np.arange(3, dtype=np.float32)
    rck.save(path, {"a": jnp.asarray(a), "b": jnp.asarray(b)})
    back = tck.restore(path, {"b": torch.zeros(3), "a": torch.zeros(3)})
    assert list(back) == ["b", "a"]
    np.testing.assert_array_equal(back["a"].numpy(), a)
    np.testing.assert_array_equal(back["b"].numpy(), b)


def test_restore_takes_the_like_trees_dtype_and_device(tmp_path):
    path = str(tmp_path / "ck")
    tck.save(path, {"x": torch.arange(4, dtype=torch.float32),
                    "n": np.arange(2, dtype=np.int32)})
    back = tck.restore(path, {"x": torch.zeros(4, dtype=torch.float64),
                              "n": np.zeros(2, np.int64)})
    assert back["x"].dtype == torch.float64
    assert back["x"].device == torch.device("cpu")
    assert back["n"].dtype == torch.int64
    np.testing.assert_array_equal(back["x"].numpy(), np.arange(4))


# ---------------------------------------------------------------------------
# (c) bf16 leaves
# ---------------------------------------------------------------------------

def test_bf16_leaf_written_as_the_reference_writes_it(tmp_path):
    vals = torch.randn(6, generator=torch.Generator().manual_seed(0))
    rp, tp = str(tmp_path / "ref"), str(tmp_path / "port")
    rck.save(rp, {"w": jnp.asarray(vals.numpy(), jnp.bfloat16)})
    tck.save(tp, {"w": vals.to(torch.bfloat16)})
    ref, port = rck.load_arrays(rp)["w"], rck.load_arrays(tp)["w"]
    assert port.dtype.kind == ref.dtype.kind == "V" and port.itemsize == 2
    assert port.tobytes() == ref.tobytes()
    assert rck.load_arrays(tp)["w"].tobytes() \
        == tck.load_arrays(rp)["w"].tobytes()
    with open(tp + ".json") as f:
        assert json.load(f)["leaves"]["w"] == {"shape": [6],
                                               "dtype": "bfloat16"}


def test_bf16_leaf_refused_on_restore(tmp_path):
    """Neither package's restore casts a bf16 leaf; the port says which
    leaf it is."""
    path = str(tmp_path / "ck")
    tck.save(path, {"w": torch.ones(3, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="leaf 'w'.*bfloat16"):
        tck.restore(path, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    with pytest.raises(ValueError):
        rck.restore(path, {"w": jnp.zeros(3, jnp.bfloat16)})


# ---------------------------------------------------------------------------
# (d) validation, as the reference's (tests/test_ps_recovery.py:329-388)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_with_extra(tmp_path):
    path = str(tmp_path / "ck")
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4)}}
    tck.save(path, tree, step=7, extra={"clock": 1.25, "rng": {"s": [1, 2]}})
    back = tck.restore(path, tree)
    assert torch.equal(back["a"], tree["a"])
    assert tck.load_extra(path) == {"clock": 1.25, "rng": {"s": [1, 2]}}
    assert set(tck.load_arrays(path)) == {"a", "b/c"}


def test_checkpoint_torn_halves_detected(tmp_path):
    """Mixed-up npz/manifest halves fail naming the file and leaf."""
    p1, p2 = str(tmp_path / "one"), str(tmp_path / "two")
    tck.save(p1, {"a": np.zeros(3)})
    tck.save(p2, {"b": np.zeros(3)})
    os.replace(p2 + ".npz", p1 + ".npz")
    with pytest.raises(ValueError, match="'a'.*torn or mixed-up"):
        tck.load_arrays(p1)
    tck.save(p1, {"a": np.zeros(3)})
    tck.save(p2, {"a": np.zeros(5)})
    os.replace(p2 + ".npz", p1 + ".npz")
    with pytest.raises(ValueError, match="shape"):
        tck.load_arrays(p1)


def test_checkpoint_extra_payload_leaf_detected(tmp_path):
    p1, p2 = str(tmp_path / "one"), str(tmp_path / "two")
    tck.save(p1, {"a": np.zeros(3)})
    tck.save(p2, {"a": np.zeros(3), "b": np.zeros(2)})
    os.replace(p2 + ".npz", p1 + ".npz")
    with pytest.raises(ValueError, match="'b' absent from the manifest"):
        tck.load_arrays(p1)


def test_checkpoint_missing_payload(tmp_path):
    path = str(tmp_path / "ck")
    tck.save(path, {"a": np.zeros(3)})
    os.unlink(path + ".npz")
    with pytest.raises(FileNotFoundError, match="torn checkpoint"):
        tck.load_arrays(path)


def test_checkpoint_missing_manifest(tmp_path):
    with pytest.raises(FileNotFoundError, match="manifest"):
        tck.load_extra(str(tmp_path / "nothing"))


def test_checkpoint_corrupt_manifest(tmp_path):
    path = str(tmp_path / "ck")
    tck.save(path, {"a": np.zeros(3)})
    with open(path + ".json", "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="corrupt JSON"):
        tck.load_arrays(path)
    with open(path + ".json", "w") as f:
        f.write("[1, 2]")
    with pytest.raises(ValueError, match="no 'leaves' table"):
        tck.load_arrays(path)


def test_checkpoint_truncated_payload(tmp_path):
    path = str(tmp_path / "ck")
    tck.save(path, {"a": np.zeros(300)})
    with open(path + ".npz", "r+b") as f:
        f.truncate(40)
    with pytest.raises(ValueError, match="truncated or corrupt"):
        tck.load_arrays(path)


def test_restore_missing_leaf_and_shape_mismatch(tmp_path):
    path = str(tmp_path / "ck")
    tck.save(path, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaves.*'b'"):
        tck.restore(path, {"a": torch.zeros(3), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="leaf 'a' has shape"):
        tck.restore(path, {"a": torch.zeros(4)})


def test_checkpoint_atomic_no_tmp_residue(tmp_path):
    """Atomic writes leave no temp files behind, and re-saving over an
    existing checkpoint replaces it in one step."""
    path = str(tmp_path / "ck")
    tck.save(path, {"a": np.zeros(3)})
    tck.save(path, {"a": torch.ones(3)})
    assert sorted(os.listdir(tmp_path)) == ["ck.json", "ck.npz"]
    np.testing.assert_array_equal(tck.load_arrays(path)["a"], np.ones(3))


def test_failed_save_leaves_the_previous_checkpoint(tmp_path):
    """A save that fails while writing its manifest removes its temp
    file, and the manifest already on disk stays."""
    path = str(tmp_path / "ck")
    tck.save(path, {"a": np.zeros(3)}, extra={"n": 1})
    with pytest.raises(TypeError):
        tck.save(path, {"a": np.ones(3)}, extra={"n": object()})
    assert sorted(os.listdir(tmp_path)) == ["ck.json", "ck.npz"]
    assert tck.load_extra(path) == {"n": 1}
