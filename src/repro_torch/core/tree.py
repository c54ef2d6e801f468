"""Pytree flatten/unflatten in JAX's leaf order.

The block-id contract of ``core/blocks.py`` (the LPT assignment, each
leaf's offset in its row) depends on the order in which a params tree's
leaves are listed. The port must list them as ``jax.tree.flatten`` does,
and ``torch.utils._pytree`` does not: it flattens a dict in insertion
order and keeps ``None`` as a leaf, where JAX sorts a dict's keys and
treats ``None`` as a node with no children. This module is the port's
own flattener for the containers a params tree is built from:

* ``dict``: children in sorted key order (an ``OrderedDict`` keeps its
  own order, as in JAX);
* ``list``, ``tuple`` and ``NamedTuple``: children in order;
* ``None``: no children;
* anything else is a leaf.

:class:`TreeDef` is hashable and compares by structure, so two trees
built with their dict keys inserted in different orders have equal
treedefs. The checkpoint and PS code keep ``torch.utils._pytree``: what
they flatten is matched by key, not by position.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, List, Tuple

_LEAF, _NONE, _DICT, _ODICT, _LIST, _TUPLE, _NAMEDTUPLE = (
    "leaf", "none", "dict", "odict", "list", "tuple", "namedtuple")


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a pytree: a node's kind, its static data (dict
    keys or a NamedTuple class) and its children's treedefs."""
    kind: str
    meta: Any = None
    children: Tuple["TreeDef", ...] = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == _LEAF:
            return 1
        return sum(c.num_leaves for c in self.children)

    def __repr__(self) -> str:
        if self.kind == _LEAF:
            return "*"
        if self.kind == _NONE:
            return "None"
        kids = [repr(c) for c in self.children]
        if self.kind in (_DICT, _ODICT):
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.meta, kids)) + "}"
        if self.kind == _LIST:
            return "[" + ", ".join(kids) + "]"
        if self.kind == _NAMEDTUPLE:
            return f"{self.meta.__name__}({', '.join(kids)})"
        return "(" + ", ".join(kids) + (",)" if len(kids) == 1 else ")")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _node(x):
    """(kind, meta, children) of one node."""
    if x is None:
        return _NONE, None, ()
    if isinstance(x, collections.OrderedDict):
        keys = tuple(x)
        return _ODICT, keys, tuple(x[k] for k in keys)
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return _DICT, keys, tuple(x[k] for k in keys)
    if _is_namedtuple(x):
        return _NAMEDTUPLE, type(x), tuple(x)
    if isinstance(x, tuple):
        return _TUPLE, None, tuple(x)
    if isinstance(x, list):
        return _LIST, None, tuple(x)
    return _LEAF, None, ()


def _flatten_into(x, leaves: list, is_leaf) -> TreeDef:
    kind, meta, children = ((_LEAF, None, ()) if is_leaf is not None
                            and is_leaf(x) else _node(x))
    if kind == _LEAF:
        leaves.append(x)
        return TreeDef(_LEAF)
    return TreeDef(kind, meta, tuple(_flatten_into(c, leaves, is_leaf)
                                     for c in children))


def _build(td: TreeDef, it):
    if td.kind == _LEAF:
        return next(it)
    kids = [_build(c, it) for c in td.children]
    if td.kind == _NONE:
        return None
    if td.kind == _DICT:
        return dict(zip(td.meta, kids))
    if td.kind == _ODICT:
        return collections.OrderedDict(zip(td.meta, kids))
    if td.kind == _NAMEDTUPLE:
        return td.meta(*kids)
    return tuple(kids) if td.kind == _TUPLE else kids


# Module-level recursion on purpose: a recursive closure refers to itself
# through its cell, and that cycle would keep the leaves it closes over
# (device tensors) alive until the cycle collector runs.

def tree_flatten(tree, is_leaf: Callable = None
                 ) -> Tuple[List[Any], TreeDef]:
    """The leaves of ``tree`` in JAX's order, and its treedef; a node
    for which ``is_leaf`` is true is a leaf (as in ``jax.tree``: a
    placement spec is a tuple)."""
    leaves: List[Any] = []
    treedef = _flatten_into(tree, leaves, is_leaf)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of structure ``treedef`` holding ``leaves`` in order."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"treedef {treedef} takes {treedef.num_leaves} "
                         f"leaves; got {len(leaves)}")
    return _build(treedef, iter(leaves))


def tree_leaves(tree, is_leaf: Callable = None) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]


def tree_structure(tree) -> TreeDef:
    return tree_flatten(tree)[1]


def tree_map(fn: Callable, tree) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(leaf) for leaf in leaves])


# ---------------------------------------------------------------------------
# key paths, as jax.tree_util's
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DictKey:
    """A dict child's place in a key path (``jax.tree_util.DictKey``)."""
    key: Any


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    """A list or tuple child's place (``jax.tree_util.SequenceKey``)."""
    idx: int


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    """A NamedTuple field's place (``jax.tree_util.GetAttrKey``)."""
    name: str


def _paths_into(x, path: tuple, out: list) -> None:
    kind, meta, children = _node(x)
    if kind == _LEAF:
        out.append(path)
    elif kind in (_DICT, _ODICT):
        for k, c in zip(meta, children):
            _paths_into(c, path + (DictKey(k),), out)
    elif kind == _NAMEDTUPLE:
        for f, c in zip(meta._fields, children):
            _paths_into(c, path + (GetAttrKey(f),), out)
    else:
        for i, c in enumerate(children):
            _paths_into(c, path + (SequenceKey(i),), out)


def tree_map_with_path(fn: Callable, tree) -> Any:
    """``jax.tree_util.tree_map_with_path``: ``fn(path, leaf)`` for every
    leaf, the path a tuple of :class:`DictKey` / :class:`SequenceKey` /
    :class:`GetAttrKey`."""
    leaves, treedef = tree_flatten(tree)
    paths: list = []
    _paths_into(tree, (), paths)
    return tree_unflatten(treedef, [fn(p, leaf)
                                    for p, leaf in zip(paths, leaves)])

