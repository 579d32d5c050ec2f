"""Small pytree algebra used by the optimizer layer.

Parameter trees are nested dicts / lists / tuples / NamedTuples of tensors.
The leaf order is ``jax.tree.flatten``'s — dict keys are *sorted*, sequences
keep their order, ``None`` is an empty subtree — because the flat layout
places leaves at offsets in that order and the seeded RandK offsets must hit
the same coordinates as in the reference. (``torch.utils._pytree`` keeps dict
insertion order, so it is not used here.)

:func:`tree_flatten_with_path` also opens dataclasses (the optimizer states,
which the reference registers as pytree nodes) and names every leaf by its
path, as ``jax.tree_util.tree_flatten_with_path`` does: the checkpoint store
keys its files by those paths.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """Structure of a pytree: ``kind`` is leaf | none | dict | list | tuple |
    namedtuple | dataclass; ``meta`` the sorted dict keys, the NamedTuple
    class, or the dataclass and its field names."""

    kind: str
    meta: Any = None
    children: tuple = ()

    def flatten_up_to(self, tree: PyTree) -> list:
        """Leaves of ``tree`` at this structure's leaf positions (the
        subtrees found there are returned whole)."""
        out: list = []
        self._flatten_up_to(tree, out)
        return out

    def _flatten_up_to(self, tree, out):
        if self.kind == "leaf":
            out.append(tree)
        elif self.kind == "none":
            return
        else:
            if self.kind == "dict":
                subs = [tree[k] for k in self.meta]
            elif self.kind == "dataclass":
                subs = [getattr(tree, name) for name in self.meta[1]]
            else:
                subs = list(tree)
            if len(subs) != len(self.children):
                raise ValueError("tree structure mismatch")
            for c, s in zip(self.children, subs):
                c._flatten_up_to(s, out)

    def unflatten(self, leaves) -> PyTree:
        it = iter(leaves)
        out = self._build(it)
        if next(it, _SENTINEL) is not _SENTINEL:
            raise ValueError("too many leaves for this tree structure")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        subs = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.meta, subs))
        if self.kind == "list":
            return subs
        if self.kind == "namedtuple":
            return self.meta(*subs)
        if self.kind == "dataclass":
            cls, names = self.meta
            return cls(**dict(zip(names, subs)))
        return tuple(subs)


_SENTINEL = object()


def tree_structure(tree: PyTree) -> TreeDef:
    if tree is None:
        return TreeDef("none")
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(tree_structure(tree[k]) for k in keys))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return TreeDef("namedtuple", type(tree), tuple(tree_structure(t) for t in tree))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return TreeDef(kind, None, tuple(tree_structure(t) for t in tree))
    return TreeDef("leaf")


def tree_flatten(tree: PyTree) -> tuple[list, TreeDef]:
    treedef = tree_structure(tree)
    return treedef.flatten_up_to(tree), treedef


@dataclasses.dataclass(frozen=True)
class DictKey:
    """A path entry: the dict key (``jax.tree_util.DictKey``)."""

    key: Any


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    """A path entry: the list or tuple index (``jax.tree_util.SequenceKey``)."""

    idx: int


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    """A path entry: the NamedTuple or dataclass field (``jax.tree_util.GetAttrKey``)."""

    name: str


def tree_flatten_with_path(tree: PyTree) -> tuple[list, TreeDef]:
    """``[(path, leaf), ...]`` and the structure, in ``tree_flatten``'s leaf
    order, with dataclass instances opened as nodes (their fields in
    declaration order, ``None`` fields holding no leaf). The paths are
    tuples of :class:`DictKey` / :class:`SequenceKey` / :class:`GetAttrKey`,
    the entries ``jax.tree_util.tree_flatten_with_path`` gives for the same
    tree; the structure unflattens back into the dataclasses."""
    out: list = []

    def walk(t, path):
        if t is None:
            return TreeDef("none")
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return TreeDef("dict", keys,
                           tuple(walk(t[k], path + (DictKey(k),)) for k in keys))
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            names = tuple(f.name for f in dataclasses.fields(t))
            return TreeDef("dataclass", (type(t), names),
                           tuple(walk(getattr(t, n), path + (GetAttrKey(n),))
                                 for n in names))
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return TreeDef("namedtuple", type(t),
                           tuple(walk(v, path + (GetAttrKey(f),))
                                 for f, v in zip(t._fields, t)))
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return TreeDef(kind, None, tuple(walk(v, path + (SequenceKey(i),))
                                             for i, v in enumerate(t)))
        out.append((path, t))
        return TreeDef("leaf")

    treedef = walk(tree, ())
    return out, treedef


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    return treedef.unflatten(leaves)


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(leaves, *others)])


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_axpy(alpha, x: PyTree, y: PyTree) -> PyTree:
    """alpha*x + y, the multiply and the add rounded separately."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def mean_axis0(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading (worker) axis: rows summed in f32 from zero in
    order 0..n−1, then one division by n, cast back to the input dtype."""
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for w in range(x.shape[0]):
        acc += x[w].float()
    n = torch.tensor(float(x.shape[0]), device=x.device)  # a true division
    return (acc / n).to(x.dtype)


def tree_mean_axis0(a: PyTree) -> PyTree:
    """Mean over the leading (worker) axis of every leaf."""
    return tree_map(mean_axis0, a)


def tree_sum_sq(a: PyTree):
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(a))


def tree_norm(a: PyTree):
    return torch.sqrt(tree_sum_sq(a))


def tree_stack_workers(trees: list) -> PyTree:
    """Stack a list of per-worker trees into one tree with leading worker dim."""
    return tree_map(lambda *xs: torch.stack(xs, 0), *trees)


def tree_worker_slice(tree: PyTree, i) -> PyTree:
    return tree_map(lambda x: x[i], tree)

