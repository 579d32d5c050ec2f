"""Path-based sharding rules for parameters, batches and caches — the rule
table of ``repro.launch.sharding``, returning plain spec tuples.

A spec is a tuple with one entry per tensor dimension: a mesh axis name, a
tuple of axis names, or None (replicated) — what ``PartitionSpec`` holds in
the reference. ``build_train_steps`` reads these to make the reference's
decisions, and :func:`shard_tree` / :func:`gather_tree` apply them across the
m ranks of a model axis (``Mesh.model``) and, on an fsdp mesh, the D ranks
of the data axis inside a worker (``Mesh.fsdp``): each rank holds one of
the D·m slices of every leaf, cut along the dimension its spec gives the
data axis and the one it gives the model axis (:func:`leaf_splits`), and
the model's forward and backward gather or reduce across the model group
and gather the data split one layer at a time, at its use
(``models/layers.py``'s parallel primitives). A data rank takes its rows
of each worker's batch (:func:`data_rows`, the reference's inner batch
axis of :func:`batch_spec`).

Every rule is a *preference*; :func:`_fit` drops any axis that does not
divide the corresponding dimension. Roles: ``M`` prefers the model axis,
``F`` the fsdp axis ("data") when the arch runs worker-per-pod, None
replicates.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np

from repro_torch.core.tree_util import DictKey, tree_flatten, tree_flatten_with_path

PyTree = Any

M, F = "M", "F"

# name → right-aligned dim roles (extra leading dims, e.g. layer stacks, replicate)
_RULES: dict[str, tuple] = {
    # embeddings: (V, d) — vocab-parallel
    "embed": (M, F),
    "lm_head": (M, F),
    # in-projections (d_in, d_out): column-parallel
    **{k: (F, M) for k in (
        "wq", "wk", "wv", "w_uq", "w_uk", "w_uv", "w_dq", "w_dkv", "w_kr",
        "w_in", "ff_up", "w_x", "w_y", "w_a", "w_i", "w_q", "w_k", "w_v",
        "w_up_mlp", "proj",
    )},
    "w_gate": (F, M),
    "w_up": (F, M),
    # MoE expert stacks (E, d_in, d_out) / (E, d_out, d_in): experts → model (EP)
    "moe_gate": (M, F, None),
    "moe_up": (M, F, None),
    "moe_down": (M, None, F),
    # out-projections (d_out, d_in): row-parallel
    **{k: (M, F) for k in ("wo", "w_down", "ff_down", "w_out")},
    # gates with tiny output dims
    "w_if": (F, None),
    # conv (W, C)
    "w": (None, M),
    "b": (M,),
    # small / replicated
    **{k: () for k in ("lam", "r_z", "r_i", "r_f", "r_o")},
    # router (d, E): replicate E (small), fsdp the input dim
    "router": (F, None),
}


def _leaf_name(path) -> str:
    for p in reversed(path):
        if hasattr(p, "key"):
            return str(p.key)
    return ""


def _fit(roles: tuple, shape: tuple, mesh, fsdp: bool) -> tuple:
    """Right-align roles to shape, drop non-dividing axes, map roles to axes."""
    axes: list[Optional[str]] = [None] * len(shape)
    used = set()
    for i, role in enumerate(roles):
        dim = len(shape) - len(roles) + i
        if dim < 0 or role is None:
            continue
        ax = "model" if role == M else ("data" if fsdp else None)
        if ax is None or ax in used or ax not in mesh.shape:
            continue
        if shape[dim] % mesh.shape[ax] == 0 and shape[dim] > 0:
            axes[dim] = ax
            used.add(ax)
    return tuple(axes)


def param_spec(path, leaf, mesh, fsdp: bool) -> tuple:
    """The spec of one parameter leaf (``path`` as ``tree_flatten_with_path``
    gives it; ``leaf`` anything with ``.shape``)."""
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    roles = _RULES.get(name)
    if roles is None:
        roles = (F, M) if len(shape) >= 2 else ()
    spec = _fit(roles, shape, mesh, fsdp)
    # fallback: a large leaf whose preferred dim didn't divide (e.g. an odd
    # vocab) still gets the model axis on any dividing dim, rightmost first
    if (all(s is None for s in spec) and int(np.prod(shape)) > 1_000_000
            and "model" in mesh.shape):
        axes: list[Optional[str]] = [None] * len(shape)
        for dim in range(len(shape) - 1, -1, -1):
            if shape[dim] % mesh.shape["model"] == 0:
                axes[dim] = "model"
                break
        spec = tuple(axes)
    return spec


def param_sharding_tree(shapes: PyTree, mesh, fsdp: bool) -> PyTree:
    """A tree of :func:`param_spec` specs shaped like ``shapes``."""
    flat, treedef = tree_flatten_with_path(shapes)
    return treedef.unflatten([param_spec(p, leaf, mesh, fsdp) for p, leaf in flat])


def axis_dim(spec: tuple, axis: str) -> Optional[int]:
    """The dimension a spec gives ``axis`` (None: not on it)."""
    for d, ax in enumerate(spec):
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return d
    return None


def model_dim(spec: tuple) -> Optional[int]:
    """The dimension a spec gives the model axis (None: not on it)."""
    return axis_dim(spec, "model")


class _Shaped(NamedTuple):
    shape: tuple


def data_dim(name: str, shape: tuple, mesh) -> Optional[int]:
    """The dimension the data axis splits a leaf named ``name`` of whole
    ``shape`` on under fsdp (None: held whole over it). Allocates nothing
    (it runs inside the model's forward, under the roofline's counters)."""
    return axis_dim(param_spec((DictKey(name),), _Shaped(tuple(shape)), mesh, True), "data")


def leaf_splits(shapes: PyTree, mesh, fsdp: bool = False) -> list:
    """Per leaf of ``shapes`` (whole shapes, flattened order), ``(data dim,
    model dim)``: the dimensions its slices split on across the data ranks
    of an fsdp mesh and across the model ranks, each None where the leaf is
    held whole along that axis (replicated, or the axis inside one rank)."""
    flat, _ = tree_flatten_with_path(shapes)
    D, m = getattr(mesh, "fsdp", 1), getattr(mesh, "model", 1)
    if D == 1 and m == 1:
        return [(None, None)] * len(flat)
    out = []
    for p, leaf in flat:
        spec = param_spec(p, leaf, mesh, fsdp)
        out.append((axis_dim(spec, "data") if D > 1 else None,
                    model_dim(spec) if m > 1 else None))
    return out


def model_dims(shapes: PyTree, mesh, fsdp: bool = False) -> list:
    """Per leaf of ``shapes``, the dimension its slices split on across the
    mesh's model ranks, or None (:func:`leaf_splits`' model half)."""
    return [md for _fd, md in leaf_splits(shapes, mesh, fsdp)]


def shard_tree(params: PyTree, mesh, fsdp: bool = False) -> PyTree:
    """This rank's slices of a whole parameter tree (its data slice along
    each leaf's data dimension, then its model slice along the model
    dimension; replicated leaves whole), as contiguous copies so the whole
    tree can be freed."""
    leaves, treedef = tree_flatten(params)
    out = []
    for t, (fd, md) in zip(leaves, leaf_splits(params, mesh, fsdp)):
        if fd is not None:
            t = mesh.fsdp_slice(t, fd)
        out.append(t if md is None else mesh.model_slice(t, md))
    return treedef.unflatten(out)


def gather_tree(local: PyTree, mesh, shapes: PyTree, fsdp: bool = False) -> PyTree:
    """Undo :func:`shard_tree`: the whole tree on every rank of the worker
    group (``shapes`` the whole leaves' shapes, e.g. meta tensors), for
    checkpoints and comparisons."""
    leaves, treedef = tree_flatten(local)
    out = []
    for t, (fd, md) in zip(leaves, leaf_splits(shapes, mesh, fsdp)):
        if md is not None:
            t = mesh.model_gather(t, md, kind="model/gather_tree")
        out.append(t if fd is None else mesh.fsdp_gather(t, fd, kind="fsdp/gather_tree"))
    return treedef.unflatten(out)


def local_shape(shape: tuple, d: Optional[int], m: int) -> tuple:
    """A leaf's slice shape on one of m model ranks."""
    if d is None:
        return tuple(shape)
    return tuple(s // m if i == d else s for i, s in enumerate(shape))


def data_rows(per_worker: int, mesh) -> range:
    """The rows of a worker's ``per_worker`` batch rows this data rank
    takes: the reference's inner batch axis ("data" on dim 1 of
    :func:`batch_spec`), contiguous, all of them where ``Mesh.fsdp`` is 1."""
    D = getattr(mesh, "fsdp", 1)
    if per_worker % D:
        raise ValueError(f"{per_worker} rows a worker do not split over {D} data ranks")
    k = per_worker // D
    j = getattr(mesh, "fsdp_rank", 0)
    return range(j * k, (j + 1) * k)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------


def batch_spec(worker_axes: tuple, inner_batch_axis: Optional[str], ndim: int) -> tuple:
    """(n_workers, per_worker_batch, ...) — workers on dim 0; optionally the
    per-worker batch over an inner axis."""
    axes: list = [worker_axes if len(worker_axes) > 1 else worker_axes[0]]
    axes.append(inner_batch_axis)
    axes += [None] * (ndim - 2)
    return tuple(axes)


def serve_batch_axes(mesh, B: int) -> Optional[tuple]:
    """Best axes to shard a serving batch dim of size B over."""
    chosen = []
    size = 1
    for ax in (a for a in ("pod", "data") if a in mesh.shape):
        if B % (size * mesh.shape[ax]) == 0:
            chosen.append(ax)
            size *= mesh.shape[ax]
    return tuple(chosen) if chosen else None


def cache_leaf_spec(path, leaf, mesh, batch_axes) -> tuple:
    """Decode-cache leaves (repeat, B, ...): B over the batch axes, then the
    model axis on a head-ish dim, then the unused data axes on the time dim
    (sequence-parallel KV for long contexts)."""
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    axes: list = [None] * len(shape)
    used = set()
    if len(shape) >= 2 and batch_axes:
        bsz = int(np.prod([mesh.shape[a] for a in batch_axes]))
        if shape[1] % bsz == 0:
            axes[1] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
            used.update(batch_axes)
    # trailing feature dims: try the model axis once, rightmost-but-one first
    if "model" in mesh.shape:
        for dim in range(len(shape) - 2, 1, -1):
            if shape[dim] % mesh.shape["model"] == 0 and "model" not in used:
                axes[dim] = "model"
                used.add("model")
                break
        else:
            if (len(shape) >= 3 and "model" not in used
                    and shape[-1] % mesh.shape["model"] == 0):
                axes[-1] = "model"
                used.add("model")
    # time dim (dim 2 of (repeat, B, S, ...) caches): over the leftover axes
    if name in ("k", "v", "ckv", "k_rope") and len(shape) >= 4:
        leftover = [a for a in ("pod", "data") if a in mesh.shape and a not in used]
        if leftover:
            size = int(np.prod([mesh.shape[a] for a in leftover]))
            if shape[2] % size == 0:
                axes[2] = tuple(leftover) if len(leftover) > 1 else leftover[0]
                used.update(leftover)
    return tuple(axes)


def replicated() -> tuple:
    """The fully replicated spec (``PartitionSpec()``)."""
    return ()
