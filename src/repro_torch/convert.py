"""Carry the JAX package's arrays into the port, given as numpy arrays.

:func:`params_from_jax` turns any tree of numpy arrays (dicts, lists,
tuples, NamedTuples — a parameter tree, a batch, an estimator or a
worker-stacked carry) into the same tree of tensors (given a mesh whose
model axis spans ranks, this rank's slices of it: ``sharding.shard_tree``);
:func:`state_from_jax` does so for the fields of a ``MarinaState``. Taking numpy only keeps the
port free of any JAX import: the caller converts with ``np.asarray``.
bfloat16 arrays (numpy's ``ml_dtypes`` extension type) keep their bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.marina import MarinaState
from repro_torch.device import default_device
from repro_torch.core.tree_util import tree_map

PyTree = Any


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree_of_numpy: PyTree, device=None, mesh=None,
                    fsdp: bool = False) -> PyTree:
    """Tree of numpy arrays → the same tree of tensors on ``device``
    (``cuda`` unless it names another); with ``mesh``, a parameter tree cut
    to this rank's slices on the mesh's model axis and, with ``fsdp``, its
    data axis (``launch.sharding.shard_tree``), so both packages start from
    the same weights."""
    device = default_device(device)
    tree = tree_map(lambda a: _tensor(a, device), tree_of_numpy)
    if mesh is None:
        return tree
    from repro_torch.launch.sharding import shard_tree

    return shard_tree(tree, mesh, fsdp)


def state_from_jax(params: PyTree, g: PyTree, step: int, h: PyTree = None,
                   device=None) -> MarinaState:
    """The fields of a reference ``MarinaState`` (as numpy trees) → the
    port's ``MarinaState``, for every optimizer of :mod:`repro_torch.core`:
    ``g`` a tree or the packed (nblk, B) buffer of the fused carry path,
    ``h`` the worker-stacked carry (VR-MARINA's last gradients, PP-MARINA's
    full n-row server table) or None. On ``cuda`` unless ``device`` names
    another."""
    device = default_device(device)
    return MarinaState(
        params=params_from_jax(params, device),
        g=params_from_jax(g, device),
        step=int(step),
        h=None if h is None else params_from_jax(h, device),
    )
