"""Client fault injection — port of ``repro.core.faults``.

:class:`FaultSpec` rewrites the worker-stacked uplink payloads of the
MARINA-family optimizers every round. The faulty clients are the id prefix
``{0, …, ⌊frac·n⌋ − 1}``, or the explicit set ``ids``:

* ``sign_flip``  — −scale·Δ_i.
* ``mean_shift`` — every faulty row is −scale·(mean of the honest rows).
* ``nan``        — NaN payloads.
* ``garbage``    — Gaussian noise of standard deviation ``scale``, one key
                   per leaf from ``split(key, n_leaves)`` in the tree's leaf
                   order, drawn by :func:`repro_torch.prng.normal`.
* ``drop``       — the client never uploaded: with ``carry=True`` the
                   server uses its carry row h_i, i.e. Δ̂_i = 0
                   (:func:`zero_rows`), keeps that row's anchor, and books
                   only the uploads that arrived.
* ``none``       — the identity.

:func:`flip_binclass_labels` is the data-poisoning attack of the binary
classification problems.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import prng

from .tree_util import tree_flatten, tree_map, tree_unflatten

PyTree = Any

ATTACKS = ("none", "sign_flip", "mean_shift", "nan", "garbage", "drop")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """The per-round client faults: ``attack`` (one of :data:`ATTACKS`), the
    faulty fraction ``frac`` (ids < ⌊frac·n⌋) or the explicit sorted set
    ``ids``, and the amplitude ``scale``."""

    attack: str = "sign_flip"
    frac: float = 0.25
    scale: float = 1.0
    ids: "tuple | None" = None

    def __post_init__(self):
        if self.attack not in ATTACKS:
            raise ValueError(f"unknown attack {self.attack!r}, expected {ATTACKS}")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError("faulty fraction must be in [0, 1]")
        if self.ids is not None:
            ids = tuple(self.ids)
            if any((not isinstance(i, int)) or i < 0 for i in ids):
                raise ValueError(f"faulty ids must be non-negative ints: {ids!r}")
            if len(set(ids)) != len(ids):
                raise ValueError(f"faulty ids has duplicates: {ids!r}")
            object.__setattr__(self, "ids", tuple(sorted(ids)))

    def n_faulty(self, n: int) -> int:
        """Faulty clients of an n-client fleet: |ids ∩ [0, n)|, else ⌊frac·n⌋."""
        if self.ids is not None:
            return sum(1 for i in self.ids if i < n)
        return int(self.frac * n)

    def byz_mask(self, ids, n: int) -> torch.Tensor:
        """(rows,) bool: which of the client ids ``ids`` (a list or a tensor:
        ``range(n)`` for the fleet, a PP cohort) are faulty."""
        ids = torch.as_tensor(ids, dtype=torch.int64)
        if self.ids is not None:
            return torch.isin(ids, torch.tensor(self.ids, dtype=torch.int64))
        return ids < self.n_faulty(n)


def _row_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(rows,) bool → (rows, 1, …, 1) on the leaf's device."""
    return mask.to(leaf.device).reshape((-1,) + (1,) * (leaf.ndim - 1))


def zero_rows(trees: PyTree, mask: torch.Tensor) -> PyTree:
    """Zero the masked leading-axis rows of every leaf: a dropped client's
    Δ̂_i = 0, i.e. the server reuses its carry row h_i."""
    return tree_map(lambda t: torch.where(_row_mask(mask, t), torch.zeros((), dtype=t.dtype,
                                                                          device=t.device), t),
                    trees)


def _rewrite_rows(t: torch.Tensor, mask: torch.Tensor, rows_fn) -> torch.Tensor:
    """A copy of ``t`` whose masked leading-axis rows are ``rows_fn(rows)``
    (the reference's ``where(mask, attacked, t)``, without materialising the
    attacked value of every row)."""
    idx = torch.nonzero(mask).flatten().to(t.device)
    out = t.clone()
    out[idx] = rows_fn(t[idx], idx).to(t.dtype)
    return out


def inject(spec: "FaultSpec | None", key, trees: PyTree, ids, n: int) -> PyTree:
    """Rewrite the faulty rows of a worker-stacked payload tree. ``ids`` are
    the client ids of the rows. ``drop`` and ``none`` are the identity here:
    a drop is a transport fault, which the optimizer handles through
    :func:`zero_rows` and its carry bookkeeping (and never on sync rounds)."""
    if spec is None or spec.attack in ("none", "drop") or spec.n_faulty(n) == 0:
        return trees
    mask = spec.byz_mask(ids, n)

    if spec.attack == "sign_flip":
        return tree_map(lambda t: _rewrite_rows(t, mask, lambda r, _: -spec.scale * r), trees)
    if spec.attack == "mean_shift":
        honest = torch.clamp(torch.sum((~mask).float()), min=1.0)

        def shift(t):
            keep = _row_mask(~mask, t)
            acc = torch.zeros(t.shape[1:], dtype=torch.float32, device=t.device)
            for w in range(t.shape[0]):  # rows summed in order from zero
                acc += t[w].float() * keep[w].float()
            byz = (-spec.scale * (acc / honest.to(t.device))).to(t.dtype)
            return _rewrite_rows(t, mask, lambda r, _: byz.expand_as(r))

        return tree_map(shift, trees)
    if spec.attack == "nan":
        return tree_map(lambda t: _rewrite_rows(t, mask, lambda r, _: torch.full_like(
            r, float("nan"))), trees)
    # garbage
    leaves, treedef = tree_flatten(trees)
    keys = prng.split(key, len(leaves))
    noisy = []
    for k, t in zip(keys, leaves):
        z = torch.from_numpy(prng.normal(k, tuple(t.shape))).to(t.device)
        noisy.append(_rewrite_rows(t, mask, lambda r, idx, z=z: spec.scale * z[idx]))
    return tree_unflatten(treedef, noisy)


def flip_binclass_labels(data, n_byz: int):
    """Label-flip data poisoning: negate the ±1 labels of the first ``n_byz``
    clients, features untouched."""
    y = data.y.clone()
    y[:n_byz] *= -1
    return data._replace(y=y)
