"""Per-client compute-time models for straggler simulation — port of
``repro.core.roundtime``.

:class:`RoundTimeModel` draws one compute time per client per round:

* ``lognormal``   — ``mean_s·exp(σ·z − σ²/2)``, so E[T_i] = ``mean_s``;
* ``exponential`` — ``mean_s·Exp(1)``;
* ``fixed``       — every client takes ``mean_s``;

with an optional fixed slow set ``slow_ids`` whose times are multiplied by
``slow_factor``. The draws come from the round key through
:data:`TIME_FOLD` (the deadline round folds it in), so a timed run keeps the
``(k_bern, k_q)`` split of an untimed one. ``z`` and ``Exp(1)`` are
:func:`repro_torch.prng.normal` and :func:`repro_torch.prng.exponential`,
within a few ulp of ``jax.random``'s (its log1p is an approximation).

The quantile helpers are host-side closed forms (``statistics.NormalDist``),
as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np
import torch

from repro_torch import prng

#: fold_in constant deriving the round-time key from the step key (reads
#: "CLOC")
TIME_FOLD = 0xC10C

DISTS = ("lognormal", "exponential", "fixed")


@dataclasses.dataclass(frozen=True)
class RoundTimeModel:
    """Per-client compute-time heterogeneity: ``dist`` (one of
    :data:`DISTS`), the mean honest time ``mean_s``, the lognormal shape
    ``sigma``, and a persistently slow set ``slow_ids`` × ``slow_factor``."""

    dist: str = "lognormal"
    mean_s: float = 1.0
    sigma: float = 0.5
    slow_ids: tuple = ()
    slow_factor: float = 4.0

    def __post_init__(self):
        if self.dist not in DISTS:
            raise ValueError(f"unknown dist {self.dist!r}, expected {DISTS}")
        if self.mean_s <= 0.0:
            raise ValueError("mean_s must be positive")
        if self.sigma < 0.0:
            raise ValueError("sigma must be non-negative")
        if self.slow_factor < 1.0:
            raise ValueError("slow_factor < 1 would make the slow set FASTER; use the "
                             "honest distribution instead")
        ids = tuple(self.slow_ids)
        if any((not isinstance(i, int)) or i < 0 for i in ids):
            raise ValueError(f"slow_ids must be non-negative ints: {ids!r}")
        if len(set(ids)) != len(ids):
            raise ValueError(f"slow_ids has duplicates: {ids!r}")
        object.__setattr__(self, "slow_ids", ids)

    def sample(self, key, n: int) -> torch.Tensor:
        """One compute time per client: (n,) f32 on the CPU, in the
        reference's float32 arithmetic."""
        f32 = np.float32
        if self.dist == "lognormal":
            z = prng.normal(key, (n,))
            arg = (f32(self.sigma) * z - f32(0.5 * self.sigma**2)).astype(f32)
            t = (f32(self.mean_s) * np.exp(arg)).astype(f32)
        elif self.dist == "exponential":
            t = (f32(self.mean_s) * prng.exponential(key, (n,))).astype(f32)
        else:  # fixed
            t = np.full((n,), self.mean_s, dtype=f32)
        if self.slow_ids:
            slow = np.zeros((n,), bool)
            slow[[i for i in self.slow_ids if i < n]] = True
            t = np.where(slow, (f32(self.slow_factor) * t).astype(f32), t)
        return torch.from_numpy(t.astype(f32))

    def deadline_for_quantile(self, q: float) -> float:
        """The deadline that admits a ``q`` share of honest uploads: the
        q-quantile of the non-slow time distribution."""
        if not 0.0 < q < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        if self.dist == "lognormal":
            z = NormalDist().inv_cdf(q)
            return self.mean_s * math.exp(self.sigma * z - 0.5 * self.sigma**2)
        if self.dist == "exponential":
            return -self.mean_s * math.log(1.0 - q)
        return self.mean_s

    def miss_prob(self, deadline: float) -> float:
        """P(T_i > deadline) for an honest client."""
        if deadline <= 0.0:
            return 1.0
        if self.dist == "lognormal":
            z = (math.log(deadline / self.mean_s) + 0.5 * self.sigma**2) / max(
                self.sigma, 1e-12)
            return 1.0 - NormalDist().cdf(z)
        if self.dist == "exponential":
            return math.exp(-deadline / self.mean_s)
        return 0.0 if deadline >= self.mean_s else 1.0
