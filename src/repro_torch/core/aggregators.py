"""Byzantine-robust server aggregation rules (GARs) — port of
``repro.core.aggregators``.

:class:`ServerAggregator` replaces the server's worker mean, at the one
place all three optimizers and the flat engine aggregate, by one of:

* ``mean``               — the paper's aggregation (the default).
* ``trimmed_mean``       — per coordinate, drop the f smallest and f
                           largest worker values and average the rest
                           (n > 2f).
* ``coordinate_median``  — the coordinate-wise median (a trim window of the
                           same rule).
* ``krum``               — the one row whose n − f − 2 smallest squared
                           distances to the other rows sum least (n ≥ f + 3).
* ``norm_clip``          — every row's ℓ2 norm clipped to τ (the median row
                           norm unless ``clip_tau`` is set), then the mean.

On the flat engine's carry rounds the coordinate-wise rules run as the
``trimmed_delta_epilogue`` / ``trimmed_sync_epilogue`` kernels
(:mod:`repro_torch.kernels.epilogue`) over the per-worker rows; everywhere
else — the recompute rounds, the tree paths, and Krum's and norm-clip's row
scores — they are plain PyTorch, as the reference computes them outside any
Pallas kernel. Krum's Gram product is ``torch.matmul``; its summation order
differs from XLA's, so a near tie between two rows' scores could pick
another winner (the tests use inputs with a clear margin).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels import ref as _ref

from . import stepsize
from .tree_util import mean_axis0, tree_leaves, tree_map

PyTree = Any

RULES = ("mean", "trimmed_mean", "coordinate_median", "krum", "norm_clip")

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class ServerAggregator:
    """A gradient aggregation rule for the server side of a round.

    ``rule`` is one of :data:`RULES`; ``f`` the assumed Byzantine count (the
    trim width of ``trimmed_mean`` and Krum's f); ``clip_tau`` the norm-clip
    threshold (default: the median row norm)."""

    rule: str = "mean"
    f: int = 0
    clip_tau: Optional[float] = None

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule {self.rule!r}, expected {RULES}")
        if self.f < 0:
            raise ValueError("Byzantine count f must be >= 0")

    @property
    def robust(self) -> bool:
        """True when the rule differs from the paper's plain mean."""
        return self.rule != "mean"

    @property
    def coordinatewise(self) -> bool:
        """True for the rules the trimmed kernels compute (trim / median)."""
        return self.rule in ("trimmed_mean", "coordinate_median")

    def trim_bounds(self, n: int) -> tuple:
        """Rank keep-window [lo, hi) for n workers: (f, n − f) for the
        trimmed mean; the middle value (odd n) or two (even n) for the
        median."""
        if self.rule == "coordinate_median":
            if n % 2:
                m = (n - 1) // 2
                return m, m + 1
            return n // 2 - 1, n // 2 + 1
        lo, hi = self.f, n - self.f
        if not lo < hi:
            raise ValueError(f"trimmed_mean needs n > 2f (n={n}, f={self.f})")
        return lo, hi

    def n_eff(self, n: int) -> int:
        """How many worker values the aggregate still averages over
        (:func:`repro_torch.core.stepsize.robust_n_eff`)."""
        return stepsize.robust_n_eff(self.rule, n, self.f)

    def combine_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Aggregate a worker-stacked tensor: (n, …) → (…) f32."""
        n = rows.shape[0]
        if self.rule == "mean":
            return mean_axis0(rows.float())
        if self.coordinatewise:
            return _ref.trimmed_mean_rows_ref(rows, *self.trim_bounds(n))
        flat = rows.reshape(n, -1).float()
        if self.rule == "krum":
            return rows[_krum_select(_pairwise_sq_dists(flat), n, self.f)].float()
        # norm_clip: non-finite entries are selected out before scaling
        norms = torch.sqrt(torch.sum(flat * flat, dim=1))
        scale = _clip_scales(norms, self.clip_tau)
        clean = torch.where(torch.isfinite(flat), flat, torch.zeros_like(flat))
        return mean_axis0(clean * scale[:, None]).reshape(rows.shape[1:])

    def combine_stacked(self, trees: PyTree) -> PyTree:
        """Aggregate a worker-stacked pytree (leading axis n on every leaf).
        Coordinate-wise rules go leaf by leaf; Krum's distances and
        norm-clip's row norms sum over all leaves first."""
        leaves = tree_leaves(trees)
        n = leaves[0].shape[0]
        if self.rule == "mean":
            return tree_map(lambda t: mean_axis0(t.float()).to(t.dtype), trees)
        if self.coordinatewise:
            return tree_map(lambda t: self.combine_rows(t).to(t.dtype), trees)
        flats = [leaf.reshape(n, -1).float() for leaf in leaves]
        if self.rule == "krum":
            dists = sum(_pairwise_sq_dists(fl) for fl in flats)
            win = _krum_select(dists, n, self.f)
            return tree_map(lambda t: t[win], trees)
        norms = torch.sqrt(sum(torch.sum(fl * fl, dim=1) for fl in flats))
        scale = _clip_scales(norms, self.clip_tau)

        def clip_mean(t):
            tf = t.float()
            clean = torch.where(torch.isfinite(tf), tf, torch.zeros_like(tf))
            rs = scale.reshape((n,) + (1,) * (t.ndim - 1))
            return mean_axis0(clean * rs).to(t.dtype)

        return tree_map(clip_mean, trees)


def _pairwise_sq_dists(flat: torch.Tensor) -> torch.Tensor:
    """(n, d) rows → (n, n) squared euclidean distances (Gram expansion)."""
    sq = torch.sum(flat * flat, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * torch.matmul(flat, flat.T)
    return torch.clamp(d2, min=0.0)


def _krum_select(dists: torch.Tensor, n: int, f: int) -> int:
    """Krum's winner: score_i = the sum of the n − f − 2 smallest distances
    to the other rows; a non-finite score is +inf (a NaN row never wins);
    the first index of the least score."""
    m = n - f - 2
    if m < 1:
        raise ValueError(f"krum needs n >= f + 3 (n={n}, f={f})")
    masked = dists + torch.diag(torch.full((n,), float("inf"), device=dists.device))
    scores = torch.sum(torch.sort(masked, dim=1).values[:, :m], dim=1)
    scores = torch.where(torch.isfinite(scores), scores,
                         torch.full_like(scores, float("inf")))
    return int(torch.argmin(scores))


def median_midpoint(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: sorted, then (v[lo] + v[hi])·0.5 at
    lo = ⌊(n−1)/2⌋, hi = ⌈(n−1)/2⌉ — the midpoint of the two middle values
    for even n (``torch.median`` takes the lower one), +inf when either is
    +inf; NaN if any value is NaN."""
    if torch.isnan(v).any():
        return torch.tensor(float("nan"), device=v.device)
    s = torch.sort(v).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _clip_scales(norms: torch.Tensor, clip_tau: Optional[float]) -> torch.Tensor:
    """Per-row clip factors min(1, τ/‖row‖), τ the median norm by default;
    rows whose norm is not finite get 0."""
    finite = torch.isfinite(norms)
    safe = torch.where(finite, norms, torch.zeros_like(norms))
    if clip_tau is None:
        tau = median_midpoint(torch.where(finite, norms,
                                          torch.full_like(norms, float("inf"))))
    else:
        tau = torch.tensor(clip_tau, dtype=torch.float32, device=norms.device)
    scale = torch.clamp(tau / torch.clamp(safe, min=_EPS), max=1.0)
    return torch.where(finite, scale, torch.zeros_like(scale))
