"""The paper's eq. (11) objective — port of ``repro.core.problems`` (the
binary-classification part).

* :func:`nonconvex_binclass_loss` — ℓ(b, c) = (1 − 1/(1+exp(−bc)))².
* :func:`binclass_grad` — its gradient through autograd.
* :func:`make_synthetic_binclass` — heterogeneous synthetic workers, drawn
  from a ``torch.Generator`` (same construction as the reference, other
  numbers: parity tests carry the reference's arrays across).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import default_device

# sup over z of |d²/dz² (1 − sigmoid(z))²| — numerically ≈ 0.1556
_ELL_SMOOTH = 0.16


class BinClassData(NamedTuple):
    """Worker-stacked dataset: features (n, m, d), labels (n, m) in {−1, +1}."""

    a: torch.Tensor
    y: torch.Tensor


def nonconvex_binclass_loss(x: torch.Tensor, batch: BinClassData) -> torch.Tensor:
    """Eq. (11) mean loss for one worker's batch: x (d,), a (m, d), y (m,)."""
    z = batch.a @ x * batch.y
    s = torch.sigmoid(z)
    return torch.mean((1.0 - s) ** 2)


def binclass_grad(x: torch.Tensor, batch: BinClassData) -> torch.Tensor:
    """∇ of :func:`nonconvex_binclass_loss` in x."""
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(nonconvex_binclass_loss(x, batch), x)
    return g


def binclass_smoothness(data: BinClassData) -> float:
    """L with L² = (1/n) Σ L_i², L_i ≤ c · mean_t ‖a_t‖² (Assumption 1.2)."""
    sq = torch.mean(torch.sum(data.a.double() ** 2, dim=-1), dim=-1).cpu().numpy()
    Li = _ELL_SMOOTH * sq
    return float(np.sqrt(np.mean(Li**2)))


def make_synthetic_binclass(seed: int, n_workers: int, m: int, d: int,
                            heterogeneity: float = 1.0,
                            device=None) -> BinClassData:
    """Heterogeneous synthetic binary classification: worker i's features
    ~ N(µ_i, Σ_i), labels from a worker-specific noisy linear teacher. On
    ``cuda`` unless ``device`` names another."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    sd = float(np.sqrt(d))
    base = torch.randn((n_workers, m, d), generator=gen) / sd
    shift = heterogeneity * torch.randn((n_workers, 1, d), generator=gen) / sd
    scale = 1.0 + 0.5 * heterogeneity * torch.rand((n_workers, 1, 1), generator=gen)
    a = (base + shift) * scale
    teacher = torch.randn((n_workers, d), generator=gen)
    teacher = (1.0 - heterogeneity * 0.5) * teacher[0:1] + heterogeneity * 0.5 * teacher
    logits = torch.einsum("nmd,nd->nm", a, teacher) * sd
    flips = torch.rand(logits.shape, generator=gen) < 0.05
    y = torch.where(flips, -torch.sign(logits), torch.sign(logits))
    y = torch.where(y == 0, torch.ones_like(y), y)
    return BinClassData(a=a.to(device), y=y.to(device))
