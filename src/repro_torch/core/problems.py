"""The paper's experimental objectives — port of ``repro.core.problems``.

* :func:`nonconvex_binclass_loss` — eq. (11): ℓ(b, c) = (1 − 1/(1+exp(−bc)))².
* :func:`binclass_grad` (:func:`binclass_full_grad`) — its gradient through
  autograd; :func:`sample_minibatch` — per-worker i.i.d. minibatches, bit
  for bit the reference's under the same key.
* :func:`quadratic_loss` and the PŁ quadratics (:func:`make_quadratic`,
  :func:`quad_optimum`); :func:`make_shifted_quadratics` with exact
  ζ-heterogeneity, measured by :func:`gradient_heterogeneity`.
* :func:`make_synthetic_binclass` and :func:`make_dirichlet_binclass` (the
  Dirichlet(α) federated split).

The makers take a ``seed`` and draw from a ``torch.Generator`` (Dirichlet
rows from ``numpy.random.default_rng(seed)``: torch's gamma takes no
generator): the reference's construction, other numbers, so parity tests
carry the reference's arrays across. They build on the host, then move to
``device`` (``cuda`` unless it names another), so every device gets the
same problem.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng
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


#: the reference's name for :func:`binclass_grad`
binclass_full_grad = binclass_grad


def binclass_smoothness(data: BinClassData) -> float:
    """L with L² = (1/n) Σ L_i², L_i ≤ c · mean_t ‖a_t‖² (Assumption 1.2)."""
    sq = torch.mean(torch.sum(data.a.double() ** 2, dim=-1), dim=-1).cpu().numpy()
    Li = _ELL_SMOOTH * sq
    return float(np.sqrt(np.mean(Li**2)))


def _binclass_labels(teacher_logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """±1 labels of the noisy teacher: the sign of its logits, 5 % flipped,
    0 taken as +1."""
    flips = torch.rand(teacher_logits.shape, generator=gen) < 0.05
    y = torch.where(flips, -torch.sign(teacher_logits), torch.sign(teacher_logits))
    return torch.where(y == 0, torch.ones_like(y), y)


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
    y = _binclass_labels(torch.einsum("nmd,nd->nm", a, teacher) * sd, gen)
    return BinClassData(a=a.to(device), y=y.to(device))


def sample_minibatch(key, data: BinClassData, b: int) -> BinClassData:
    """Per-worker i.i.d. uniform minibatch indices (Assumption 3.1 regime):
    ``prng.randint`` under the JAX-format ``key``, so the rows are the
    reference's."""
    n, m, _ = data.a.shape
    idx = torch.from_numpy(prng.randint(key, (n, b), 0, m)).long().to(data.a.device)
    return BinClassData(a=torch.take_along_dim(data.a, idx[..., None], dim=1),
                        y=torch.take_along_dim(data.y, idx, dim=1))


# ---------------------------------------------------------------------------
# Quadratics (PŁ with µ = λ_min ≥ 0; strongly convex if λ_min > 0)
# ---------------------------------------------------------------------------


class QuadData(NamedTuple):
    A: torch.Tensor  # (n, d, d) PSD per worker
    b: torch.Tensor  # (n, d)


def quadratic_loss(x: torch.Tensor, batch: QuadData) -> torch.Tensor:
    """f_i(x) = ½ xᵀA_i x − b_iᵀx."""
    return 0.5 * x @ batch.A @ x - batch.b @ x


def _spectrum(d: int, kappa: float) -> torch.Tensor:
    """d eigenvalues log-spaced over [1/κ, 1] (in float64, then rounded
    once: the ends are f32(1/κ) and 1)."""
    return torch.from_numpy((np.logspace(0, np.log10(kappa), d) / kappa).astype(np.float32))


def make_quadratic(seed: int, n_workers: int, d: int, kappa: float = 10.0,
                   device=None):
    """Heterogeneous PSD quadratics A_i = Q_i diag(λ) Q_iᵀ with one spectrum
    λ in [1/κ, 1] and per-worker rotations. Returns (QuadData, L, mu) of the
    mean Ā."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    qs = torch.randn((n_workers, d, d), generator=gen)
    eigs = _spectrum(d, kappa)
    qq, _ = torch.linalg.qr(qs)
    A = (qq * eigs) @ qq.transpose(-1, -2)
    b = torch.randn((n_workers, d), generator=gen) / float(np.sqrt(d))
    ev = torch.linalg.eigvalsh(torch.mean(A, 0))
    return QuadData(A=A.to(device), b=b.to(device)), float(ev.max()), float(ev.min())


def quad_optimum(data: QuadData) -> torch.Tensor:
    """Minimizer of the client-average quadratic: x* = Ā⁻¹ b̄."""
    return torch.linalg.solve(torch.mean(data.A, 0), torch.mean(data.b, 0))


# ---------------------------------------------------------------------------
# Federated heterogeneity: the exact ζ dial and the Dirichlet(α) split
# ---------------------------------------------------------------------------


def make_shifted_quadratics(seed: int, n_workers: int, d: int, zeta: float = 1.0,
                            kappa: float = 10.0, device=None):
    """Per-client shifted quadratics with exact ζ-heterogeneity:
    f_i(x) = ½ xᵀA x − b_iᵀ x with one shared PSD A (spectrum in [1/κ, 1])
    and b_i = b̄ + ζ·u_i, Σ_i u_i = 0 and (1/n)Σ‖u_i‖² = 1, so
    ∇f_i − ∇f = −ζ·u_i at every x and the gradient dissimilarity is ζ².
    Returns (QuadData, L, mu)."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=gen))
    eigs = _spectrum(d, kappa)
    A = (q * eigs) @ q.T
    bbar = torch.randn((d,), generator=gen) / float(np.sqrt(d))
    u = torch.randn((n_workers, d), generator=gen)
    u = u - torch.mean(u, dim=0, keepdim=True)                    # Σ u_i = 0
    u = u / torch.sqrt(torch.mean(torch.sum(u * u, dim=-1)))      # (1/n)Σ‖u_i‖² = 1
    b = bbar[None, :] + zeta * u
    data = QuadData(A=A.expand(n_workers, d, d).to(device), b=b.to(device))
    return data, float(eigs[-1]), float(eigs[0])


def gradient_heterogeneity(grads: torch.Tensor) -> torch.Tensor:
    """Empirical ζ²(x) = (1/n)Σ‖∇f_i(x) − ∇f(x)‖² from stacked (n, d) grads."""
    mean = torch.mean(grads, dim=0, keepdim=True)
    return torch.mean(torch.sum((grads - mean) ** 2, dim=-1))


def make_dirichlet_binclass(seed: int, n_workers: int, m: int, d: int,
                            alpha: float | None = 1.0, n_clusters: int = 8,
                            device=None) -> BinClassData:
    """Dirichlet(α) non-IID federated split of the eq.-(11) problem: samples
    in ``n_clusters`` Gaussian feature clusters, labels from one global
    noisy linear teacher; client i draws each sample's cluster from its own
    π_i ~ Dir(α). α = ``None`` or a non-finite value gives the uniform
    mixture (iid clients), α = 0.1 near-single-cluster clients."""
    device = default_device(device)
    if alpha is not None and np.isfinite(alpha):
        rng = np.random.default_rng(seed)
        pi = torch.from_numpy(rng.dirichlet(np.full(n_clusters, float(alpha)),
                                            n_workers).astype(np.float32))
    else:
        pi = torch.full((n_workers, n_clusters), 1.0 / n_clusters)
    gen = torch.Generator().manual_seed(seed)
    sd = float(np.sqrt(d))
    centers = torch.randn((n_clusters, d), generator=gen) * (2.0 / sd)
    asn = torch.multinomial(pi, m, replacement=True, generator=gen)   # (n, m)
    noise = torch.randn((n_workers, m, d), generator=gen) / sd
    a = centers[asn] + noise
    teacher = torch.randn((d,), generator=gen)
    y = _binclass_labels(torch.einsum("nmd,d->nm", a, teacher) * sd, gen)
    return BinClassData(a=a.to(device), y=y.to(device))
