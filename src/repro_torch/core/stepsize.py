"""Theory stepsizes and iteration bounds from the paper's theorems (a verbatim
copy of ``repro.core.stepsize``, which imports only ``math``).

These are the *exact* admissible stepsizes of Theorems 2.1, 2.2, 3.1/3.2, 4.1 —
the experiments in §5 / Appendix A run MARINA and DIANA with these theoretical
choices, and our reproduction benchmarks do the same.
"""

from __future__ import annotations

import math


def marina_gamma(L: float, omega: float, p: float, n: int) -> float:
    """Thm 2.1:  γ ≤ 1 / ( L (1 + sqrt((1-p) ω / (p n))) )."""
    return 1.0 / (L * (1.0 + math.sqrt((1.0 - p) * omega / (p * n))))


def marina_gamma_pl(L: float, omega: float, p: float, n: int, mu: float) -> float:
    """Thm 2.2:  γ ≤ min{ 1/(L(1+sqrt(2(1-p)ω/(pn)))), p/(2µ) }."""
    g1 = 1.0 / (L * (1.0 + math.sqrt(2.0 * (1.0 - p) * omega / (p * n))))
    return min(g1, p / (2.0 * mu))


def vr_marina_gamma(
    L: float, calL: float, omega: float, p: float, n: int, b_prime: int
) -> float:
    """Thm 3.1/3.2:  γ ≤ 1 / ( L + sqrt((1-p)/(pn) (ω L² + (1+ω) 𝓛²/b')) )."""
    inner = (1.0 - p) / (p * n) * (omega * L**2 + (1.0 + omega) * calL**2 / b_prime)
    return 1.0 / (L + math.sqrt(inner))


def pp_marina_gamma(L: float, omega: float, p: float, r: int) -> float:
    """Thm 4.1:  γ ≤ 1 / ( L (1 + sqrt((1-p)(1+ω)/(p r))) )."""
    return 1.0 / (L * (1.0 + math.sqrt((1.0 - p) * (1.0 + omega) / (p * r))))


# ---------------------------------------------------------------------------
# (A, B)-refined stepsizes (Szlendak et al. 2021, "Permutation Compressors")
#
# The collection {Q_i} enters MARINA's rate only through the AB-inequality
#
#     E‖(1/n)Σ Q_i(x_i) − x̄‖² ≤ A·(1/n)Σ‖x_i‖² − B·‖x̄‖²
#
# (see Compressor.ab_constants). The estimator-drift term of the Thm 2.1
# proof then carries A·L₊² − B·L₋² instead of (ω/n)·L², where L₊² = (1/n)ΣL_i²
# and L₋ is the "Hessian variance" smoothness of f_i − f (L₋ ≤ L₊; equal in
# the worst case). Independent ω-compressors have (A, B) = ((1+ω)/n, 1/n)
# (tight — see ab_constants), which recovers marina_gamma exactly; PermK's
# (1, 1) makes the drift term vanish for homogeneous smoothness and admits
# the plain GD stepsize γ = 1/L at d/n uplink per worker.
# ---------------------------------------------------------------------------


def ab_from_omega(omega: float, n: int) -> tuple:
    """Tight (A, B) for n *independent* ω-compressors: ((1+ω)/n, 1/n).

    NOT (1+ω, ω): with identical inputs that pair demands ω ≤ n (its right
    side degenerates to ‖x‖² against a true aggregate variance of (ω/n)‖x‖²),
    so it is violated by any high-compression operator — see the counter-
    example in Compressor.ab_constants."""
    return ((1.0 + omega) / n, 1.0 / n)


def marina_gamma_ab(
    L: float,
    A: float,
    B: float,
    p: float,
    l_plus: float | None = None,
    l_minus: float | None = None,
) -> float:
    """AB-refined Thm 2.1:  γ ≤ 1 / ( L + sqrt((1-p)/p · (A·L₊² − B·L₋²)) ).

    With (A, B) = ab_from_omega(ω, n) and L₊ = L₋ = L this is exactly
    :func:`marina_gamma`; with PermK's (1, 1) and homogeneous smoothness the
    sqrt term vanishes and γ = 1/L."""
    lp = L if l_plus is None else l_plus
    lm = lp if l_minus is None else l_minus
    inner = max((1.0 - p) / p * (A * lp**2 - B * lm**2), 0.0)
    return 1.0 / (L + math.sqrt(inner))


def marina_gamma_permk(
    L: float,
    p: float,
    l_plus: float | None = None,
    l_minus: float | None = None,
) -> float:
    """Perm-K corollary of the AB theorem: (A, B) = (1, 1), so
    γ = 1 / (L + sqrt((1-p)/p · (L₊² − L₋²))) — and exactly 1/L whenever the
    workers share the smoothness constant (L₋ = L₊), i.e. MARINA+PermK runs
    at the uncompressed GD stepsize while uplinking d/n coords per worker."""
    return marina_gamma_ab(L, 1.0, 1.0, p, l_plus, l_minus)


def permk_default_p(n: int) -> float:
    """ζ_Q/d for PermK is (d/n)/d = 1/n (Cor. 2.1 choice)."""
    return 1.0 / n


def diana_alpha(omega: float) -> float:
    """DIANA shift learning rate α ≤ 1/(1+ω) (Mishchenko et al. 2019)."""
    return 1.0 / (1.0 + omega)


def diana_gamma(L: float, omega: float, n: int) -> float:
    """Non-convex DIANA stepsize (Li & Richtárik 2020, simplified constants):

    γ = 1 / ( L (1 + (1+ω) sqrt(ω/n) · c) ), c = O(1). We use c = 2 which satisfies
    the admissibility condition of their Theorem 4.1 specialization.
    """
    return 1.0 / (L * (1.0 + 2.0 * (1.0 + omega) * math.sqrt(omega / n) + 2.0 * omega / n))


# ---------------------------------------------------------------------------
# Robust-aggregation γ degradation (DESIGN.md §4.9)
#
# Swapping the server mean for a GAR costs variance averaging: the 1/n factor
# in Thm 2.1's drift term came from averaging n independent compressor
# noises, and a robust rule only averages over the values it keeps. The
# standard heuristic (e.g. El-Mhamdi et al.'s (f, λ)-resilient-averaging
# view) is to substitute the rule's *effective averaging count* n_eff for n:
# trimmed mean keeps n − 2f values per coordinate, the median one (odd n) or
# two (even n), Krum forwards a single row, norm-clip still averages all n
# (clipping only shrinks rows). This is a conservative bookkeeping device,
# not a theorem from the paper — MARINA's analysis leaves Byzantine rates to
# future work — so the helpers are explicitly labeled heuristic.
# ---------------------------------------------------------------------------


def robust_n_eff(rule: str, n: int, f: int = 0) -> int:
    """Effective averaging count n_eff of a GAR over n workers.

    mean/norm_clip: n (all rows enter the average); trimmed_mean: n − 2f
    (needs n > 2f); coordinate_median: 1 for odd n, 2 for even (the kept
    middle values); krum: 1 (a single selected row)."""
    if rule in ("mean", "norm_clip"):
        return n
    if rule == "trimmed_mean":
        if n <= 2 * f:
            raise ValueError(f"trimmed_mean needs n > 2f (n={n}, f={f})")
        return n - 2 * f
    if rule == "coordinate_median":
        return 2 if n % 2 == 0 else 1
    if rule == "krum":
        return 1
    raise ValueError(f"unknown GAR rule {rule!r}")


def robust_marina_gamma(
    L: float, omega: float, p: float, n: int, rule: str, f: int = 0
) -> float:
    """Thm 2.1 γ with the GAR's n_eff substituted for n — the robust-rate
    degradation: γ_robust = 1/(L(1 + sqrt((1−p)ω/(p·n_eff)))). Heuristic
    (see the section comment); equals :func:`marina_gamma` for the mean."""
    return marina_gamma(L, omega, p, robust_n_eff(rule, n, f))


def robust_pp_marina_gamma(
    L: float, omega: float, p: float, r: int, rule: str, f: int = 0
) -> float:
    """Thm 4.1 γ with n_eff(r) substituted for the cohort size r — the
    PP-MARINA robust degradation (the GAR acts on the r uploaded rows).
    Heuristic; equals :func:`pp_marina_gamma` for the mean."""
    return pp_marina_gamma(L, omega, p, robust_n_eff(rule, r, f))


# ---------------------------------------------------------------------------
# Deadline/staleness γ degradation (DESIGN.md §4.10)
#
# A deadline round looks like a PP round whose cohort the clock sampled:
# only the clients that beat the deadline (plus accepted late uploads)
# contribute fresh differences, so the variance-averaging count in the
# Thm 4.1 view is the expected arrivals r_eff = arrive_frac·n, not n. On
# top of that, an accepted upload that is τ rounds stale diffs against an
# anchor τ rounds old: under L-smoothness its second moment grows with the
# iterate drift ‖x^{k+1} − x^{k−τ+1}‖² ≲ (1+τ)·Σ‖x^{j+1} − x^j‖², which we
# book as a (1 + τ̄) inflation of the compressor-noise term — the same
# conservative substitution device as robust_n_eff, NOT a theorem from the
# paper (MARINA's analysis leaves asynchrony to future work), so the helper
# is explicitly labeled heuristic. At arrive_frac = 1, staleness = 0 it
# reduces exactly to marina_gamma.
# ---------------------------------------------------------------------------


def async_marina_gamma(
    L: float,
    omega: float,
    p: float,
    n: int,
    arrive_frac: float = 1.0,
    staleness: float = 0.0,
) -> float:
    """Heuristic deadline-MARINA stepsize, degrading with the observed
    participation and anchor staleness:

        γ = 1 / ( L (1 + sqrt((1−p) ω (1+τ̄) / (p · max(1, ā·n)))) )

    with ā = ``arrive_frac`` (the fraction of clients whose upload made the
    round — :attr:`AsyncStepMetrics.uploaded`/n averaged over rounds) and
    τ̄ = ``staleness`` (mean anchor age, ``staleness_mean``). Equals
    :func:`marina_gamma` at ā = 1, τ̄ = 0; heuristic otherwise (see the
    section comment)."""
    if not 0.0 <= arrive_frac <= 1.0:
        raise ValueError("arrive_frac must be in [0, 1]")
    if staleness < 0.0:
        raise ValueError("staleness must be non-negative")
    n_eff = max(1.0, arrive_frac * n)
    inflated = omega * (1.0 + staleness)
    return 1.0 / (L * (1.0 + math.sqrt((1.0 - p) * inflated / (p * n_eff))))


def marina_iteration_bound(
    delta0: float, L: float, omega: float, p: float, n: int, eps: float
) -> float:
    """Thm 2.1 iteration count K = 2Δ₀/(γ ε²) to reach E‖∇f‖² ≤ ε²."""
    return 2.0 * delta0 / (marina_gamma(L, omega, p, n) * eps**2)


def marina_comm_per_worker(d: int, zeta: float, p: float, K: float) -> float:
    """Expected communicated coordinates per worker (eq. 19): d + K(pd + (1-p)ζ)."""
    return d + K * (p * d + (1.0 - p) * zeta)
