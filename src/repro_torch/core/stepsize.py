"""Theory stepsizes from the paper's theorems (port of the MARINA part of
``repro.core.stepsize``)."""

from __future__ import annotations

import math


def marina_gamma(L: float, omega: float, p: float, n: int) -> float:
    """Thm 2.1:  γ ≤ 1 / ( L (1 + sqrt((1-p) ω / (p n))) )."""
    return 1.0 / (L * (1.0 + math.sqrt((1.0 - p) * omega / (p * n))))
