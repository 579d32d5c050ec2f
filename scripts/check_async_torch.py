"""CI gate for the port's deadline-cohort async path — the twin of
``scripts/check_async.py`` on ``repro_torch``.

Runs the two equivalence contracts of ``core/async_rounds.py`` at test
scale and fails when either stops holding BITWISE:

1. **p_miss = 0** — a deadline no client can ever miss leaves
   ``DeadlineMarina`` bit-identical to ``Marina(carry=True)``: the
   (k_bern, k_q) key split is untouched (round times ride the ``TIME_FOLD``
   side channel) and the diff rows coincide.

2. **static slow set, tau_max = 0** — clients that always miss the
   deadline and are never accepted late reproduce the static
   ``FaultSpec("drop", ids=...)`` carry substitution exactly: Δ̂_i = 0 rows,
   no h refresh, and the uploaded·ζ_Q/n billing.

Bitwise on purpose: both sides run the same operations in one process, so
any difference is a change of semantics, not float noise. On the card
unless ``--device`` names another (it raises without a card).

Usage: PYTHONPATH=src python scripts/check_async_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

N, M, D = 6, 32, 24
ROUNDS = 40
SLOW = (1, 4)


def run_pair(label, method_a, method_b, device, steps=ROUNDS, seed=7):
    from repro_torch import prng
    from repro_torch.core.problems import make_synthetic_binclass

    data = make_synthetic_binclass(0, N, M, D, device=device)
    x0 = torch.zeros((D,), device=device)
    sa = method_a.init(x0, data)
    sb = method_b.init(x0, data)
    bits_a = bits_b = 0.0
    for k in range(steps):
        key = prng.PRNGKey(seed * 100_000 + k)
        sa, ma = method_a.step(sa, key, data)
        sb, mb = method_b.step(sb, key, data)
        bits_a += float(ma.bits_per_worker)
        bits_b += float(mb.bits_per_worker)
        for name in ("params", "g"):
            va, vb = getattr(sa, name), getattr(sb, name)
            if not torch.equal(va, vb):
                print(f"{label}: {name} DIVERGED at round {k} "
                      f"(max |Δ| = {float((va - vb).abs().max()):.3e})", file=sys.stderr)
                return False
    if bits_a != bits_b:
        print(f"{label}: ledger drift — {bits_a} vs {bits_b} bits/worker", file=sys.stderr)
        return False
    print(f"{label}: {steps} rounds bit-identical "
          f"({bits_a:.0f} bits/worker booked on both sides)")
    return True


def main(argv=None):
    from repro_torch.core import DeadlineMarina, FaultSpec, Marina, RandK, RoundTimeModel
    from repro_torch.core.problems import binclass_grad
    from repro_torch.device import default_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    device = default_device(ap.parse_args(argv).device)
    comp = RandK(k=3)
    gamma, p = 0.05, 0.3

    ok = run_pair(
        "p_miss=0 (never-miss deadline == full participation)",
        DeadlineMarina(binclass_grad, comp, gamma, p, deadline=1e9,
                       times=RoundTimeModel(dist="fixed", mean_s=1.0)),
        Marina(binclass_grad, comp, gamma, p, carry=True),
        device,
    )
    ok &= run_pair(
        "static slow set (always-miss == FaultSpec drop)",
        DeadlineMarina(binclass_grad, comp, gamma, p, deadline=2.0,
                       times=RoundTimeModel(dist="fixed", mean_s=1.0, slow_ids=SLOW,
                                            slow_factor=8.0)),
        Marina(binclass_grad, comp, gamma, p, carry=True, faults=FaultSpec("drop", ids=SLOW)),
        device,
    )
    if not ok:
        print("FAIL: async equivalence gate", file=sys.stderr)
        return 1
    print("async gate passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
