"""Quickstart on the PyTorch port: MARINA vs DIANA vs GD on the paper's §5.1
experiment (``examples/quickstart.py``'s twin).

Reproduces the qualitative claim of Fig. 1: to reach the same gradient-norm
target, MARINA needs far fewer transmitted bits than DIANA (and than
uncompressed GD), on the non-convex binary classification loss (eq. 11) with
heterogeneous workers and theoretical stepsizes. The problem is the port's
own draw of the same construction, so the counts differ from the reference
example's.

Run on the card:  PYTHONPATH=src python examples/quickstart_torch.py
Run on the CPU:   PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import torch

from repro_torch import prng
from repro_torch.core import (
    Diana,
    Marina,
    RandK,
    diana_alpha,
    diana_gamma,
    make_gd,
    marina_gamma,
)
from repro_torch.core.problems import (
    BinClassData,
    binclass_full_grad,
    binclass_smoothness,
    make_synthetic_binclass,
)
from repro_torch.device import default_device

N_WORKERS, M, D = 10, 256, 100
TARGET = 1e-4  # ||grad f||^2 target


def grad_sqnorm(x, data):
    flat = BinClassData(a=data.a.reshape(-1, D), y=data.y.reshape(-1))
    return float(torch.sum(binclass_full_grad(x, flat) ** 2))


def run(name, method, state, data, max_steps=3000):
    bits = 0.0
    for k in range(max_steps):
        state, met = method.step(state, prng.PRNGKey(k), data)
        bits += float(met.bits_per_worker)
        if k % 50 == 0 and grad_sqnorm(state.params, data) < TARGET:
            break
    gn = grad_sqnorm(state.params, data)
    print(f"{name:>10}: steps={k+1:5d}  bits/worker={bits/1e6:9.3f} Mb  "
          f"final ||∇f||² = {gn:.2e}")
    return bits, k + 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = default_device(args.device)
    data = make_synthetic_binclass(0, N_WORKERS, M, D, device=device)
    L = binclass_smoothness(data)
    x0 = torch.zeros((D,), device=device)
    comp = RandK(k=5)  # Rand5, as in Fig. 1's K ∈ {1,5,10}
    omega = comp.omega(D)
    p = comp.default_p(D)

    print(f"n={N_WORKERS} workers, d={D}, RandK K=5 (ω={omega:.0f}), L={L:.3f}, "
          f"device {device}\n")

    # GD (dense communication)
    gd = make_gd(binclass_full_grad, gamma=1.0 / L)
    run("GD", gd, gd.init(x0, data), data)

    # MARINA, theoretical stepsize (Thm 2.1)
    m = Marina(binclass_full_grad, comp, marina_gamma(L, omega, p, N_WORKERS), p)
    run("MARINA", m, m.init(x0, data), data)

    # DIANA, theoretical stepsize
    dia = Diana(binclass_full_grad, comp, diana_gamma(L, omega, N_WORKERS),
                diana_alpha(omega), N_WORKERS)
    run("DIANA", dia, dia.init(x0), data)


if __name__ == "__main__":
    main()
