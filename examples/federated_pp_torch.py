"""PP-MARINA on the PyTorch port: federated partial participation
(``examples/federated_pp.py``'s twin).

Simulates a federated fleet where only r of n clients upload per round
(Alg. 4), on Dirichlet(α) non-IID clients. Shows the Thm 4.1 trade: smaller
r cuts per-round uplink and client compute, at more rounds to the same
accuracy. A final row runs the server-side carry table: one backprop per
sampled client instead of two, against stale anchors. The problem is the
port's own draw of the same construction.

Run on the card:  PYTHONPATH=src python examples/federated_pp_torch.py
Run on the CPU:   PYTHONPATH=src python examples/federated_pp_torch.py --device cpu
"""

import argparse

import torch

from repro_torch import prng
from repro_torch.core import PPMarina, RandK, pp_marina_gamma
from repro_torch.core.problems import (
    BinClassData,
    binclass_full_grad,
    binclass_smoothness,
    make_dirichlet_binclass,
)
from repro_torch.device import default_device

N, M, D = 20, 128, 60
TARGET = 3e-4


def grad_sqnorm(x, data):
    flat = BinClassData(a=data.a.reshape(-1, D), y=data.y.reshape(-1))
    return float(torch.sum(binclass_full_grad(x, flat) ** 2))


def run(m, data, label):
    st = m.init(torch.zeros((D,), device=data.a.device), data)
    bits = oracle = 0.0
    for k in range(8000):
        st, met = m.step(st, prng.PRNGKey(k), data)
        bits += float(met.bits_per_worker) * N   # fleet-total uplink
        oracle += float(met.oracle_calls) * N    # fleet-total backprops
        if k % 100 == 99 and grad_sqnorm(st.params, data) < TARGET:
            break
    print(f"{label:>12} {k+1:>7} {bits/1e6:>12.2f} {oracle:>10.0f} "
          f"{grad_sqnorm(st.params, data):>10.2e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    data = make_dirichlet_binclass(1, N, M, D, alpha=0.3,
                                   device=default_device(args.device))
    L = binclass_smoothness(data)
    comp = RandK(k=3)
    omega = comp.omega(D)

    print(f"n={N} Dir(0.3) clients, d={D}, Rand3 (ω={omega:.0f}), "
          f"without-replacement cohorts, device {data.a.device}\n")
    print(f"{'variant':>12} {'rounds':>7} {'total Mbits':>12} "
          f"{'backprops':>10} {'||∇f||²':>10}")
    for r in (20, 10, 4, 2):
        p = comp.default_p(D) * r / N
        gamma = pp_marina_gamma(L, omega, p, r)
        run(PPMarina(binclass_full_grad, comp, gamma, p, r, replace=False), data,
            f"r={r}")
    # the server-side carry table at moderate r: one backprop per sampled
    # client (half the oracle column) against slightly stale anchors
    r = 10
    p = comp.default_p(D) * r / N
    run(PPMarina(binclass_full_grad, comp, pp_marina_gamma(L, omega, p, r), p, r,
                 replace=False, carry=True), data, f"r={r}+carry")


if __name__ == "__main__":
    main()
