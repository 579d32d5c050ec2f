"""Baseline distributed methods the paper compares against — port of
``repro.core.baselines``.

* DIANA (Mishchenko et al. 2019): unbiased compression of gradient *shifts*.
* VR-DIANA (Horváth et al. 2019): DIANA + SVRG-style local variance reduction.
* QSGD-style DCGD (Alistarh et al. 2017): direct quantization of gradients.
* EC-SGD (Seide et al. 2014; Stich & Karimireddy 2020): biased TopK + error
  feedback.

Same worker-stacked-tree conventions as :mod:`repro_torch.core.marina`.
Every method compresses on the per-leaf tree path, as in the reference:
worker w's key is the w-th of ``split(key, n)`` and :func:`tree_compress`
splits it per leaf, so each worker draws the reference's bits. They launch
no kernel (the tree compressors run the plain versions).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import prng

from .compressors import (
    Compressor,
    tree_compress,
    tree_decompress,
    tree_dim,
    tree_payload_bits,
)
from .marina import GradFn, StepMetrics, _batch_rows, _per_worker_grads
from .tree_util import (
    tree_axpy,
    tree_map,
    tree_mean_axis0,
    tree_norm,
    tree_stack_workers,
    tree_sub,
    tree_worker_slice,
)

PyTree = Any


def _roundtrip_workers(comp: Compressor, key, trees: PyTree, like: PyTree,
                       n: int) -> PyTree:
    """Q(Δ_i) for every worker, stacked: worker w compresses under the w-th
    key of ``split(key, n)`` (the reference's vmapped compress) and the
    payload decompresses against ``like``'s shapes and dtypes."""
    keys = prng.split(key, n)
    return tree_stack_workers([
        tree_decompress(comp, tree_compress(comp, keys[w], tree_worker_slice(trees, w)),
                        like)
        for w in range(n)])


def _zeros_stacked(params: PyTree, n: int) -> PyTree:
    return tree_map(lambda x: x.new_zeros((n, *x.shape)), params)


def _metrics(comp: Compressor, like: PyTree, gnorm, oracle: float,
             sync: int = 0) -> StepMetrics:
    """Every baseline round uplinks one compressed payload per worker and
    broadcasts the dense estimator (32d bits)."""
    return StepMetrics(grad_est_norm=gnorm,
                       bits_per_worker=float(tree_payload_bits(comp, like)),
                       sync_round=sync, oracle_calls=oracle,
                       down_bits=32.0 * tree_dim(like))


def _shift_update(h: PyTree, h_mean: PyTree, q: PyTree, alpha: float):
    """DIANA's shifts: h_i += α·Q(Δ_i) and their server mean likewise."""
    h_new = tree_map(lambda hi, qi: hi + alpha * qi, h, q)
    h_mean_new = tree_map(lambda hm, qm: hm + alpha * qm, h_mean, tree_mean_axis0(q))
    return h_new, h_mean_new


# ---------------------------------------------------------------------------
# DIANA
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DianaState:
    params: PyTree
    h: PyTree        # per-worker shifts h_i, leading axis n
    h_mean: PyTree   # server-side (1/n)Σ h_i
    step: int


@dataclasses.dataclass
class Diana:
    grad_fn: GradFn
    compressor: Compressor
    gamma: float
    alpha: float  # shift stepsize, ≤ 1/(1+ω)
    n: int

    def init(self, params: PyTree) -> DianaState:
        return DianaState(params=params, h=_zeros_stacked(params, self.n),
                          h_mean=tree_map(torch.zeros_like, params), step=0)

    def step(self, state: DianaState, key, batches: PyTree):
        grads = _per_worker_grads(self.grad_fn, state.params, batches)  # (n, …)
        deltas = tree_sub(grads, state.h)                               # ∇f_i − h_i
        del grads
        q = _roundtrip_workers(self.compressor, key, deltas, state.params, self.n)
        g = tree_map(torch.add, state.h_mean, tree_mean_axis0(q))       # unbiased
        h_new, h_mean_new = _shift_update(state.h, state.h_mean, q, self.alpha)
        x_new = tree_axpy(-self.gamma, g, state.params)
        metrics = _metrics(self.compressor, state.params, tree_norm(g), 1.0)
        return (DianaState(params=x_new, h=h_new, h_mean=h_mean_new,
                           step=state.step + 1), metrics)


# ---------------------------------------------------------------------------
# VR-DIANA (SVRG-flavoured local variance reduction, option II snapshots)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VRDianaState:
    params: PyTree
    h: PyTree
    h_mean: PyTree
    snapshot: PyTree      # w_i — shared x at snapshot time (replicated)
    mu: PyTree            # per-worker full gradients at the snapshot, axis n
    step: int


@dataclasses.dataclass
class VRDiana:
    full_grad_fn: GradFn
    mb_grad_fn: GradFn
    compressor: Compressor
    gamma: float
    alpha: float
    n: int
    snapshot_prob: float  # SVRG option II: refresh w_i with prob 1/m

    def init(self, params: PyTree, full_batches: PyTree) -> VRDianaState:
        mu = _per_worker_grads(self.full_grad_fn, params, full_batches)
        return VRDianaState(params=params, h=_zeros_stacked(params, self.n),
                            h_mean=tree_map(torch.zeros_like, params),
                            snapshot=params, mu=mu, step=0)

    def step(self, state: VRDianaState, key, full_batches: PyTree,
             mb_batches: PyTree):
        k_q, k_snap = prng.split(key)
        # SVRG estimator: v_i = ∇f_iB(x) − ∇f_iB(w) + µ_i
        g_x = _per_worker_grads(self.mb_grad_fn, state.params, mb_batches)
        g_w = _per_worker_grads(self.mb_grad_fn, state.snapshot, mb_batches)
        v = tree_map(lambda a, b, m: a - b + m, g_x, g_w, state.mu)
        del g_x, g_w

        deltas = tree_sub(v, state.h)
        q = _roundtrip_workers(self.compressor, k_q, deltas, state.params, self.n)
        g = tree_map(torch.add, state.h_mean, tree_mean_axis0(q))
        h_new, h_mean_new = _shift_update(state.h, state.h_mean, q, self.alpha)
        x_new = tree_axpy(-self.gamma, g, state.params)

        # option-II snapshot refresh (a shared coin; a refresh costs m calls)
        refresh = bool(prng.bernoulli(k_snap, self.snapshot_prob))
        if refresh:
            snapshot = x_new
            mu = _per_worker_grads(self.full_grad_fn, x_new, full_batches)
        else:
            snapshot, mu = state.snapshot, state.mu

        b, m_full = _batch_rows(mb_batches), _batch_rows(full_batches)
        metrics = _metrics(self.compressor, state.params, tree_norm(g),
                           2.0 * b + m_full if refresh else 2.0 * b, int(refresh))
        return (VRDianaState(params=x_new, h=h_new, h_mean=h_mean_new,
                             snapshot=snapshot, mu=mu, step=state.step + 1),
                metrics)


# ---------------------------------------------------------------------------
# DCGD / QSGD: x^{k+1} = x^k − γ (1/n) Σ Q(∇f_i(x^k))
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DCGDState:
    params: PyTree
    step: int


@dataclasses.dataclass
class DCGD:
    grad_fn: GradFn
    compressor: Compressor
    gamma: float
    n: int

    def init(self, params: PyTree) -> DCGDState:
        return DCGDState(params=params, step=0)

    def step(self, state: DCGDState, key, batches: PyTree):
        grads = _per_worker_grads(self.grad_fn, state.params, batches)
        q = _roundtrip_workers(self.compressor, key, grads, state.params, self.n)
        g = tree_mean_axis0(q)
        x_new = tree_axpy(-self.gamma, g, state.params)
        metrics = _metrics(self.compressor, state.params, tree_norm(g), 1.0)
        return DCGDState(params=x_new, step=state.step + 1), metrics


# ---------------------------------------------------------------------------
# EC-SGD: biased compressor + error feedback
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ECSGDState:
    params: PyTree
    e: PyTree  # per-worker error buffers, axis n
    step: int


@dataclasses.dataclass
class ECSGD:
    grad_fn: GradFn
    compressor: Compressor  # typically TopK (biased)
    gamma: float
    n: int

    def init(self, params: PyTree) -> ECSGDState:
        return ECSGDState(params=params, e=_zeros_stacked(params, self.n), step=0)

    def step(self, state: ECSGDState, key, batches: PyTree):
        grads = _per_worker_grads(self.grad_fn, state.params, batches)
        # p_i = e_i + γ ∇f_i ; transmit C(p_i); e_i ← p_i − C(p_i)
        p_i = tree_map(lambda e, g: e + self.gamma * g, state.e, grads)
        del grads
        c = _roundtrip_workers(self.compressor, key, p_i, state.params, self.n)
        e_new = tree_sub(p_i, c)
        update = tree_mean_axis0(c)
        x_new = tree_sub(state.params, update)
        metrics = _metrics(self.compressor, state.params,
                           tree_norm(update) / self.gamma, 1.0)
        return ECSGDState(params=x_new, e=e_new, step=state.step + 1), metrics
