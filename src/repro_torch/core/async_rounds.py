"""Deadline-cohort MARINA: straggler-tolerant rounds on the carry table —
port of ``repro.core.async_rounds`` (tree path only, as in the reference).

The server closes every compressed round at ``deadline``. Clients whose
compute time (a :class:`repro_torch.core.roundtime.RoundTimeModel` draw)
beats it upload the compressed difference against their carry anchor; a
client that misses is a PP non-participant: Δ̂_i = 0 on the wire, no h
refresh, no bits booked. A miss by τ = ⌈T_i/deadline⌉ − 1 rounds with
τ ≤ ``tau_max`` keeps computing and lands at round k + τ against the anchor
it diffed (pinned while in flight); beyond tau_max the client abandons. Sync
rounds (c_k ~ Be(p)) are the rendezvous: in-flight work is discarded, every
anchor refreshes, the round costs the slowest client.

Two equivalence contracts, held by the tests on the port as on the
reference:

* a deadline never missed ⇒ bit-identical to ``Marina(carry=True)`` (the
  time draws ride :data:`TIME_FOLD`, the (k_bern, k_q) split is untouched);
* a fixed slow set that always misses, ``tau_max=0`` ⇒ bit-identical to
  ``Marina(carry=True, faults=FaultSpec("drop", ids=slow))``.

The per-client bookkeeping (tags, arrival rounds) is small host-side state
on the CPU; the gradients stay on their device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import prng

from .compressors import Compressor, tree_dim
from .faults import FaultSpec
from .marina import GradFn, _compressed_delta, _counted_bits, _per_worker_grads, _round_bits
from .roundtime import TIME_FOLD, RoundTimeModel
from .tree_util import tree_axpy, tree_leaves, tree_map, tree_mean_axis0, tree_norm

PyTree = Any


class AsyncStepMetrics(NamedTuple):
    grad_est_norm: torch.Tensor  # ‖g^{k+1}‖
    bits_per_worker: float       # fleet uplink / n: uploaded·ζ_Q, or 32d on sync
    sync_round: int              # c_k
    wall_clock_s: float          # simulated round duration (server view)
    uploaded: int                # compressed payloads accepted this round
    staleness_mean: float        # mean anchor age over clients, in rounds
    staleness_max: int           # oldest anchor age
    down_bits: float             # dense 32d estimator broadcast every round


@dataclasses.dataclass
class AsyncMarinaState:
    params: PyTree          # lookahead iterate x^{k+1} (carry convention)
    g: PyTree               # server estimator g^k
    step: int
    h: PyTree               # (n,)-stacked carry anchors, pinned while in flight
    tag: torch.Tensor       # (n,) i32: round whose lookahead produced h_i (−1: init)
    pend_g: PyTree          # (n,)-stacked in-flight gradients
    arrive: torch.Tensor    # (n,) i32: round the in-flight upload lands; −1 idle
    born: torch.Tensor      # (n,) i32: round the in-flight compute started; −1


def _where_rows(mask: torch.Tensor, a: PyTree, b: PyTree) -> PyTree:
    """Row-select between two worker-stacked trees on an (n,) bool mask."""
    return tree_map(lambda ta, tb: torch.where(
        mask.to(ta.device).reshape((-1,) + (1,) * (ta.ndim - 1)), ta, tb), a, b)


def _full(n: int, v: int) -> torch.Tensor:
    return torch.full((n,), v, dtype=torch.int32)


@dataclasses.dataclass
class DeadlineMarina:
    """MARINA with deadline cohorts and stale-difference acceptance:
    ``times`` draws each round's per-client compute times, ``deadline`` is
    the server's round budget, ``tau_max`` the staleness bound on accepted
    late uploads (0: a miss is pure non-participation). Carry rounds only."""

    grad_fn: GradFn
    compressor: Compressor
    gamma: float
    p: float
    deadline: float
    times: RoundTimeModel = RoundTimeModel()
    tau_max: int = 0

    def __post_init__(self):
        if self.deadline <= 0.0:
            raise ValueError("deadline must be positive")
        if self.tau_max < 0:
            raise ValueError("tau_max must be non-negative")

    def static_miss_faults(self) -> "FaultSpec | None":
        """The equivalent static ``drop`` FaultSpec when the slow set always
        misses and late uploads are never accepted; None otherwise."""
        if not self.times.slow_ids or self.tau_max > 0:
            return None
        return FaultSpec("drop", ids=self.times.slow_ids)

    def init(self, params: PyTree, batches: PyTree) -> AsyncMarinaState:
        n = tree_leaves(batches)[0].shape[0]
        grads = _per_worker_grads(self.grad_fn, params, batches)
        g0 = tree_mean_axis0(grads)
        return AsyncMarinaState(
            params=tree_axpy(-self.gamma, g0, params), g=g0, step=0, h=grads,
            tag=_full(n, -1), pend_g=tree_map(torch.zeros_like, grads),
            arrive=_full(n, -1), born=_full(n, -1))

    def step(self, state: AsyncMarinaState, key, batches: PyTree):
        n = tree_leaves(batches)[0].shape[0]
        k = state.step
        # the Marina carry key discipline: (k_bern, k_q) untouched
        k_bern, k_q = prng.split(key)
        c_k = bool(prng.bernoulli(k_bern, self.p))
        times = self.times.sample(prng.fold_in(key, TIME_FOLD), n)
        D = float(np.float32(self.deadline))
        d = tree_dim(state.params)

        # the one backprop of the round (busy clients' rows are computed too
        # and never consumed)
        grads = _per_worker_grads(self.grad_fn, state.params, batches)
        idle = state.arrive < 0
        arriving = state.arrive == k

        if c_k:
            g_next = tree_mean_axis0(grads)
            # busy clients finish or abandon their in-flight rounds first
            residual = torch.clamp(state.arrive - k, min=0).float()
            wall = float(torch.max(times + residual * D))
            h_next, tag_next = grads, _full(n, k)
            pend_next = tree_map(torch.zeros_like, grads)
            arrive_next, born_next = _full(n, -1), _full(n, -1)
            uploaded = n
        else:
            on_time = idle & (times <= D)
            tau = torch.ceil(times / D).to(torch.int32) - 1
            pending = idle & (times > D) & (tau <= self.tau_max)
            contrib = on_time | arriving
            # accepted rows diff against the anchor both sides hold; every
            # other row is h_i − h_i = 0, the drop fault's zero row
            up_src = _where_rows(on_time, grads, _where_rows(arriving, state.pend_g, state.h))
            diffs = tree_map(torch.sub, up_src, state.h)
            delta = _compressed_delta(self.compressor, None, k_q, diffs, state.params, n)
            g_next = tree_map(torch.add, state.g, delta)
            h_next = _where_rows(contrib, up_src, state.h)
            tag_next = torch.where(on_time, k, torch.where(arriving, state.born, state.tag))
            pend_next = _where_rows(pending, grads, state.pend_g)
            arrive_next = torch.where(pending, k + tau,
                                      torch.where(arriving, -1, state.arrive)).to(torch.int32)
            born_next = torch.where(pending, k,
                                    torch.where(arriving, -1, state.born)).to(torch.int32)
            # an all-on-time round closes at its slowest upload, else at D
            if bool(on_time.all()):
                wall = float(torch.max(torch.where(idle, times, torch.zeros_like(times))))
            else:
                wall = D
            uploaded = int(contrib.sum())
        # the iterate update once, on the round's estimator, as Marina's carry
        x_next = tree_axpy(-self.gamma, g_next, state.params)
        new_state = AsyncMarinaState(
            params=x_next, g=g_next, step=k + 1, h=h_next, tag=tag_next.to(torch.int32),
            pend_g=pend_next, arrive=arrive_next, born=born_next)

        bits_dense = 32.0 * d
        zeta = _round_bits(self.compressor, None, state.params, n)
        # fleet total / n: only the payloads that arrived bill
        bits_q = _counted_bits(uploaded, zeta, n)
        age = k - new_state.tag
        metrics = AsyncStepMetrics(
            grad_est_norm=tree_norm(new_state.g),
            bits_per_worker=bits_dense if c_k else bits_q, sync_round=int(c_k),
            wall_clock_s=wall, uploaded=uploaded,
            staleness_mean=float(torch.mean(age.float())),
            staleness_max=int(torch.max(age)), down_bits=bits_dense)
        return new_state, metrics
