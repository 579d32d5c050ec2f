"""MARINA, Algorithm 1 — port of ``repro.core.marina.Marina``.

The algorithm works on *worker-stacked* pytrees: every per-worker quantity
carries a leading axis of size ``n``. Per-worker gradients are a loop over
the workers (the reference's ``vmap``), written into one stacked tree.

* ``c_k ~ Be(p)`` is shared across workers and drawn on the host from the
  step key exactly as the reference draws it, so a Python ``if`` takes the
  place of ``lax.cond`` and both packages take the same branch.
* Recompute rounds (``carry=False``) evaluate gradients at both points on
  the same batch; with an engine, the compressed round aggregates through
  the seeded RandK uplink kernel and the scatter-mean kernel.
* Carry rounds (``carry=True``) keep the per-worker gradients ``h`` of the
  previous round and run one backprop per round; the state is lookahead
  (params already stepped). With an engine, the round ends in the fused
  epilogue kernel: ``scatter_epilogue`` on compressed rounds,
  ``mean_epilogue`` on sync rounds, and ``g`` lives as a packed (nblk, B)
  buffer.

Not ported yet (raise): the compressed downlink, robust aggregators and
fault injection.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import prng

from . import wire
from .compressors import (
    Compressor,
    tree_compress,
    tree_decompress,
    tree_dim,
    tree_payload_bits,
)
from .flat import FlatEngine, pack, pack_stacked, unpack
from .tree_util import (
    mean_axis0,
    tree_axpy,
    tree_leaves,
    tree_map,
    tree_mean_axis0,
    tree_norm,
    tree_stack_workers,
    tree_sub,
    tree_worker_slice,
)

PyTree = Any
GradFn = Callable[[PyTree, PyTree], PyTree]  # (params, batch) -> grad tree


class StepMetrics(NamedTuple):
    grad_est_norm: torch.Tensor   # ‖g^k‖ (the estimator driving the step)
    bits_per_worker: float        # bits uplinked by one worker this round
    sync_round: int               # c_k (1 = dense round)
    oracle_calls: float           # gradient oracle calls per worker
    down_bits: float = 0.0        # bits each worker receives this round


@dataclasses.dataclass
class MarinaState:
    params: PyTree
    g: PyTree          # estimator g^k: a packed (nblk, B) buffer on the fused
                       # carry path, a tree otherwise
    step: int
    h: Optional[PyTree] = None  # carry mode: per-worker ∇f_i(x^k), stacked


def _num_workers(batches: PyTree) -> int:
    return tree_leaves(batches)[0].shape[0]


def _per_worker_grads(grad_fn: GradFn, params: PyTree, batches: PyTree) -> PyTree:
    """∇f_i at params for every worker, written into one stacked tree."""
    n = _num_workers(batches)
    out = None
    for w in range(n):
        g = grad_fn(params, tree_worker_slice(batches, w))
        if out is None:
            out = tree_map(lambda t: t.new_empty((n, *t.shape)), g)
        for o, t in zip(tree_leaves(out), tree_leaves(g)):
            o[w].copy_(t)
        del g
    return out


def _compressed_delta(comp: Compressor, engine: "FlatEngine | None", key,
                      diffs: PyTree, like: PyTree, n: int) -> PyTree:
    """One compressed uplink round: (1/n) Σ_i Q(Δ_i). With an engine: the
    fused flat-buffer pipeline; without: the per-leaf tree path."""
    if engine is not None:
        return engine.fused_delta(key, diffs, n)
    dense = [
        tree_decompress(comp, tree_compress(comp, k, tree_worker_slice(diffs, w)), like)
        for w, k in enumerate(prng.split(key, n))
    ]
    return tree_mean_axis0(tree_stack_workers(dense))


def _round_bits(comp: Compressor, engine: "FlatEngine | None", like: PyTree) -> float:
    """Per-worker uplink bits of one compressed round (the ζ_Q axis)."""
    if engine is not None:
        return engine.payload_bits()
    return float(tree_payload_bits(comp, like))


def _sync_mean(engine: "FlatEngine | None", grads: PyTree) -> PyTree:
    """Sync-round mean: over the packed (n, nblk, B) buffer with an engine,
    leaf by leaf otherwise."""
    if engine is None:
        return tree_mean_axis0(grads)
    bufs = pack_stacked(engine.layout, grads)
    return unpack(engine.layout, mean_axis0(bufs))


@dataclasses.dataclass
class Marina:
    """Algorithm 1. ``grad_fn(params, batch)`` returns the local full
    gradient ∇f_i. ``carry=True`` enables single-backprop lookahead rounds.
    """

    grad_fn: GradFn
    compressor: Compressor
    gamma: float
    p: float
    engine: Optional[FlatEngine] = None
    carry: bool = False
    down_compressor: Any = None
    down_engine: Any = None
    aggregator: Any = None
    faults: Any = None

    def __post_init__(self):
        for name in ("down_compressor", "down_engine", "aggregator", "faults"):
            if getattr(self, name) is not None:
                raise NotImplementedError(f"Marina({name}=...) is not ported yet")

    def init(self, params: PyTree, batches: PyTree) -> MarinaState:
        grads = _per_worker_grads(self.grad_fn, params, batches)
        g0 = tree_mean_axis0(grads)
        if not self.carry:
            return MarinaState(params=params, g=g0, step=0)
        x1 = tree_axpy(-self.gamma, g0, params)
        if self.engine is not None:
            return MarinaState(params=x1, g=pack(self.engine.layout, g0), step=0,
                               h=grads)
        return MarinaState(params=x1, g=g0, step=0, h=grads)

    def _metrics(self, gnorm, c_k: bool, params: PyTree, oracle: float):
        d = tree_dim(params)
        bits_dense = wire.dense_f32_bits(d)
        bits = bits_dense if c_k else _round_bits(self.compressor, self.engine,
                                                   params)
        down = bits_dense if c_k else wire.downlink_dense_bits(d)
        return StepMetrics(grad_est_norm=gnorm, bits_per_worker=bits,
                           sync_round=int(c_k), oracle_calls=oracle,
                           down_bits=down)

    # -- seed-shaped rounds (two backprops on compressed rounds) ------------
    def _step_recompute(self, state: MarinaState, key, batches: PyTree):
        n = _num_workers(batches)
        k_bern, k_q = prng.split(key)
        c_k = bool(prng.bernoulli(k_bern, self.p))

        x_old = state.params
        x_new = tree_axpy(-self.gamma, state.g, x_old)  # Alg. 1 line 7
        if c_k:
            grads = _per_worker_grads(self.grad_fn, x_new, batches)
            g_next = _sync_mean(self.engine, grads)
        else:
            g_new = _per_worker_grads(self.grad_fn, x_new, batches)
            g_prev = _per_worker_grads(self.grad_fn, x_old, batches)
            diffs = tree_sub(g_new, g_prev)
            del g_new, g_prev
            delta = _compressed_delta(self.compressor, self.engine, k_q, diffs,
                                      state.params, n)
            g_next = tree_map(torch.add, state.g, delta)

        metrics = self._metrics(tree_norm(g_next), c_k, state.params,
                                1.0 if c_k else 2.0)
        return MarinaState(params=x_new, g=g_next, step=state.step + 1), metrics

    # -- gradient-carry lookahead rounds (one backprop, fused epilogue) -----
    def _step_carry(self, state: MarinaState, key, batches: PyTree):
        n = _num_workers(batches)
        k_bern, k_q = prng.split(key)
        c_k = bool(prng.bernoulli(k_bern, self.p))

        # the one backprop of the round: state.params is already x^{k+1}
        grads = _per_worker_grads(self.grad_fn, state.params, batches)

        if self.engine is not None:
            lay = self.engine.layout
            x2d = pack(lay, state.params)
            if c_k:
                g2d, x_new2d = self.engine.fused_sync(
                    pack_stacked(lay, grads), x2d, self.gamma)
            else:
                diff_bufs = pack_stacked(lay, tree_sub(grads, state.h))
                g2d, x_new2d = self.engine.fused_round(
                    k_q, diff_bufs, n, state.g, x2d, self.gamma)
                del diff_bufs
            new_state = MarinaState(params=unpack(lay, x_new2d), g=g2d,
                                    step=state.step + 1, h=grads)
            gnorm = tree_norm(g2d)
        else:
            if c_k:
                g_next = tree_mean_axis0(grads)
            else:
                delta = _compressed_delta(self.compressor, None, k_q,
                                          tree_sub(grads, state.h),
                                          state.params, n)
                g_next = tree_map(torch.add, state.g, delta)
            x_next = tree_axpy(-self.gamma, g_next, state.params)
            new_state = MarinaState(params=x_next, g=g_next,
                                    step=state.step + 1, h=grads)
            gnorm = tree_norm(g_next)

        return new_state, self._metrics(gnorm, c_k, state.params, 1.0)

    def step(self, state: MarinaState, key, batches: PyTree):
        if self.carry:
            return self._step_carry(state, key, batches)
        return self._step_recompute(state, key, batches)
