"""MARINA, VR-MARINA and PP-MARINA (Algorithms 1–4) — port of
``repro.core.marina``.

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
* ``VRMarina`` (Alg. 2/3) takes two oracles: full (or b-batch) gradients on
  sync rounds, b′-minibatch gradients at both points on compressed rounds.
* ``PPMarina`` (Alg. 4) samples a cohort of r clients per compressed round
  (``replace`` = i.i.d., else distinct), optionally weights the clients,
  and with ``carry=True`` keeps a server-side table of every client's last
  gradient, refreshed only for the sampled rows.

* The compressed downlink (``down_engine``, a second flat engine over the
  uplink's layout from :func:`repro_torch.core.flat.make_downlink`, or
  ``down_compressor``, a per-leaf tree compressor): on compressed rounds
  the server broadcasts Q_down(δ_up) under the key ``fold_in(key,
  _DOWN_FOLD)`` — the round's (k_bern, k_q) split is untouched — and
  ``StepMetrics.down_bits`` books its payload instead of the dense 32d
  broadcast. A fused carry round with an engine takes only a
  ``down_engine`` (its epilogue kernel speaks the flat wire formats).

* ``aggregator`` (:class:`repro_torch.core.aggregators.ServerAggregator`)
  replaces the server mean by a Byzantine-robust rule on both round types;
  on the flat engine's carry rounds the coordinate-wise rules end in the
  ``trimmed_delta_epilogue`` / ``trimmed_sync_epilogue`` kernels. ``faults``
  (:class:`repro_torch.core.faults.FaultSpec`) rewrites the faulty clients'
  uplinked payloads under the key ``fold_in(key, _FAULT_FOLD)``; ``drop``
  needs ``carry=True``: a dropped client's row is zero on the wire, its
  anchor h_i stays, and the ledger books only the uploads that arrived. The
  carry table keeps the honest gradients. Robust rules are refused on PermK
  and with client weights, ``drop`` under a robust rule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import prng

from . import faults as fault_lib
from . import wire
from .compressors import (
    Compressor,
    CorrelatedCompressor,
    Identity,
    SharedRandK,
    tree_compress,
    tree_compress_worker,
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

#: fold_in constant deriving the downlink key from the step key without
#: perturbing the (k_bern, k_q) split: a downlink run draws the same uplink
#: randomness as a run without one
_DOWN_FOLD = 0x0D0C

#: fold_in constant deriving the fault-injection key (the garbage attack's
#: noise) from the step key, leaving the (k_bern, k_sel, k_q) split as it is
_FAULT_FOLD = 0xFA17


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
                      diffs: PyTree, like: PyTree, n: int, aggregator=None) -> PyTree:
    """One compressed uplink round: (1/n) Σ_i Q(Δ_i). With an engine: the
    fused flat-buffer pipeline; without: the per-leaf tree path, with one
    key per worker — except SharedRandK, whose workers all use the round key
    (one mask), and the correlated collections (PermK, CorrelatedQ), where
    every worker gets the round key and its index. A robust ``aggregator``
    replaces the mean by its rule over the decompressed payloads."""
    if engine is not None:
        return engine.fused_delta(key, diffs, n, aggregator)
    if isinstance(comp, CorrelatedCompressor):
        if n != comp.n:
            raise ValueError(f"{comp.name} collection sized for n={comp.n} but "
                             f"the round has {n} workers")
        payloads = [tree_compress_worker(comp, key, tree_worker_slice(diffs, w), w)
                    for w in range(n)]
    else:
        keys = [key] * n if isinstance(comp, SharedRandK) else prng.split(key, n)
        payloads = [tree_compress(comp, k, tree_worker_slice(diffs, w))
                    for w, k in enumerate(keys)]
    dense = tree_stack_workers([tree_decompress(comp, pl, like) for pl in payloads])
    if _robust(aggregator):
        return aggregator.combine_stacked(dense)
    return tree_mean_axis0(dense)


def _down_roundtrip(down_comp: "Compressor | None", down_engine: "FlatEngine | None",
                    key, delta: PyTree, like: PyTree) -> PyTree:
    """The compressed downlink on the aggregated round delta: the server
    broadcasts Q_down(δ_up) and every worker decompresses it — since
    g^{k+1} − g^k = δ_up, this is the compressed estimator difference.
    Through the downlink engine, else the per-leaf compressor (``like``
    gives the leaves' shapes and dtypes); the identity without either
    (dense broadcast)."""
    if down_engine is not None:
        return down_engine.roundtrip_worker(key, delta)
    if down_comp is not None:
        return tree_decompress(down_comp, tree_compress(down_comp, key, delta), like)
    return delta


def _down_round_bits(down_comp: "Compressor | None", down_engine: "FlatEngine | None",
                     like: PyTree, d: int) -> float:
    """Bits each worker receives on a compressed round: the downlink's one
    payload, or the dense 32d estimator without one."""
    if down_engine is not None:
        return down_engine.payload_bits(1)
    if down_comp is not None:
        return float(tree_payload_bits(down_comp, like))
    return wire.downlink_dense_bits(d)


def _round_bits(comp: Compressor, engine: "FlatEngine | None", like: PyTree,
                n: int = 1) -> float:
    """Per-worker uplink bits of one compressed round (the ζ_Q axis). ``n``
    matters only for partition compressors (PermK): a worker's payload is
    the d/n share."""
    if engine is not None:
        return engine.payload_bits(n)
    return float(tree_payload_bits(comp, like))


def _sync_aggregate(engine: "FlatEngine | None", aggregator, grads: PyTree,
                    weights: "torch.Tensor | None" = None) -> PyTree:
    """Sync-round server aggregate: the robust rule when one is configured,
    else the mean — over the packed (n, nblk, B) buffer with an engine, leaf
    by leaf otherwise, and weighted when client weights are set."""
    if _robust(aggregator):
        return aggregator.combine_stacked(grads)
    if weights is not None:
        return _weighted_mean_axis0(grads, weights)
    if engine is None:
        return tree_mean_axis0(grads)
    bufs = pack_stacked(engine.layout, grads)
    return unpack(engine.layout, mean_axis0(bufs))


def _carry_finish(m, state: "MarinaState", c_k: bool, k_q, grads: PyTree,
                  make_diffs: Optional[Callable[[], PyTree]], n: int, k_down):
    """End a carry round: g' = the server aggregate of the uplinked
    ``grads`` (sync) or g + the aggregate of Q(``make_diffs()``)
    (compressed, through the downlink under ``k_down`` if there is one),
    then x' = x − γ·g'. With an engine, one fused epilogue over the packed
    buffers (g stays packed). The diff tree is built here, so on the engine
    path it is freed once packed. Returns (params', g')."""
    agg = m.aggregator
    if m.engine is not None:
        lay = m.engine.layout
        x2d = pack(lay, state.params)
        if c_k:
            g2d, x_new2d = m.engine.fused_sync(pack_stacked(lay, grads), x2d, m.gamma,
                                               aggregator=agg)
        else:
            g2d, x_new2d = m.engine.fused_round(
                k_q, pack_stacked(lay, make_diffs()), n, state.g, x2d, m.gamma,
                down=m.down_engine, down_key=k_down, aggregator=agg)
        return unpack(lay, x_new2d), g2d
    if c_k:
        g_next = _sync_aggregate(None, agg, grads)
    else:
        delta = _compressed_delta(m.compressor, None, k_q, make_diffs(),
                                  state.params, n, agg)
        delta = _down_roundtrip(m.down_compressor, m.down_engine, k_down, delta,
                                state.params)
        g_next = tree_map(torch.add, state.g, delta)
    return tree_axpy(-m.gamma, g_next, state.params), g_next


def _carry_uplink(m, state: "MarinaState", key, c_k: bool, k_q, grads: PyTree,
                  n: int):
    """A full-fleet carry round (MARINA, VR-MARINA) from this round's honest
    gradients: the faulted sync uplink, or the faulted diffs against h, into
    :func:`_carry_finish`."""
    k_f = prng.fold_in(key, _FAULT_FOLD)
    ids = list(range(n))
    if c_k:
        return _carry_finish(m, state, True, k_q,
                             _sync_faults(m.faults, k_f, grads, ids, n), None, n, None)
    return _carry_finish(
        m, state, False, k_q, None,
        lambda: _uplink_faults(m.faults, k_f, tree_sub(grads, state.h), ids, n), n,
        prng.fold_in(key, _DOWN_FOLD))


def _lookahead_init(m, params: PyTree, grads: PyTree, g0: PyTree) -> "MarinaState":
    """Carry mode's lookahead start: x^1 = x^0 − γ·g^0, h = the per-worker
    gradients, g packed with an engine."""
    x1 = tree_axpy(-m.gamma, g0, params)
    g = pack(m.engine.layout, g0) if m.engine is not None else g0
    return MarinaState(params=x1, g=g, step=0, h=grads)


def _check_downlink_config(m) -> None:
    """A fused carry round consumes the downlink payload inside the epilogue
    kernel, which speaks only the flat wire formats: a per-leaf
    ``down_compressor`` cannot slot in there, and skipping it would book
    compressed down-bits for a dense broadcast."""
    if m.carry and m.engine is not None and (
            m.down_compressor is not None and m.down_engine is None):
        raise ValueError(
            "carry=True with a flat engine needs a down_engine for the "
            "compressed downlink (make_downlink(engine, ...)); a per-leaf "
            "down_compressor only fits the tree paths")


def _check_config(m) -> None:
    _check_downlink_config(m)
    _check_robust_config(m)


# ---------------------------------------------------------------------------
# Robust aggregation and fault injection
# ---------------------------------------------------------------------------


def _robust(aggregator) -> bool:
    """True when a ServerAggregator with a rule other than the mean is set."""
    return aggregator is not None and aggregator.robust


def _check_robust_config(m) -> None:
    """Refuse what has no defined meaning: a robust rule on a partition
    compressor (PermK gives each coordinate to one worker) or with client
    weights (the rules select and trim, they do not weight); ``drop``
    without the carry table (the server has no row to substitute) or under
    a robust rule (the zero-row substitution is exact only for the mean)."""
    agg = m.aggregator
    if _robust(agg):
        if isinstance(m.compressor, CorrelatedCompressor):
            raise ValueError(
                f"robust rule {agg.rule!r} is undefined on the correlated partition "
                f"compressor {m.compressor.name}: each coordinate reaches the server "
                "from exactly one worker")
        if m.engine is not None and m.engine.sampler == "permk":
            raise ValueError(f"robust rule {agg.rule!r} is undefined on the permk "
                             "engine wire: the workers partition the coordinates")
        if getattr(m, "weights", None) is not None:
            raise ValueError("client weights only make sense for mean aggregation; "
                             "robust rules select or trim rows instead of weighting them")
    flt = m.faults
    if flt is not None and flt.attack == "drop":
        if not m.carry:
            raise ValueError(
                "faults='drop' substitutes the server-side carry row h_i for the "
                f"missing upload: carry=True is required; construct "
                f"{type(m).__name__}(..., carry=True) or drop the FaultSpec")
        if _robust(agg):
            raise ValueError(
                "faults='drop' relies on mean aggregation: the zero-row carry "
                f"substitution is not defined under the {agg.rule!r} rule")


def _uplink_faults(faults, key, trees: PyTree, ids, n: int) -> PyTree:
    """Compressed-round payload faults: attacks rewrite their rows; dropped
    rows are zero (Δ̂_i = 0: the server's anchor h_i stands in)."""
    if faults is None:
        return trees
    if faults.attack == "drop":
        return fault_lib.zero_rows(trees, faults.byz_mask(ids, n))
    return fault_lib.inject(faults, key, trees, ids, n)


def _sync_faults(faults, key, trees: PyTree, ids, n: int) -> PyTree:
    """Sync-round payload faults: the attacks apply, ``drop`` does not (the
    sync round is the rendezvous every client attends)."""
    if faults is None:
        return trees
    return fault_lib.inject(faults, key, trees, ids, n)


def _uplink_bits_scale(faults, n: int) -> float:
    """The share of the fleet whose compressed upload arrived: (n − f)/n
    under ``drop``, else 1."""
    if faults is not None and faults.attack == "drop":
        return (n - faults.n_faulty(n)) / n
    return 1.0


def _counted_bits(uploaded: int, zeta: float, n: int) -> float:
    """uploaded·ζ/n as the reference books a round whose uploads it counted
    (PP-MARINA's drops, deadline rounds): in float32, the division by n
    compiled by XLA into a multiply by float32(1/n)."""
    f32 = np.float32
    return float(f32(f32(uploaded) * f32(zeta)) * f32(1.0 / n))


def _carry_refresh(h_old: PyTree, grads: PyTree, faults, c_k: bool, n: int,
                   ids=None) -> PyTree:
    """The next carry h: this round's gradients, except a dropped client's
    row on a compressed round, which keeps the anchor both sides last
    agreed on. ``ids`` are the client ids of the rows (default: the whole
    fleet, 0..n−1; a rank of the launch layer passes its own workers')."""
    if c_k or faults is None or faults.attack != "drop" or faults.n_faulty(n) == 0:
        return grads
    ids = list(range(n)) if ids is None else list(ids)
    keep_old = faults.byz_mask(ids, n)
    return tree_map(lambda ho, gn: torch.where(
        keep_old.to(gn.device).reshape((len(ids),) + (1,) * (gn.ndim - 1)),
        ho.to(gn.dtype), gn), h_old, grads)


def _metrics(m, like: PyTree, gnorm, c_k: bool, oracle: float,
             n: int) -> StepMetrics:
    d = tree_dim(like)
    bits_dense = wire.dense_f32_bits(d)
    bits = bits_dense
    if not c_k:
        bits = _round_bits(m.compressor, m.engine, like, n)
        up_scale = _uplink_bits_scale(m.faults, n)
        if up_scale != 1.0:
            # float32, as the reference books it
            bits = float(np.float32(bits) * np.float32(up_scale))
    down = bits_dense if c_k else _down_round_bits(m.down_compressor, m.down_engine,
                                                    like, d)
    return StepMetrics(grad_est_norm=gnorm, bits_per_worker=bits,
                       sync_round=int(c_k), oracle_calls=oracle, down_bits=down)


def _batch_rows(batches: PyTree) -> int:
    """Per-worker batch size: the second axis of the worker-stacked batch."""
    return tree_leaves(batches)[0].shape[1]


# ---------------------------------------------------------------------------
# MARINA — Algorithm 1
# ---------------------------------------------------------------------------


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
        _check_config(self)

    def init(self, params: PyTree, batches: PyTree) -> MarinaState:
        grads = _per_worker_grads(self.grad_fn, params, batches)
        g0 = tree_mean_axis0(grads)
        if not self.carry:
            return MarinaState(params=params, g=g0, step=0)
        return _lookahead_init(self, params, grads, g0)

    # -- seed-shaped rounds (two backprops on compressed rounds) ------------
    def _step_recompute(self, state: MarinaState, key, batches: PyTree):
        n = _num_workers(batches)
        k_bern, k_q = prng.split(key)
        c_k = bool(prng.bernoulli(k_bern, self.p))
        k_f = prng.fold_in(key, _FAULT_FOLD)
        ids = list(range(n))

        x_old = state.params
        x_new = tree_axpy(-self.gamma, state.g, x_old)  # Alg. 1 line 7
        if c_k:
            grads = _per_worker_grads(self.grad_fn, x_new, batches)
            grads = _sync_faults(self.faults, k_f, grads, ids, n)
            g_next = _sync_aggregate(self.engine, self.aggregator, grads)
        else:
            g_new = _per_worker_grads(self.grad_fn, x_new, batches)
            g_prev = _per_worker_grads(self.grad_fn, x_old, batches)
            diffs = tree_sub(g_new, g_prev)
            del g_new, g_prev
            diffs = _uplink_faults(self.faults, k_f, diffs, ids, n)
            delta = _compressed_delta(self.compressor, self.engine, k_q, diffs,
                                      state.params, n, self.aggregator)
            delta = _down_roundtrip(self.down_compressor, self.down_engine,
                                    prng.fold_in(key, _DOWN_FOLD), delta, state.params)
            g_next = tree_map(torch.add, state.g, delta)

        metrics = _metrics(self, state.params, tree_norm(g_next), c_k,
                           1.0 if c_k else 2.0, n)
        return MarinaState(params=x_new, g=g_next, step=state.step + 1), metrics

    # -- gradient-carry lookahead rounds (one backprop, fused epilogue) -----
    def _step_carry(self, state: MarinaState, key, batches: PyTree):
        n = _num_workers(batches)
        k_bern, k_q = prng.split(key)
        c_k = bool(prng.bernoulli(k_bern, self.p))

        # the one backprop of the round: state.params is already x^{k+1}
        grads = _per_worker_grads(self.grad_fn, state.params, batches)
        params, g = _carry_uplink(self, state, key, c_k, k_q, grads, n)
        # h keeps the honest gradients (a faulty client lies on the wire)
        new_state = MarinaState(params=params, g=g, step=state.step + 1,
                                h=_carry_refresh(state.h, grads, self.faults, c_k, n))
        return new_state, _metrics(self, state.params, tree_norm(g), c_k, 1.0, n)

    def step(self, state: MarinaState, key, batches: PyTree):
        if self.carry:
            return self._step_carry(state, key, batches)
        return self._step_recompute(state, key, batches)


# ---------------------------------------------------------------------------
# VR-MARINA — Algorithms 2 (finite-sum) and 3 (online)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VRMarina:
    """Algorithms 2/3. ``full_grad_fn`` is the oracle of sync rounds (∇f_i,
    or the b-batch gradient online); ``mb_grad_fn`` the b′-minibatch oracle
    of compressed rounds, evaluated at both points on the same minibatch.
    ``carry=True`` carries whatever local gradient the previous round
    evaluated (full on sync rounds, minibatch on compressed ones): one
    oracle sweep per round."""

    full_grad_fn: GradFn
    mb_grad_fn: GradFn
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
        _check_config(self)

    def init(self, params: PyTree, full_batches: PyTree) -> MarinaState:
        grads = _per_worker_grads(self.full_grad_fn, params, full_batches)
        g0 = tree_mean_axis0(grads)
        if not self.carry:
            return MarinaState(params=params, g=g0, step=0)
        return _lookahead_init(self, params, grads, g0)

    def _step_recompute(self, state, key, full_batches, mb_batches):
        n = _num_workers(full_batches)
        k_bern, k_q = prng.split(key)
        c_k = bool(prng.bernoulli(k_bern, self.p))

        k_f = prng.fold_in(key, _FAULT_FOLD)
        ids = list(range(n))

        x_old = state.params
        x_new = tree_axpy(-self.gamma, state.g, x_old)
        if c_k:
            grads = _per_worker_grads(self.full_grad_fn, x_new, full_batches)
            grads = _sync_faults(self.faults, k_f, grads, ids, n)
            g_next = _sync_aggregate(self.engine, self.aggregator, grads)
        else:
            # Alg. 2 line 8: the same minibatch at x^{k+1} and x^k
            g_new = _per_worker_grads(self.mb_grad_fn, x_new, mb_batches)
            g_prev = _per_worker_grads(self.mb_grad_fn, x_old, mb_batches)
            diffs = tree_sub(g_new, g_prev)
            del g_new, g_prev
            diffs = _uplink_faults(self.faults, k_f, diffs, ids, n)
            delta = _compressed_delta(self.compressor, self.engine, k_q, diffs,
                                      state.params, n, self.aggregator)
            delta = _down_roundtrip(self.down_compressor, self.down_engine,
                                    prng.fold_in(key, _DOWN_FOLD), delta, state.params)
            g_next = tree_map(torch.add, state.g, delta)

        oracle = (float(_batch_rows(full_batches)) if c_k
                  else 2.0 * _batch_rows(mb_batches))
        metrics = _metrics(self, state.params, tree_norm(g_next), c_k, oracle, n)
        return MarinaState(params=x_new, g=g_next, step=state.step + 1), metrics

    def _step_carry(self, state, key, full_batches, mb_batches):
        n = _num_workers(full_batches)
        k_bern, k_q = prng.split(key)
        c_k = bool(prng.bernoulli(k_bern, self.p))

        # the round's ONE oracle sweep, with the oracle of its round type
        if c_k:
            grads = _per_worker_grads(self.full_grad_fn, state.params, full_batches)
        else:
            grads = _per_worker_grads(self.mb_grad_fn, state.params, mb_batches)
        params, g = _carry_uplink(self, state, key, c_k, k_q, grads, n)
        oracle = (float(_batch_rows(full_batches)) if c_k
                  else 1.0 * _batch_rows(mb_batches))
        new_state = MarinaState(params=params, g=g, step=state.step + 1,
                                h=_carry_refresh(state.h, grads, self.faults, c_k, n))
        return new_state, _metrics(self, state.params, tree_norm(g), c_k, oracle, n)

    def step(self, state: MarinaState, key, full_batches: PyTree,
             mb_batches: PyTree):
        if self.carry:
            return self._step_carry(state, key, full_batches, mb_batches)
        return self._step_recompute(state, key, full_batches, mb_batches)


# ---------------------------------------------------------------------------
# PP-MARINA — Algorithm 4
# ---------------------------------------------------------------------------


def pp_sample_cohort(k_sel, n: int, r: int, replace: bool) -> list:
    """PP-MARINA's cohort I'_k (Alg. 4 line 5), drawn as the reference draws
    it: r i.i.d. uniform client ids (``replace=True``) or the first r of a
    permutation (r distinct ids)."""
    if replace:
        return prng.randint(k_sel, (r,), 0, n).tolist()
    return prng.permutation(k_sel, n)[:r].tolist()


def _weighted_mean_axis0(trees: PyTree, weights: "torch.Tensor | None") -> PyTree:
    """Σ_i w_i t_i over the leading client axis (the plain mean when w is
    None)."""
    if weights is None:
        return tree_mean_axis0(trees)
    return tree_map(
        lambda t: torch.tensordot(weights.to(t.device, t.dtype), t, dims=1), trees)


def _scale_rows(trees: PyTree, row_scale: torch.Tensor) -> PyTree:
    """Scale each leading-axis row of every leaf by ``row_scale`` (r,)."""
    return tree_map(
        lambda t: t * row_scale.to(t.device, t.dtype).reshape(
            (-1,) + (1,) * (t.ndim - 1)), trees)


def _take_rows(tree: PyTree, sel: list) -> PyTree:
    """Rows ``sel`` (repeats allowed) of every leaf's leading axis."""
    return tree_map(lambda t: t[torch.tensor(sel, device=t.device)], tree)


def _pp_carry_refresh(h_old: PyTree, sel: list, grads_sel: PyTree, faults,
                      n: int, positions=None, offset: int = 0) -> PyTree:
    """The server table with rows ``sel`` set to the cohort's gradients, in
    cohort order, one row after another (a repeated client writes the same
    values twice) — except a dropped client's row, which the server never
    received and keeps. A new table: the old one stays valid for a revert.
    ``grads_sel`` holds the gradients of cohort ``positions`` (default:
    all of them), in order, and ``h_old`` the table's rows from ``offset``
    on (a rank's rows of it); the drop mask reads the whole cohort."""
    dropped = [False] * len(sel)
    if faults is not None and faults.attack == "drop":
        dropped = faults.byz_mask(sel, n).tolist()
    positions = range(len(sel)) if positions is None else positions

    def refresh(ht, gt):
        out = ht.clone()
        for j, i in enumerate(positions):
            if not dropped[i]:
                out[sel[i] - offset].copy_(gt[j])
        return out

    return tree_map(refresh, h_old, grads_sel)


@dataclasses.dataclass
class PPMarina:
    """Algorithm 4 with the federated dials:

    * ``replace`` — the cohort I'_k is r i.i.d. uniform clients (the analysed
      variant) or, with ``replace=False``, r distinct clients; both keep the
      1/r server scaling.
    * ``weights`` — client weights w_i (raw counts are normalised to Σw = 1
      at construction): sync rounds average with w, compressed rounds
      pre-scale the sampled differences by n·w_i.
    * ``carry`` — the server-side carry table: h_i = the gradient of the last
      round client i took part in (all rows on sync rounds, the sampled rows
      on compressed ones); one backprop per sampled client, lookahead state.

    The ledger books the fleet totals (n·32d on sync rounds, r·ζ_Q on
    compressed rounds, ``wire.pp_*``) divided by n."""

    grad_fn: GradFn
    compressor: Compressor
    gamma: float
    p: float
    r: int
    engine: Optional[FlatEngine] = None
    down_compressor: Any = None
    down_engine: Any = None
    replace: bool = True
    weights: Any = None
    carry: bool = False
    aggregator: Any = None
    faults: Any = None

    def __post_init__(self):
        _check_config(self)
        if self.weights is not None:
            w = torch.as_tensor(self.weights, dtype=torch.float32)
            self.weights = w / torch.sum(w)

    def _cohort(self, k_sel, n: int) -> list:
        return pp_sample_cohort(k_sel, n, self.r, self.replace)

    def _scaled_diffs(self, diffs: PyTree, sel: list, n: int) -> PyTree:
        """Pre-compression scaling n·w_i that keeps the 1/r cohort mean
        unbiased for the weighted mean (none with uniform weights)."""
        if self.weights is None:
            return diffs
        return _scale_rows(diffs, n * self.weights[torch.tensor(sel)])

    def init(self, params: PyTree, batches: PyTree) -> MarinaState:
        grads = _per_worker_grads(self.grad_fn, params, batches)
        g0 = _weighted_mean_axis0(grads, self.weights)
        if not self.carry:
            return MarinaState(params=params, g=g0, step=0)
        # the server seeds the full carry table with every client's ∇f_i(x^0)
        return _lookahead_init(self, params, grads, g0)

    # -- seed-shaped rounds (two backprops per sampled client) --------------
    def _step_recompute(self, state: MarinaState, key, batches: PyTree):
        n = _num_workers(batches)
        k_bern, k_sel, k_q = prng.split(key, 3)
        c_k = bool(prng.bernoulli(k_bern, self.p))
        k_f = prng.fold_in(key, _FAULT_FOLD)

        x_old = state.params
        x_new = tree_axpy(-self.gamma, state.g, x_old)
        if c_k:
            grads = _per_worker_grads(self.grad_fn, x_new, batches)
            grads = _sync_faults(self.faults, k_f, grads, list(range(n)), n)
            g_next = _sync_aggregate(self.engine, self.aggregator, grads, self.weights)
        else:
            sel = self._cohort(k_sel, n)
            sel_batches = _take_rows(batches, sel)
            g_new = _per_worker_grads(self.grad_fn, x_new, sel_batches)
            g_prev = _per_worker_grads(self.grad_fn, x_old, sel_batches)
            diffs = self._scaled_diffs(tree_sub(g_new, g_prev), sel, n)
            del g_new, g_prev
            diffs = _uplink_faults(self.faults, k_f, diffs, sel, n)
            delta = _compressed_delta(self.compressor, self.engine, k_q, diffs,
                                      state.params, self.r, self.aggregator)
            delta = _down_roundtrip(self.down_compressor, self.down_engine,
                                    prng.fold_in(key, _DOWN_FOLD), delta, state.params)
            g_next = tree_map(torch.add, state.g, delta)

        new_state = MarinaState(params=x_new, g=g_next, step=state.step + 1)
        return new_state, self._metrics(c_k, tree_norm(g_next), state.params, n, 2.0)

    # -- carry rounds: ONE backprop per sampled client vs the server table --
    def _step_carry(self, state: MarinaState, key, batches: PyTree):
        n = _num_workers(batches)
        k_bern, k_sel, k_q = prng.split(key, 3)
        c_k = bool(prng.bernoulli(k_bern, self.p))
        k_f = prng.fold_in(key, _FAULT_FOLD)
        sel = self._cohort(k_sel, n)
        # the ledger books only the uploads that arrived
        uploaded = None
        if self.faults is not None and self.faults.attack == "drop":
            uploaded = self.r - int(self.faults.byz_mask(sel, n).sum())

        if c_k:
            grads = _per_worker_grads(self.grad_fn, state.params, batches)
            h_new = grads  # the table keeps the honest gradients
            g_up = _sync_faults(self.faults, k_f, grads, list(range(n)), n)
            if self.weights is None:
                params, g = _carry_finish(self, state, True, k_q, g_up, None, n,
                                          None)
            else:
                g = _weighted_mean_axis0(g_up, self.weights)
                if self.engine is not None:
                    lay = self.engine.layout
                    g = pack(lay, g)
                    params = unpack(lay, pack(lay, state.params) - self.gamma * g)
                else:
                    params = tree_axpy(-self.gamma, g, state.params)
        else:
            grads_sel = _per_worker_grads(self.grad_fn, state.params,
                                          _take_rows(batches, sel))
            # the table keeps the raw client gradients (weights apply at
            # aggregation), refreshed only for the sampled rows
            h_new = _pp_carry_refresh(state.h, sel, grads_sel, self.faults, n)
            params, g = _carry_finish(
                self, state, False, k_q, None,
                lambda: _uplink_faults(self.faults, k_f, self._scaled_diffs(
                    tree_sub(grads_sel, _take_rows(state.h, sel)), sel, n), sel, n),
                self.r, prng.fold_in(key, _DOWN_FOLD))

        new_state = MarinaState(params=params, g=g, step=state.step + 1, h=h_new)
        return new_state, self._metrics(c_k, tree_norm(g), state.params, n, 1.0,
                                        uploaded)

    def _metrics(self, c_k: bool, gnorm, like: PyTree, n: int,
                 oracle_factor: float, uploaded: "int | None" = None) -> StepMetrics:
        """Fleet-total uplink from the wire helpers, divided by n: r·ζ_Q on
        compressed rounds, or uploaded·ζ_Q when dropped cohort members never
        delivered theirs."""
        d = tree_dim(like)
        zeta = _round_bits(self.compressor, self.engine, like, self.r)
        if c_k:
            bits = wire.pp_sync_total_bits(n, d) / n
        elif uploaded is None:
            bits = wire.pp_uplink_total_bits(self.r, zeta) / n
        else:
            bits = _counted_bits(uploaded, zeta, n)
        return StepMetrics(
            grad_est_norm=gnorm, bits_per_worker=bits, sync_round=int(c_k),
            # the reference books r/n in float32 (``jnp.where`` under jit)
            oracle_calls=1.0 if c_k else float(np.float32(oracle_factor * self.r / n)),
            down_bits=(wire.dense_f32_bits(d) if c_k
                       else _down_round_bits(self.down_compressor, self.down_engine,
                                             like, d)))

    def step(self, state: MarinaState, key, batches: PyTree):
        if self.carry:
            return self._step_carry(state, key, batches)
        return self._step_recompute(state, key, batches)


def make_gd(grad_fn: GradFn, gamma: float) -> Marina:
    """GD = MARINA with identity quantization (paper §2)."""
    return Marina(grad_fn=grad_fn, compressor=Identity(), gamma=gamma, p=1.0)
