"""Federated round assembly: PP-MARINA cohort rounds on the mesh (port of
``repro.launch.participation``).

``build_train_steps`` calls :func:`build_pp_steps` to override its
compressed and train steps when ``participation=(r, scheme)`` is set. Sync
rounds are untouched (all n clients ship dense gradients); compressed
rounds take the cohort row ``sel`` from :func:`pp_cohort_schedule`, respread
the r sampled clients' batch rows over all n worker shards (each rank
computes its own shards; the shard gradients are assembled where the
workers span ranks), and put exactly r payload rows on the wire. Where
packing cannot force a reshard (replicated parameters, or no model axis
wider than 1) the r-row payload pipeline is the core flat engine — pack →
sampler → aggregate with the core's key and seed derivation — which keeps
mesh rounds trajectory-equal to core ``PPMarina``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import flat as flat_engine
from repro_torch.core.marina import (
    _FAULT_FOLD,
    _pp_carry_refresh,
    _uplink_faults,
    pp_sample_cohort,
)
from repro_torch.core.tree_util import mean_axis0, tree_map, tree_sub
from repro_torch.launch.topology import cohort_group_size


def pp_cohort_schedule(base_key, n_steps: int, n: int, r: int,
                       scheme: str = "without") -> np.ndarray:
    """The (n_steps, r) int32 PP cohort table. Row k is exactly the cohort
    the core ``PPMarina`` step draws from the step key ``fold_in(base_key,
    k)`` (the same 3-way ``(bern, sel, q)`` split), so a precomputed schedule
    keeps mesh rounds trajectory-equal to the core."""
    assert scheme in ("with", "without"), scheme
    rows = []
    for step in range(n_steps):
        _, k_sel, _ = prng.split(prng.fold_in(base_key, step), 3)
        rows.append(pp_sample_cohort(k_sel, n, r, replace=(scheme == "with")))
    return np.asarray(rows, dtype=np.int32).reshape(n_steps, r)


def build_pp_steps(participation, *, n: int, per_worker: int, p: float, block: int, kb: int,
                   shared_mask: bool, compression: str, compression_backend: str, qsgd_s: int,
                   replicate_params: bool, inner: tuple, param_shapes, mesh, transport,
                   downlink: str, robust: bool, aggregator, faults, grad_carry: bool,
                   sync_step, worker_grads, descend, robust_delta):
    """Build the PP compressed and train steps over the shared round
    plumbing. ``sync_step`` / ``worker_grads`` / ``descend`` /
    ``robust_delta`` close over the model and transport of
    ``build_train_steps``; this function assembles the cohort compute and
    the r-row wire around them. Returns ``(compressed_step, train_step,
    meta, book_compressed)``: ``meta`` records the participation mode,
    cohort compute against the masked fallback, and the flat-PP decision;
    ``book_compressed()`` books what one compressed round crosses."""
    r_part, scheme = participation
    assert scheme in ("with", "without"), scheme
    assert 1 <= r_part <= n, f"cohort r={r_part} vs n={n} workers"
    assert not shared_mask, (
        "participation composes with randk/permk/qsgd, not shared_mask "
        "(a shared mask already correlates the whole fleet)")
    grp = cohort_group_size(n, r_part)
    cohort_compute = grp is not None and (per_worker * r_part) % n == 0
    flat_pp = replicate_params or not inner
    pp_eng = None
    if flat_pp and compression in ("randk", "permk", "qsgd"):
        if compression == "permk" and block % r_part != 0:
            flat_pp = False
        else:
            pp_eng = flat_engine.make_engine(param_shapes, kb=kb, block=block,
                                             backend=compression_backend,
                                             sampler=compression, s=qsgd_s,
                                             device=mesh.device)
    else:
        flat_pp = False
    lo_hi = mesh.workers(n)

    def cohort_grads(x, batch, sel):
        """Per-client gradients of the r sampled clients, on every rank.

        Cohort-mapped: the r clients' batch rows respread over all n shards
        (each backprops per_worker·r/n tokens: r/n of a full round's
        compute), then the n shard gradients group-mean back to r client
        gradients. Masked fallback: every shard backprops its own full
        batch and only the r sampled rows are kept."""
        if cohort_compute:
            sub = (per_worker * r_part) // n
            sel_t = torch.as_tensor(sel, dtype=torch.int64)
            sel_b = tree_map(lambda t: t[sel_t.to(t.device)].reshape(n, sub, *t.shape[2:]),
                             batch)
            wg = worker_grads(x, sel_b)

            def group_mean(t):
                full = mesh.assemble_rows(t, n)
                return torch.stack([mean_axis0(full[i * grp:(i + 1) * grp])
                                    for i in range(r_part)])
            return tree_map(group_mean, wg)
        wg = worker_grads(x, batch)
        sel_t = torch.as_tensor(sel, dtype=torch.int64)
        return tree_map(lambda t: mesh.assemble_rows(t, n)[sel_t.to(t.device)], wg)

    def book_flat():
        # the flat engine stages this exchange itself: the r·ζ_Q uplink from
        # the engine's own wire accounting
        transport.book("up", "all-to-all" if compression == "permk" else "all-gather",
                       r_part * pp_eng.payload_bits(r_part) / n)

    def book_compressed():
        if flat_pp:
            book_flat()
        elif robust:
            transport.book_worker_rows(param_shapes, r_part)
        else:
            transport.book_uplink(param_shapes, rows_n=r_part)
        transport.book_downlink(param_shapes)

    def pp_delta(key, diffs):
        """(1/r)·Σ Q(Δ_i) over the r cohort payload rows (the rule over the
        cohort's decoded rows when robust), then the downlink."""
        k_up, k_down = prng.split(key)
        k_up = k_up if downlink != "none" else key
        if flat_pp:
            bufs = flat_engine.pack_stacked(pp_eng.layout, diffs)
            delta = flat_engine.unpack(pp_eng.layout,
                                       pp_eng.aggregate(k_up, bufs, r_part, aggregator))
        elif robust:
            delta = robust_delta(k_up, diffs, r_part, rows_sharded=False)
        else:
            # the per-leaf wire on the r-row payload stack (cohort rows are
            # on every rank: r·ζ, not n·ζ)
            delta = transport.uplink_mean(k_up, diffs, rows_n=r_part, rows_sharded=False)
        return transport.downlink(k_down, delta)

    def cohort_faults(key, diffs, sel):
        return _uplink_faults(faults, prng.fold_in(key, _FAULT_FOLD), diffs, list(sel), n)

    if grad_carry:
        # h is the server-side carry table: this rank's rows of it; the
        # sampled rows refresh
        def compressed_step(params, g, h, batch, key, sel):
            x_new = descend(params, g)
            cg = cohort_grads(x_new, batch, sel)
            sel_t = torch.as_tensor(sel, dtype=torch.int64)
            h_full = tree_map(lambda t: mesh.assemble_rows(t, n), h)
            h_sel = tree_map(lambda t: t[sel_t.to(t.device)], h_full)
            diffs = cohort_faults(key, tree_sub(cg, h_sel), sel)
            g_new = tree_map(torch.add, g, pp_delta(key, diffs))
            h_new = _pp_carry_refresh(h_full, [int(i) for i in sel], cg, faults, n)
            return x_new, g_new, tree_map(lambda t: t[lo_hi.start:lo_hi.stop], h_new)

        def train_step(params, g, h, batch, key, sel):
            k_b, _, k_q = prng.split(key, 3)
            if bool(prng.bernoulli(k_b, p)):
                return sync_step(params, g, h, batch)
            return compressed_step(params, g, h, batch, k_q, sel)
    else:
        def compressed_step(params, g, batch, key, sel):
            x_new = descend(params, g)
            g_plus = cohort_grads(x_new, batch, sel)
            g_minus = cohort_grads(params, batch, sel)
            diffs = cohort_faults(key, tree_sub(g_plus, g_minus), sel)
            del g_plus, g_minus
            return x_new, tree_map(torch.add, g, pp_delta(key, diffs))

        def train_step(params, g, batch, key, sel):
            # the core PPMarina key discipline: (bern, sel, q) 3-way split;
            # the sel slot is consumed by pp_cohort_schedule
            k_b, _, k_q = prng.split(key, 3)
            if bool(prng.bernoulli(k_b, p)):
                return sync_step(params, g, batch)
            return compressed_step(params, g, batch, k_q, sel)

    meta = {"participation": participation, "cohort_compute": cohort_compute,
            "flat_pp": flat_pp}
    return compressed_step, train_step, meta, book_compressed
