"""Federated round assembly: PP-MARINA cohort rounds on the mesh (port of
``repro.launch.participation``).

``build_train_steps`` calls :func:`build_pp_steps` to override its
compressed and train steps when ``participation=(r, scheme)`` is set. Sync
rounds are untouched (all n clients ship dense gradients); compressed
rounds take the cohort row ``sel`` from :func:`pp_cohort_schedule`, respread
the r sampled clients' batch rows over all n worker shards, and put exactly
r payload rows on the wire.

Where the rows form. Group g of grp = n/r consecutive shards computes one
cohort client; with the contiguous split of the workers over the ranks a
group lies on one rank when grp divides the per-rank worker count, and its
group mean forms there. A group that spans ranks passes its running f32 sum
from rank to rank (the mean's own order, so no bit changes). With the
server's carry table (``grad_carry``) each sampled client goes to a group on
the rank that owns its h row wherever the cohort allows (which shards
compute a client changes no bit: a shard's gradient depends only on its
tokens); only a client left over from a cohort spread unevenly over the
ranks has its dense gradient sent to its owner. Masked fallback (r does not
split the batch): every shard backprops its own batch and a client's row
forms on its own rank.

What crosses. Where packing cannot force a reshard (replicated parameters,
or no model axis wider than 1) the payload pipeline is the core flat engine
split at the wire (:meth:`FlatEngine.encode_rows` /
:meth:`FlatEngine.decode_mean`): each row is compressed where it forms,
with the core's per-row key and seed derivation; the payloads (and the
seeds the wire format carries) cross by all-gather, the RandK offsets are
regenerated from the seeds, and the mean runs in row order 0..r−1 on every
rank — so a compressed round carries exactly the r·ζ_Q the ledger books,
and trajectories stay bit-equal to the one-rank run and to core
``PPMarina``. Dense state crosses, under the mesh's ``gather_state`` kind,
only for a group's partial sum across ranks, a carry client's gradient on
its way to its owner, the diffs of a fleet-wide attack, and the per-leaf
wire of permk where r does not divide the block (all r rows gathered).
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
from repro_torch.core.tree_util import (
    mean_axis0,
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from repro_torch.launch.topology import cohort_group_size

#: attacks whose rewrite of a row depends on other rows or on the stack's
#: shape: applied to the whole fleet's rows where the workers span ranks
FLEET_ATTACKS = ("mean_shift", "garbage")


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


def cohort_plan(sel, *, n: int, r: int, world: int, cohort_compute: bool,
                carry: bool) -> tuple:
    """Where a cohort's rows live: ``(assign, form, home)``. ``assign[g]``
    is the cohort position group g computes (identity without
    ``cohort_compute``), ``form[i]`` the rank where position i's client
    gradient forms, ``home[i]`` the rank that encodes row i (the owner of
    the client's h row under ``carry``, else ``form[i]``). Under ``carry``
    a position takes a group homed on its owner's rank wherever one is
    free, in cohort order; the rest take the leftover groups in order."""
    per = n // world
    sel = [int(c) for c in sel]
    owner = [c // per for c in sel]
    if not cohort_compute:
        return list(range(r)), owner, owner
    grp = n // r
    group_home = [((g + 1) * grp - 1) // per for g in range(r)]
    assign = [None] * r
    if carry:
        free = {}
        for g in range(r):
            free.setdefault(group_home[g], []).append(g)
        left = []
        for i in range(r):
            if free.get(owner[i]):
                assign[free[owner[i]].pop(0)] = i
            else:
                left.append(i)
        for g in range(r):
            if assign[g] is None:
                assign[g] = left.pop(0)
    else:
        assign = list(range(r))
    form = [None] * r
    for g, i in enumerate(assign):
        form[i] = group_home[g]
    return assign, form, (owner if carry else form)


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
    per = len(lo_hi)
    leaf_shapes, treedef = tree_flatten(param_shapes)

    def stack(rows: list) -> list:
        """Per leaf, the rows' leaves stacked (0 rows: empty stacks)."""
        if not rows:
            return [torch.empty((0, *s.shape), dtype=s.dtype, device=mesh.device)
                    for s in leaf_shapes]
        return [torch.stack(ls) for ls in zip(*rows)]

    def group_mean(leaf: torch.Tensor, g: int):
        """Group g's mean of one leaf of this rank's shard gradients (None
        off the group's home rank). Across ranks the running f32 sum moves
        on from rank to rank, as :func:`mean_axis0` adds the rows."""
        lo, hi = g * grp, (g + 1) * grp
        ranks = sorted({w // per for w in range(lo, hi)})
        mine = range(max(lo, lo_hi.start), min(hi, lo_hi.stop))
        if len(ranks) == 1:
            if mesh.rank != ranks[0]:
                return None
            return mean_axis0(leaf[mine.start - lo_hi.start:mine.stop - lo_hi.start])
        acc = None
        for j, rank in enumerate(ranks):
            if mesh.rank == rank:
                if acc is None:
                    acc = torch.zeros(leaf.shape[1:], dtype=torch.float32, device=leaf.device)
                for w in mine:
                    acc += leaf[w - lo_hi.start].float()
            if j + 1 < len(ranks):
                moved = mesh.send_row(acc if mesh.rank == rank else None, rank, ranks[j + 1],
                                      leaf.shape[1:], torch.float32)
                acc = moved if mesh.rank == ranks[j + 1] else None
        if mesh.rank != ranks[-1]:
            return None
        return (acc / torch.tensor(float(grp), device=acc.device)).to(leaf.dtype)

    def client_rows(x, batch, sel, plan) -> dict:
        """Cohort position → its client's gradient leaves, for the positions
        whose row forms on this rank (``plan``'s ``form``).

        Cohort-mapped: the r clients' batch rows respread over all n shards
        (each backprops per_worker·r/n tokens: r/n of a full round's
        compute), group g's shards take position ``assign[g]``'s client,
        and each group's shard gradients average on its home rank. Masked
        fallback: every shard backprops its own full batch and a client's
        row is its own worker's gradient."""
        assign, form, _ = plan
        if cohort_compute:
            sub = (per_worker * r_part) // n
            order = torch.as_tensor([int(sel[i]) for i in assign], dtype=torch.int64)
            sel_b = tree_map(lambda t: t[order.to(t.device)].reshape(n, sub, *t.shape[2:]),
                             batch)
            wg, _ = tree_flatten(worker_grads(x, sel_b))
            out = {}
            for g, i in enumerate(assign):
                leaves = [group_mean(t, g) for t in wg]
                if form[i] == mesh.rank:
                    out[i] = leaves
            return out
        wg, _ = tree_flatten(worker_grads(x, batch))
        return {i: [t[int(sel[i]) - lo_hi.start] for t in wg]
                for i in range(r_part) if form[i] == mesh.rank}

    def to_home(rows: dict, plan) -> dict:
        """Send each row that formed off its home rank to its home (dense,
        ``gather_state``); positions in order, leaves in order."""
        _, form, home = plan
        out = {i: v for i, v in rows.items() if form[i] == home[i]}
        for i in range(r_part):
            if form[i] == home[i]:
                continue
            moved = [mesh.send_row(rows[i][j] if i in rows else None, form[i], home[i],
                                   s.shape, s.dtype) for j, s in enumerate(leaf_shapes)]
            if mesh.rank == home[i]:
                out[i] = moved
        return out

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

    def cohort_faults(key, diffs: list, sel, home, mine: list) -> list:
        """The uplink faults on this rank's diff rows (leaves of stacks); a
        fleet-wide attack reads the whole cohort's rows where they span
        ranks."""
        if faults is None:
            return diffs
        fkey = prng.fold_in(key, _FAULT_FOLD)
        if mesh.world == 1 or faults.attack not in FLEET_ATTACKS:
            out = _uplink_faults(faults, fkey, tree_unflatten(treedef, diffs),
                                 [int(sel[i]) for i in mine], n)
            return tree_flatten(out)[0]
        full = [mesh.share_rows(t, home, kind="gather_state") for t in diffs]
        out, _ = tree_flatten(_uplink_faults(faults, fkey, tree_unflatten(treedef, full),
                                             [int(c) for c in sel], n))
        idx = torch.as_tensor(mine, dtype=torch.int64)
        return [t[idx.to(t.device)] for t in out]

    def flat_wire_delta(k_up, bufs: torch.Tensor, home, mine: list) -> torch.Tensor:
        """The split flat engine: encode this rank's rows, all-gather the
        payloads, decode in row order (this rank's RandK offsets as the
        kernel drew them, the other ranks' regenerated from their seeds)."""
        payload = pp_eng.encode_rows(k_up, bufs, mine, r_part)
        offs = payload.pop("offsets", None)
        wire = {name: mesh.share_rows(t, home) for name, t in payload.items()}
        if offs is not None:
            wire["offsets"] = offs
        return pp_eng.decode_mean(wire, r_part, aggregator, rows=mine)

    def pp_delta(key, rows: dict, sel, home) -> dict:
        """(1/r)·Σ Q(Δ_i) over the r cohort rows (the rule over the cohort's
        decoded rows when robust), then the downlink; ``rows`` maps this
        rank's positions to their diff leaves."""
        k_up, k_down = prng.split(key)
        k_up = k_up if downlink != "none" else key
        mine = sorted(rows)
        diffs = cohort_faults(key, stack([rows[i] for i in mine]), sel, home, mine)
        if flat_pp:
            bufs = flat_engine.pack_stacked(pp_eng.layout, tree_unflatten(treedef, diffs))
            del diffs
            delta = flat_engine.unpack(pp_eng.layout,
                                       flat_wire_delta(k_up, bufs, home, mine))
        else:
            # the per-leaf wire on the r-row payload stack: the cohort's dense
            # rows gathered on every rank first
            full = tree_unflatten(treedef, [mesh.share_rows(t, home, kind="gather_state")
                                            for t in diffs])
            if robust:
                delta = robust_delta(k_up, full, r_part, rows_sharded=False)
            else:
                delta = transport.uplink_mean(k_up, full, rows_n=r_part, rows_sharded=False)
        return transport.downlink(k_down, delta)

    def plan_of(sel):
        return cohort_plan(sel, n=n, r=r_part, world=mesh.world,
                           cohort_compute=cohort_compute, carry=grad_carry)

    if grad_carry:
        # h is the server-side carry table: this rank's rows of it; the
        # sampled rows refresh on their owners
        def compressed_step(params, g, h, batch, key, sel):
            x_new = descend(params, g)
            plan = plan_of(sel)
            cg = to_home(client_rows(x_new, batch, sel, plan), plan)
            h_leaves, _ = tree_flatten(h)
            diffs = {i: [a - b[int(sel[i]) - lo_hi.start] for a, b in zip(cg[i], h_leaves)]
                     for i in cg}
            g_new = tree_map(torch.add, g, pp_delta(key, diffs, sel, plan[2]))
            del diffs
            mine = sorted(cg)  # the positions whose client's h row is here
            h_new = _pp_carry_refresh(h, [int(c) for c in sel],
                                      tree_unflatten(treedef, stack([cg[i] for i in mine])),
                                      faults, n, positions=mine, offset=lo_hi.start)
            return x_new, g_new, h_new

        def train_step(params, g, h, batch, key, sel):
            k_b, _, k_q = prng.split(key, 3)
            if bool(prng.bernoulli(k_b, p)):
                return sync_step(params, g, h, batch)
            return compressed_step(params, g, h, batch, k_q, sel)
    else:
        def compressed_step(params, g, batch, key, sel):
            x_new = descend(params, g)
            plan = plan_of(sel)
            g_plus = client_rows(x_new, batch, sel, plan)
            g_minus = client_rows(params, batch, sel, plan)
            diffs = {i: [a - b for a, b in zip(g_plus[i], g_minus[i])] for i in g_plus}
            del g_plus, g_minus
            return x_new, tree_map(torch.add, g, pp_delta(key, diffs, sel, plan[2]))

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
