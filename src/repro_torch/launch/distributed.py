"""Round assembly: MARINA train rounds composed on the mesh (port of
``repro.launch.distributed``).

The mesh instantiation of ``core/marina.py``'s update equations over the
port's launch stack:

* **topology** (`launch/topology.py`) — the mesh, its process group, the
  workers each rank hosts, the link tiers, multi-process bring-up;
* **transport** (`launch/transport.py`) — the dense sync exchange, the
  compressed uplink (randk / shared-mask / permk / qsgd), the per-worker
  robust decode and the compressed downlink, each booking its bits into the
  bits-by-link-tier ledger;
* **round assembly** (this file) — composition only: the step bodies wire
  gradients, carries, cohorts and faults through the transport.

Steps built here: ``sync_step`` (the probability-p dense round),
``compressed_step`` (the probability-(1−p) round: gradient differences
through ``Transport.uplink_mean`` and ``Transport.downlink``) and
``train_step`` (c_k ~ Be(p) drawn on the host from the step key, as the
reference draws it, choosing one of the two).

GSPMD has no counterpart here; what it guarantees is kept. Each rank holds
the whole model and computes the gradients of the workers it hosts
(:meth:`Mesh.workers`); the step functions take the global (n,
per_worker, S) batch on every rank, and ``h`` (with ``grad_carry``) as this
rank's rows of the worker-stacked carry. A model axis wider than 1 without
``replicate_params`` would shard the parameters (tensor and expert
parallelism): that is ROADMAP A3b, and it raises ``NotImplementedError``.
With ``replicate_params`` the model axis is within-worker data parallelism
and the arithmetic is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import prng
from repro_torch.core import flat as flat_engine
from repro_torch.core.marina import _FAULT_FOLD, _carry_refresh, _sync_faults, _uplink_faults
from repro_torch.core.tree_util import tree_flatten, tree_map, tree_sub, tree_unflatten
from repro_torch.launch.participation import (  # noqa: F401
    FLEET_ATTACKS,
    build_pp_steps,
    pp_cohort_schedule,
)
from repro_torch.launch.topology import Mesh, detect_topology, num_workers, worker_axis_names
from repro_torch.launch.transport import make_transport
from repro_torch.models import init_params, lm_loss

PyTree = Any

BLOCK = 1024   # compression block width of the flat-PP engine and the sync buffer
KB = 8         # retained coordinates a block → ζ/d = 1/128, ω = 127


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A bundle of mesh steps for one (arch × mesh) combination.
    ``fns[name]`` is a plain callable with the reference's signature
    (``h`` with ``grad_carry``, a trailing ``sel`` under participation);
    ``param_shapes`` are meta tensors (every rank holds the whole model, so
    the reference's ``param_shardings`` have no counterpart)."""

    mesh: Any
    n_workers: int
    param_shapes: PyTree
    fns: dict
    meta: dict = dataclasses.field(default_factory=dict)
    transport: Any = None


def _grad_one(cfg):
    """∇ of the LM loss of one worker's batch, by autograd."""
    def grad_one(params, one_batch):
        leaves, treedef = tree_flatten(params)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        loss = lm_loss(tree_unflatten(treedef, leaves), cfg, one_batch["tokens"],
                       one_batch.get("prefix"))
        return tree_unflatten(treedef, torch.autograd.grad(loss, leaves))
    return grad_one


def build_train_steps(
    arch,
    mesh: Mesh,
    multi_pod: bool,
    *,
    global_batch: int,
    seq_len: int,
    gamma: float = 1e-3,
    p: float = KB / BLOCK,
    dtype=torch.bfloat16,
    shared_mask: bool = False,
    remat: bool = True,
    packed_payload: bool = False,
    replicate_params: bool = False,
    compression_backend: str = "auto",
    compression: str = "randk",
    qsgd_s: int = 15,
    grad_carry: bool = False,
    flat_sync: "bool | None" = None,
    downlink: str = "none",
    downlink_s: int = 7,
    participation: "tuple[int, str] | None" = None,
    aggregator: "Any | None" = None,
    faults: "Any | None" = None,
    topology: "Any | None" = None,
) -> StepBundle:
    """The mesh steps ``sync_step`` / ``compressed_step`` / ``train_step``.

    Dials (the wire policy freezes into the transport):

    * shared_mask      — SharedRandK: a K-value all-reduce instead of the
      n·K all-gather
    * packed_payload   — bf16 values + int16 offsets on the wire; with
      compression="qsgd" and s ≤ 7, 4-bit nibbles
    * compression      — "randk" | "permk" | "qsgd"
    * qsgd_s           — quantization levels for compression="qsgd"
    * topology         — the fabric the ledger tiers by (default: the
      runtime fabric, ``detect_topology``)
    * replicate_params — small-model mode: the model axis becomes
      within-worker data parallelism (required for a model axis > 1:
      sharded parameters are ROADMAP A3b)
    * grad_carry       — single-backprop compressed rounds: the carry holds
      per-worker h_i^k = ∇f_i(x^k); signatures become (params, g, h,
      batch[, key]) → (params, g, h)
    * flat_sync        — sync rounds exchange ONE packed (n, nblk, B) buffer
      instead of one collective a leaf; None enables it where packing
      cannot force a reshard (replicated params, or no model axis > 1)
    * downlink         — "none" (dense estimator broadcast) or
      "qsgd" / "randk": broadcast Q_down(g^{k+1} − g^k), downlink_s levels
    * participation    — (r, "with" | "without"): PP-MARINA on the mesh.
      Compressed rounds take a cohort of r clients (``pp_cohort_schedule``;
      the steps gain a trailing (r,) ``sel``), respread its batch rows over
      all n shards (masked dense compute where r does not split
      n·per_worker evenly; ``bundle.meta``) and put r payload rows on the
      wire. With ``grad_carry`` h is the server-side carry table: only the
      sampled rows refresh
    * aggregator       — a ``repro_torch.core.ServerAggregator``: a robust
      rule on decoded per-worker rows; refused with permk and shared_mask
    * faults           — a ``repro_torch.core.FaultSpec``: client faults on
      the uplinked payloads; ``drop`` requires ``grad_carry``
    """
    cfg = dataclasses.replace(arch.model, remat=remat)
    robust = aggregator is not None and aggregator.robust
    if robust:
        if compression == "permk":
            raise ValueError(
                f"robust rule {aggregator.rule!r} is undefined on the permk "
                "wire: workers partition the coordinates (DESIGN.md §4.9)")
        if shared_mask:
            raise ValueError(
                f"robust rule {aggregator.rule!r} is undefined with "
                "shared_mask: one correlated mask spans the whole fleet "
                "(DESIGN.md §4.9)")
    if faults is not None and faults.attack == "drop" and not grad_carry:
        raise ValueError(
            "faults='drop' substitutes the carried h row for the missing "
            "upload — grad_carry=True is required (DESIGN.md §4.9)")
    waxes = worker_axis_names(multi_pod, arch.worker_axes)
    sharded = [a for a in mesh.axis_names if a not in waxes and mesh.shape[a] > 1]
    if sharded and not replicate_params:
        raise NotImplementedError(
            f"mesh axes {sharded} would shard the parameters (tensor / expert "
            "parallelism): ROADMAP A3b. Pass replicate_params=True to run them "
            "as within-worker data parallelism")
    n = num_workers(mesh, multi_pod, arch.worker_axes)
    per_worker = global_batch // n
    rows = mesh.workers(n)

    param_shapes = init_params(0, cfg, dtype, device="meta")

    # size-1 axes shard nothing, so they neither disqualify the packed
    # exchange nor the flat-PP pipeline
    inner = tuple(a for a in mesh.axis_names if a not in set(waxes) and mesh.shape[a] > 1)
    if flat_sync is None:
        flat_sync = replicate_params or not inner
    lay = flat_engine.make_layout(param_shapes, block=BLOCK)

    topo = topology if topology is not None else detect_topology(mesh)
    transport = make_transport(
        mesh, topo, waxes, n, backend=compression_backend, compression=compression,
        qsgd_s=qsgd_s, packed_payload=packed_payload, shared_mask=shared_mask,
        downlink=downlink, downlink_s=downlink_s, flat_sync=flat_sync, sync_layout=lay)

    grad_one = _grad_one(cfg)

    def worker_grads(params, batch):
        """This rank's workers' gradients, stacked: (rows, *leaf) per leaf,
        from the global (n, per_worker, ...) batch."""
        out = None
        for i, w in enumerate(rows):
            g = grad_one(params, tree_map(lambda t: t[w], batch))
            if out is None:
                out = tree_map(lambda t: t.new_empty((len(rows), *t.shape)), g)
            tree_map(lambda o, t: o[i].copy_(t), out, g)
            del g
        return out

    def fleet_faults(fn, key, trees):
        """``fn`` (``_sync_faults`` / ``_uplink_faults``) on this rank's rows,
        as on the whole fleet's: attacks that read other rows or the
        stack's shape see all n rows where the workers span ranks."""
        if faults is None:
            return trees
        if mesh.world == 1 or faults.attack not in FLEET_ATTACKS:
            return fn(faults, key, trees, list(rows), n)
        full = tree_map(lambda t: mesh.assemble_rows(t, n), trees)
        out = fn(faults, key, full, list(range(n)), n)
        return tree_map(lambda t: t[rows.start:rows.stop], out)

    # mesh sync steps are keyless, so the sync-round garbage noise draws from
    # a fixed key — every other attack is deterministic
    sync_fault_key = prng.PRNGKey(_FAULT_FOLD)

    def sync_uplink(grads):
        return fleet_faults(_sync_faults, sync_fault_key, grads)

    def descend(params, g):
        return tree_map(lambda w, gg: w - gamma * gg.to(w.dtype), params, g)

    def robust_delta(key, diffs, rows_n, rows_sharded=True):
        """Robust compressed-round delta: per-worker dense payload rows →
        the rule (replaces the fused mean)."""
        return aggregator.combine_stacked(
            transport.worker_rows(key, diffs, rows_n, rows_sharded=rows_sharded))

    # dropped clients ride the collective as zero rows, but only the
    # surviving uploads bill: booked uplink == (n − f)·ζ_Q
    drop_uploaded = (n - faults.n_faulty(n)
                     if faults is not None and faults.attack == "drop" else None)

    def compressed_delta(key, diffs):
        k_up, k_down = prng.split(key)
        k_up = k_up if downlink != "none" else key
        if robust:
            delta = robust_delta(k_up, diffs, n)
        else:
            delta = transport.uplink_mean(k_up, diffs, uploaded_rows=drop_uploaded)
        return transport.downlink(k_down, delta)

    def book_sync():
        transport.book_sync(param_shapes)

    def book_compressed():
        if robust:
            transport.book_worker_rows(param_shapes, n)
        else:
            transport.book_uplink(param_shapes, uploaded_rows=drop_uploaded)
        transport.book_downlink(param_shapes)

    def uplink_faults(key, diffs):
        return fleet_faults(_uplink_faults, prng.fold_in(key, _FAULT_FOLD), diffs)

    if grad_carry:
        # single-backprop rounds: the carry holds h_i^k = ∇f_i(x^k), so the
        # compressed round differences against it
        def sync_step(params, g, h, batch):
            x_new = descend(params, g)
            grads = worker_grads(x_new, batch)
            # h keeps the HONEST gradients: liars lie on the wire only
            return x_new, transport.sync_aggregate(sync_uplink(grads), aggregator), grads

        def compressed_step(params, g, h, batch, key):
            x_new = descend(params, g)
            g_plus = worker_grads(x_new, batch)
            diffs = uplink_faults(key, tree_sub(g_plus, h))
            g_new = tree_map(torch.add, g, compressed_delta(key, diffs))
            del diffs
            # dropped rows keep their old h (the server never heard from them)
            h_new = _carry_refresh(h, g_plus, faults, False, n, ids=list(rows))
            return x_new, g_new, h_new

        def train_step(params, g, h, batch, key):
            k_b, k_q = prng.split(key)
            if bool(prng.bernoulli(k_b, p)):
                return sync_step(params, g, h, batch)
            return compressed_step(params, g, h, batch, k_q)
    else:
        def sync_step(params, g, batch):
            x_new = descend(params, g)
            grads = worker_grads(x_new, batch)
            return x_new, transport.sync_aggregate(sync_uplink(grads), aggregator)

        def compressed_step(params, g, batch, key):
            x_new = descend(params, g)
            g_plus = worker_grads(x_new, batch)
            g_minus = worker_grads(params, batch)
            diffs = uplink_faults(key, tree_sub(g_plus, g_minus))
            del g_plus, g_minus
            return x_new, tree_map(torch.add, g, compressed_delta(key, diffs))

        def train_step(params, g, batch, key):
            k_b, k_q = prng.split(key)
            if bool(prng.bernoulli(k_b, p)):
                return sync_step(params, g, batch)
            return compressed_step(params, g, batch, k_q)

    pp_meta = {}
    if participation is not None:
        # federated PP-MARINA cohort rounds override compressed / train
        # (launch/participation.py — sync rounds stay as built above)
        compressed_step, train_step, pp_meta, book_compressed = build_pp_steps(
            participation, n=n, per_worker=per_worker, p=p, block=BLOCK, kb=KB,
            shared_mask=shared_mask, compression=compression,
            compression_backend=compression_backend, qsgd_s=qsgd_s,
            replicate_params=replicate_params, inner=inner, param_shapes=param_shapes,
            mesh=mesh, transport=transport, downlink=downlink, robust=robust,
            aggregator=aggregator, faults=faults, grad_carry=grad_carry,
            sync_step=sync_step, worker_grads=worker_grads, descend=descend,
            robust_delta=robust_delta)

    def entry(name, fn, bookings):
        """The step as a plain callable. The first call books ``bookings``
        under the entry's scope (the reference books once per trace, and
        ``train_step`` traces both round types); every call runs its
        exchanges unbooked."""
        traced = []

        def step(*args):
            with transport.quiet():
                out = fn(*args)
            if not traced:
                traced.append(True)
                with transport.scope(name):
                    for book in bookings:
                        book()
            return out

        step.__name__ = name
        step.__doc__ = fn.__doc__
        return step

    fns = {
        "sync_step": entry("sync_step", sync_step, (book_sync,)),
        "compressed_step": entry("compressed_step", compressed_step, (book_compressed,)),
        "train_step": entry("train_step", train_step, (book_sync, book_compressed)),
    }
    return StepBundle(
        mesh=mesh,
        n_workers=n,
        param_shapes=param_shapes,
        fns=fns,
        meta={
            **pp_meta,
            **({"aggregator": aggregator.rule} if robust else {}),
            **({"faults": faults.attack} if faults is not None else {}),
        },
        transport=transport,
    )


# the serving assembly lives in launch/serve_steps.py; re-exported here, as
# the reference does, so the launch layer has one import site
from repro_torch.launch.serve_steps import build_serve_steps  # noqa: E402,F401
