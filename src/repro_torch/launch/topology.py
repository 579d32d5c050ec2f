"""Topology layer of the launch stack on ``torch.distributed`` (port of
``repro.launch.topology``).

It answers the reference's three questions for a fleet of MARINA workers
hosted by one or more processes:

1. **What does the fabric look like?** :class:`Topology` (the reference's
   record, unchanged) names the link tier every mesh axis crosses —
   ``loopback`` (workers inside one process: the fleet simulated on one card
   or one CPU), ``ici`` (GPUs of one host joined by NVLink), ``dcn`` (the
   slow link a CPU cluster's process boundary stands for) — each with its
   α–β cost model (:class:`LinkSpec`, :data:`DEFAULT_LINKS`).

2. **How do I get a mesh on it?** GSPMD has no counterpart here, so a
   :class:`Mesh` is a plain record: ordered axis names and sizes (``.shape``
   and ``.axis_names`` as in JAX), the process groups, and the device. A
   rank is a (worker group, model index) pair: the workers of the worker
   axes are split into contiguous groups (:meth:`Mesh.workers`), and within
   a group the m model indices are m ranks, each holding one slice of every
   parameter the rule table shards (``launch/sharding.py``). The worker-axis
   collectives run among the ranks of one model index; the model-axis ones
   (``model_*``) among the m ranks of one worker group. One rank may host
   all n workers and the whole model (one process, one card).
   :func:`detect_topology` classifies the axes against that layout: an axis
   that spans processes is ``dcn`` under gloo and ``ici`` under nccl; an
   axis inside one process is ``loopback``, four workers on one card
   included.

3. **How do multiple processes come up?** :func:`initialize_multiprocess`
   is ``torch.distributed.init_process_group`` with a TCP rendezvous —
   ``nccl`` when the process runs on the card (the default), ``gloo`` when
   the caller asks for the CPU, or for gloo by name on the card (each
   collective's tensors then staged through host memory: the way two ranks
   share one card, which NCCL refuses); nothing falls back quietly.
   :func:`init_from_env` reads the reference's ``MARINA_MP_*`` contract and
   :func:`spawn_local_cluster` stands up an N-process local cluster in
   subprocesses, with the reference's crash and recovery helpers.

Demo (a 2-process gloo cluster on the CPU, one all-reduce and the topology
report per process):

    PYTHONPATH=src python -m repro_torch.launch.topology --processes 2
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import default_device

PROCESS_ENV = "MARINA_MP_PROCESS"       # "<process_id>/<num_processes>"
COORD_ENV = "MARINA_MP_COORDINATOR"     # "host:port"
#: workers each process of a local cluster hosts (the reference's fake
#: devices per process)
LOCAL_ENV = "MARINA_MP_LOCAL"

# crash / recovery contract (the reference's DESIGN.md §4.10): the resilient
# runner and the worker programs communicate through these —
CRASH_ENV = "MARINA_MP_CRASH"           # "<rank>@<round>": hard-exit there
DEAD_ENV = "MARINA_MP_DEAD"             # "2,3": client ids lost to a crash
RESUME_ENV = "MARINA_MP_RESUME"         # first round the dead set applies

#: per-round liveness marker worker programs print (every rank) after
#: completing each round; the resilient runner reads the streams back to
#: locate the last fleet-wide completed round after a crash
HEARTBEAT = "MARINA_HB"

#: link-tier names, fastest to slowest (``core.wire.LINK_TIERS``)
TIERS = ("loopback", "ici", "dcn")


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """α–β cost model of one link tier: a collective over the tier costs
    ``steps·alpha_s + wire_bytes/bw``."""

    alpha_s: float          # latency per collective step (seconds)
    bw: float               # bandwidth per device (bytes/s)


#: The reference's default α–β table: modeling constants (loopback ≈ one
#: memcpy inside a process, ici = TPU v5e ~50 GB/s a link with ~1 µs hop
#: latency, dcn = a 50 Gbit/s NIC with ~25 µs software latency), not
#: measurements of this port or of an H100 host.
DEFAULT_LINKS: dict = {
    "loopback": LinkSpec(alpha_s=5e-7, bw=100e9),
    "ici": LinkSpec(alpha_s=1e-6, bw=50e9),
    "dcn": LinkSpec(alpha_s=25e-6, bw=6.25e9),
}


@dataclasses.dataclass(frozen=True)
class Topology:
    """The fabric: process / pod extents plus a link tier per mesh axis.

    ``axis_tiers`` maps every mesh axis name to the SLOWEST link a
    collective over that axis crosses. ``devices_per_pod`` bounds the ici
    domain for group-size classification; ``devices_per_process`` bounds the
    loopback domain the same way."""

    axis_tiers: tuple            # ((axis, tier), ...) — frozen mapping
    n_devices: int
    n_processes: int = 1
    devices_per_pod: Optional[int] = None   # None: single-pod fabric
    links: tuple = tuple(sorted(DEFAULT_LINKS.items()))

    @property
    def devices_per_process(self) -> int:
        """Mesh slots per OS process (the loopback domain)."""
        return self.n_devices // max(1, self.n_processes)

    def tier_of_axis(self, axis: str) -> str:
        """Link tier of a collective over one mesh axis."""
        for a, t in self.axis_tiers:
            if a == axis:
                return t
        raise KeyError(f"axis {axis!r} not in topology {self.axis_tiers}")

    def tier_for_axes(self, axes) -> str:
        """Slowest tier among the given mesh axes; empty axes (an exchange
        inside one device) price as loopback."""
        if not axes:
            return "loopback"
        if isinstance(axes, str):
            axes = (axes,)
        return max((self.tier_of_axis(a) for a in axes), key=TIERS.index)

    def tier_for_group_size(self, g: int) -> str:
        """Classify a collective by its group extent: wider than one pod →
        dcn; wider than one process → ici; inside one process, loopback
        unless an axis of the fabric models real links (then ici)."""
        if self.devices_per_pod is not None and g > self.devices_per_pod:
            return "dcn"
        if g > self.devices_per_process:
            return "ici"
        if any(t != "loopback" for _a, t in self.axis_tiers):
            return "ici"
        return "loopback"

    def tier_for_ids(self, ids) -> str:
        """Classify a group by its member slot ids: one spanning pods, or
        (with several processes) spanning processes, crosses the dcn; else
        as :meth:`tier_for_group_size`."""
        ids = [int(i) for i in ids]
        if len(ids) <= 1:
            return "loopback"
        if self.devices_per_pod is not None and len(
                {i // self.devices_per_pod for i in ids}) > 1:
            return "dcn"
        if self.n_processes > 1 and len(
                {i // self.devices_per_process for i in ids}) > 1:
            return "dcn"
        return self.tier_for_group_size(len(ids))

    def link(self, tier: str) -> LinkSpec:
        """The α–β constants of one tier."""
        return dict(self.links)[tier]


# ---------------------------------------------------------------------------
# the mesh: axes, the process group, the workers this rank hosts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Mesh:
    """A named mesh over the process group. ``sizes`` follow
    ``axis_names``; ``group`` is the ``torch.distributed`` group (None: no
    process group, one process); ``rank`` / ``world`` locate this process
    in it; ``device`` is where this rank computes. ``collectives`` counts
    the collectives issued through the mesh, by kind, and ``payload_bytes``
    the bytes of this rank's rows that they carried: summed over the ranks,
    ×8 and ÷ n, a payload kind's bytes are the bits per worker the ledger
    books for it. The dense worker state a rank gathers whole
    (:meth:`assemble_rows`) counts under its own kind, ``gather_state``.
    ``op_counts`` / ``op_bytes`` count the same traffic by the collective
    that carried it (``all-gather``, ``all-reduce``, ``broadcast``,
    ``send``, ``all-to-all``), which is what
    ``roofline.collective_stats_from_mesh`` prices.

    ``rank`` / ``world`` are this rank's worker group and the number of
    worker groups, and ``group`` the worker-axis group of this rank's (data,
    model) index. ``model`` is the number of ranks along the model axis (1:
    the rank holds the whole model), ``model_rank`` this rank's model index
    and ``model_group`` the ranks of its worker group and data index.
    ``fsdp`` is the number of ranks along the data axis inside a worker (an
    fsdp mesh: the parameters split over "data" too; 1 otherwise),
    ``fsdp_rank`` this rank's data index and ``fsdp_group`` the ranks of
    its worker group and model index. The model- and data-axis collectives
    count under kinds of their own (``model/...``, ``fsdp/...``) and ops
    prefixed ``model/`` / ``fsdp/``: the ledger books no bits for a reshard
    inside a worker. ``staged``: a gloo group on the card, every
    collective's tensors copied through host memory.

    Every collective goes through six primitives (``_all_gather``,
    ``_broadcast``, ``_all_reduce``, ``_all_to_all``, ``_send``,
    ``_recv``), which a
    stand-in mesh with no process group overrides
    (``launch/dryrun.py``)."""

    axis_names: tuple
    sizes: tuple
    device: torch.device
    group: Any = None
    rank: int = 0
    world: int = 1
    model: int = 1
    model_rank: int = 0
    model_group: Any = None
    fsdp: int = 1
    fsdp_rank: int = 0
    fsdp_group: Any = None
    staged: bool = False
    collectives: dict = dataclasses.field(default_factory=dict)
    payload_bytes: dict = dataclasses.field(default_factory=dict)
    op_counts: dict = dataclasses.field(default_factory=dict)
    op_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def backend(self) -> Optional[str]:
        """The group's backend ("nccl" / "gloo"), None without a group."""
        if self.group is None:
            return None
        import torch.distributed as dist

        return dist.get_backend(self.group)

    def global_rank(self, group_rank: int, fsdp_rank: Optional[int] = None,
                    model_rank: Optional[int] = None) -> int:
        """The process-group rank of worker group ``group_rank`` at this
        rank's data and model index (or the ones given): g·(D·m) + j·m + i."""
        j = self.fsdp_rank if fsdp_rank is None else fsdp_rank
        i = self.model_rank if model_rank is None else model_rank
        return (group_rank * self.fsdp + j) * self.model + i

    # -- the primitives every collective goes through ------------------------

    def _all_gather(self, outs: list, raw: torch.Tensor, group) -> None:
        import torch.distributed as dist

        dist.all_gather(outs, raw, group=group)

    def _broadcast(self, raw: torch.Tensor, src: int, group) -> None:
        import torch.distributed as dist

        dist.broadcast(raw, src=src, group=group)

    def _all_reduce(self, raw: torch.Tensor, group) -> None:
        import torch.distributed as dist

        dist.all_reduce(raw, group=group)

    def _all_to_all(self, out: torch.Tensor, raw: torch.Tensor, group) -> None:
        import torch.distributed as dist

        dist.all_to_all_single(out, raw, group=group)

    def _send(self, raw: torch.Tensor, dst: int, group) -> None:
        import torch.distributed as dist

        dist.send(raw, dst, group=group)

    def _recv(self, raw: torch.Tensor, src: int, group) -> None:
        import torch.distributed as dist

        dist.recv(raw, src, group=group)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a collective takes it: on the host when staged."""
        return t.cpu() if self.staged else t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def workers(self, n: int) -> range:
        """The contiguous group of the n workers this rank hosts."""
        if n % self.world:
            raise ValueError(f"{n} workers do not split evenly over {self.world} ranks")
        per = n // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    def _count(self, kind: str, nbytes: int, op: str) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0) + 1
        self.payload_bytes[kind] = self.payload_bytes.get(kind, 0) + int(nbytes)
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        self.op_bytes[op] = self.op_bytes.get(op, 0) + int(nbytes)

    def reset_counts(self) -> None:
        """Zero the counts (by kind and by collective)."""
        for counts in (self.collectives, self.payload_bytes, self.op_counts, self.op_bytes):
            counts.clear()

    def gather_rows(self, local: torch.Tensor, n: int,
                    kind: str = "all_gather") -> torch.Tensor:
        """All n rows from each rank's :meth:`workers` rows: an all-gather
        across the group (as bytes, so any dtype crosses), rows in worker
        order, counted under ``kind``. Runs whenever the mesh has a group, a
        world of one rank included; without a group the local rows are all n
        rows."""
        if self.group is None:
            if local.shape[0] != n:
                raise ValueError(f"{local.shape[0]} local rows of {n} without a process group")
            return local
        src = local.contiguous()
        raw = self._out(src.view(torch.uint8))
        outs = [torch.empty_like(raw) for _ in range(self.world)]
        self._all_gather(outs, raw, self.group)
        self._count(kind, raw.numel(), "all-gather")
        full = self._back(outs[0] if self.world == 1 else torch.cat(outs))
        return full.view(src.dtype).reshape((n,) + tuple(local.shape[1:]))

    def sum_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """All n rows through an all-reduce (the psum kinds): each rank
        adds its own rows into zeros elsewhere, so the sum is exact and the
        rows come out in worker order. A world of one reduces in place. The
        bytes counted are this rank's rows, not the zeros."""
        if self.group is None:
            if local.shape[0] != n:
                raise ValueError(f"{local.shape[0]} local rows of {n} without a process group")
            return local
        if self.world == 1:
            full = local.contiguous()
        else:
            full = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype,
                               device=local.device)
            w = self.workers(n)
            full[w.start:w.stop] = local
        wire = self._out(full)
        self._all_reduce(wire, self.group)
        self._count("all_reduce", local.numel() * local.element_size(), "all-reduce")
        return self._back(wire) if self.staged else full

    def assemble_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """All n rows of dense worker state (per-worker gradients or decoded
        rows a rank needs whole): gathered only where the workers span
        ranks, the local rows themselves on a world of one."""
        if self.world == 1:
            return local
        return self.gather_rows(local, n, kind="gather_state")

    def share_rows(self, local: torch.Tensor, owners, kind: str = "all_gather") -> torch.Tensor:
        """All m rows of a stack whose row j lives on rank ``owners[j]``:
        ``local`` holds this rank's rows in row order. One all-gather when
        every rank holds as many rows, else one broadcast a row from its
        owner; rows come out in row order on every rank, counted under
        ``kind`` where they leave. Runs whenever the mesh has a group."""
        owners = [int(o) for o in owners]
        mine = [j for j, o in enumerate(owners) if o == self.rank]
        if local.shape[0] != len(mine):
            raise ValueError(f"{local.shape[0]} local rows for owners {owners}")
        if self.group is None:
            if len(mine) != len(owners):
                raise ValueError(f"rows of ranks {set(owners)} without a process group")
            return local

        shape, dtype = tuple(local.shape[1:]), local.dtype
        counts = [owners.count(r) for r in range(self.world)]
        if len(set(counts)) == 1:
            got = self.gather_rows(local, len(owners), kind=kind)
            order = [j for r in range(self.world) for j, o in enumerate(owners) if o == r]
            if order == sorted(order):
                return got
            out = torch.empty_like(got)
            out[torch.as_tensor(order, device=got.device)] = got
            return out
        out = torch.empty((len(owners),) + shape, dtype=dtype, device=local.device)
        if mine:
            out[torch.as_tensor(mine, device=out.device)] = local
        for j, o in enumerate(owners):
            raw = out[j:j + 1].view(torch.uint8)  # a view: receivers write in place
            wire = self._out(raw)
            self._broadcast(wire, self.global_rank(o), self.group)
            if self.staged:
                raw.copy_(wire)
            if o == self.rank:
                self._count(kind, raw.numel(), "broadcast")
        return out

    def send_row(self, t: "torch.Tensor | None", src: int, dst: int, shape, dtype,
                 kind: str = "gather_state") -> "torch.Tensor | None":
        """Move one tensor from rank ``src`` to rank ``dst`` (point to point,
        counted under ``kind`` at ``src``). Every rank calls it in the same
        order; ``dst`` gets the tensor, ``src`` keeps ``t``, the others get
        None. ``src == dst`` moves nothing."""
        if src == dst or self.rank not in (src, dst):
            return t if self.rank == src else None
        if self.rank == src:
            raw = self._out(t.contiguous().view(torch.uint8).reshape(-1))
            self._send(raw, self.global_rank(dst), self.group)
            self._count(kind, raw.numel(), "send")
            return t
        buf = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        raw = self._out(buf.view(torch.uint8).reshape(-1))
        self._recv(raw, self.global_rank(src), self.group)
        if self.staged:
            buf.view(torch.uint8).reshape(-1).copy_(raw)
        return buf

    def gather_ragged(self, local: torch.Tensor, sizes, kind: str = "all_gather") -> list:
        """Every worker group's 1-d ``local`` of ``sizes[g]`` elements (every
        rank knows the sizes): one broadcast a group from its rank, counted
        where it leaves, for payloads whose share differs from group to
        group (a column-sharded leaf's offsets). Runs whenever the mesh has
        a group; without one the local share is the only one."""
        sizes = [int(k) for k in sizes]
        if local.numel() != sizes[self.rank]:
            raise ValueError(f"{local.numel()} local elements, sizes {sizes}")
        if self.group is None:
            return [local]
        out = []
        for g, k in enumerate(sizes):
            if g == self.rank:
                buf = local.contiguous()
                self._count(kind, buf.numel() * buf.element_size(), "broadcast")
            else:
                buf = torch.empty((k,), dtype=local.dtype, device=self.device)
            if self.world > 1 and k:
                raw = buf.view(torch.uint8)
                wire = self._out(raw)
                self._broadcast(wire, self.global_rank(g), self.group)
                if self.staged and g != self.rank:
                    raw.copy_(wire)
            out.append(buf)
        return out

    # -- the model axis: the m ranks of one worker group and data index -----

    def _gather_parts(self, t: torch.Tensor, parts: int, group, kind: str,
                      op: str) -> torch.Tensor:
        """The ``parts`` ranks' ``t`` of one inner group, stacked on a new
        leading dimension in rank order (one all-gather as bytes, counted
        under ``kind`` and ``op``)."""
        src = t.contiguous()
        raw = self._out(src.view(torch.uint8).reshape(-1))
        outs = [torch.empty_like(raw) for _ in range(parts)]
        self._all_gather(outs, raw, group)
        self._count(kind, raw.numel(), op)
        return self._back(torch.cat(outs)).view(src.dtype).reshape((parts, *src.shape))

    def _model_count(self, kind: str, nbytes: int, op: str) -> None:
        self._count(kind, nbytes, "model/" + op)

    def model_gather(self, t: torch.Tensor, dim: int, kind: str = "model/gather") -> torch.Tensor:
        """The m slices of ``t`` along ``dim``, in model-rank order."""
        if self.model == 1:
            return t
        full = self._gather_parts(t, self.model, self.model_group, kind, "model/all-gather")
        return _concat_parts(full, dim)

    def model_sum(self, t: torch.Tensor, kind: str = "model/sum") -> torch.Tensor:
        """Σ over the model group of ``t``: the partials all-gathered and
        added in model-rank order, so every rank holds the same bits (a ring
        all-reduce promises no order)."""
        if self.model == 1:
            return t
        parts = self._gather_parts(t, self.model, self.model_group, kind, "model/all-gather")
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return acc

    def model_bcast(self, t: "torch.Tensor | None", shape, dtype,
                    kind: str = "model/broadcast") -> torch.Tensor:
        """Model rank 0's ``t`` on every rank of the model group (the others
        pass None and the shape and dtype)."""
        if self.model == 1:
            return t
        return self._inner_bcast(t, shape, dtype, kind, self.model_rank == 0,
                                 self.global_rank(self.rank, model_rank=0),
                                 self.model_group, "model/broadcast")

    def _inner_bcast(self, t, shape, dtype, kind: str, root: bool, src: int, group,
                     op: str) -> torch.Tensor:
        if root:
            buf = t.contiguous()
            self._count(kind, buf.numel() * buf.element_size(), op)
        else:
            buf = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        raw = buf.view(torch.uint8).reshape(-1)
        wire = self._out(raw)
        self._broadcast(wire, src, group)
        if self.staged and not root:
            raw.copy_(wire)
        return buf

    def model_slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim`` (no exchange)."""
        if self.model == 1:
            return t
        return t.chunk(self.model, dim=dim)[self.model_rank].contiguous()

    # -- the data axis inside a worker (fsdp): the D ranks of one worker
    # group and model index ----------------------------------------------

    def fsdp_gather(self, t: torch.Tensor, dim: int, kind: str = "fsdp/gather") -> torch.Tensor:
        """The D slices of ``t`` along ``dim``, in data-rank order."""
        if self.fsdp == 1:
            return t
        full = self._gather_parts(t, self.fsdp, self.fsdp_group, kind, "fsdp/all-gather")
        return _concat_parts(full, dim)

    def fsdp_sum(self, t: torch.Tensor, kind: str = "fsdp/sum") -> torch.Tensor:
        """Σ over the data group of ``t``, added in data-rank order (every
        rank the same bits)."""
        if self.fsdp == 1:
            return t
        parts = self._gather_parts(t, self.fsdp, self.fsdp_group, kind, "fsdp/all-gather")
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return acc

    def fsdp_reduce_scatter(self, t: torch.Tensor, dim: int,
                            kind: str = "fsdp/reduce_scatter") -> torch.Tensor:
        """This rank's slice along ``dim`` of Σ over the data group of
        ``t``: each rank's D slices exchanged all-to-all (rank k receives
        every rank's slice k), then added in data-rank order, so every run
        gives the same bits; a rank moves (D − 1)/D of ``t``, where an
        all-gather of the partials would move D − 1 times it."""
        if self.fsdp == 1:
            return t
        D = self.fsdp
        parts = torch.stack(t.chunk(D, dim=dim))
        got = self.fsdp_all_to_all(parts.reshape(D, -1), kind=kind).reshape(parts.shape)
        acc = got[0]
        for k in range(1, D):
            acc = acc + got[k]
        return acc

    def fsdp_all_to_all(self, parts: torch.Tensor, kind: str) -> torch.Tensor:
        """(D, n) rows, row k sent to data rank k → the (D, n) rows every
        data rank sent this one, in data-rank order."""
        raw = self._out(parts.contiguous().view(torch.uint8))
        got = torch.empty_like(raw)
        self._all_to_all(got, raw, self.fsdp_group)
        self._count(kind, raw.numel(), "fsdp/all-to-all")
        return self._back(got).view(parts.dtype)

    def fsdp_bcast(self, t: "torch.Tensor | None", shape, dtype,
                   kind: str = "fsdp/broadcast") -> torch.Tensor:
        """Data rank 0's ``t`` on every rank of the data group (the others
        pass None and the shape and dtype)."""
        if self.fsdp == 1:
            return t
        return self._inner_bcast(t, shape, dtype, kind, self.fsdp_rank == 0,
                                 self.global_rank(self.rank, fsdp_rank=0),
                                 self.fsdp_group, "fsdp/broadcast")

    def fsdp_slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's data slice of ``t`` along ``dim`` (no exchange)."""
        if self.fsdp == 1:
            return t
        return t.chunk(self.fsdp, dim=dim)[self.fsdp_rank].contiguous()

    def fsdp_dim(self, name: str, shape: tuple) -> Optional[int]:
        """The dimension of a whole leaf (named ``name``, of ``shape``) that
        the data axis splits on this mesh (None: held whole over it), by the
        rule table (``sharding.param_spec`` with fsdp on)."""
        if self.fsdp == 1:
            return None
        from repro_torch.launch.sharding import data_dim

        return data_dim(name, tuple(shape), self)


def _concat_parts(full: torch.Tensor, dim: int) -> torch.Tensor:
    """The (parts, *slice) stack of an all-gather joined along ``dim`` of
    the slices: a view where ``dim`` is the leading one (no copy)."""
    dim = dim % (full.dim() - 1)
    if dim == 0:
        return full.reshape((full.shape[0] * full.shape[1], *full.shape[2:]))
    return torch.cat(full.unbind(0), dim=dim)


#: set by :func:`initialize_multiprocess` when the caller asked for gloo on
#: the card: the meshes over that group stage every collective through host
#: memory
_STAGED = {"on": False}


def make_mesh(shape: tuple, axes: tuple, device=None, *, fsdp: bool = False) -> Mesh:
    """A mesh over the initialized default process group (or none). A model
    axis of m spans m ranks when the world is a multiple of m (ranks
    ``g·m + i``: worker group g, model index i; one subgroup per worker
    group and one per model index); in a world of one the rank holds the
    whole model. With ``fsdp`` (the parameters split over "data" inside a
    worker, the data axis not a worker axis) the D data indices span ranks
    too: rank ``g·(D·m) + j·m + i`` (data index j), one model group per
    (g, j), one data group per (g, i) and one worker-axis group per (j, i)."""
    device = default_device(device)
    import torch.distributed as dist

    axes, sizes = tuple(axes), tuple(int(s) for s in shape)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(axis_names=axes, sizes=sizes, device=device)
    backend = dist.get_backend()
    staged = backend == "gloo" and device.type == "cuda" and _STAGED["on"]
    if backend == "gloo" and device.type != "cpu" and not staged:
        raise ValueError("a gloo group stages CPU tensors only: the mesh must be on the CPU "
                         "(or ask for gloo on the card by name: initialize_multiprocess("
                         "backend='gloo'))")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an nccl group stages CUDA tensors only: the mesh must be on the card")
    rank, world = dist.get_rank(), dist.get_world_size()
    m = dict(zip(axes, sizes)).get("model", 1)
    D = dict(zip(axes, sizes)).get("data", 1) if fsdp else 1
    if world == 1 or m * D == 1:
        return Mesh(axis_names=axes, sizes=sizes, device=device, group=dist.group.WORLD,
                    rank=rank, world=world, staged=staged)
    if world % (m * D):
        raise ValueError(f"a model axis of {m} and a data axis of {D} inside a worker do not "
                         f"split a world of {world} ranks")
    groups = world // (m * D)

    def at(g: int, j: int, i: int) -> int:
        return (g * D + j) * m + i

    # every rank makes every subgroup, in the same order (new_group is collective)
    model_groups = {(g, j): dist.new_group([at(g, j, i) for i in range(m)])
                    for g in range(groups) for j in range(D)} if m > 1 else {}
    data_groups = {(g, i): dist.new_group([at(g, j, i) for j in range(D)])
                   for g in range(groups) for i in range(m)} if D > 1 else {}
    worker_groups = {(j, i): dist.new_group([at(g, j, i) for g in range(groups)])
                     for j in range(D) for i in range(m)}
    g, j, i = rank // (m * D), (rank // m) % D, rank % m
    return Mesh(axis_names=axes, sizes=sizes, device=device,
                group=worker_groups[(j, i)], rank=g, world=groups,
                model=m, model_rank=i, model_group=model_groups.get((g, j)),
                fsdp=D, fsdp_rank=j, fsdp_group=data_groups.get((g, i)), staged=staged)


#: the production meshes' (shape, axes): 16×16 single-pod, 2×16×16 two-pod
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16×16 single-pod or 2×16×16 two-pod mesh (the axes the rule table
    and the tiers read; the dry run's one-device stand-in has them,
    ``launch/dryrun.py``)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device)


def production_topology(*, multi_pod: bool = False) -> Topology:
    """The fabric the production meshes model: every intra-pod axis ici,
    the pod axis dcn, one pod = 256 chips."""
    if multi_pod:
        return Topology(
            axis_tiers=(("pod", "dcn"), ("data", "ici"), ("model", "ici")),
            n_devices=512, n_processes=1, devices_per_pod=256,
        )
    return Topology(
        axis_tiers=(("data", "ici"), ("model", "ici")),
        n_devices=256, n_processes=1, devices_per_pod=256,
    )


def make_test_mesh(data: int = 2, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh: ``data`` workers split over the ranks."""
    return make_mesh((data, model), ("data", "model"), device)


def make_federated_mesh(clients: int, model: int = 1, device=None) -> Mesh:
    """Mesh for the federated PP scenario: the worker ("data") axis is the
    client fleet, the model axis within-client parallelism."""
    return make_mesh((clients, model), ("data", "model"), device)


def worker_axis_names(multi_pod: bool, worker_axes: str) -> tuple:
    """Which mesh axes form the MARINA worker dimension."""
    if not multi_pod:
        return ("data",)
    return ("pod",) if worker_axes == "pod" else ("pod", "data")


def num_workers(mesh, multi_pod: bool, worker_axes: str) -> int:
    """Worker-fleet size n: product of the worker mesh axes' extents."""
    n = 1
    for ax in worker_axis_names(multi_pod, worker_axes):
        n *= mesh.shape[ax]
    return n


def cohort_group_size(n: int, r: int) -> Optional[int]:
    """Worker shards per sampled client when a PP cohort of r is respread
    over all n shards: n/r when r divides n, else None (masked dense
    compute)."""
    return n // r if (r > 0 and n % r == 0) else None


def detect_topology(mesh: Mesh) -> Topology:
    """Classify a runtime mesh's axes against the process layout.

    The worker groups split the mesh's non-model slots (the worker index
    space, row major over the non-model axes) into contiguous groups; the
    model axis spans the m ranks of a group (``mesh.model``), or stays
    inside the rank at m = 1. An axis along which the rank changes spans
    processes: "dcn" under gloo (the CPU, or the card staged through the
    host), "ici" under nccl. An axis inside one process is "loopback" on
    either. An axis named "pod" is always "dcn", read from the mesh itself
    (the reference's ``multi_pod`` argument is not needed)."""
    sizes = [s for a, s in zip(mesh.axis_names, mesh.sizes) if a != "model"]
    m = int(np.prod(sizes)) if sizes else 1
    if m % mesh.world:
        raise ValueError(f"{m} worker slots do not split over {mesh.world} ranks")
    ranks = (np.arange(m) // (m // mesh.world)).reshape(sizes or (1,))
    slow = "dcn" if (mesh.device.type == "cpu" or mesh.staged) else "ici"
    cpu = slow == "dcn"
    tiers, i = [], 0
    for axis in mesh.axis_names:
        if axis == "model":
            tiers.append((axis, slow if mesh.model > 1 else "loopback"))
            continue
        if axis == "data" and mesh.fsdp > 1:
            tiers.append((axis, slow))
            i += 1
            continue
        along = np.moveaxis(ranks, i, 0)
        i += 1
        if axis == "pod":
            tiers.append((axis, "dcn"))
        elif bool((along != along[0]).any()):
            tiers.append((axis, "dcn" if cpu else "ici"))
        else:
            tiers.append((axis, "loopback"))
    pod_devs = mesh.size // mesh.shape["pod"] if "pod" in mesh.axis_names else None
    return Topology(axis_tiers=tuple(tiers), n_devices=mesh.size,
                    n_processes=mesh.world * mesh.model * mesh.fsdp,
                    devices_per_pod=pod_devs)


# ---------------------------------------------------------------------------
# multi-process bring-up (torch.distributed)
# ---------------------------------------------------------------------------


def initialize_multiprocess(coordinator_address: str, num_processes: int,
                            process_id: int, *, device=None, backend: Optional[str] = None,
                            timeout_s: float = 120.0) -> torch.device:
    """``torch.distributed.init_process_group`` over a TCP rendezvous at
    ``coordinator_address`` ("host:port"): nccl on the card (the default;
    the process takes card ``process_id mod device_count``), gloo when
    ``device`` asks for the CPU. ``backend="gloo"`` on the card is asked for
    by name only: the meshes then stage every collective's tensors through
    host memory (two ranks on one card, which NCCL refuses). Returns the
    device this process computes on."""
    import torch.distributed as dist

    device = default_device(device)
    kw = {}
    _STAGED["on"] = False
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if backend in (None, "nccl"):
            backend = "nccl"
            kw["device_id"] = device
        elif backend == "gloo":
            _STAGED["on"] = True
        else:
            raise ValueError(f"no process-group backend {backend!r} on the card")
    elif device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"no process-group backend {backend!r} on the CPU")
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return device


def init_from_env(device=None, backend: Optional[str] = None) -> tuple:
    """Bring this process up from the ``MARINA_MP_*`` contract set by
    :func:`spawn_local_cluster` (no process group when the variables are
    absent). Returns ``(process_id, num_processes)``. On the card unless
    ``device`` names the CPU (raises without a card); ``backend`` as
    :func:`initialize_multiprocess`."""
    device = default_device(device)
    spec = os.environ.get(PROCESS_ENV)
    coord = os.environ.get(COORD_ENV)
    if not spec or not coord:
        return (0, 1)
    pid_s, nproc_s = spec.split("/")
    pid, nproc = int(pid_s), int(nproc_s)
    initialize_multiprocess(coord, nproc, pid, device=device, backend=backend)
    return (pid, nproc)


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def local_workers() -> int:
    """Workers each process of a local cluster hosts (``MARINA_MP_LOCAL``;
    1 outside a cluster)."""
    return int(os.environ.get(LOCAL_ENV, "") or 1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch_procs(prog: str, num_processes: int, devices_per_process: int,
                  extra_env: Optional[dict]) -> list:
    """Start the cluster's subprocesses (rank order) on a fresh rendezvous
    port — the shared bring-up of :func:`spawn_local_cluster` and
    :func:`run_resilient_cluster`."""
    port = _free_port()
    env_base = dict(os.environ)
    env_base[COORD_ENV] = f"127.0.0.1:{port}"
    env_base[LOCAL_ENV] = str(devices_per_process)
    env_base.setdefault("PYTHONPATH", os.path.join(os.path.dirname(__file__), "..", ".."))
    if extra_env:
        env_base.update(extra_env)
    procs = []
    for pid in range(num_processes):
        env = dict(env_base)
        env[PROCESS_ENV] = f"{pid}/{num_processes}"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", prog], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    return procs


class ClusterBringupError(RuntimeError):
    """A local-cluster attempt came back with failed children. Carries the
    per-rank ``CompletedProcess`` list so the retry wrapper can surface the
    LAST attempt's stderr when the budget runs out."""

    def __init__(self, message: str, results: Optional[list] = None):
        super().__init__(message)
        self.results = results


def spawn_local_cluster(prog: str, *, num_processes: int = 2, devices_per_process: int = 2,
                        timeout: float = 560.0, extra_env: Optional[dict] = None,
                        retry=None) -> list:
    """Run ``prog`` (python source) in ``num_processes`` subprocesses wired
    into one process group; each hosts ``devices_per_process`` workers
    (``MARINA_MP_LOCAL``) and must call :func:`init_from_env` before any
    collective. Returns the per-process ``CompletedProcess`` list (rank
    order).

    ``retry`` (a :class:`repro_torch.launch.transport.RetryPolicy`) tears
    the whole attempt down and relaunches it — fresh port, fresh children —
    when it times out or any child exits nonzero (a rendezvous race is a
    whole-cluster failure). Each attempt gets ``retry.timeout_s``; the last
    attempt's failure propagates (``TimeoutExpired``) or returns its failed
    results for the caller's asserts."""

    def one_attempt(attempt_timeout: float) -> list:
        procs = _launch_procs(prog, num_processes, devices_per_process, extra_env)
        done = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=attempt_timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.communicate()
                raise
            done.append(subprocess.CompletedProcess(p.args, p.returncode, out, err))
        return done

    if retry is None:
        return one_attempt(timeout)

    from repro_torch.launch.transport import retry_call  # transport imports topology

    def attempt() -> list:
        results = one_attempt(retry.timeout_s)
        bad = [i for i, r in enumerate(results) if r.returncode != 0]
        if bad:
            raise ClusterBringupError(f"cluster ranks {bad} exited nonzero", results=results)
        return results

    try:
        return retry_call(attempt, retry,
                          retryable=(ClusterBringupError, subprocess.TimeoutExpired))
    except ClusterBringupError as exc:
        return exc.results


# ---------------------------------------------------------------------------
# crash detection + recovery (the reference's DESIGN.md §4.10)
#
# A killed worker process takes its workers with it, and every survivor then
# hangs in the next collective. The resilient runner watches liveness from
# outside, kills the survivors the moment any rank dies, and locates the last
# fleet-wide completed round from the heartbeat lines; recovery relaunches
# with the dead clients as a static ``drop`` set from the first incomplete
# round.
# ---------------------------------------------------------------------------


def clients_of_rank(rank: int, devices_per_process: int) -> tuple:
    """Client ids a crashed rank takes down: rank r hosts the contiguous
    workers [r·dpp, (r+1)·dpp) (:meth:`Mesh.workers`)."""
    lo = rank * devices_per_process
    return tuple(range(lo, lo + devices_per_process))


def crash_spec_from_env() -> Optional[tuple]:
    """``(rank, round)`` from ``MARINA_MP_CRASH="<rank>@<round>"``; None
    when unset or empty."""
    spec = os.environ.get(CRASH_ENV, "")
    if not spec:
        return None
    rank_s, round_s = spec.split("@")
    return (int(rank_s), int(round_s))


def maybe_crash(rank: int, round_k: int) -> None:
    """Process-crash fault injection: ``os._exit`` when the environment names
    this rank and round. Call at the top of the round body, before any
    collective."""
    if crash_spec_from_env() == (rank, round_k):
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(17)


def recovery_from_env() -> tuple:
    """``(dead_client_ids, resume_round)`` from ``MARINA_MP_DEAD`` /
    ``MARINA_MP_RESUME``; ``((), 0)`` when unset."""
    dead_s = os.environ.get(DEAD_ENV, "")
    dead = tuple(int(x) for x in dead_s.split(",") if x.strip()) if dead_s else ()
    resume = int(os.environ.get(RESUME_ENV, "") or 0)
    return dead, resume


def last_heartbeat(text: str) -> int:
    """Last round a rank reported complete (``MARINA_HB <k>`` lines); −1
    when it never finished one."""
    last = -1
    for line in text.splitlines():
        parts = line.strip().split()
        if len(parts) == 2 and parts[0] == HEARTBEAT:
            try:
                last = int(parts[1])
            except ValueError:
                pass
    return last


@dataclasses.dataclass
class ClusterOutcome:
    """What :func:`run_resilient_cluster` observed: per-rank results, the
    ranks that died on their own, the last round every rank completed, and
    the attempts it took (a bring-up that failed is launched again)."""

    results: list
    dead_ranks: tuple
    last_round: int
    attempts: int = 1

    @property
    def crashed(self) -> bool:
        return bool(self.dead_ranks)


def _first_death(procs: list, timeout: float) -> tuple:
    """Wait until a child exits nonzero, every child has exited, or
    ``timeout`` runs out; each child is reaped by a thread of its own the
    moment it exits, so the exits are seen in the order they happen.
    Returns the rank whose nonzero exit came first, as a 1-tuple (() when
    none did): a peer that exits after it did not die on its own — gloo
    throws a survivor out of the collective that its dead peer left, within
    milliseconds, where the reference's survivor hangs."""
    order = []
    cond = threading.Condition()

    def reap(rank: int, p) -> None:
        code = p.wait()
        with cond:
            order.append((rank, code))
            cond.notify()

    for rank, p in enumerate(procs):
        threading.Thread(target=reap, args=(rank, p), daemon=True).start()
    deadline = time.monotonic() + timeout
    with cond:
        while True:
            failed = [rank for rank, code in order if code != 0]
            if failed or len(order) == len(procs):
                return tuple(failed[:1])
            left = deadline - time.monotonic()
            if left <= 0:
                return ()
            cond.wait(left)


def _resilient_attempt(prog: str, num_processes: int, devices_per_process: int,
                       timeout: float, extra_env: Optional[dict]) -> ClusterOutcome:
    procs = _launch_procs(prog, num_processes, devices_per_process, extra_env)
    dead = _first_death(procs, timeout)
    for p in procs:
        if p.poll() is None:
            p.kill()
    results = []
    for p in procs:
        out, err = p.communicate()
        results.append(subprocess.CompletedProcess(p.args, p.returncode, out, err))
    beats = [last_heartbeat(r.stdout or "") for r in results]
    return ClusterOutcome(results=results, dead_ranks=dead,
                          last_round=min(beats) if beats else -1)


def bringup_failed(outcome: ClusterOutcome) -> bool:
    """An attempt that did not end cleanly before any rank reported a round
    complete: a rank died, or the hang backstop fired, in the rendezvous
    (another process took the free port between :func:`_free_port` and the
    bind) or before the first heartbeat."""
    clean = all(r.returncode == 0 for r in outcome.results)
    return not clean and all(last_heartbeat(r.stdout or "") < 0 for r in outcome.results)


def run_resilient_cluster(prog: str, *, num_processes: int = 2, devices_per_process: int = 2,
                          timeout: float = 560.0, extra_env: Optional[dict] = None,
                          retry=None) -> ClusterOutcome:
    """Like :func:`spawn_local_cluster`, but crash-aware: waits on the
    children, kills the survivors (hung or failing in their next
    collective) as soon as a rank exits nonzero, and reads the heartbeats
    back. ``dead_ranks`` holds the rank that died on its own
    (:func:`_first_death`). ``timeout`` is the hang backstop.

    ``retry`` (a :class:`repro_torch.launch.transport.RetryPolicy`)
    launches the cluster again — fresh port, fresh children, each attempt
    given ``retry.timeout_s`` — after an attempt whose bring-up failed
    (:func:`bringup_failed`), as :func:`spawn_local_cluster` does; the last
    attempt's outcome is returned either way. A crash injected before the
    first heartbeat is indistinguishable from a failed bring-up and is
    retried too."""
    attempts = 1 if retry is None else retry.retries + 1
    for attempt in range(attempts):
        outcome = _resilient_attempt(prog, num_processes, devices_per_process,
                                     timeout if retry is None else retry.timeout_s, extra_env)
        outcome.attempts = attempt + 1
        if attempt + 1 == attempts or not bringup_failed(outcome):
            return outcome
        time.sleep(retry.backoff(attempt))


def run_with_recovery(prog: str, *, num_processes: int = 2, devices_per_process: int = 2,
                      timeout: float = 560.0, extra_env: Optional[dict] = None,
                      retry=None) -> tuple:
    """Run ``prog`` crash-aware; if a rank dies, relaunch it as one process
    hosting every worker, the crashed rank's clients exported as the dead set
    from the first incomplete round. ``retry`` relaunches a failed bring-up
    of either run. Returns ``(outcome, recovery)``, the recovery run's
    ``CompletedProcess`` or None."""
    outcome = run_resilient_cluster(prog, num_processes=num_processes,
                                    devices_per_process=devices_per_process,
                                    timeout=timeout, extra_env=extra_env, retry=retry)
    if not outcome.crashed:
        return outcome, None
    dead_clients = ()
    for r in outcome.dead_ranks:
        dead_clients += clients_of_rank(r, devices_per_process)
    recovery_env = dict(extra_env or {})
    recovery_env[CRASH_ENV] = ""          # the ghost must not die twice
    recovery_env[DEAD_ENV] = ",".join(str(c) for c in sorted(dead_clients))
    recovery_env[RESUME_ENV] = str(outcome.last_round + 1)
    results = spawn_local_cluster(prog, num_processes=1,
                                  devices_per_process=num_processes * devices_per_process,
                                  timeout=timeout, extra_env=recovery_env, retry=retry)
    return outcome, results[0]


_DEMO_PROG = r"""
import torch
from repro_torch.launch import topology as topo
pid, nproc = topo.init_from_env(device="cpu")
mesh = topo.make_test_mesh(nproc * topo.local_workers(), 1, device="cpu")
t = topo.detect_topology(mesh)
n = mesh.shape["data"]
rows = torch.arange(n, dtype=torch.float32)[list(mesh.workers(n))]
total = float(mesh.sum_rows(rows, n).sum())
print(f"process {pid}/{nproc}: hosts workers {list(mesh.workers(n))} of {n}; "
      f"worker-axis tier = {t.tier_for_axes(('data',))}; "
      f"all-reduce(arange) = {total:.0f}", flush=True)
topo.shutdown()
"""


def main():
    """CLI demo: spawn an N-process local cluster on the CPU (gloo), run one
    cross-process all-reduce, and print each process's view of the
    topology."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=2,
                    help="workers each process hosts")
    args = ap.parse_args()
    results = spawn_local_cluster(_DEMO_PROG, num_processes=args.processes,
                                  devices_per_process=args.devices_per_process,
                                  timeout=120.0)
    ok = True
    for r in results:
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            ok = False
            sys.stderr.write(r.stderr[-2000:])
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
