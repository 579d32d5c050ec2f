"""Roofline terms of one step of the port on the H100 (port of
``repro.roofline.analysis``).

    compute term    = FLOPs / (devices × peak FLOP/s)
    memory term     = bytes / (devices × HBM bandwidth)
    collective term = collective bytes / link bandwidth (or the per-tier α–β
                      cost when a topology is given)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and the
collective bytes from the optimized HLO text (``collective_bytes_from_hlo``,
``analyze_compiled``). A PyTorch program has neither a compiled artifact
nor HLO, so that parser has no counterpart here. Its two uses map to:

* :func:`collective_stats_from_mesh` — the collectives the port's mesh
  counted as it issued them (``Mesh.op_counts`` / ``Mesh.op_bytes``, this
  rank's bytes), priced per collective under the reference's ring rule
  (all-gather (g−1)/g of the gathered bytes, all-reduce 2(g−1)/g of the
  reduced buffer; a broadcast or a send moves its bytes once) and booked
  under the tier the mesh's worker axes cross (``detect_topology``: nccl
  ranks of one host are ``ici``);
* :func:`analyze_step` — runs one call of a step: FLOPs from
  ``torch.utils.flop_counter.FlopCounterMode``, bytes from a dispatch mode
  that counts each operator's tensor inputs read once and its outputs
  written once (views move nothing and count nothing), the device memory
  the call holds from :class:`~repro_torch.roofline.memory.MemoryCounter`
  (XLA's ``memory_analysis`` keys; its peak is the report's peak on meta
  and the CPU, while on the card the peak stays
  ``torch.cuda.max_memory_allocated``'s and the count sits beside it),
  collectives from the mesh.

:class:`HW` holds the H100 SXM's published figures (NVIDIA's data sheet):
989 TFLOP/s dense bf16, 3.35 TB/s HBM, and NVLink 4's 450 GB/s a direction
as the ``ici`` bandwidth. These are peaks, not measurements; an f32 run is
read against ``HW(peak_flops=67e12)``, the FP32 rate outside the tensor
cores. The arithmetic (:class:`CollectiveStats`, :class:`RooflineReport`,
:func:`alpha_beta_disagreement`, :func:`decode_bandwidth_bound_s`,
:func:`prefill_sharing_savings`) is the reference's, unchanged: the same
inputs and ``HW`` values give the same results, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _torch_tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .memory import MemoryCounter


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12      # bf16 dense, per H100 SXM
    hbm_bw: float = 3.35e12         # bytes/s of HBM3 per card
    ici_bw: float = 450e9           # bytes/s a direction, NVLink 4 per card


#: the FP32 rate of one H100 SXM outside the tensor cores (data sheet)
H100_F32_PEAK_FLOPS = 67e12


@dataclasses.dataclass
class CollectiveStats:
    per_device_bytes: float = 0.0
    counts: dict = dataclasses.field(default_factory=dict)
    by_kind_bytes: dict = dataclasses.field(default_factory=dict)
    # per-link-tier splits (empty when no topology classified the groups)
    by_tier_bytes: dict = dataclasses.field(default_factory=dict)
    by_tier_counts: dict = dataclasses.field(default_factory=dict)


#: wire bytes a device moves for ``counted`` bytes of its own rows in a
#: group of g ranks: an all-gather sends its rows to the g−1 others
#: ((g−1)/g of the g·counted gathered), an all-reduce 2(g−1)/g of the
#: g·counted buffer the mesh reduces, a broadcast or a send its bytes once
#: (the reference's collective-permute)
_RING = {
    "all-gather": lambda counted, g: counted * (g - 1),
    "all-reduce": lambda counted, g: 2.0 * counted * (g - 1),
    "broadcast": lambda counted, g: float(counted),
    "send": lambda counted, g: float(counted),
    # each rank keeps 1/g of what it hands in and sends the rest
    "all-to-all": lambda counted, g: counted * (g - 1) / g,
}


def mesh_counts(mesh) -> dict:
    """``{op: (count, bytes)}`` the mesh has counted so far (a snapshot for
    :func:`collective_stats_from_mesh`'s ``since``)."""
    return {op: (mesh.op_counts[op], mesh.op_bytes.get(op, 0)) for op in mesh.op_counts}


def collective_stats_from_mesh(mesh, topology: Optional[Any] = None,
                               since: Optional[dict] = None) -> CollectiveStats:
    """The collectives the mesh counted (since the :func:`mesh_counts`
    snapshot ``since``), priced per collective under the ring rule: the
    worker axes' for a group of ``mesh.world`` worker groups and, with a
    ``topology``, booked under the tier of the worker axes (every axis but
    ``model``, and but ``data`` on an fsdp mesh); the model axis's (ops
    ``model/...``) for a group of the ``mesh.model`` ranks of one worker
    group, under the model axis's tier; the data axis's inside a worker
    (ops ``fsdp/...``) for a group of ``mesh.fsdp`` ranks, under the data
    axis's tier. A group of one rank moves nothing over a link."""
    stats = CollectiveStats()
    since = since or {}
    inner = {"model/": ("model", getattr(mesh, "model", 1)),
             "fsdp/": ("data", getattr(mesh, "fsdp", 1))}
    inner_axes = {"model"} | ({"data"} if getattr(mesh, "fsdp", 1) > 1 else set())
    worker_tier = None
    if topology is not None:
        worker_tier = topology.tier_for_axes(
            tuple(a for a in mesh.axis_names if a not in inner_axes))
    for op, (count, counted) in mesh_counts(mesh).items():
        c0, b0 = since.get(op, (0, 0))
        count, counted = count - c0, counted - b0
        prefix = next((p for p in inner if op.startswith(p)), None)
        if prefix is None:
            g, tier = mesh.world, worker_tier
        else:
            axis, g = inner[prefix]
            tier = (topology.tier_for_axes((axis,))
                    if topology is not None and axis in mesh.axis_names else None)
        if count <= 0 or g <= 1:
            continue
        wire = _RING[op.removeprefix(prefix or "")](counted, g)
        stats.per_device_bytes += wire
        stats.counts[op] = stats.counts.get(op, 0) + count
        stats.by_kind_bytes[op] = stats.by_kind_bytes.get(op, 0.0) + wire
        if tier is not None:
            stats.by_tier_bytes[tier] = stats.by_tier_bytes.get(tier, 0.0) + wire
            stats.by_tier_counts[tier] = stats.by_tier_counts.get(tier, 0) + count
    return stats


@dataclasses.dataclass
class RooflineReport:
    flops_per_device: float
    bytes_per_device: float
    collective: CollectiveStats
    n_devices: int
    hw: HW = dataclasses.field(default_factory=HW)
    model_flops_total: Optional[float] = None
    peak_memory_per_device: Optional[float] = None
    topology: Optional[Any] = None  # launch.topology.Topology (α–β model)
    # the counted memory (``MemoryCounter.analysis``), the operator at its
    # peak, the bytes live there by allocating operator and, on the card,
    # the bytes the allocator held at entry
    memory_analysis: Optional[dict] = None
    peak_memory_op: Optional[str] = None
    peak_memory_by_op: Optional[dict] = None
    allocated_at_entry: Optional[float] = None

    @property
    def compute_s(self) -> float:
        """Compute term from the counted FLOPs."""
        return self.flops_per_device / self.hw.peak_flops

    @property
    def analytic_compute_s(self) -> float:
        """MFU-style lower bound: MODEL_FLOPS / (devices × peak)."""
        if not self.model_flops_total:
            return 0.0
        return self.model_flops_total / self.n_devices / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def collective_s_flat(self) -> float:
        """The single-bandwidth model (bytes / flat ici bw)."""
        return self.collective.per_device_bytes / self.hw.ici_bw

    @property
    def collective_s(self) -> float:
        """Collective term: the per-tier α–β cost when a topology classified
        the collectives, else the flat-ici fallback."""
        if self.topology is None or not self.collective.by_tier_bytes:
            return self.collective_s_flat
        total = 0.0
        for tier, byts in self.collective.by_tier_bytes.items():
            link = self.topology.link(tier)
            total += self.collective.by_tier_counts.get(tier, 0) * link.alpha_s
            total += byts / link.bw
        return total

    @property
    def dominant(self) -> str:
        terms = {
            "compute": max(self.compute_s, self.analytic_compute_s),
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> Optional[float]:
        if not self.model_flops_total:
            return None
        total = self.flops_per_device * self.n_devices
        return self.model_flops_total / total if total else None

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective.per_device_bytes,
            "collective_counts": self.collective.counts,
            "collective_by_kind_bytes": self.collective.by_kind_bytes,
            **(
                {
                    "collective_by_tier_bytes": self.collective.by_tier_bytes,
                    "collective_by_tier_counts": self.collective.by_tier_counts,
                    "collective_s_flat": self.collective_s_flat,
                    "link_table": {
                        t: {"alpha_s": sp.alpha_s, "bw": sp.bw}
                        for t, sp in dict(self.topology.links).items()
                    },
                }
                if self.topology is not None
                else {}
            ),
            "analytic_compute_s": self.analytic_compute_s,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_total": self.model_flops_total,
            "useful_ratio": self.useful_ratio,
            "peak_memory_per_device": self.peak_memory_per_device,
            "n_devices": self.n_devices,
            **{k: getattr(self, k) for k in ("memory_analysis", "peak_memory_op",
                                             "peak_memory_by_op", "allocated_at_entry")
               if getattr(self, k) is not None},
        }


def alpha_beta_disagreement(
    recorded_s: float, modeled_s: float, factor: float = 2.0
) -> Optional[dict]:
    """REFUTED-style flag for recorded-vs-model roofline drift.

    ``recorded_s`` is the collective term a record holds (typically the
    flat-ici model); ``modeled_s`` the per-tier α–β cost of the same step.
    A ratio above ``factor`` either way earns REFUTED. Returns None when
    either side is degenerate (a step with no collective has nothing to
    disagree about)."""
    if recorded_s <= 0.0 or modeled_s <= 0.0:
        return None
    ratio = max(recorded_s / modeled_s, modeled_s / recorded_s)
    return {
        "ratio": ratio,
        "verdict": "REFUTED" if ratio > factor else "CONFIRMED",
    }


def decode_bandwidth_bound_s(
    kv_bytes: float,
    param_bytes: float,
    n_devices: int,
    hw: HW = HW(),
    topology: Optional[Any] = None,
    collective_bytes: float = 0.0,
    n_collectives: int = 0,
    tier: str = "ici",
) -> dict:
    """Analytic floor for one single-token decode step.

    A decode step touches every parameter byte and every LIVE KV byte
    once per token with trivial arithmetic intensity, so its floor is pure
    streaming:

        hbm_s = (param_bytes + kv_bytes) / (n_devices · hbm_bw)

    ``kv_bytes`` is where paging pays: a dense cache streams ``n_slots ×
    max_len`` rows whatever their occupancy, the page pool only the
    occupied pages — pass the pool's live bytes and the bound shrinks with
    them. The step's collectives are priced under the link tiers
    (``n_collectives`` α launches plus ``collective_bytes`` over the named
    ``tier``'s β), or over :class:`HW`'s flat ``ici_bw`` without a
    topology. Returns ``{"hbm_s", "collective_s", "bound_s"}``, ``bound_s``
    their sum (the pessimistic additive floor)."""
    hbm_s = (param_bytes + kv_bytes) / (n_devices * hw.hbm_bw)
    if topology is not None:
        link = topology.link(tier)
        coll_s = n_collectives * link.alpha_s + collective_bytes / link.bw
    else:
        coll_s = collective_bytes / hw.ici_bw
    return {
        "hbm_s": hbm_s,
        "collective_s": coll_s,
        "bound_s": hbm_s + coll_s,
    }


def prefill_sharing_savings(
    tokens_unshared: float,
    tokens_shared: float,
    flops_per_token: float,
    kv_bytes_per_token: float,
    n_devices: int,
    hw: HW = HW(),
) -> dict:
    """Analytic price of COW prefix sharing on the prefill bill: each
    prompt token a follower maps from the donor's cached pages instead of
    recomputing saves its forward FLOPs (``flops_per_token``, ~2·N) and
    its KV write (``kv_bytes_per_token``). Returns the saved FLOPs and
    bytes and the time each is worth on the ``hw`` roofline; ``saved_s`` is
    the compute leg (prefill is compute-bound at any realistic chunk)."""
    tokens_saved = max(0.0, tokens_unshared - tokens_shared)
    flops_saved = tokens_saved * flops_per_token
    hbm_saved = tokens_saved * kv_bytes_per_token
    compute_s = flops_saved / (n_devices * hw.peak_flops)
    hbm_s = hbm_saved / (n_devices * hw.hbm_bw)
    return {
        "tokens_unshared": tokens_unshared,
        "tokens_shared": tokens_shared,
        "tokens_saved": tokens_saved,
        "prefill_token_reduction": (
            tokens_unshared / tokens_shared if tokens_shared > 0 else float("inf")
        ),
        "flops_saved": flops_saved,
        "kv_write_bytes_saved": hbm_saved,
        "compute_s_saved": compute_s,
        "hbm_s_saved": hbm_s,
        "saved_s": compute_s,
    }


def _is_view(func) -> bool:
    """An operator whose outputs alias its inputs without writing them."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


#: operators that only allocate: they read and write no bytes
_ALLOCATORS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided"})


class ByteCounter(TorchDispatchMode):
    """Counts the bytes each operator reads and writes: every distinct
    tensor input once, every tensor output once; views and bare allocations
    (``empty`` and its kin) count nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func) and func.overloadpacket.__name__ not in _ALLOCATORS:
            seen = set()
            for t in _torch_tree_flatten((args, kwargs or {}))[0]:
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += t.numel() * t.element_size()
            for t in _torch_tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def analyze_step(fn, *args, n_devices: int = 1, model_flops_total: Optional[float] = None,
                 topology: Optional[Any] = None, mesh=None, hw: Optional[HW] = None,
                 device=None, arg_shares=None):
    """Run ``fn(*args)`` once (its output is dropped) and return its
    :class:`RooflineReport`: FLOPs counted by ``FlopCounterMode``, bytes by
    :class:`ByteCounter`, the device memory by :class:`MemoryCounter`
    (``arg_shares``: the share of each argument the device holds), the
    collectives ``mesh`` counted during the call
    (:func:`collective_stats_from_mesh`). The peak memory is the counted
    one, or with ``device`` a CUDA device the allocator's, beside what it
    held at entry."""
    on_card = device is not None and torch.device(device).type == "cuda"
    at_entry = None
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        at_entry = float(torch.cuda.memory_allocated(device))
    before = mesh_counts(mesh) if mesh is not None else None
    flops = FlopCounterMode(display=False)
    byts = ByteCounter()
    mem = MemoryCounter(args, arg_shares)
    with flops, byts, mem:
        out = fn(*args)
    analysis = mem.analysis(out)
    del out
    peak = float(mem.peak)
    if on_card:
        torch.cuda.synchronize(device)
        peak = float(torch.cuda.max_memory_allocated(device))
    coll = (collective_stats_from_mesh(mesh, topology, since=before)
            if mesh is not None else CollectiveStats())
    return RooflineReport(
        flops_per_device=float(flops.get_total_flops()),
        bytes_per_device=float(byts.bytes),
        collective=coll,
        n_devices=n_devices,
        hw=hw if hw is not None else HW(),
        model_flops_total=model_flops_total,
        peak_memory_per_device=peak,
        topology=topology,
        memory_analysis=analysis,
        peak_memory_op=mem.peak_op,
        peak_memory_by_op=mem.peak_by_op,
        allocated_at_entry=at_entry,
    )
