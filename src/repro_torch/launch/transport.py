"""Transport layer — the collective primitives every mesh round rides (port
of ``repro.launch.transport``).

Round assembly (`launch/distributed.py`) never calls a collective itself:
it composes a :class:`Transport`, which owns

* the **sync exchange** — the dense worker mean (one all-reduce over the
  packed (n, nblk, B) flat buffer under ``flat_sync``, one a leaf
  otherwise), and the robust rule on the worker gradient stack;
* the **compressed uplink** — per-leaf Block-RandK / shared-mask / Perm-K /
  QSGD payloads and their exchange (:meth:`Transport.uplink_mean`), and the
  per-worker dense decode the robust rules aggregate
  (:meth:`Transport.worker_rows`);
* the **compressed downlink** — the Q_down(g^{k+1} − g^k) broadcast
  (:meth:`Transport.downlink`);

and the **bits-by-link-tier ledger** (``core.wire.TierLedger``), which
holds what the reference's holds after the same calls: bits per worker per
round under (scope, direction, tier, kind), booked leaf by leaf in the
reference's order and arithmetic. A method called directly books on every
call (the reference books outside ``jit`` on every call); the step
functions of a bundle book once, on their first call, as the reference
books once per trace.

Each rank stages its own workers' rows (:meth:`Mesh.workers`); the payload
crosses the process group with an all-gather, or an all-reduce for the
psum kinds (:meth:`Mesh.gather_rows` / :meth:`Mesh.sum_rows`), whenever the
mesh has a group. The mean is then taken in worker order 0..n−1 on every
rank, so the output does not depend on how the workers are laid out across
ranks. The draws come from :mod:`repro_torch.prng` — one ``split`` key a
leaf in ``jax.tree.flatten`` order, then ``randint``, ``permutation`` or
``uniform`` — bit-equal to ``jax.random``, so the payloads are the
reference's. The gather along a leaf's last dimension and the
scatter-mean are the ``randk_gather`` and ``scatter_accum`` kernels
(through ``core.flat``'s backend-switched block primitives).

On a model axis of m ranks (``Mesh.model``) each rank holds its slice of
every leaf (``leaf_dims``: the dimension of each leaf's whole per-row
``leaf_shapes`` its slices split, ``launch/sharding.py``) and ships only
its share of the payload, so the wire's bytes, summed over all ranks, ×8
÷ n, stay the booked bits. The draws are the whole leaf's on every rank;
a rank keeps its share of them:

* a leaf split on a leading dimension splits the (R, L) rows: every family
  runs on the rank's rows (its offsets, dither or mask rows);
* a leaf split on its last dimension splits L: under RandK a rank's share
  of a row's kb offsets varies from row to row, so each worker group ships
  the values (and offsets) that fall in its columns (a ragged exchange whose
  sizes every rank regenerates from the key), and the scatter-mean runs at
  the rank's width with the other offsets sent to a dropped column. Perm-K
  ships each worker's lanes that fall in the rank's columns (ragged too:
  the permutation is over the whole L). QSGD's row norm needs the whole
  row: the rows are gathered over the model axis first, so the norm is
  one rank's, bit for bit, and each rank ships its columns' levels, model
  rank 0 the norms. Under the shared mask (and QSGD packed on columns that
  split a 32-bit word) the leaf is gathered over the model axis, model
  rank 0 ships its whole payload and broadcasts the decoded slice back;
* a replicated leaf (bit-equal on every model rank) is shipped by model
  rank 0 and its decoded delta broadcast over the model group.

The decoded delta is the one-rank port's, bit for bit: the same offsets,
values and worker order reach every coordinate. The model-axis traffic
counts under ``model/...`` kinds, apart from the wire's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import flat as flat_engine
from repro_torch.core import wire
from repro_torch.core.tree_util import mean_axis0, tree_flatten, tree_leaves
from repro_torch.kernels import ref as kref
from repro_torch.launch.topology import Mesh, Topology
from repro_torch.roofline.memory import shapes_only

PyTree = Any


def _bits(shape, dtype) -> float:
    """Wire bits of one staged array of ``shape`` and ``dtype``."""
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return float(int(np.prod(shape)) * info.bits)


def _shape(shape) -> torch.Tensor:
    """A meta tensor that carries ``shape`` only (what the ledger books)."""
    with shapes_only():
        return torch.empty(shape, device="meta")


def _leaf_dims(shape: tuple) -> tuple:
    """(R, L) of a leaf's per-row shape: L its last dimension, R the rest."""
    L = int(shape[-1])
    R = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return R, L


def _qsgd_quantize_rows(u: torch.Tensor, x: torch.Tensor, s: int):
    """Per-row ℓ2-norm s-level stochastic quantization over the LAST axis,
    against the dither ``u``: levels sign(x)·⌊s|x|/‖row‖ + u⌋ as int8, norms
    f32 (kept dims). The one formula both wire directions share."""
    assert 1 <= s <= 127, f"s={s} does not fit the int8 wire"
    xf = x.float()
    norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    q = (torch.sign(xf) * torch.floor(s * torch.abs(xf) / safe + u)).to(torch.int8)
    return q, norm


def _nibble_roundtrip_rows(q: torch.Tensor) -> torch.Tensor:
    """Push int8 levels through the 4-bit wire (|level| ≤ 7): eight
    two's-complement nibbles a 32-bit word, and back."""
    L = q.shape[-1]
    flat = q.reshape(-1, L)
    return kref.nibble_unpack_ref(kref.nibble_pack_ref(flat), L).reshape(q.shape)


def _gather_along_last(x3d: torch.Tensor, idx3d: torch.Tensor, scale: float,
                       backend: str) -> torch.Tensor:
    """(rows, R, L) gather at (rows, R, kb) int32 offsets, scaled: the
    ``randk_gather`` kernel over (rows·R, L)."""
    rows, R, L = x3d.shape
    kb = idx3d.shape[-1]
    out = flat_engine.block_gather(x3d.reshape(rows * R, L).contiguous(),
                                   idx3d.reshape(rows * R, kb).contiguous(), scale, backend)
    return out.reshape(rows, R, kb)


def _scatter_mean_last(vals3d: torch.Tensor, idx3d: torch.Tensor, L: int,
                       backend: str) -> torch.Tensor:
    """(n, R, kb) scatter-accumulate mean over workers → (R, L) f32: the
    ``scatter_accum`` kernel at row width L."""
    return flat_engine.block_scatter_mean(vals3d.float().contiguous(),
                                          idx3d.contiguous(), L, backend)


# -- retry/timeout/backoff (the reference's DESIGN.md §4.10) -----------------
#
# Bring-up and rendezvous fail transiently (port races, slow process start).
# One policy serves the launch layer (topology.spawn_local_cluster) and the
# tests: bounded attempts, exponential backoff, a per-attempt timeout the
# caller passes to whatever blocking call it wraps.


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Timeout/retry-with-backoff dial for flaky transport operations:
    ``timeout_s`` bounds one attempt; ``retries`` re-tries follow the first
    (0 = fail fast); the sleep before retry ``i`` is
    ``backoff_s · backoff_mult**i``."""

    timeout_s: float = 120.0
    retries: int = 1
    backoff_s: float = 1.0
    backoff_mult: float = 2.0

    def __post_init__(self):
        if self.timeout_s <= 0.0:
            raise ValueError("timeout_s must be positive")
        if self.retries < 0:
            raise ValueError("retries must be non-negative")
        if self.backoff_s < 0.0:
            raise ValueError("backoff_s must be non-negative")
        if self.backoff_mult < 1.0:
            raise ValueError("backoff_mult must be >= 1 (backoff never shrinks)")

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based): backoff_s·mult^attempt."""
        return self.backoff_s * self.backoff_mult ** attempt


def retry_call(fn: Callable, policy: RetryPolicy, *, retryable: tuple = (Exception,),
               on_retry: Optional[Callable] = None, sleep: Callable = time.sleep):
    """Run ``fn()`` under ``policy``: up to ``1 + policy.retries`` attempts,
    exponential backoff between them, the last error re-raised. Only
    ``retryable`` exceptions retry; ``on_retry(attempt, exc)`` sees each
    failure before the sleep; ``sleep`` is injectable for tests."""
    for attempt in range(policy.retries + 1):
        try:
            return fn()
        except retryable as exc:
            if attempt >= policy.retries:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            sleep(policy.backoff(attempt))


@dataclasses.dataclass
class Transport:
    """Worker-axis collective interface + bits-by-tier ledger (module doc).

    Built once per step bundle by :func:`make_transport`; the wire policy
    (compression family, levels, packing, staging, downlink) is frozen here
    so round assembly passes trees and keys, never wire flags. Worker-sharded
    row stacks hold this rank's :meth:`Mesh.workers` rows."""

    mesh: Mesh
    topology: Topology
    waxes: tuple
    n: int
    backend: str = "auto"
    compression: str = "randk"
    qsgd_s: int = 15
    packed_payload: bool = False
    shared_mask: bool = False
    downlink_mode: str = "none"
    downlink_s: int = 7
    flat_sync: bool = False
    sync_layout: Any = None
    leaf_shapes: Optional[list] = None
    leaf_dims: Optional[list] = None    # per leaf (data dim, model dim)
    ledger: wire.TierLedger = dataclasses.field(default_factory=wire.TierLedger)
    _scope: str = "unscoped"
    _booking: bool = True

    # -- ledger -------------------------------------------------------------

    @contextlib.contextmanager
    def scope(self, name: str):
        """Tag ledger bookings with the step that made them."""
        prev = self._scope
        self._scope = name
        try:
            yield
        finally:
            self._scope = prev

    @contextlib.contextmanager
    def quiet(self):
        """Run exchanges without booking them (a step re-executed: the
        reference books once per trace)."""
        prev = self._booking
        self._booking = False
        try:
            yield
        finally:
            self._booking = prev

    def book(self, direction: str, kind: str, bits: float,
             axes: Optional[tuple] = None) -> None:
        """Book per-worker wire bits under the current scope, tiered by the
        worker axes the exchange crosses (default: this transport's)."""
        if not self._booking:
            return
        t = self.topology.tier_for_axes(self.waxes if axes is None else axes)
        self.ledger.book(self._scope, direction, t, kind, bits)

    # -- what each exchange books (shapes only) -----------------------------

    def book_sync(self, shapes: PyTree) -> None:
        """The sync round's n dense f32 uploads (32d up) and the dense
        estimator broadcast (32d down); ``shapes`` are parameter-shaped
        (anything with ``.shape``)."""
        d = sum(int(np.prod(t.shape)) for t in tree_leaves(shapes))
        self.book("up", "psum", wire.dense_f32_bits(d))
        self.book("down", "broadcast", wire.downlink_dense_bits(d))

    def _up_fraction(self, n: int, uploaded_rows: Optional[int]) -> float:
        if uploaded_rows is not None and not 0 <= uploaded_rows <= n:
            raise ValueError(f"uploaded_rows={uploaded_rows} outside [0, {n}] staged rows")
        return 1.0 if uploaded_rows is None else uploaded_rows / n

    def _uplink_leaf_bits(self, n: int, shape: tuple, dtype) -> tuple:
        """(kind, bits) the reference books for one leaf's uplink: the staged
        payload's dtype-exact bits over the fleet, ÷ this transport's n."""
        R, L = _leaf_dims(shape)
        kb = max(1, L // 128)
        packed = self.packed_payload
        if self.compression == "permk" and L % n == 0:
            vdt = torch.bfloat16 if packed else dtype
            return "all-to-all", _bits((n, R, L // n), vdt) / self.n
        if self.compression == "qsgd":
            s = int(self.qsgd_s)
            if packed and s <= 7 and L % 8 == 0:
                return "all-gather", (_bits((n, R, L // 8), torch.int32)
                                      + _bits((n, R, 1), torch.float32)) / self.n
            return "all-gather", (_bits((n, R, L), torch.int8)
                                  + _bits((n, R, 1), torch.float32)) / self.n
        if self.shared_mask:
            return "psum", _bits((n, R, kb), dtype) / self.n
        if packed:
            idt = torch.int32 if L > 32767 else torch.int16
            return "all-gather", (_bits((n, R, kb), torch.bfloat16)
                                  + _bits((n, R, kb), idt)) / self.n
        return "all-gather", (_bits((n, R, kb), dtype)
                              + _bits((n, R, kb), torch.int32)) / self.n

    def book_uplink(self, shapes: PyTree, rows_n: Optional[int] = None,
                    uploaded_rows: Optional[int] = None) -> None:
        """What :meth:`uplink_mean` books for parameter-shaped ``shapes``."""
        n = self.n if rows_n is None else rows_n
        frac = self._up_fraction(n, uploaded_rows)
        for t in tree_leaves(shapes):
            kind, bits = self._uplink_leaf_bits(n, tuple(t.shape), t.dtype)
            self.book("up", kind, bits * frac)

    def _worker_rows_leaf_bits(self, n: int, shape: tuple, dtype) -> float:
        R, L = _leaf_dims(shape)
        kb = max(1, L // 128)
        if self.compression == "qsgd":
            norm = _bits((n, R, 1), torch.float32)
            q = _bits((n, R, L), torch.int8)
            s = int(self.qsgd_s)
            if self.packed_payload and s <= 7 and L % 8 == 0:
                return (norm + q / 2) / self.n
            return (q + norm) / self.n
        return (_bits((n, R, kb), dtype) + _bits((n, R, kb), torch.int32)) / self.n

    def book_worker_rows(self, shapes: PyTree, rows_n: int,
                         uploaded_rows: Optional[int] = None) -> None:
        """What :meth:`worker_rows` books."""
        frac = self._up_fraction(rows_n, uploaded_rows)
        for t in tree_leaves(shapes):
            self.book("up", "all-gather",
                      self._worker_rows_leaf_bits(rows_n, tuple(t.shape), t.dtype) * frac)

    def book_downlink(self, shapes: PyTree) -> None:
        """What :meth:`downlink` books: the dense f32 broadcast, or the
        Q_down payload leaf by leaf."""
        mode, s = self.downlink_mode, self.downlink_s
        if mode == "none":
            d = sum(int(np.prod(t.shape)) for t in tree_leaves(shapes))
            self.book("down", "broadcast", wire.downlink_dense_bits(d))
            return
        for t in tree_leaves(shapes):
            R, L = _leaf_dims(tuple(t.shape))
            if mode == "qsgd":
                norm, q = _bits((R, 1), torch.float32), _bits((R, L), torch.int8)
                if self.packed_payload and s <= 7 and L % 8 == 0:
                    self.book("down", "broadcast", norm + q / 2)
                else:
                    self.book("down", "broadcast", q + norm)
            elif mode == "randk":
                self.book("down", "broadcast", _bits((R, max(1, L // 128)), torch.float32))
            else:
                raise ValueError(f"unknown downlink {mode!r}")

    # -- rows and splits ----------------------------------------------------

    def _local(self, n: int, rows_sharded: bool) -> range:
        """The rows of an n-row stack this rank holds."""
        return self.mesh.workers(n) if rows_sharded else range(n)

    def _parts(self, ax: str) -> tuple:
        """(ranks, this rank's index) along an inner axis ("model" / "fsdp")."""
        if ax == "model":
            return self.mesh.model, self.mesh.model_rank
        return self.mesh.fsdp, self.mesh.fsdp_rank

    def _leaf(self, j: int, leaf: torch.Tensor) -> tuple:
        """(whole per-row shape, :class:`_Split`) of leaf j of a stack; the
        leaf's own shape, held whole, on a rank that holds the whole model."""
        if self.leaf_shapes is None:
            return tuple(leaf.shape[1:]), _WHOLE
        shape = tuple(self.leaf_shapes[j])
        fd, md = self.leaf_dims[j]
        rows, col, rep = [], None, []
        for d, ax in ((fd, "fsdp"), (md, "model")):
            if self._parts(ax)[0] == 1:
                continue
            if d is None:
                rep.append(ax)
            elif d == len(shape) - 1:
                col = ax
            else:
                rows.append((d, ax))
        return shape, _Split(tuple(rows), col, tuple(rep))

    def _narrow(self, t: torch.Tensor, ax: int, lead: tuple, sp: "_Split") -> torch.Tensor:
        """A whole leaf's draw with its R = prod(``lead``) axis at ``ax`` →
        the rows of this rank's slices along the leading-dimension splits."""
        if not sp.rows:
            return t
        v = t.reshape(*t.shape[:ax], *lead, *t.shape[ax + 1:])
        for d, name in sp.rows:
            parts, i = self._parts(name)
            k = lead[d] // parts
            v = v.narrow(ax + d, i * k, k)
        return v.reshape(*t.shape[:ax], -1, *t.shape[ax + 1:])

    def _family(self, L: int, n: int) -> str:
        if self.compression == "permk" and L % n == 0:
            return "permk"
        if self.compression == "qsgd":
            return "qsgd"
        return "shared" if self.shared_mask else "randk"

    def _cols(self, L: int, ax: str) -> tuple:
        """This rank's columns [c0, c0 + Ll) of a leaf whose last dimension
        ``ax`` splits."""
        parts, i = self._parts(ax)
        Ll = L // parts
        return i * Ll, Ll

    def _gather(self, ax: str, t: torch.Tensor, dim: int) -> torch.Tensor:
        return getattr(self.mesh, f"{ax}_gather")(t, dim, kind=f"{ax}/wire")

    def _slice(self, ax: str, t: torch.Tensor, dim: int) -> torch.Tensor:
        return getattr(self.mesh, f"{ax}_slice")(t, dim)

    def _whole(self, leaf: torch.Tensor, shape: tuple, sp: "_Split",
               row_axis: bool = True) -> torch.Tensor:
        """A sharded stack (or tree leaf) gathered over both inner axes."""
        off = 1 if row_axis else 0
        if sp.col is not None:
            leaf = self._gather(sp.col, leaf, len(shape) - 1 + off)
        for d, ax in sp.rows:
            leaf = self._gather(ax, leaf, d + off)
        return leaf

    def _unwhole(self, t: torch.Tensor, shape: tuple, sp: "_Split",
                 row_axis: bool = True) -> torch.Tensor:
        """This rank's slices of a whole stack (or tree leaf)."""
        off = 1 if row_axis else 0
        if sp.col is not None:
            t = self._slice(sp.col, t, len(shape) - 1 + off)
        for d, ax in sp.rows:
            t = self._slice(ax, t, d + off)
        return t

    def _from_root(self, axes: tuple, compute: Callable, shape, dtype) -> torch.Tensor:
        """``compute()`` on the rank at index 0 of every axis in ``axes``
        (inner axes along which the ranks hold the same thing), broadcast
        over them: only that rank ships over the worker axis."""
        if not axes:
            return compute()
        idx = {ax: self._parts(ax)[1] for ax in axes}
        out = compute() if all(i == 0 for i in idx.values()) else None
        for k, ax in enumerate(axes):
            if all(idx[a] == 0 for a in axes[k + 1:]):
                out = getattr(self.mesh, f"{ax}_bcast")(out, shape, dtype,
                                                        kind=f"{ax}/broadcast")
        return out

    # -- sync exchange ------------------------------------------------------

    def sync_mean(self, grads: PyTree) -> PyTree:
        """Dense worker mean of this rank's stacked gradients (its
        :meth:`Mesh.workers` rows): one all-reduce over the packed (n, nblk,
        B) flat buffer under ``flat_sync`` where the mesh has a group, one a
        leaf otherwise; rows summed in worker order, then ÷ n. A leaf the
        ranks of an inner axis hold alike is shipped by index 0 of that axis
        and its mean broadcast. Books 32d up and 32d down."""
        leaves, treedef = tree_flatten(grads)
        self.book_sync(self._row_shapes(leaves))
        n, mesh = self.n, self.mesh
        if self.flat_sync and mesh.group is not None:
            lay = self.sync_layout
            if self.leaf_shapes is None:
                bufs = mesh.sum_rows(flat_engine.pack_stacked(lay, grads), n)
                return flat_engine.unpack(lay, mean_axis0(bufs))
            # this rank's slices: the whole stacks gathered over the inner
            # axes (what GSPMD's packing reshards), the buffer shipped by
            # their index 0 and its mean broadcast back, each rank keeping
            # its slices
            splits = [self._leaf(j, t) for j, t in enumerate(leaves)]
            whole = treedef.unflatten([self._whole(t, shape, sp)
                                       for t, (shape, sp) in zip(leaves, splits)])
            inner = tuple(a for a in ("fsdp", "model") if self._parts(a)[0] > 1)
            mean = self._from_root(
                inner, lambda: mean_axis0(mesh.sum_rows(flat_engine.pack_stacked(lay, whole),
                                                        n)),
                (lay.nblk, lay.block), lay.dtype)
            del whole
            got, _ = tree_flatten(flat_engine.unpack(lay, mean))
            return treedef.unflatten([self._unwhole(t, shape, sp, row_axis=False)
                                      for t, (shape, sp) in zip(got, splits)])
        out = []
        for j, t in enumerate(leaves):
            _shape, sp = self._leaf(j, t)
            out.append(self._from_root(sp.rep, lambda t=t: mean_axis0(mesh.sum_rows(t, n)),
                                       t.shape[1:], t.dtype))
        return treedef.unflatten(out)

    def _row_shapes(self, leaves: list) -> list:
        """The whole per-row shapes of a stack's leaves (meta tensors)."""
        return [_shape(self._leaf(j, t)[0]) for j, t in enumerate(leaves)]

    def combine(self, aggregator, stacked: PyTree) -> PyTree:
        """``aggregator.combine_stacked`` on this rank's slices of the
        workers' rows: a coordinate-wise rule runs on the slices; a rule
        that reads whole rows (Krum, norm clipping) runs on the rows
        gathered over the inner axes, and each rank keeps its slices."""
        if ((self.mesh.model == 1 and self.mesh.fsdp == 1)
                or aggregator.rule in ("trimmed_mean", "coordinate_median", "mean")):
            return aggregator.combine_stacked(stacked)
        leaves, treedef = tree_flatten(stacked)
        splits = [self._leaf(j, t) for j, t in enumerate(leaves)]
        whole = [self._whole(t, shape, sp) for t, (shape, sp) in zip(leaves, splits)]
        got, _ = tree_flatten(aggregator.combine_stacked(treedef.unflatten(whole)))
        return treedef.unflatten([self._unwhole(t, shape, sp, row_axis=False)
                                  for t, (shape, sp) in zip(got, splits)])

    def sync_aggregate(self, grads: PyTree, aggregator=None) -> PyTree:
        """Sync-round server aggregation: the robust rule on the whole
        worker gradient stack when one is configured, else
        :meth:`sync_mean`; the wire cost is the same either way."""
        if aggregator is not None and aggregator.robust:
            leaves, treedef = tree_flatten(grads)
            self.book_sync(self._row_shapes(leaves))
            full = treedef.unflatten([self.mesh.assemble_rows(t, self.n) for t in leaves])
            return self.combine(aggregator, full)
        return self.sync_mean(grads)

    # -- compressed uplink --------------------------------------------------

    def uplink_mean(self, key, diffs: PyTree, *, rows_n: Optional[int] = None,
                    rows_sharded: bool = True,
                    uploaded_rows: Optional[int] = None) -> PyTree:
        """Per-leaf compressed exchange across workers → dense mean update.

        Each leaf (rows, *shape) is (rows, R, L), L its last dimension; the
        gathers and the scatter act along L. Families, as the reference's:
        ``randk`` (kb = max(1, L // 128) offsets a row with replacement;
        ``packed_payload``: bf16 values + int16 offsets, int32 past L =
        32767), ``shared_mask`` (one mask for the fleet; the values cross an
        all-reduce), ``permk`` (one shared permutation partitions each
        leaf's lanes; values only; L % n ≠ 0 falls back to randk masks) and
        ``qsgd`` (int8 levels, 4-bit nibbles in 32-bit words with
        ``packed_payload`` and s ≤ 7, plus f32 row norms; the dequantize
        and mean in worker order).

        ``diffs`` holds this rank's rows of the stack (``rows_sharded``), or
        all ``rows_n`` rows on every rank (``rows_sharded=False``: PP cohort
        rows; nothing crosses the group). ``uploaded_rows`` scales the
        booking when some staged rows never crossed the wire."""
        n = self.n if rows_n is None else rows_n
        frac = self._up_fraction(n, uploaded_rows)
        rows = self._local(n, rows_sharded)

        leaves, treedef = tree_flatten(diffs)
        keys = prng.split(key, len(leaves))
        outs = []
        for j, (lk, leaf) in enumerate(zip(keys, leaves)):
            shape, sp = self._leaf(j, leaf)
            kind, bits = self._uplink_leaf_bits(n, shape, leaf.dtype)
            self.book("up", kind, bits * frac)
            outs.append(self._uplink_split(lk, leaf, shape, sp, n, rows, rows_sharded))
        return treedef.unflatten(outs)

    def _uplink_split(self, lk, leaf: torch.Tensor, shape: tuple, sp: "_Split", n: int,
                      rows: range, rows_sharded: bool) -> torch.Tensor:
        """One leaf's exchange on this rank's slices of it: leading-dimension
        splits narrow the rows; a split of the last dimension runs its
        family's column exchange; where the shared mask (or QSGD packed on
        columns that split a 32-bit word) meets a column split, the leaf is
        gathered over that axis first and its index 0 ships. The ranks of an
        axis that holds the leaf whole ship from its index 0."""
        R, L = _leaf_dims(shape)
        fam = self._family(L, n)
        rep, col = sp.rep, sp.col
        if col is not None and fam == "randk":
            compute = partial(self._uplink_cols, lk, leaf, shape, sp, n, rows, rows_sharded)
        elif col is not None and fam == "permk":
            compute = partial(self._permk_cols, lk, leaf, shape, sp, n, rows, rows_sharded)
        elif col is not None and fam == "qsgd" and self._qsgd_cols_ok(L, col):
            compute = partial(self._qsgd_cols, lk, leaf, shape, sp, n, rows, rows_sharded)
        elif col is not None:
            whole = self._gather(col, leaf, len(shape))
            flat = _Split(sp.rows, None, sp.rep)
            compute = partial(self._uplink_leaf, lk, whole, shape, flat, n, rows, rows_sharded)
            rep = (col,) + rep
        else:
            compute = partial(self._uplink_leaf, lk, leaf, shape, sp, n, rows, rows_sharded)
        if not rows_sharded:
            dense = compute()
        else:
            lshape = leaf.shape[1:] if col is None or rep[:1] != (col,) else \
                (*leaf.shape[1:-1], L)
            dense = self._from_root(rep, compute, lshape, leaf.dtype)
        if col is not None and rep[:1] == (col,):
            dense = self._slice(col, dense, len(shape) - 1)
        return dense

    def _uplink_leaf(self, lk, leaf: torch.Tensor, shape: tuple, sp: "_Split", n: int,
                     rows: range, rows_sharded: bool) -> torch.Tensor:
        """One leaf's exchange and dense mean (the one-rank arithmetic) on
        this rank's rows of it: all of them, or where leading dimensions
        split the rows this rank's (the draws narrowed to them)."""
        backend, packed, mesh = self.backend, self.packed_payload, self.mesh
        lead = shape[:-1]
        R, L = _leaf_dims(shape)
        kb = max(1, L // 128)
        dev = leaf.device
        x = leaf.reshape(len(rows), -1, L)
        Rl = x.shape[1]

        def narrow(t: torch.Tensor, ax: int) -> torch.Tensor:
            return self._narrow(t, ax, lead, sp)

        def exchange(t: torch.Tensor) -> torch.Tensor:
            return mesh.gather_rows(t, n) if rows_sharded else t

        fam = self._family(L, n)
        if fam == "permk":
            C = L // n
            perm = torch.from_numpy(prng.permutation(lk, L)).to(dev)
            idx = perm.reshape(n, 1, C)[rows.start:rows.stop].expand(len(rows), Rl, C)
            vals = _gather_along_last(x, idx, float(n), backend)
            sent = exchange(vals.to(torch.bfloat16) if packed else vals)
            # (n, R, C) → (R, n·C): slot w·C + c holds worker w's c-th value
            by_slot = sent.float().permute(1, 0, 2).reshape(Rl, L)
            dense = (by_slot[:, torch.argsort(perm)] / n).to(leaf.dtype)
        elif fam == "qsgd":
            s = int(self.qsgd_s)
            u = narrow(prng.uniform(lk, (n, R, L), device=dev)[rows.start:rows.stop], 1)
            q, norm = _qsgd_quantize_rows(u, x, s)
            del u
            if packed and s <= 7 and L % 8 == 0:
                words = kref.nibble_pack_ref(q.reshape(len(rows) * Rl, L))
                words = exchange(words.reshape(len(rows), Rl, L // 8))
                q = kref.nibble_unpack_ref(words.reshape(n * Rl, L // 8), L).reshape(n, Rl, L)
            else:
                q = exchange(q)
            norm = exchange(norm)
            # dequantize and mean: worker-indexed accumulation into one
            # (R, L) f32 buffer, in worker order
            acc = torch.zeros((Rl, L), dtype=torch.float32, device=dev)
            for w in range(n):
                acc = acc + q[w].float() * (norm[w] / s)
            dense = (acc / n).to(leaf.dtype)
        elif fam == "shared":
            idx = narrow(prng.randint(lk, (R, kb), 0, L, device=dev), 0)
            vals = _gather_along_last(x, idx.expand(len(rows), Rl, kb), L / kb, backend)
            full = mesh.sum_rows(vals, n) if rows_sharded else vals
            dense = _scatter_mean_last(mean_axis0(full)[None], idx[None], L,
                                       backend).to(leaf.dtype)
        else:
            idx = narrow(prng.randint(lk, (n, R, kb), 0, L, device=dev)[rows.start:rows.stop], 1)
            vals = _gather_along_last(x, idx, L / kb, backend)
            if packed:
                idx_wire = idx if L > 32767 else idx.to(torch.int16)
                vals = exchange(vals.to(torch.bfloat16)).to(leaf.dtype)
                idx = exchange(idx_wire).to(torch.int32)
            else:
                vals, idx = exchange(vals), exchange(idx)
            dense = _scatter_mean_last(vals, idx, L, backend).to(leaf.dtype)
        return dense.reshape(leaf.shape[1:])

    def _qsgd_cols_ok(self, L: int, col: str) -> bool:
        """Whether a rank's columns pack to whole 4-bit words (or the wire
        is unpacked int8)."""
        packed = self.packed_payload and int(self.qsgd_s) <= 7 and L % 8 == 0
        return not packed or (L // self._parts(col)[0]) % 8 == 0

    def _qsgd_cols(self, lk, leaf: torch.Tensor, shape: tuple, sp: "_Split", n: int,
                   rows: range, rows_sharded: bool) -> torch.Tensor:
        """QSGD on a column-split leaf: each worker's whole rows gathered
        over the column axis, so the row norm is one rank's, bit for bit;
        each rank ships its columns' levels, the column axis's index 0 the
        norms (broadcast over it); the dequantize and mean run in worker
        order on the rank's columns."""
        mesh, s, col = self.mesh, int(self.qsgd_s), sp.col
        R, L = _leaf_dims(shape)
        c0, Ll = self._cols(L, col)
        dev = leaf.device
        x = leaf.reshape(len(rows), -1, Ll)
        Rl = x.shape[1]
        whole = self._gather(col, x, 2)
        u = self._narrow(prng.uniform(lk, (n, R, L), device=dev)[rows.start:rows.stop], 1,
                         shape[:-1], sp)
        q, norm = _qsgd_quantize_rows(u, whole, s)
        del u, whole
        q = q[..., c0:c0 + Ll].contiguous()

        def exchange(t: torch.Tensor) -> torch.Tensor:
            return mesh.gather_rows(t, n) if rows_sharded else t

        if self.packed_payload and s <= 7 and L % 8 == 0:
            words = kref.nibble_pack_ref(q.reshape(len(rows) * Rl, Ll))
            words = exchange(words.reshape(len(rows), Rl, Ll // 8))
            q = kref.nibble_unpack_ref(words.reshape(n * Rl, Ll // 8), Ll).reshape(n, Rl, Ll)
        else:
            q = exchange(q)
        if rows_sharded:
            norm = self._from_root((col,), lambda: exchange(norm), (n, Rl, 1), torch.float32)
        acc = torch.zeros((Rl, Ll), dtype=torch.float32, device=dev)
        for w in range(n):
            acc = acc + q[w].float() * (norm[w] / s)
        return (acc / n).to(leaf.dtype).reshape(leaf.shape[1:])

    def _group_sizes(self, n: int, per_worker: Callable) -> list:
        """Each worker group's element count of a ragged share, from the
        per-worker counts ``per_worker(w)``."""
        per = n // self.mesh.world
        return [sum(per_worker(w) for w in range(g * per, (g + 1) * per))
                for g in range(self.mesh.world)]

    def _permk_cols(self, lk, leaf: torch.Tensor, shape: tuple, sp: "_Split", n: int,
                    rows: range, rows_sharded: bool) -> torch.Tensor:
        """Perm-K on a column-split leaf: the permutation is over the whole
        L, so worker w's C lanes fall in this rank's columns in a number
        that differs from worker to worker; each rank gathers its workers'
        values there and the worker groups ship them (ragged, sized from the
        key), each lane decoded from its one worker."""
        mesh, backend = self.mesh, self.backend
        R, L = _leaf_dims(shape)
        c0, Ll = self._cols(L, sp.col)
        dev = leaf.device
        C = L // n
        lanes = torch.from_numpy(prng.permutation(lk, L)).reshape(n, C)
        mine = [lanes[w][(lanes[w] >= c0) & (lanes[w] < c0 + Ll)] - c0 for w in range(n)]
        x = leaf.reshape(len(rows), -1, Ll)
        Rl = x.shape[1]
        # a worker may have no lane in this rank's columns: nothing to gather
        vals = [_gather_along_last(x[i:i + 1], mine[w].to(dev, torch.int32).expand(1, Rl, -1),
                                   float(n), backend).reshape(-1) if len(mine[w])
                else x.new_empty((0,))
                for i, w in enumerate(rows)]
        if self.packed_payload:
            vals = [v.to(torch.bfloat16) for v in vals]
        if rows_sharded:
            sizes = self._group_sizes(n, lambda w: Rl * len(mine[w]))
            got = torch.cat(mesh.gather_ragged(torch.cat(vals), sizes))
            vals = list(got.split([Rl * len(m) for m in mine]))
        dense = torch.zeros((Rl, Ll), dtype=torch.float32, device=dev)
        for w in range(n):
            dense[:, mine[w].to(dev)] = vals[w].float().reshape(Rl, -1)
        return (dense / n).to(leaf.dtype).reshape(leaf.shape[1:])

    def _cols_draw(self, lk, shape: tuple, sp: "_Split", n: int, dev) -> tuple:
        """A column-split leaf's RandK draw: the (n, R, kb) offsets narrowed
        to this rank's rows, which of them fall in its columns, and their
        offsets there (the others sent to the dropped column Ll)."""
        R, L = _leaf_dims(shape)
        kb = max(1, L // 128)
        c0, Ll = self._cols(L, sp.col)
        idx = self._narrow(prng.randint(lk, (n, R, kb), 0, L, device=dev), 1, shape[:-1], sp)
        mine = (idx >= c0) & (idx < c0 + Ll)
        return idx, mine, torch.where(mine, idx - c0, torch.full_like(idx, Ll)), kb, Ll

    def _uplink_cols(self, lk, leaf: torch.Tensor, shape: tuple, sp: "_Split", n: int,
                     rows: range, rows_sharded: bool) -> torch.Tensor:
        """RandK on a column-split leaf: this rank gathers its workers'
        values at the offsets that fall in its columns, each worker group
        ships those values and offsets (ragged: every rank knows the counts
        from the key), and the scatter-mean runs at the rank's width."""
        mesh, backend, packed = self.mesh, self.backend, self.packed_payload
        R, L = _leaf_dims(shape)
        dev = leaf.device
        if dev.type == "meta":
            return self._uplink_cols_meta(lk, leaf, shape, sp, n, rows, rows_sharded)
        idx, mine, loc, kb, Ll = self._cols_draw(lk, shape, sp, n, dev)
        lo, hi = rows.start, rows.stop
        x = leaf.reshape(len(rows), -1, Ll)
        vals = _gather_along_last(x, loc[lo:hi].clamp(max=Ll - 1), L / kb, backend)
        if rows_sharded:
            sel = mine[lo:hi]
            send_v, send_i = vals[sel], idx[lo:hi][sel]
            if packed:
                send_v = send_v.to(torch.bfloat16)
                send_i = send_i if L > 32767 else send_i.to(torch.int16)
            counts = mine.reshape(n, -1).sum(1).tolist()
            sizes = self._group_sizes(n, lambda w: counts[w])
            got_v = torch.cat(mesh.gather_ragged(send_v, sizes))
            mesh.gather_ragged(send_i, sizes)   # the offsets cross as the ledger books them
            vals = torch.zeros(mine.shape, dtype=leaf.dtype, device=dev)
            vals[mine] = got_v.to(leaf.dtype)
        else:
            vals = torch.where(mine, vals, torch.zeros_like(vals))
        dense = _scatter_mean_last(vals, loc, Ll + 1, backend)[:, :Ll]
        return dense.to(leaf.dtype).reshape(leaf.shape[1:])

    def _uplink_cols_meta(self, lk, leaf: torch.Tensor, shape: tuple, sp: "_Split", n: int,
                          rows: range, rows_sharded: bool) -> torch.Tensor:
        """:meth:`_uplink_cols` on meta tensors (the dry run's stand-in): the
        ragged sizes are the key's, counted on the CPU (:func:`_cols_counts`),
        the exchanges carry meta tensors of those sizes."""
        mesh, packed = self.mesh, self.packed_payload
        R, L = _leaf_dims(shape)
        kb = max(1, L // 128)
        if rows_sharded:
            counts = _cols_counts(lk, shape, n, self._cols(L, sp.col),
                                  [(d, *self._parts(ax)) for d, ax in sp.rows])
            sizes = self._group_sizes(n, lambda w: counts[w])
            vdt = torch.bfloat16 if packed else leaf.dtype
            idt = torch.int32 if (not packed or L > 32767) else torch.int16
            mine = sizes[mesh.rank]
            mesh.gather_ragged(torch.empty((mine,), dtype=vdt, device="meta"), sizes)
            mesh.gather_ragged(torch.empty((mine,), dtype=idt, device="meta"), sizes)
        x = leaf.reshape(len(rows), -1, shape[-1] // self._parts(sp.col)[0])
        vals = _gather_along_last(x, torch.empty((n, x.shape[1], kb), dtype=torch.int32,
                                                 device="meta")[:len(rows)], L / kb, self.backend)
        dense = _scatter_mean_last(torch.empty((n, *vals.shape[1:]), dtype=vals.dtype,
                                               device="meta"),
                                   torch.empty((n, *vals.shape[1:]), dtype=torch.int32,
                                               device="meta"), x.shape[-1] + 1, self.backend)
        return dense[:, :x.shape[-1]].to(leaf.dtype).reshape(leaf.shape[1:])

    def worker_rows(self, key, diffs: PyTree, rows_n: int, *,
                    uploaded_rows: Optional[int] = None,
                    rows_sharded: bool = True) -> PyTree:
        """Per-worker DENSE payload rows — what the server received from each
        client before aggregation — for the robust rules, with the key
        discipline of :meth:`uplink_mean` (one split a leaf, the same draw
        shapes), so the honest rows carry exactly the values the mean would
        have averaged. Returns all ``rows_n`` rows on every rank
        (``rows_sharded``: this rank decodes its own rows, then the decoded
        rows are assembled). ``permk`` is refused upstream."""
        n = rows_n
        frac = self._up_fraction(n, uploaded_rows)
        rows = self._local(n, rows_sharded)
        mesh = self.mesh
        leaves, treedef = tree_flatten(diffs)
        keys = prng.split(key, len(leaves))
        out = []
        for j, (lk, leaf) in enumerate(zip(keys, leaves)):
            shape, sp = self._leaf(j, leaf)
            self.book("up", "all-gather",
                      self._worker_rows_leaf_bits(n, shape, leaf.dtype) * frac)
            R, L = _leaf_dims(shape)
            if sp.col == "model" and sp.rows == () and self.compression != "qsgd":
                # RandK on a column-sharded leaf: each worker's offsets in
                # this rank's columns, scattered at the rank's width
                _, mine, loc, kb, Ll = self._cols_draw(lk, shape, sp, n, leaf.device)
                loc = loc[rows.start:rows.stop]
                x = leaf.reshape(len(rows), R, Ll)
                vals = _gather_along_last(x, loc.clamp(max=Ll - 1), L / kb, self.backend)
                vals = torch.where(mine[rows.start:rows.stop], vals, torch.zeros_like(vals))
                dense = torch.stack([_scatter_mean_last(vals[i:i + 1], loc[i:i + 1], Ll + 1,
                                                        self.backend)[:, :Ll]
                                     for i in range(len(rows))])
            elif sp.col is not None:
                # the row norm (or a split in two dimensions): decode the
                # whole leaf, keep the slices
                whole = self._whole(leaf, shape, sp)
                dense = self._unwhole(self._worker_rows_leaf(
                    lk, whole, shape, _WHOLE, n, rows).reshape(whole.shape), shape, sp)
            else:
                dense = self._worker_rows_leaf(lk, leaf, shape, sp, n, rows)
            dense = dense.reshape(leaf.shape)
            out.append(mesh.assemble_rows(dense, n) if rows_sharded else dense)
        return treedef.unflatten(out)

    def _worker_rows_leaf(self, lk, leaf: torch.Tensor, shape: tuple, sp: "_Split",
                          n: int, rows: range) -> torch.Tensor:
        """One leaf's per-worker dense decode on this rank's rows of it (the
        slices' rows where leading dimensions split it)."""
        lead = shape[:-1]
        R, L = _leaf_dims(shape)
        kb = max(1, L // 128)
        dev = leaf.device
        x = leaf.reshape(len(rows), -1, L)

        def narrow(t: torch.Tensor, ax: int) -> torch.Tensor:
            return self._narrow(t, ax, lead, sp)

        if self.compression == "qsgd":
            s = int(self.qsgd_s)
            u = narrow(prng.uniform(lk, (n, R, L), device=dev)[rows.start:rows.stop], 1)
            q, norm = _qsgd_quantize_rows(u, x, s)
            if self.packed_payload and s <= 7 and L % 8 == 0:
                q = _nibble_roundtrip_rows(q)
            return q.float() * (norm / s)
        # independent Block-RandK masks
        idx = narrow(prng.randint(lk, (n, R, kb), 0, L, device=dev)[rows.start:rows.stop], 1)
        vals = _gather_along_last(x, idx, L / kb, self.backend)
        return torch.stack([_scatter_mean_last(vals[i:i + 1], idx[i:i + 1], L, self.backend)
                            for i in range(len(rows))])

    # -- compressed downlink ------------------------------------------------

    def downlink(self, key, delta: PyTree) -> PyTree:
        """Compressed downlink of the aggregated round delta: every rank
        holds the same delta and compresses it with the shared round key, so
        the replicas stay bitwise in step. "qsgd": per-row ℓ2-norm s-level
        quantization (4-bit nibbles with ``packed_payload`` and s ≤ 7);
        "randk": a seeded K-subsample (K = L/128 a row, values only);
        "none": the dense delta, booking the dense f32 broadcast."""
        mode = self.downlink_mode
        leaves, treedef = tree_flatten(delta)
        if mode == "none":
            self.book_downlink([_shape(self._leaf(j, t[None])[0])
                                for j, t in enumerate(leaves)])
            return delta
        keys = prng.split(key, len(leaves))
        outs = []
        for j, (lk, leaf) in enumerate(zip(keys, leaves)):
            shape, sp = self._leaf(j, leaf[None])
            self.book_downlink([_shape(shape)])
            if sp.col is None and not sp.rows:
                outs.append(self._downlink_leaf(lk, leaf))
            else:
                # the whole leaf's draw and row norms: compress it whole, keep the slices
                whole = self._whole(leaf, shape, sp, row_axis=False)
                outs.append(self._unwhole(self._downlink_leaf(lk, whole), shape, sp,
                                          row_axis=False))
        return treedef.unflatten(outs)

    def _downlink_leaf(self, lk, leaf: torch.Tensor) -> torch.Tensor:
        mode, s = self.downlink_mode, self.downlink_s
        R, L = _leaf_dims(tuple(leaf.shape))
        dev = leaf.device
        x = leaf.reshape(R, L).float()
        if mode == "qsgd":
            q, norm = _qsgd_quantize_rows(prng.uniform(lk, (R, L), device=dev), x, s)
            if self.packed_payload and s <= 7 and L % 8 == 0:
                q = _nibble_roundtrip_rows(q)
            y = q.float() * (norm / s)
        else:  # randk: plain PyTorch, as the reference's jnp
            kb = max(1, L // 128)
            idx = prng.randint(lk, (R, kb), 0, L, device=dev)
            vals = kref.randk_block_compress_ref(x, idx, L / kb)
            y = kref.scatter_accum_ref(vals[None], idx[None], L)
        return y.reshape(leaf.shape).to(leaf.dtype)


@dataclasses.dataclass(frozen=True)
class _Split:
    """How a leaf's whole per-row shape splits over this rank's inner axes:
    ``rows`` the leading-dimension splits ((dim, axis), …), ``col`` the axis
    that splits the last dimension (or None), ``rep`` the axes of more than
    one rank that hold it whole ("fsdp" before "model")."""

    rows: tuple = ()
    col: Optional[str] = None
    rep: tuple = ()


_WHOLE = _Split()


def _cols_counts(lk, shape: tuple, n: int, cols: tuple, row_splits: list) -> list:
    """Per worker, how many of a column-split leaf's RandK offsets (the
    (n, R, kb) draw under ``lk``, narrowed to the rows of ``row_splits``
    ((dim, parts, index), …)) fall in ``cols`` = (c0, Ll), for a run on meta
    tensors: the offsets hashed again from the key in chunks of rows, on the
    card where the process has one (the integer hash is exact anywhere; the
    CPU takes minutes at a 671 B model's widths), else on the CPU."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    R, L = _leaf_dims(shape)
    kb = max(1, L // 128)
    c0, Ll = cols
    lead = shape[:-1]
    rows = torch.arange(R, dtype=torch.int64).reshape(lead if lead else (1,))
    for d, parts, i in row_splits:
        k = lead[d] // parts
        rows = rows.narrow(d, i * k, k)
    rows = rows.reshape(-1).to(dev)
    lanes = torch.arange(kb, dtype=torch.int64, device=dev)
    k1, k2 = prng.split(lk)
    out = []
    step = max(1, (1 << (26 if dev.type == "cuda" else 22)) // kb)   # rows a chunk
    for w in range(n):
        total = 0
        for a in range(0, rows.numel(), step):
            counters = ((rows[a:a + step, None] + w * R) * kb + lanes).reshape(-1)
            idx = prng.randint_at(k1, k2, counters, 0, L)
            total += int(((idx >= c0) & (idx < c0 + Ll)).sum())
        out.append(total)
    return out


def make_transport(mesh: Mesh, topology: Topology, waxes: tuple, n: int, *,
                   backend: str = "auto", compression: str = "randk", qsgd_s: int = 15,
                   packed_payload: bool = False, shared_mask: bool = False,
                   downlink: str = "none", downlink_s: int = 7, flat_sync: bool = False,
                   sync_layout=None, param_shapes=None, fsdp: bool = False) -> Transport:
    """Build the per-bundle :class:`Transport` (wire policy, sync-exchange
    layout, a fresh tier ledger). The reference's GSPMD pins
    (``staged_payload``, ``sync_buf_shard``) have no counterpart: every rank
    stages its own workers' rows; ``param_shapes`` (whole meta shapes) give
    each leaf's data- and model-axis splits (``sharding.leaf_splits``) where
    the mesh's inner axes span ranks."""
    shapes = dims = None
    if param_shapes is not None and (mesh.model > 1 or mesh.fsdp > 1):
        from repro_torch.launch.sharding import leaf_splits

        shapes = [tuple(t.shape) for t in tree_leaves(param_shapes)]
        dims = leaf_splits(param_shapes, mesh, fsdp)
    return Transport(mesh=mesh, topology=topology, waxes=tuple(waxes), n=n, backend=backend,
                     compression=compression, qsgd_s=qsgd_s, packed_payload=packed_payload,
                     shared_mask=shared_mask,
                     downlink_mode=downlink, downlink_s=downlink_s, flat_sync=flat_sync,
                     sync_layout=sync_layout, leaf_shapes=shapes, leaf_dims=dims)
