"""Flat-buffer compression engine (port of ``repro.core.flat``).

* :class:`FlatLayout` — a static description of how a pytree maps onto one
  zero-padded ``(nblk, B)`` block buffer. Leaves sit at offsets in
  ``jax.tree.flatten`` order (:mod:`repro_torch.core.tree_util`), so the
  seeded offsets hit the same coordinates as in the reference.
* :class:`FlatEngine` — the fused compress → uplink → decompress-mean
  pipeline over that buffer, with one of five seeded wires:

  - ``randk``: per-worker payloads are ``(nblk, kb)`` values whose offsets
    the server regenerates from the worker's uint32 seed; aggregation
    scatter-accumulates into one ``(nblk, B)`` buffer.
  - ``permk``: ONE seed shared by all workers draws a per-block affine
    permutation that partitions every block; worker w uplinks its
    ``(nblk, B/n)`` share scaled by n, and the server assembles the mean by
    an inverse-permutation gather (no scatter, no collisions).
  - ``qsgd``: blockwise s-level ℓ2 QSGD on the packed wire; worker w's
    levels (int8, |level| ≤ s) and per-block f32 norms come from its uint32
    seed's murmur3 dither, cross the 4-bit nibble words when s ≤ 7, and the
    server dequantizes and averages them.
  - ``natural``: blockwise natural compression (ω = 1/8); |x| rounds
    stochastically to a power of two under the same dither stream, and
    worker w uplinks one int8 exponent-delta code per coordinate and one f32
    power-of-two scale per block; the server decodes and averages them.
  - ``randk_qsgd``: the RandK wire's kb coordinates per block, QSGD-quantized
    against the per-block norm of the sampled values (dither counters at
    ``DITHER_CTR_OFFSET``). The gather and the scatter-mean (or scatter
    epilogue) are the RandK kernels; the K-sized quantize and dequantize in
    between are plain PyTorch on the buffers' device, as in the reference,
    which has no kernel for that stage either.

  A second engine over the same layout (:func:`make_downlink`) compresses
  the server's broadcast: ``fused_round(down=…)`` and
  :meth:`FlatEngine.roundtrip_worker` send the aggregated round delta
  through it as one payload (n = 1).

Backends: ``ref`` runs the plain PyTorch versions on any device; ``cuda``
(CUDA tensors only) and ``auto`` call the kernel wrappers in
:mod:`repro_torch.kernels`, which launch the hand-written kernels on CUDA
tensors and run the plain versions on CPU tensors — so ``auto`` resolves to
``cuda`` for CUDA tensors and ``ref`` for CPU ones.

A robust ``aggregator`` (:class:`repro_torch.core.aggregators.ServerAggregator`)
replaces the mean by its rule over the per-worker decoded rows
(:meth:`FlatEngine.worker_dense`); on carry rounds the coordinate-wise rules
end in the ``trimmed_delta_epilogue`` / ``trimmed_sync_epilogue`` kernels,
Krum and norm-clip in the delta epilogue. PermK refuses: its workers
partition the coordinates.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import default_device
from repro_torch.kernels import epilogue as _epi
from repro_torch.kernels import permk as _permk
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import randk as _randk
from repro_torch.kernels import ref as _ref

from . import wire
from .tree_util import TreeDef, tree_flatten, tree_map

PyTree = Any

DEFAULT_BLOCK = 1024  # must be a power of two

BACKENDS = ("auto", "cuda", "ref")


def resolve_backend(backend: str = "auto", tensor: "torch.Tensor | None" = None) -> str:
    """'auto' → 'cuda' for a CUDA tensor, 'ref' for a CPU one. 'cuda' on a
    CPU tensor raises: the kernels run only on the card."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}, expected one of {BACKENDS}")
    on_cuda = tensor is not None and tensor.is_cuda
    if backend == "auto":
        return "cuda" if on_cuda else "ref"
    if backend == "cuda" and tensor is not None and not on_cuda:
        raise ValueError("backend 'cuda' needs CUDA tensors")
    return backend


# ---------------------------------------------------------------------------
# Static layout: pytree ↔ (nblk, B) padded block buffer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside the flat buffer (static metadata)."""

    offset: int
    size: int
    shape: tuple
    dtype: Any


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Precomputed static layout of a pytree over a padded block buffer.

    The tail ``padded - d`` entries are structural zeros."""

    treedef: TreeDef
    slots: tuple
    d: int          # true dimension Σ leaf sizes
    block: int      # B, a power of two
    nblk: int       # number of blocks = ceil(d / B)
    dtype: Any      # buffer compute dtype (leaves are cast in/out)

    @property
    def padded(self) -> int:
        return self.nblk * self.block


def make_layout(tree: PyTree, block: int = DEFAULT_BLOCK,
                dtype=torch.float32) -> FlatLayout:
    """Build the static layout for ``tree`` (shapes/dtypes only are read, so
    ``meta`` tensors work)."""
    if block <= 0 or block & (block - 1):
        raise ValueError("block must be a power of two")
    leaves, treedef = tree_flatten(tree)
    slots = []
    off = 0
    for leaf in leaves:
        size = int(np.prod(leaf.shape)) if leaf.shape else 1
        slots.append(LeafSlot(off, size, tuple(leaf.shape), leaf.dtype))
        off += size
    nblk = max(1, -(-off // block))
    return FlatLayout(treedef=treedef, slots=tuple(slots), d=off, block=block,
                      nblk=nblk, dtype=dtype)


def _pack(layout: FlatLayout, tree: PyTree, stacked: bool) -> torch.Tensor:
    leaves = layout.treedef.flatten_up_to(tree)
    lead = (leaves[0].shape[0],) if stacked else ()
    out = torch.zeros((*lead, layout.padded), dtype=layout.dtype,
                      device=leaves[0].device)
    for s, leaf in zip(layout.slots, leaves):
        out[..., s.offset : s.offset + s.size] = leaf.reshape(*lead, s.size)
    return out.reshape(*lead, layout.nblk, layout.block)


def pack(layout: FlatLayout, tree: PyTree) -> torch.Tensor:
    """Pytree → ``(nblk, B)`` padded buffer (leaves copied in, zero pad)."""
    return _pack(layout, tree, stacked=False)


def unpack(layout: FlatLayout, buf: torch.Tensor) -> PyTree:
    """Inverse of :func:`pack`; restores leaf shapes and dtypes. Leaves of
    the buffer's dtype are views into it."""
    flat = buf.reshape(-1)
    outs = [
        flat[s.offset : s.offset + s.size].reshape(s.shape).to(s.dtype)
        for s in layout.slots
    ]
    return layout.treedef.unflatten(outs)


def pack_stacked(layout: FlatLayout, tree: PyTree) -> torch.Tensor:
    """Worker-stacked pytree (leading axis n) → ``(n, nblk, B)``."""
    return _pack(layout, tree, stacked=True)


# ---------------------------------------------------------------------------
# Backend-switched block primitives (what the launch layer calls; the
# engine below calls the wrappers itself)
# ---------------------------------------------------------------------------


def seeded_offsets(seed: int, nblk: int, block: int, kb: int,
                   device=None) -> torch.Tensor:
    """(nblk, kb) int32 offsets in [0, block) from the murmur3 counter RNG,
    the ones the seeded kernel samples for ``seed``. On ``cuda`` unless
    ``device`` names another."""
    seeds = torch.tensor([int(seed) & 0xFFFFFFFF], dtype=torch.int64,
                         device=default_device(device))
    return _ref.seeded_offsets_ref(seeds, nblk, block, kb)[0]


def _kernel(backend: str, tensor: torch.Tensor, wrapper, plain):
    """The kernel wrapper, or its plain version under backend 'ref' ('cuda'
    with a CPU tensor raises); on CPU tensors the wrappers return their plain
    versions themselves."""
    resolve_backend(backend, tensor)
    return plain if backend == "ref" else wrapper


def block_compress(x2d: torch.Tensor, seed: int, kb: int, scale: float,
                   backend: str = "auto"):
    """Seeded RandK over one block buffer under one uint32 seed: (nblk, B) →
    values (x's dtype) and int32 offsets, both (nblk, kb); the offsets are
    :func:`seeded_offsets` of the seed."""
    fn = _kernel(backend, x2d, _randk.randk_seeded, _ref.randk_seeded_ref)
    return fn(x2d, int(seed) & 0xFFFFFFFF, kb, scale)


def block_compress_workers(x3d: torch.Tensor, seeds, kb: int, scale: float,
                           backend: str = "auto"):
    """Per-worker seeded RandK: (n, nblk, B) f32 + (n,) uint32 seeds →
    values and offsets, both (n, nblk, kb)."""
    fn = _kernel(backend, x3d, _randk.randk_seeded_workers, _ref.randk_seeded_workers_ref)
    return fn(x3d, _randk.seeds_tensor(seeds, x3d.device), kb, scale)


def block_gather(x2d: torch.Tensor, offsets: torch.Tensor, scale: float,
                 backend: str = "auto") -> torch.Tensor:
    """Gather and scale at host-supplied offsets: (nblk, B), (nblk, kb) int32
    → (nblk, kb) in x's dtype."""
    fn = _kernel(backend, x2d, _randk.randk_gather, _ref.randk_block_compress_ref)
    return fn(x2d, offsets, scale)


def block_scatter_mean(values: torch.Tensor, offsets: torch.Tensor, block: int,
                       backend: str = "auto") -> torch.Tensor:
    """Scatter-accumulate mean over workers: (n, nblk, kb) ×2 → (nblk, block)
    f32; the only dense buffer is the one accumulator."""
    fn = _kernel(backend, values, _randk.scatter_accum, _ref.scatter_accum_ref)
    return fn(values, offsets, block)


def block_permk_workers(x3d: torch.Tensor, seed: int, backend: str = "auto"):
    """PermK uplink under ONE shared seed: (n, nblk, B) → values and offsets
    (n, nblk, B/n); the n workers' offsets partition every block."""
    fn = _kernel(backend, x3d, _permk.permk_seeded_workers, _ref.permk_seeded_workers_ref)
    return fn(x3d, int(seed) & 0xFFFFFFFF)


def permk_concat_mean(values: torch.Tensor, seed: int, block: int,
                      backend: str = "auto") -> torch.Tensor:
    """Scatter-free PermK aggregation: (n, nblk, B/n) payloads → (nblk, B)
    mean by concatenation and an inverse-permutation gather (plain PyTorch
    on every backend, as in the reference)."""
    resolve_backend(backend, values)
    return _ref.permk_concat_mean_ref(values, int(seed) & 0xFFFFFFFF, block)


def block_qsgd_workers(x3d: torch.Tensor, seeds, s: int, backend: str = "auto"):
    """Blockwise QSGD uplink: (n, nblk, B) + (n,) seeds → levels (n, nblk,
    B) int8 and per-block norms (n, nblk) f32."""
    fn = _kernel(backend, x3d, _quant.qsgd_block_workers, _ref.qsgd_block_workers_ref)
    return fn(x3d, _randk.seeds_tensor(seeds, x3d.device), s)


def block_qsgd_dequant_mean(levels: torch.Tensor, norms: torch.Tensor, s: int,
                            backend: str = "auto") -> torch.Tensor:
    """Dequantize-and-mean: (n, nblk, B) int8 + (n, nblk) f32 → (nblk, B) f32."""
    fn = _kernel(backend, levels, _quant.qsgd_dequant_mean, _ref.qsgd_dequant_mean_ref)
    return fn(levels, norms, s)


def block_natural_workers(x3d: torch.Tensor, seeds, backend: str = "auto"):
    """Blockwise natural-compression uplink: (n, nblk, B) + (n,) seeds →
    codes (n, nblk, B) int8 and scales (n, nblk) f32."""
    fn = _kernel(backend, x3d, _quant.natural_block_workers, _ref.natural_block_workers_ref)
    return fn(x3d, _randk.seeds_tensor(seeds, x3d.device))


def block_natural_dequant_mean(codes: torch.Tensor, scales: torch.Tensor,
                               backend: str = "auto") -> torch.Tensor:
    """Decode-and-mean of natural payloads → (nblk, B) f32."""
    fn = _kernel(backend, codes, _quant.natural_dequant_mean, _ref.natural_dequant_mean_ref)
    return fn(codes, scales)


def key_to_seed(key) -> int:
    """PRNG key → uint32 seed for the counter-based kernel RNG."""
    return prng.key_to_seed(key)


def seeded_payload_bits(nblk: int, kb: int) -> float:
    """Wire bits of one seeded-RandK payload (:mod:`repro_torch.core.wire`)."""
    return wire.seeded_randk_bits(nblk, kb)


def nibble_roundtrip(levels: torch.Tensor, block: int,
                     backend: str = "auto") -> torch.Tensor:
    """Push (n, nblk, B) int8 levels through the 4-bit wire: pack eight to a
    32-bit word, then unpack with sign extension. The identity on levels in
    [−8, 7]; running it keeps the pipeline honest about what the wire
    carries. Backends as for the engine: 'ref' runs the plain versions, the
    others the kernel wrappers."""
    n, nblk, B = levels.shape
    if B != block:
        raise ValueError(f"levels last dim {B} != wire block width {block}")
    resolve_backend(backend, levels)  # 'cuda' with a CPU tensor raises
    if backend == "ref":
        pack_fn, unpack_fn = _ref.nibble_pack_ref, _ref.nibble_unpack_ref
    else:
        pack_fn, unpack_fn = _quant.nibble_pack, _quant.nibble_unpack
    words = pack_fn(levels.reshape(n * nblk, B))
    return unpack_fn(words, B).reshape(n, nblk, B)


# ---------------------------------------------------------------------------
# The fused engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlatEngine:
    """Fused compressed-round pipeline over a packed flat buffer.

    ``randk``: worker w's seed is derived from the round key as the
    reference derives it (``split`` then ``bits``) and its counter stream
    restarts at 0; sampling is with replacement, ω = B/kb. ``permk``: one
    seed from the round key (``bits``) for all workers; ``kb`` is unused,
    and the worker count must divide B. ``qsgd``: per-worker seeds as for
    randk, ``s`` levels; ``kb`` is unused. ``natural``: per-worker seeds;
    ``kb`` and ``s`` are unused. ``randk_qsgd``: per-worker seeds, ``kb``
    coordinates per block, ``s`` levels."""

    layout: FlatLayout
    kb: int = 8
    backend: str = "auto"
    sampler: str = "randk"
    s: int = 7              # quantization levels of the qsgd-family samplers
    #: the device the engine's buffers live on (None: whatever it is given)
    device: Any = None

    SAMPLERS = ("randk", "permk", "qsgd", "natural", "randk_qsgd")
    #: the samplers whose wire splits at the rows (:meth:`encode_rows`)
    SPLIT_WIRE = ("randk", "permk", "qsgd")

    def __post_init__(self):
        if self.sampler not in self.SAMPLERS:
            raise ValueError(f"unknown sampler {self.sampler!r} (one of {self.SAMPLERS})")
        if self.sampler in ("qsgd", "randk_qsgd") and not 1 <= self.s <= wire.INT8_MAX_S:
            raise ValueError(f"s={self.s} does not fit the int8 wire")
        resolve_backend(self.backend)

    def worker_seeds(self, key, n: int) -> np.ndarray:
        """(n,) uint32 seeds, mirroring the tree path's per-worker key split."""
        return np.array([prng.key_to_seed(k) for k in prng.split(key, n)],
                        dtype=np.uint32)

    def _shared_seed(self, key) -> int:
        """ONE uint32 seed for the correlated (PermK) sampler."""
        return prng.key_to_seed(key)

    @property
    def scale(self) -> float:
        return self.layout.block / self.kb

    @property
    def omega(self) -> float:
        """Def-1.1 ω of one worker's sampler. PermK's is collection-level
        (n − 1): ask the compressor. Composition: 1 + ω multiplies over
        independent stages, the QSGD stage acting on the kb sampled values."""
        B = self.layout.block
        if self.sampler == "permk":
            raise ValueError("PermK ω is n − 1; ask the compressor")
        if self.sampler == "qsgd":
            return min(B / self.s**2, float(np.sqrt(B)) / self.s)
        if self.sampler == "natural":
            return 1.0 / 8.0
        if self.sampler == "randk_qsgd":
            w_q = min(self.kb / self.s**2, float(np.sqrt(self.kb)) / self.s)
            return (1.0 + B / self.kb) * (1.0 + w_q) - 1.0
        return B / self.kb

    def payload_bits(self, n: "int | None" = None) -> float:
        """Wire bits per worker per compressed round (wire.py). A permk
        engine needs the worker count: its share is B/n of every block."""
        lay = self.layout
        if self.sampler == "permk":
            if n is None:
                raise ValueError("permk payload_bits needs the worker count")
            if lay.block % n:
                raise ValueError("worker count must divide the block width")
            return wire.permk_bits(lay.padded, n)
        if self.sampler == "qsgd":
            return wire.block_qsgd_bits(lay.nblk, lay.block, self.s)
        if self.sampler == "natural":
            return wire.block_natural_bits(lay.nblk, lay.block)
        if self.sampler == "randk_qsgd":
            return wire.randk_qsgd_bits(lay.nblk, self.kb, self.s)
        return wire.seeded_randk_bits(lay.nblk, self.kb)

    # -- stages -------------------------------------------------------------
    def compress_stacked(self, seeds, bufs: torch.Tensor):
        """(n, nblk, B) + (n,) uint32 seeds → per-worker payloads
        (values, offsets), both (n, nblk, kb)."""
        fn = (_ref.randk_seeded_workers_ref if self._plain(bufs)
              else _randk.randk_seeded_workers)
        return fn(bufs, _randk.seeds_tensor(seeds, bufs.device), self.kb, self.scale)

    def decompress_mean(self, vals: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """(n, nblk, kb) payloads → (nblk, B) dense mean over workers."""
        fn = _ref.scatter_accum_ref if self._plain(vals) else _randk.scatter_accum
        return fn(vals, offs, self.layout.block)

    # -- per-worker dense decode (robust aggregation) -----------------------
    def worker_dense(self, key, bufs: torch.Tensor, n: int) -> torch.Tensor:
        """Each worker's payload decoded densely: (n, nblk, B) diffs → (n, nblk,
        B) f32 rows Q_i(Δ_i), from the seeds and payloads :meth:`aggregate`
        uses. RandK and QSGD: the wire of :meth:`encode_rows`, decoded by
        :meth:`decode_rows`; natural: the uplink kernel, then the plain
        decode; RandK∘QSGD: the RandK kernel and the plain K-sized QSGD
        stage, then one scatter-mean kernel per worker at n = 1. PermK
        raises: its workers partition the coordinates, so there is no
        per-coordinate sample to aggregate robustly."""
        if self.sampler == "natural":  # worker by worker: the decode's temporaries
            codes, scales = self._natural_payloads(key, bufs, n)
            rows = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
            for w in range(codes.shape[0]):
                rows[w] = _ref.natural_decode_ref(codes[w], scales[w])
            return rows
        if self.sampler == "randk_qsgd":
            return self._scatter_rows(*self._sampled_payloads(key, bufs, n))
        return self.decode_rows(self.encode_rows(key, bufs, range(n), n), n)

    # -- the hot path -------------------------------------------------------
    def fused_delta(self, key, diffs: PyTree, n: int, aggregator=None) -> PyTree:
        """Compressed-round aggregate: worker-stacked diff tree → mean Q tree
        (or the robust ``aggregator``'s rule over the decoded rows)."""
        bufs = pack_stacked(self.layout, diffs)
        return unpack(self.layout, self.aggregate(key, bufs, n, aggregator))

    def aggregate(self, key, bufs: torch.Tensor, n: int, aggregator=None) -> torch.Tensor:
        """Server-side aggregate over packed diffs: (n, nblk, B) → (nblk, B).
        RandK, PermK and QSGD: every row through the split wire
        (:meth:`encode_rows`, then :meth:`decode_mean`). A robust
        ``aggregator`` combines :meth:`worker_dense`'s rows."""
        if self.sampler in self.SPLIT_WIRE:
            return self.decode_mean(self.encode_rows(key, bufs, range(n), n), n, aggregator)
        if aggregator is not None and aggregator.robust:
            return aggregator.combine_rows(self.worker_dense(key, bufs, n))
        if self.sampler == "natural":
            codes, scales = self._natural_payloads(key, bufs, n)
            fn = (_ref.natural_dequant_mean_ref if self._plain(codes)
                  else _quant.natural_dequant_mean)
            return fn(codes, scales)
        return self.decompress_mean(*self._sampled_payloads(key, bufs, n))

    # -- the split wire: rows encoded where they form, decoded everywhere --
    def encode_rows(self, key, bufs: torch.Tensor, rows, n: int) -> dict:
        """The payloads of rows ``rows`` of an n-row stack, from their packed
        diffs ``bufs`` (len(rows), nblk, B), under the seeds :meth:`aggregate`
        gives those rows. Returns the tensors that cross the wire, each with
        a leading row axis — randk: ``values`` and ``seeds``; permk: the
        ``values`` of the rows' shares and the shared ``seeds``; qsgd:
        ``norms`` and the 4-bit ``words`` (s ≤ 7) or int8 ``levels`` — and,
        for randk, the rows' ``offsets``, which never cross: a receiver
        regenerates them from the seeds (:meth:`decode_mean`)."""
        rows = [int(i) for i in rows]
        if self.sampler not in self.SPLIT_WIRE:
            raise ValueError(f"no split wire for sampler {self.sampler!r}")
        if not rows:
            return self._empty_payload(n, bufs.device)
        seeds = (np.full(len(rows), self._shared_seed(key), dtype=np.uint32)
                 if self.sampler == "permk" else self.worker_seeds(key, n)[rows])
        seeds_t = _randk.seeds_tensor(seeds, bufs.device)
        if self.sampler == "randk":
            vals, offs = self.compress_stacked(seeds, bufs)
            return {"values": vals, "seeds": seeds_t, "offsets": offs}
        if self.sampler == "permk":
            # the kernel numbers the shares by row: a part of the stack sits
            # at its rows of an n-row stack (zeros elsewhere: those rows are
            # computed and dropped)
            every = rows == list(range(n))
            full = bufs
            if not every:
                full = bufs.new_zeros((n,) + tuple(bufs.shape[1:]))
                full[rows] = bufs
            fn = (_ref.permk_seeded_workers_ref if self._plain(bufs)
                  else _permk.permk_seeded_workers)
            vals, _ = fn(full, int(seeds[0]))
            return {"values": vals if every else vals[rows], "seeds": seeds_t}
        fn = (_ref.qsgd_block_workers_ref if self._plain(bufs)
              else _quant.qsgd_block_workers)
        levels, norms = fn(bufs, seeds_t, self.s)
        m, nblk, B = levels.shape
        if self.s > wire.NIBBLE_MAX_S:
            return {"levels": levels, "norms": norms}
        pack = _ref.nibble_pack_ref if self._plain(bufs) else _quant.nibble_pack
        return {"words": pack(levels.reshape(m * nblk, B)).reshape(m, nblk, B // 8),
                "norms": norms}

    def _empty_payload(self, n: int, device) -> dict:
        """:meth:`encode_rows`' tensors for a rank that holds no row."""
        nblk, B = self.layout.nblk, self.layout.block

        def empty(*shape, dtype=torch.float32):
            return torch.empty((0, *shape), dtype=dtype, device=device)

        if self.sampler == "randk":
            return {"values": empty(nblk, self.kb), "seeds": empty(dtype=torch.int32),
                    "offsets": empty(nblk, self.kb, dtype=torch.int32)}
        if self.sampler == "permk":
            return {"values": empty(nblk, B // n), "seeds": empty(dtype=torch.int32)}
        if self.s > wire.NIBBLE_MAX_S:
            return {"levels": empty(nblk, B, dtype=torch.int8), "norms": empty(nblk)}
        return {"words": empty(nblk, B // 8, dtype=torch.int32), "norms": empty(nblk)}

    def decode_mean(self, payload: dict, n: int, aggregator=None, rows=None) -> torch.Tensor:
        """All n rows' payloads (:meth:`encode_rows`, rows in order 0..n−1)
        → (nblk, B): the mean :meth:`aggregate` takes, bit for bit, or the
        robust ``aggregator``'s rule over :meth:`decode_rows`. RandK
        ``offsets`` in ``payload`` are those of rows ``rows`` (default: all
        n); the other rows' come from their seeds."""
        if aggregator is not None and aggregator.robust:
            return aggregator.combine_rows(self.decode_rows(payload, n, rows))
        if self.sampler == "randk":
            return self.decompress_mean(payload["values"], self._offsets(payload, n, rows))
        if self.sampler == "permk":
            seed = int(payload["seeds"][0]) & 0xFFFFFFFF
            return _ref.permk_concat_mean_ref(payload["values"], seed, self.layout.block)
        levels = self._levels(payload, n)
        fn = (_ref.qsgd_dequant_mean_ref if self._plain(levels)
              else _quant.qsgd_dequant_mean)
        return fn(levels, payload["norms"], self.s)

    def decode_rows(self, payload: dict, n: int, rows=None) -> torch.Tensor:
        """All n rows' payloads → (n, nblk, B) f32 rows Q_i(Δ_i): RandK one
        scatter-mean kernel per row at n = 1, QSGD levels·(norm/s). PermK
        raises (its rows partition the coordinates)."""
        if self.sampler == "permk":
            raise ValueError("PermK partitions coordinates across workers; robust "
                             "aggregation is undefined on its payloads")
        if self.sampler == "randk":
            return self._scatter_rows(payload["values"], self._offsets(payload, n, rows))
        return self._levels(payload, n).float().mul_(
            _ref.div_n(payload["norms"], self.s)[..., None])

    def _offsets(self, payload: dict, n: int, rows=None) -> torch.Tensor:
        """The n rows' RandK offsets: ``payload``'s for rows ``rows``
        (default: all n), the rest regenerated from their seeds in one
        batched call (:func:`seeded_offsets` of each)."""
        offs = payload.get("offsets")
        if offs is None:
            have = []
        else:
            have = list(range(n)) if rows is None else [int(j) for j in rows]
        if len(have) == n:
            return offs
        seeds = payload["seeds"]
        rest = torch.as_tensor([j for j in range(n) if j not in have], device=seeds.device)
        out = torch.empty((n, self.layout.nblk, self.kb), dtype=torch.int32,
                          device=seeds.device)
        out[rest] = _ref.seeded_offsets_ref(seeds[rest], self.layout.nblk,
                                            self.layout.block, self.kb)
        if have:
            out[torch.as_tensor(have, device=seeds.device)] = offs
        return out

    def _levels(self, payload: dict, n: int) -> torch.Tensor:
        """The n rows' QSGD levels (n, nblk, B) int8, unpacked from the 4-bit
        words where the wire carries them."""
        if "levels" in payload:
            return payload["levels"]
        words, lay = payload["words"], self.layout
        unpack = _ref.nibble_unpack_ref if self._plain(words) else _quant.nibble_unpack
        return unpack(words.reshape(n * lay.nblk, -1), lay.block).reshape(
            n, lay.nblk, lay.block)

    def _scatter_rows(self, vals: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """Each row's RandK payload decoded densely: one scatter-mean at n = 1
        a row."""
        return torch.stack([self.decompress_mean(vals[w:w + 1], offs[w:w + 1])
                            for w in range(vals.shape[0])])

    def _qsgd_payloads(self, key, bufs: torch.Tensor, n: int):
        """Every worker's QSGD payload (levels, norms), the levels through the
        4-bit words when s ≤ 7."""
        payload = self.encode_rows(key, bufs, range(n), n)
        return self._levels(payload, n), payload["norms"]

    def _natural_payloads(self, key, bufs: torch.Tensor, n: int):
        """Every worker's natural payload (codes, scales)."""
        seeds = _randk.seeds_tensor(self.worker_seeds(key, n), bufs.device)
        fn = (_ref.natural_block_workers_ref if self._plain(bufs)
              else _quant.natural_block_workers)
        return fn(bufs, seeds)

    def _sampled_payloads(self, key, bufs: torch.Tensor, n: int):
        """Every worker's RandK payload (values, offsets) through the RandK
        kernel; for ``randk_qsgd`` the values then cross the QSGD stage (K
        int8 levels and nblk norms per worker, plain PyTorch: the stage
        touches kb ≪ B values per block) and come back dequantized."""
        seeds = self.worker_seeds(key, n)
        vals, offs = self.compress_stacked(seeds, bufs)
        if self.sampler == "randk_qsgd":
            levels, norms = _ref.qsgd_sampled_quantize_ref(
                vals, _randk.seeds_tensor(seeds, vals.device), self.s)
            vals = _ref.randk_qsgd_dequant_ref(levels, norms, self.s)
        return vals, offs

    def fused_round(self, key, diff_bufs: torch.Tensor, n: int, g2d: torch.Tensor,
                    x2d: torch.Tensor, gamma: float, down: "FlatEngine | None" = None,
                    down_key=None, aggregator=None):
        """Finish a compressed round in one sweep: sample the uplink payloads
        from the packed diffs, then the fused epilogue (scatter-mean or
        dequant-mean → ``g += δ`` → ``x −= γ·g``). Returns
        ``(g_new f32, x_new)``. PermK rounds assemble the dense delta first
        and end in the delta epilogue; ``randk_qsgd`` rounds end in the
        scatter epilogue on the dequantized values.

        With ``down`` (an engine over the same layout) the round is
        bidirectional: the uplink aggregates to the dense δ_up, the server
        broadcasts Q_down(δ_up) under ``down_key``, and the epilogue
        consumes that single payload (n = 1).

        A robust ``aggregator`` decodes the worker rows (:meth:`worker_dense`)
        and ends in the trimmed epilogue (trimmed mean, median) or, for Krum
        and norm-clip, in the delta epilogue on its combined row; under a
        downlink the uplink aggregate is past the rule before it is
        broadcast."""
        if down is not None:
            if (down.layout.block, down.layout.nblk) != (self.layout.block,
                                                          self.layout.nblk):
                raise ValueError("the downlink engine must share the uplink layout")
            if down.sampler == "permk":
                raise ValueError("PermK is a partition across n receivers; a broadcast "
                                 "downlink has one payload: use randk, qsgd or natural")
            delta = self.aggregate(key, diff_bufs, n, aggregator)
            return down.fused_round(down_key, delta[None], 1, g2d, x2d, gamma)
        if aggregator is not None and aggregator.robust:
            rows = self.worker_dense(key, diff_bufs, n)
            if aggregator.coordinatewise:
                fn = (_ref.trimmed_delta_epilogue_ref if self._plain(rows)
                      else _epi.trimmed_delta_epilogue)
                return fn(rows, g2d, x2d, gamma, *aggregator.trim_bounds(n))
            delta = aggregator.combine_rows(rows)
            del rows
            fn = _ref.delta_epilogue_ref if self._plain(delta) else _epi.delta_epilogue
            return fn(delta, g2d, x2d, gamma)
        if self.sampler == "qsgd":
            levels, norms = self._qsgd_payloads(key, diff_bufs, n)
            fn = _ref.qsgd_epilogue_ref if self._plain(levels) else _epi.qsgd_epilogue
            return fn(levels, norms, g2d, x2d, gamma, self.s)
        if self.sampler == "natural":
            codes, scales = self._natural_payloads(key, diff_bufs, n)
            fn = (_ref.natural_epilogue_ref if self._plain(codes)
                  else _epi.natural_epilogue)
            return fn(codes, scales, g2d, x2d, gamma)
        if self.sampler == "permk":
            delta = self.aggregate(key, diff_bufs, n)
            fn = _ref.delta_epilogue_ref if self._plain(delta) else _epi.delta_epilogue
            return fn(delta, g2d, x2d, gamma)
        vals, offs = self._sampled_payloads(key, diff_bufs, n)
        fn = _ref.scatter_epilogue_ref if self._plain(vals) else _epi.scatter_epilogue
        return fn(vals, offs, g2d, x2d, gamma)

    def fused_sync(self, grad_bufs: torch.Tensor, x2d: torch.Tensor, gamma: float,
                   aggregator=None):
        """Sync-round epilogue: worker mean of the packed gradients fused with
        the iterate update. Returns (g_new, x_new) like fused_round. A robust
        ``aggregator`` replaces the mean: the trimmed sync epilogue for the
        coordinate-wise rules; Krum and norm-clip combine the rows first and
        end in the delta epilogue with g = 0."""
        if aggregator is not None and aggregator.robust:
            n = grad_bufs.shape[0]
            if aggregator.coordinatewise:
                fn = (_ref.trimmed_sync_epilogue_ref if self._plain(grad_bufs)
                      else _epi.trimmed_sync_epilogue)
                return fn(grad_bufs, x2d, gamma, *aggregator.trim_bounds(n))
            g_agg = aggregator.combine_rows(grad_bufs)
            fn = _ref.delta_epilogue_ref if self._plain(g_agg) else _epi.delta_epilogue
            return fn(g_agg, torch.zeros_like(g_agg), x2d, gamma)
        fn = _ref.mean_epilogue_ref if self._plain(grad_bufs) else _epi.mean_epilogue
        return fn(grad_bufs, x2d, gamma)

    def roundtrip_worker(self, key, tree: PyTree) -> PyTree:
        """Q(x) of one payload through the whole pipeline (n = 1): the
        compressed downlink's broadcast of a dense tree."""
        return self.fused_delta(key, tree_map(lambda t: t[None], tree), 1)

    def _plain(self, buf: torch.Tensor) -> bool:
        """True for backend 'ref'; otherwise the kernel wrappers run. 'cuda'
        with a CPU buffer raises here."""
        if self.device is not None and buf.device.type != torch.device(self.device).type:
            raise ValueError(f"engine on {self.device} got a buffer on {buf.device}")
        resolve_backend(self.backend, buf)
        return self.backend == "ref"


def make_engine(params: PyTree, kb: int = 8, block: int = DEFAULT_BLOCK,
                backend: str = "auto", dtype=torch.float32,
                sampler: str = "randk", s: int = 7, device=None) -> FlatEngine:
    """Engine for a parameter tree: layout once, fused pipeline forever.
    Runs on ``cuda`` unless ``device`` names another (raises without a card)."""
    return FlatEngine(layout=make_layout(params, block=block, dtype=dtype),
                      kb=kb, backend=backend, sampler=sampler, s=s,
                      device=default_device(device))


def make_downlink(engine: FlatEngine, sampler: str = "qsgd",
                  kb: "int | None" = None, s: "int | None" = None) -> FlatEngine:
    """Downlink engine sharing ``engine``'s layout, backend and device: the
    server's compressor of Q_down(g^{k+1} − g^k). PermK is refused at use
    time (a broadcast has one payload, not an n-partition)."""
    return dataclasses.replace(engine, sampler=sampler,
                               kb=engine.kb if kb is None else kb,
                               s=engine.s if s is None else s)
