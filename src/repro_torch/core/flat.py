"""Flat-buffer compression engine (port of ``repro.core.flat``).

* :class:`FlatLayout` — a static description of how a pytree maps onto one
  zero-padded ``(nblk, B)`` block buffer. Leaves sit at offsets in
  ``jax.tree.flatten`` order (:mod:`repro_torch.core.tree_util`), so the
  seeded offsets hit the same coordinates as in the reference.
* :class:`FlatEngine` — the fused compress → uplink → decompress-mean
  pipeline over that buffer, with one of two seeded wires:

  - ``randk``: per-worker payloads are ``(nblk, kb)`` values whose offsets
    the server regenerates from the worker's uint32 seed; aggregation
    scatter-accumulates into one ``(nblk, B)`` buffer.
  - ``permk``: ONE seed shared by all workers draws a per-block affine
    permutation that partitions every block; worker w uplinks its
    ``(nblk, B/n)`` share scaled by n, and the server assembles the mean by
    an inverse-permutation gather (no scatter, no collisions).

Backends: ``ref`` runs the plain PyTorch versions on any device; ``cuda``
(CUDA tensors only) and ``auto`` call the kernel wrappers in
:mod:`repro_torch.kernels`, which launch the hand-written kernels on CUDA
tensors and run the plain versions on CPU tensors — so ``auto`` resolves to
``cuda`` for CUDA tensors and ``ref`` for CPU ones.

The ``qsgd``, ``natural`` and ``randk_qsgd`` samplers are not ported yet
(``NotImplementedError``).
Robust aggregators and the compressed downlink are not ported yet (``Marina``
refuses them).
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
from repro_torch.kernels import randk as _randk
from repro_torch.kernels import ref as _ref

from . import wire
from .tree_util import TreeDef, tree_flatten

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
# Backend-switched block primitives
# ---------------------------------------------------------------------------


def seeded_offsets(seed: int, nblk: int, block: int, kb: int,
                   device=None) -> torch.Tensor:
    """(nblk, kb) int32 offsets in [0, block) from the murmur3 counter RNG,
    the ones the seeded kernel samples for ``seed``. On ``cuda`` unless
    ``device`` names another."""
    device = default_device(device)
    ctr = (torch.arange(kb, dtype=torch.int64, device=device)[None, :]
           + (torch.arange(nblk, dtype=torch.int64, device=device) * kb)[:, None])
    bits = _ref.murmur_bits_ref(int(seed) & 0xFFFFFFFF, ctr)
    return (bits & (block - 1)).to(torch.int32)


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
    and the worker count must divide B."""

    layout: FlatLayout
    kb: int = 8
    backend: str = "auto"
    sampler: str = "randk"
    #: the device the engine's buffers live on (None: whatever it is given)
    device: Any = None

    SAMPLERS = ("randk", "permk")

    def __post_init__(self):
        if self.sampler not in self.SAMPLERS:
            raise NotImplementedError(
                f"sampler {self.sampler!r} is not ported yet (only {self.SAMPLERS})")
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
        (n − 1): ask the compressor."""
        if self.sampler == "permk":
            raise ValueError("PermK ω is n − 1; ask the compressor")
        return self.layout.block / self.kb

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

    # -- the hot path -------------------------------------------------------
    def fused_delta(self, key, diffs: PyTree, n: int) -> PyTree:
        """Compressed-round aggregate: worker-stacked diff tree → mean Q tree."""
        bufs = pack_stacked(self.layout, diffs)
        return unpack(self.layout, self.aggregate(key, bufs, n))

    def aggregate(self, key, bufs: torch.Tensor, n: int) -> torch.Tensor:
        """Server-side aggregate over packed diffs: (n, nblk, B) → (nblk, B)."""
        if self.sampler == "permk":
            return self._permk_mean(key, bufs)
        vals, offs = self.compress_stacked(self.worker_seeds(key, n), bufs)
        return self.decompress_mean(vals, offs)

    def _permk_mean(self, key, bufs: torch.Tensor) -> torch.Tensor:
        """PermK uplink of every worker under ONE shared seed, then the
        scatter-free mean: an inverse-permutation gather in plain PyTorch on
        every backend, as in the reference (disjoint supports make the mean
        an assembly, not a sum)."""
        seed = self._shared_seed(key)  # shared: all workers, one permutation
        fn = (_ref.permk_seeded_workers_ref if self._plain(bufs)
              else _permk.permk_seeded_workers)
        vals, _ = fn(bufs, seed)
        return _ref.permk_concat_mean_ref(vals, seed, self.layout.block)

    def fused_round(self, key, diff_bufs: torch.Tensor, n: int, g2d: torch.Tensor,
                    x2d: torch.Tensor, gamma: float):
        """Finish a compressed round in one sweep: sample the uplink payloads
        from the packed diffs, then the fused epilogue (scatter-mean →
        ``g += δ`` → ``x −= γ·g``). Returns ``(g_new f32, x_new)``. PermK
        rounds assemble the dense delta first and end in the delta epilogue."""
        if self.sampler == "permk":
            delta = self._permk_mean(key, diff_bufs)
            fn = _ref.delta_epilogue_ref if self._plain(delta) else _epi.delta_epilogue
            return fn(delta, g2d, x2d, gamma)
        vals, offs = self.compress_stacked(self.worker_seeds(key, n), diff_bufs)
        fn = _ref.scatter_epilogue_ref if self._plain(vals) else _epi.scatter_epilogue
        return fn(vals, offs, g2d, x2d, gamma)

    def fused_sync(self, grad_bufs: torch.Tensor, x2d: torch.Tensor, gamma: float):
        """Sync-round epilogue: worker mean of the packed gradients fused with
        the iterate update. Returns (g_new, x_new) like fused_round."""
        fn = _ref.mean_epilogue_ref if self._plain(grad_bufs) else _epi.mean_epilogue
        return fn(grad_bufs, x2d, gamma)

    def _plain(self, buf: torch.Tensor) -> bool:
        """True for backend 'ref'; otherwise the kernel wrappers run. 'cuda'
        with a CPU buffer raises here."""
        if self.device is not None and buf.device.type != torch.device(self.device).type:
            raise ValueError(f"engine on {self.device} got a buffer on {buf.device}")
        resolve_backend(self.backend, buf)
        return self.backend == "ref"


def make_engine(params: PyTree, kb: int = 8, block: int = DEFAULT_BLOCK,
                backend: str = "auto", dtype=torch.float32,
                sampler: str = "randk", device=None) -> FlatEngine:
    """Engine for a parameter tree: layout once, fused pipeline forever.
    Runs on ``cuda`` unless ``device`` names another (raises without a card)."""
    return FlatEngine(layout=make_layout(params, block=block, dtype=dtype),
                      kb=kb, backend=backend, sampler=sampler,
                      device=default_device(device))
