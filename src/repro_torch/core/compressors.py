"""Unbiased quantization operators (Def. 1.1) — port of
``repro.core.compressors`` for the compressors of the main path.

Every compressor exposes ``omega(d)``, ``expected_density(d)``,
``payload_bits(d)`` and ``default_p(d)``, and compresses a flat vector under
an explicit PRNG key (:mod:`repro_torch.prng`), drawing exactly the bits the
reference draws. :func:`tree_compress` lifts a compressor to pytrees leaf by
leaf (Block-RandK semantics).

Every compressor of the reference: ``Identity``, ``RandK``,
``SharedRandK`` (one index key for every worker of a round),
``BlockRandK``, the packed-wire ``BlockQSGD`` and ``BlockNatural``, the
per-leaf ``QSGD`` and ``NaturalCompression``, the biased ``TopK`` (for
EC-SGD) and the correlated collections ``PermK`` and ``CorrelatedQ``
(workers share one round key and are told their index:
:func:`tree_compress_worker`). ``ab_constants(d, n)`` gives the (A, B) of
the AB-inequality for an n-worker collection. Per-coordinate draws (RandK's
keys, the QSGD and natural dithers, CorrelatedQ's strata) are made on the
vector's device, bit-equal to ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import ref as _ref

from . import flat, wire
from .tree_util import tree_flatten, tree_leaves

Payload = Any
PyTree = Any


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base for stochastic mappings Q: R^d -> R^d (Def. 1.1 when unbiased)."""

    unbiased: bool = dataclasses.field(default=True, init=False)
    name: str = dataclasses.field(default="base", init=False)

    def omega(self, d: int) -> float:
        raise NotImplementedError

    def expected_density(self, d: int) -> float:
        raise NotImplementedError

    def payload_bits(self, d: int) -> float:
        """Bits per compressed vector of dimension d (32-bit value convention)."""
        raise NotImplementedError

    def default_p(self, d: int) -> float:
        """The paper's synchronization probability choice p = ζ_Q/d (Cor. 2.1)."""
        return min(1.0, max(self.expected_density(d) / max(d, 1), 1e-6))

    def ab_constants(self, d: int, n: int) -> tuple:
        """(A, B) of the AB-inequality for n independent copies of this Q:
        E‖(1/n)Σ Q_i(x_i) − x̄‖² ≤ A·(1/n)Σ‖x_i‖² − B·‖x̄‖² holds with
        ((1 + ω)/n, 1/n), whose A − B = ω/n recovers Thm 2.1. Correlated
        collections override it."""
        w = self.omega(d)
        return ((1.0 + w) / n, 1.0 / n)

    def compress(self, key, x: torch.Tensor) -> Payload:
        raise NotImplementedError

    def decompress(self, payload: Payload, d: int) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, key, x: torch.Tensor) -> torch.Tensor:
        """Q(x) as a dense vector (compress → decompress round trip)."""
        return self.decompress(self.compress(key, x), x.shape[0])


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    name: str = dataclasses.field(default="identity", init=False)

    def omega(self, d: int) -> float:
        return 0.0

    def expected_density(self, d: int) -> float:
        return float(d)

    def payload_bits(self, d: int) -> float:
        return 32.0 * d

    def compress(self, key, x):
        return {"dense": x}

    def decompress(self, payload, d):
        return payload["dense"]


def _randk_indices(key, d: int, k: int, device) -> torch.Tensor:
    """K uniform indices without replacement: top-K of iid uniform keys,
    ties to the lower index (as ``lax.top_k``)."""
    u = prng.uniform(key, (d,), device=device)
    return torch.sort(u, descending=True, stable=True).indices[:k]


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Uniform-K sparsification with scaling d/K. ``k`` is an absolute count
    (``k >= 1``) or a fraction of d (``0 < k < 1``)."""

    k: float = 1
    name: str = dataclasses.field(default="randk", init=False)

    def k_for(self, d: int) -> int:
        if self.k < 1:
            return max(1, int(round(self.k * d)))
        return min(int(self.k), d)

    def omega(self, d: int) -> float:
        return d / self.k_for(d) - 1.0

    def expected_density(self, d: int) -> float:
        return float(self.k_for(d))

    def payload_bits(self, d: int) -> float:
        return 64.0 * self.k_for(d)  # value (32b) + index (32b) per coordinate

    def compress(self, key, x):
        d = x.shape[0]
        k = self.k_for(d)
        idx = _randk_indices(key, d, k, x.device)
        scale = torch.tensor(d / k, dtype=x.dtype, device=x.device)
        return {"values": x[idx] * scale, "indices": idx}

    def decompress(self, payload, d):
        vals = payload["values"]
        out = torch.zeros((d,), dtype=vals.dtype, device=vals.device)
        return out.index_put_((payload["indices"],), vals, accumulate=True)


@dataclasses.dataclass(frozen=True)
class SharedRandK(RandK):
    """RandK whose workers share the round's index key: identical masks, so
    the workers' payloads sum on the same K indices. Each worker is still an
    unbiased ω = d/K − 1 quantization; the shared mask forfeits the 1/n
    variance averaging."""

    name: str = dataclasses.field(default="shared_randk", init=False)

    def ab_constants(self, d: int, n: int) -> tuple:
        """(1/n)Σ Q_M(x_i) = Q_M(x̄) for one mask M, so the aggregation
        error is at most ω‖x̄‖² ≤ ω·(1/n)Σ‖x_i‖²: (A, B) = (ω, 0)."""
        return (self.omega(d), 0.0)


def _pad_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """Flat (d,) → zero-padded (ceil(d/block), block)."""
    nblk = max(1, -(-x.shape[0] // block))
    return torch.nn.functional.pad(x, (0, nblk * block - x.shape[0])).reshape(
        nblk, block)


@dataclasses.dataclass(frozen=True)
class BlockRandK(Compressor):
    """Seeded blockwise RandK — the wire format of the flat engine.

    ``kb`` coordinates per ``block`` are drawn with replacement by the
    murmur3 counter RNG and scaled by ``block/kb``; the payload is
    ``{values, seed}`` (offsets regenerate from the seed), 32 + 32·K bits.
    ω = block/kb; ζ_Q = nblk·B·(1−(1−1/B)^kb)."""

    kb: int = 8
    block: int = 1024
    name: str = dataclasses.field(default="block_randk", init=False)

    def __post_init__(self):
        if self.block & (self.block - 1):
            raise ValueError("block must be a power of two")
        if not 1 <= self.kb <= self.block:
            raise ValueError("kb must lie in [1, block]")

    def _nblk(self, d: int) -> int:
        return max(1, -(-d // self.block))

    def omega(self, d: int) -> float:
        return self.block / self.kb

    def expected_density(self, d: int) -> float:
        per_block = self.block * (1.0 - (1.0 - 1.0 / self.block) ** self.kb)
        return float(min(d, self._nblk(d) * per_block))

    def payload_bits(self, d: int) -> float:
        return wire.seeded_randk_bits(self._nblk(d), self.kb)

    def compress(self, key, x):
        x2d = _pad_blocks(x, self.block)
        seed = prng.key_to_seed(key)
        vals, _ = _ref.randk_seeded_ref(x2d, seed, self.kb, self.block / self.kb)
        return {"values": vals, "seed": seed}

    def decompress(self, payload, d):
        vals = payload["values"]
        offs = flat.seeded_offsets(payload["seed"], vals.shape[0], self.block,
                                   self.kb, device=vals.device)
        dense = _ref.scatter_accum_ref(vals[None], offs[None], self.block)
        return dense.reshape(-1)[:d].to(vals.dtype)


@dataclasses.dataclass(frozen=True)
class BlockQSGD(Compressor):
    """Blockwise s-level ℓ2 QSGD — the packed quantization wire.

    The vector is viewed as ``(nblk, block)`` zero-padded blocks, each
    quantized against its own ℓ2 norm with the murmur3-seeded dither of the
    flat engine's ``qsgd`` sampler, so both paths draw the same levels. Wire
    per vector: nblk f32 norms + one level per coordinate, a signed 4-bit
    nibble for s ≤ 7 (the levels cross the packed words), int8 for s ≤ 127.
    ω = min(B/s², √B/s); ζ_Q ≤ s(s + √B) per block, capped at B."""

    s: int = 7
    block: int = 1024
    name: str = dataclasses.field(default="block_qsgd", init=False)

    def __post_init__(self):
        if self.block & (self.block - 1):
            raise ValueError("block must be a power of two")
        if not 1 <= self.s <= wire.INT8_MAX_S:
            raise ValueError(f"s={self.s} does not fit the int8 wire")

    def _nblk(self, d: int) -> int:
        return max(1, -(-d // self.block))

    def omega(self, d: int) -> float:
        return min(self.block / self.s**2, math.sqrt(self.block) / self.s)

    def expected_density(self, d: int) -> float:
        per_block = min(self.block, self.s * (self.s + math.sqrt(self.block)))
        return float(min(d, self._nblk(d) * per_block))

    def payload_bits(self, d: int) -> float:
        return wire.block_qsgd_bits(self._nblk(d), self.block, self.s)

    def default_p(self, d: int) -> float:
        """Bits-balanced p = bits_Q / (32d): the expected uplink of sync and
        compressed rounds equal (ζ_Q ≈ d would make Cor. 2.1's p ≈ 1)."""
        return min(1.0, max(self.payload_bits(d) / (32.0 * d), 1e-6))

    def compress(self, key, x):
        x2d = _pad_blocks(x, self.block)
        levels, norms = _ref.qsgd_block_ref(x2d, prng.key_to_seed(key), self.s)
        if self.s <= wire.NIBBLE_MAX_S:  # the levels cross the 4-bit words
            levels = _ref.nibble_unpack_ref(_ref.nibble_pack_ref(levels), self.block)
        return {"q": levels, "norms": norms}

    def decompress(self, payload, d):
        dense = _ref.qsgd_dequant_mean_ref(payload["q"][None], payload["norms"][None],
                                           self.s)
        return dense.reshape(-1)[:d]


@dataclasses.dataclass(frozen=True)
class BlockNatural(Compressor):
    """Blockwise natural compression (Horváth et al. 2019) on the packed wire.

    |x| rounds stochastically to a power of two (unbiased, ω = 1/8) under
    the murmur3 dither of the flat engine's ``natural`` sampler, so both
    paths draw the same codes. Wire per vector: per block one f32 reference
    scale (the power of two just above the block's max) and one int8
    ``sign·(exponent-delta + 1)`` code per coordinate; magnitudes 2^126 or
    more below the block's max, and subnormals, encode as 0."""

    block: int = 1024
    name: str = dataclasses.field(default="block_natural", init=False)

    def __post_init__(self):
        if self.block & (self.block - 1):
            raise ValueError("block must be a power of two")

    def _nblk(self, d: int) -> int:
        return max(1, -(-d // self.block))

    def omega(self, d: int) -> float:
        return 1.0 / 8.0

    def expected_density(self, d: int) -> float:
        return float(d)

    def payload_bits(self, d: int) -> float:
        return wire.block_natural_bits(self._nblk(d), self.block)

    def default_p(self, d: int) -> float:
        """Bits-balanced p (as :meth:`BlockQSGD.default_p`): ζ_Q = d would
        give the degenerate p = 1; the int8 wire gives p ≈ 1/4."""
        return min(1.0, max(self.payload_bits(d) / (32.0 * d), 1e-6))

    def compress(self, key, x):
        x2d = _pad_blocks(x, self.block)
        codes, scales = _ref.natural_block_ref(x2d, prng.key_to_seed(key))
        return {"q": codes, "scales": scales}

    def decompress(self, payload, d):
        return _ref.natural_decode_ref(payload["q"], payload["scales"]).reshape(-1)[:d]


# ---------------------------------------------------------------------------
# Correlated collections (Szlendak et al. 2021)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CorrelatedCompressor(Compressor):
    """Base for collections {Q_1..Q_n} with *shared* round randomness:
    workers draw from ONE round key and are told their index
    (``compress_worker(key, x, wid)``). ``compress(key, x)`` samples a
    uniform worker index. ``n = 0`` means "set at wiring time" (the trainer
    sets it to its worker count)."""

    n: int = 0

    def _n(self) -> int:
        if self.n < 1:
            raise ValueError(f"{self.name}: worker count not set (n={self.n})")
        return self.n

    def compress_worker(self, key, x: torch.Tensor, wid: int) -> Payload:
        raise NotImplementedError

    def compress(self, key, x):
        k_w, k_q = prng.split(key)
        wid = int(prng.randint(k_w, (), 0, self._n()))
        return self.compress_worker(k_q, x, wid)


@dataclasses.dataclass(frozen=True)
class PermK(CorrelatedCompressor):
    """Perm-K: a shared seeded permutation partitions the coordinates across
    the n workers; worker i keeps its d/n share scaled by n. The vector is
    zero-padded to ``(nblk, block)`` and each block permuted by the affine
    bijection π(t) = (a·t + c) mod B of the flat engine's ``permk`` sampler;
    worker w owns slots ``[w·B/n, (w+1)·B/n)``. ω = n − 1 per worker,
    (A, B) = (1, 1) for the collection. Payload: uint32 seed +
    (nblk·B)/n f32 values. Requires n | B."""

    block: int = 1024
    name: str = dataclasses.field(default="permk", init=False)

    def __post_init__(self):
        if self.block & (self.block - 1):
            raise ValueError("block must be a power of two")
        if self.n and self.block % self.n:
            raise ValueError("worker count must divide block")

    def _nblk(self, d: int) -> int:
        return max(1, -(-d // self.block))

    def omega(self, d: int) -> float:
        return float(self._n() - 1)

    def expected_density(self, d: int) -> float:
        return d / self._n()

    def payload_bits(self, d: int) -> float:
        return 32.0 + 32.0 * self._nblk(d) * self.block / self._n()

    def ab_constants(self, d: int, n: int) -> tuple:
        if n != self._n():
            raise ValueError(f"PermK built for n={self.n}, asked for n={n}")
        return (1.0, 1.0)

    def compress_worker(self, key, x, wid):
        x2d = _pad_blocks(x, self.block)
        nblk = x2d.shape[0]
        seed = prng.key_to_seed(key)  # SHARED across workers: same key, same π
        offs = _ref.permk_offsets_ref(seed, nblk, self.block, self._n(), wid,
                                      x.device)
        vals = torch.gather(x2d, 1, offs.to(torch.int64)) * torch.tensor(
            float(self._n()), dtype=x.dtype, device=x.device)
        return {"values": vals, "seed": seed, "wid": int(wid)}

    def decompress(self, payload, d):
        vals = payload["values"]
        offs = _ref.permk_offsets_ref(payload["seed"], vals.shape[0], self.block,
                                      self._n(), payload["wid"], vals.device)
        # one scatter_add_ of a permutation per row: no duplicate index, so
        # the order is fixed and the sums are the reference's scatter-adds
        dense = torch.zeros((vals.shape[0], self.block), dtype=vals.dtype,
                            device=vals.device)
        dense.scatter_add_(1, offs.to(torch.int64), vals)
        return dense.reshape(-1)[:d]


@dataclasses.dataclass(frozen=True)
class CorrelatedQ(CorrelatedCompressor):
    """Correlated s-level quantization: each worker stochastically rounds
    s·x/‖x‖ with a dither stratified across the collection, u_ij =
    frac(v_j + (wid + r_j)/n), v and r shared (one round key for every
    worker). Marginally u_ij ~ U[0, 1), so each worker is an unbiased
    ω = d/(4s²) quantization; jointly the n dithers of a coordinate form a
    stratified grid. (A, B) = (ω, 0): the correlation-free bound (the
    cross-worker covariance can be positive for heterogeneous inputs). The
    division by n is a true one (the reference's XLA may multiply by 1/n
    under ``jit``: the same for n a power of two, ROADMAP C)."""

    s: int = 4
    name: str = dataclasses.field(default="correlated_qsgd", init=False)

    def __post_init__(self):
        if not 1 <= self.s <= 63:
            raise ValueError("levels must fit int8 with the sign folded in")

    def omega(self, d: int) -> float:
        return d / (4.0 * self.s**2)

    def expected_density(self, d: int) -> float:
        return float(d)

    def payload_bits(self, d: int) -> float:
        return wire.correlated_q_bits(d, self.s)

    def ab_constants(self, d: int, n: int) -> tuple:
        return (self.omega(d), 0.0)

    def quantize_worker(self, key, x: torch.Tensor, wid: int,
                        norm: torch.Tensor) -> torch.Tensor:
        """Worker ``wid``'s int8 levels ⌊s·x / safe + u⌋ against a given norm
        (safe = norm, 1 where it is 0), each operation rounded once."""
        n = self._n()
        xf = x.to(torch.float32)
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        k_v, k_r = prng.split(key)
        v = prng.uniform(k_v, tuple(x.shape), device=x.device)
        r = prng.randint(k_r, tuple(x.shape), 0, n, device=x.device)
        u = torch.remainder(v + (float(wid) + r.to(torch.float32)) / torch.tensor(
            float(n), device=x.device), 1.0)
        level = torch.floor((xf * float(self.s)) / safe + u)
        return level.to(torch.int8)

    def compress_worker(self, key, x, wid):
        xf = x.to(torch.float32)
        norm = torch.sqrt(torch.sum(xf * xf))
        return {"q": self.quantize_worker(key, x, wid, norm), "norm": norm}

    def decompress(self, payload, d):
        return payload["norm"] * payload["q"].to(torch.float32) / float(self.s)


# ---------------------------------------------------------------------------
# TopK (biased, for EC-SGD), per-leaf QSGD and natural compression
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Greedy magnitude selection. Biased: E[Q(x)] ≠ x; contractive with
    δ = K/d. Only valid inside error feedback (EC-SGD). Equal magnitudes are
    taken lowest index first, as ``lax.top_k`` takes them (``torch.topk``
    does not promise an order among ties)."""

    k: float = 1
    unbiased: bool = dataclasses.field(default=False, init=False)
    name: str = dataclasses.field(default="topk", init=False)

    def k_for(self, d: int) -> int:
        if self.k < 1:
            return max(1, int(round(self.k * d)))
        return min(int(self.k), d)

    def omega(self, d: int) -> float:  # not a Def-1.1 quantization
        raise ValueError("TopK is biased; it has no ω. Use delta().")

    def delta(self, d: int) -> float:
        """Contraction factor: E‖Q(x) − x‖² ≤ (1 − δ)‖x‖²."""
        return self.k_for(d) / d

    def expected_density(self, d: int) -> float:
        return float(self.k_for(d))

    def payload_bits(self, d: int) -> float:
        return 64.0 * self.k_for(d)

    def compress(self, key, x):
        del key  # deterministic
        idx = torch.sort(x.abs(), descending=True, stable=True).indices[:self.k_for(x.shape[0])]
        return {"values": x[idx], "indices": idx.to(torch.int32)}

    def decompress(self, payload, d):
        vals = payload["values"]
        out = torch.zeros((d,), dtype=vals.dtype, device=vals.device)
        return out.index_put_((payload["indices"].long(),), vals, accumulate=True)


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """Stochastic s-level ℓ2 quantization against the vector's global norm:
    Q(x)_j = ‖x‖·sign(x_j)·⌊s|x_j|/‖x‖ + u_j⌋ / s, u_j ~ U[0, 1) drawn as
    the reference draws it (``uniform(key, (d,))``). ω = min(d/s², √d/s).
    Payload: one f32 norm + one int8 level per coordinate (s ≤ 127). The
    norm is torch's sum of squares, whose order XLA's need not share."""

    s: int = 1
    name: str = dataclasses.field(default="qsgd", init=False)

    def __post_init__(self):
        if not 1 <= self.s <= 127:
            raise ValueError("levels must fit the int8 payload")

    def omega(self, d: int) -> float:
        return min(d / self.s**2, math.sqrt(d) / self.s)

    def expected_density(self, d: int) -> float:
        return float(min(d, self.s * (self.s + math.sqrt(d))))

    def payload_bits(self, d: int) -> float:
        return wire.qsgd_global_bits(d, self.s)

    def compress(self, key, x):
        xf = x.float()
        norm = torch.sqrt(torch.sum(xf * xf))
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        u = prng.uniform(key, tuple(x.shape), device=x.device)
        level = torch.floor((xf.abs() * float(self.s)) / safe + u)
        return {"q": (torch.sign(xf) * level).to(torch.int8), "norm": norm}

    def decompress(self, payload, d):
        return payload["norm"] * payload["q"].to(torch.float32) / float(self.s)


@dataclasses.dataclass(frozen=True)
class NaturalCompression(Compressor):
    """C_nat: |x| rounded to a power of two, up with probability
    (|x| − 2^e)/2^e so E[Q(x)] = x, the coin ``bernoulli(key, p)`` as the
    reference draws it. ω = 1/8, density d, 32 + 8d bits on a byte-aligned
    wire. Exponents come from the float's bits and powers of two are built
    from bits (exact; the reference's XLA log2 / exp2 approximate them), and
    subnormals count as zero, as XLA on the CPU flushes them."""

    name: str = dataclasses.field(default="natural", init=False)

    def omega(self, d: int) -> float:
        return 1.0 / 8.0

    def expected_density(self, d: int) -> float:
        return float(d)

    def payload_bits(self, d: int) -> float:
        return wire.natural_tree_bits(d)

    def compress(self, key, x):
        xf = x.float()
        ax = xf.abs()
        keep = ax >= _ref.TINY
        lo = _ref.pow2_ref(torch.where(keep, _ref.float_exponent_ref(ax), 0))
        prob_up = torch.where(keep, (ax - lo) / lo, torch.zeros_like(ax))
        up = prng.uniform(key, tuple(x.shape), device=x.device) < prob_up
        mag = torch.where(up, 2.0 * lo, lo)
        q = torch.where(keep, torch.sign(xf) * mag, torch.zeros_like(xf))
        return {"dense": q.to(x.dtype)}

    def decompress(self, payload, d):
        return payload["dense"]


# ---------------------------------------------------------------------------
# Tree lifting (Block-RandK semantics)
# ---------------------------------------------------------------------------


def tree_compress(comp: Compressor, key, tree: PyTree) -> PyTree:
    """Compress each leaf with its own key; a single-leaf tree consumes the
    key directly (no split), as the reference does."""
    leaves, treedef = tree_flatten(tree)
    keys = [key] if len(leaves) == 1 else list(prng.split(key, len(leaves)))
    payloads = [comp.compress(k, leaf.reshape(-1)) for k, leaf in zip(keys, leaves)]
    return _PayloadTree(treedef, payloads)


def tree_compress_worker(comp: CorrelatedCompressor, key, tree: PyTree,
                         wid: int) -> PyTree:
    """:func:`tree_compress` for correlated collections: the round key is
    shared across workers and the worker index passed through; the same
    per-leaf key schedule."""
    leaves, treedef = tree_flatten(tree)
    keys = [key] if len(leaves) == 1 else list(prng.split(key, len(leaves)))
    payloads = [comp.compress_worker(k, leaf.reshape(-1), wid)
                for k, leaf in zip(keys, leaves)]
    return _PayloadTree(treedef, payloads)


@dataclasses.dataclass
class _PayloadTree:
    """Per-leaf payloads at the leaf positions of the compressed tree."""

    treedef: Any
    payloads: list


def tree_decompress(comp: Compressor, payload_tree: _PayloadTree, like: PyTree
                    ) -> PyTree:
    """Inverse of tree_compress; ``like`` supplies leaf shapes and dtypes."""
    like_leaves = tree_leaves(like)
    outs = [
        comp.decompress(p, l.numel()).reshape(l.shape).to(l.dtype)
        for p, l in zip(payload_tree.payloads, like_leaves)
    ]
    return payload_tree.treedef.unflatten(outs)


def tree_roundtrip(comp: Compressor, key, tree: PyTree) -> PyTree:
    """Q applied leafwise, returning a dense tree (compress → decompress)."""
    return tree_decompress(comp, tree_compress(comp, key, tree), tree)


def tree_omega(comp: Compressor, tree: PyTree) -> float:
    """Effective ω of the leafwise compressor = max over leaves (worst case)."""
    return max(comp.omega(l.numel()) for l in tree_leaves(tree))


def tree_payload_bits(comp: Compressor, tree: PyTree) -> float:
    """Per-worker wire bits of one compressed round under per-leaf lifting."""
    return sum(comp.payload_bits(l.numel()) for l in tree_leaves(tree))


def tree_ab_constants(comp: Compressor, tree: PyTree, n: int) -> tuple:
    """Collection (A, B) of the leafwise-lifted compressor: the worst leaf's
    A and the smallest leaf's B bound the whole tree (the AB-inequality adds
    over orthogonal coordinate blocks)."""
    pairs = [comp.ab_constants(l.numel(), n) for l in tree_leaves(tree)]
    return (max(a for a, _ in pairs), min(b for _, b in pairs))


def tree_dim(tree: PyTree) -> int:
    """Total dimension d = Σ leaf sizes."""
    return sum(int(np.prod(l.shape)) for l in tree_leaves(tree))


def make_compressor(name: str, **kw) -> Compressor:
    """Registry: compressor by name."""
    name = name.lower()
    if name in ("identity", "none"):
        return Identity()
    if name == "randk":
        return RandK(**kw)
    if name in ("block_randk", "flat_randk"):
        return BlockRandK(**kw)
    if name in ("block_qsgd", "flat_qsgd"):
        return BlockQSGD(**kw)
    if name in ("block_natural", "flat_natural"):
        return BlockNatural(**kw)
    if name == "shared_randk":
        return SharedRandK(**kw)
    if name in ("permk", "perm_k"):
        return PermK(**kw)
    if name in ("correlated_qsgd", "correlated_q", "cqsgd"):
        return CorrelatedQ(**kw)
    if name == "topk":
        return TopK(**kw)
    if name == "qsgd":
        return QSGD(**kw)
    if name == "natural":
        return NaturalCompression()
    raise ValueError(f"unknown compressor {name!r}")
