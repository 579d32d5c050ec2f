"""The flat-vector wire: the kernels on one flat vector (port of
``repro.kernels.ops``).

Handles the flat → (nblk, B) blocked layout with zero padding, the
jittered-stratified offsets (one index per stride of each block: unbiased
with ω = B/kb − 1, no repeated index), and the two-pass global-norm QSGD
(Σx² per block, the square root of their sum, a uniform dither per
coordinate, the levels). The offsets and the dither are ``jax.random``'s
draws under the given key, made on the vector's device (:mod:`repro_torch.prng`).

``backend``: ``auto`` runs the kernel wrappers, which launch the
hand-written kernels on CUDA tensors and return their plain versions on
CPU ones; ``cuda`` insists on CUDA tensors; ``ref`` runs the plain versions
on any device. (The reference's ``interpret`` flag has no counterpart: on
the CPU its ``randk_compress`` runs the Pallas kernel in interpret mode and
its ``qsgd_compress`` the oracles; the port's plain versions compute the
same values, ROADMAP C.)
"""

from __future__ import annotations

import torch

from repro_torch import prng

from . import quantize as _quant
from . import randk as _randk
from . import ref as _ref

DEFAULT_BLOCK = 1024


def _plain(backend: str, tensor: torch.Tensor) -> bool:
    """True for backend ``ref``; otherwise the kernel wrappers run (``cuda``
    with a CPU tensor raises), as in :class:`repro_torch.core.flat.FlatEngine`."""
    from repro_torch.core.flat import resolve_backend

    resolve_backend(backend, tensor)
    return backend == "ref"


def pad_to_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """Flat (d,) → (nblk, block) with zero padding (a view when d fills the
    blocks)."""
    d = x.shape[0]
    nblk = max(1, -(-d // block))
    if nblk * block == d:
        return x.reshape(nblk, block)
    return torch.nn.functional.pad(x, (0, nblk * block - d)).reshape(nblk, block)


def jittered_offsets(key, nblk: int, block: int, kb: int, device=None) -> torch.Tensor:
    """Stratified sampling: one uniform index inside each of the kb strides of
    every block, ``base_t + randint(key, (nblk, kb), 0, B // kb)``; int32
    (nblk, kb) on ``device`` (``cuda`` unless it names another). Every
    coordinate of a stride is drawn with probability 1/stride."""
    from repro_torch.device import default_device

    stride = block // kb
    device = default_device(device)
    base = torch.arange(kb, dtype=torch.int32, device=device) * stride
    jitter = prng.randint(key, (nblk, kb), 0, stride, device=device)
    return base[None, :] + jitter


def randk_compress(x: torch.Tensor, key, kb: int, block: int = DEFAULT_BLOCK,
                   backend: str = "auto"):
    """Blockwise jittered RandK of a flat vector: (values (nblk, kb) in x's
    dtype, offsets (nblk, kb) int32), scale = block/kb."""
    x2d = pad_to_blocks(x, block)
    offsets = jittered_offsets(key, x2d.shape[0], block, kb, device=x.device)
    fn = _ref.randk_block_compress_ref if _plain(backend, x) else _randk.randk_gather
    return fn(x2d, offsets, block / kb), offsets


def randk_decompress_mean(values: torch.Tensor, offsets: torch.Tensor, d: int,
                          block: int = DEFAULT_BLOCK, backend: str = "auto") -> torch.Tensor:
    """Server aggregation of n payloads (n, nblk, kb) → dense (d,) mean."""
    fn = _ref.scatter_accum_ref if _plain(backend, values) else _randk.scatter_accum
    return fn(values, offsets, block).reshape(-1)[:d]


def global_norm(sumsq: torch.Tensor) -> torch.Tensor:
    """sqrt(Σ_b sumsq_b) as a 0-d f32 tensor: the sum in float64 (so its
    order barely matters), rounded once to f32, then an IEEE square root.
    (The reference sums in f32 with XLA's unspecified order: ROADMAP C.)"""
    return torch.sqrt(torch.sum(sumsq.to(torch.float64)).to(torch.float32))


def qsgd_compress(x: torch.Tensor, key, s: int, block: int = DEFAULT_BLOCK,
                  backend: str = "auto"):
    """Two-pass global-norm QSGD: (levels (nblk, block) int8, norm 0-d f32),
    the dither ``uniform(key, (nblk, block))``."""
    plain = _plain(backend, x)
    x2d = pad_to_blocks(x, block)
    sumsq = (_ref.block_sumsq_ref if plain else _quant.block_sumsq)(x2d)
    norm = global_norm(sumsq)
    u2d = prng.uniform(key, tuple(x2d.shape), device=x.device)
    q = (_ref.qsgd_quantize_ref if plain else _quant.qsgd_quantize)(x2d, u2d, norm, s)
    return q, norm


def qsgd_decompress(q: torch.Tensor, norm: torch.Tensor, s: int, d: int,
                    block: int = DEFAULT_BLOCK, backend: str = "auto") -> torch.Tensor:
    """(nblk, block) int8 levels and the norm → dense (d,) f32."""
    del block  # the levels already carry the blocked shape
    fn = _ref.qsgd_dequantize_ref if _plain(backend, q) else _quant.qsgd_dequantize
    return fn(q, norm, s).reshape(-1)[:d]
