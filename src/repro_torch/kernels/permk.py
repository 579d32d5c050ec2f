"""PermK uplink: wrapper of the Hopper kernel in ``csrc/permk.cu``.

Ports ``repro.kernels.permk::permk_seeded_workers``. A wrapper given CUDA
tensors launches its kernel (or raises); given CPU tensors it returns the
plain version from :mod:`repro_torch.kernels.ref`. It counts its launches in
``permk_seeded_workers.launches``.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as _ref
from .randk import _check_block, _stream

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def permk_seeded_workers(x3d: torch.Tensor, seed: int):
    """PermK with one shared uint32 seed: (n, nblk, B) f32 or bf16 → values
    in x's dtype (scaled by n) and int32 offsets, both (n, nblk, B/n); the
    n workers' offsets partition every block."""
    n, nblk, B = x3d.shape
    _check_block(B)
    if B % n:
        raise ValueError(f"worker count {n} must divide the block width {B}")
    if not x3d.is_cuda:
        return _ref.permk_seeded_workers_ref(x3d, seed)
    if x3d.dtype not in _SUFFIX or not x3d.is_contiguous():
        raise ValueError("permk_seeded_workers takes a contiguous f32 or bf16 buffer")
    if nblk < 1:
        raise ValueError("permk_seeded_workers needs at least one block")
    vals = torch.empty((n, nblk, B // n), dtype=x3d.dtype, device=x3d.device)
    offs = torch.empty((n, nblk, B // n), dtype=torch.int32, device=x3d.device)
    lib = _build.library("permk")
    err = getattr(lib, f"permk_seeded_workers_{_SUFFIX[x3d.dtype]}")(
        x3d.data_ptr(), int(seed) & 0xFFFFFFFF, vals.data_ptr(), offs.data_ptr(),
        n, nblk, B, _stream(),
    )
    _build.check(err, "permk_seeded_workers")
    permk_seeded_workers.launches += 1
    return vals, offs


permk_seeded_workers.launches = 0
