"""PermK uplink: wrapper of the Hopper kernel in ``csrc/permk.cu``.

Ports ``repro.kernels.permk::permk_seeded_workers``. A wrapper given CUDA
tensors launches its kernel (or raises); given CPU tensors it returns the
plain version from :mod:`repro_torch.kernels.ref`. It counts its launches in
``permk_seeded_workers.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.roofline.memory import kernel_call

from . import _build
from . import ref as _ref
from .randk import _check_block, _stream

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@kernel_call
def permk_seeded_workers(x3d: torch.Tensor, seed: int, *, workers=None, n=None,
                         offsets: bool = True):
    """PermK with one shared uint32 seed: (r, nblk, B) f32 or bf16 → values
    in x's dtype (scaled by n) and int32 offsets, both (r, nblk, B/n). Row i
    is worker ``workers[i]`` of a fleet of ``n`` (a list, or an integer
    tensor on x3d's device); with neither, the rows are the n = r workers,
    whose offsets partition every block. ``offsets=False`` returns (values,
    None) and writes no offsets. One launch a call."""
    r, nblk, B = x3d.shape
    _check_block(B)
    wid, n = _ref.permk_worker_rows(x3d, workers, n)
    if not x3d.is_cuda:
        return _ref.permk_seeded_workers_ref(x3d, seed, workers=workers, n=n, offsets=offsets)
    if x3d.dtype not in _SUFFIX or not x3d.is_contiguous():
        raise ValueError("permk_seeded_workers takes a contiguous f32 or bf16 buffer")
    if nblk < 1 or r < 1:
        raise ValueError("permk_seeded_workers needs at least one row and one block")
    # the kernel reads the int32 indices on the device (none: row k is worker k)
    vals = torch.empty((r, nblk, B // n), dtype=x3d.dtype, device=x3d.device)
    offs = (torch.empty((r, nblk, B // n), dtype=torch.int32, device=x3d.device)
            if offsets else None)
    lib = _build.library("permk")
    err = getattr(lib, f"permk_seeded_workers_{_SUFFIX[x3d.dtype]}")(
        x3d.data_ptr(), int(seed) & 0xFFFFFFFF, None if wid is None else wid.data_ptr(),
        vals.data_ptr(), None if offs is None else offs.data_ptr(), n, r, nblk, B,
        _stream(),
    )
    _build.check(err, "permk_seeded_workers")
    permk_seeded_workers.launches += 1
    return vals, offs


permk_seeded_workers.launches = 0
