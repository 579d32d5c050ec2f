"""Seeded RandK uplink, server scatter-mean and the flat-vector gathers:
wrappers of the Hopper kernels in ``csrc/randk.cu``.

Ports ``repro.kernels.randk::randk_seeded_workers``, ``::scatter_accum``,
``::randk_gather`` (host-supplied offsets) and ``::randk_seeded`` (one
buffer, one seed). A wrapper given CUDA tensors launches its kernel (or
raises); given CPU tensors it returns the plain version from
:mod:`repro_torch.kernels.ref`. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.roofline.memory import kernel_call

from . import _build
from . import ref as _ref

#: entry-point suffix by x dtype, for the kernels that take f32 or bf16
X_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _stream_on(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device: naming the device skips the
    current-device lookup (about 3 µs of host time a call on the H100's
    host, ``chip_smoke.dequant_host_us``)."""
    return torch.cuda.current_stream(t.get_device()).cuda_stream


def _check_block(B: int) -> None:
    if B <= 0 or B & (B - 1):
        raise ValueError(f"block width {B} must be a power of two")


#: the widest row ``scatter_accum`` takes: one f32 row in the 227 KiB of
#: shared memory a CTA may hold on Hopper
MAX_SCATTER_WIDTH = 232448 // 4


def _check_scatter_width(B: int) -> None:
    if not 1 <= B <= MAX_SCATTER_WIDTH:
        raise ValueError(f"scatter_accum row width {B} outside [1, {MAX_SCATTER_WIDTH}]: "
                         "one f32 row must fit a CTA's shared memory")


def fetch_granularity(device=None) -> int:
    """The L2 fetch granularity of ``device``'s context (the current card
    by default), in bytes, as the runtime reads back
    ``cudaLimitMaxL2FetchGranularity``: how much device memory L2 fetches
    for one random 4-byte load. The port leaves it at the runtime's default
    (``csrc/randk.cu`` says why); raises on a CUDA error."""
    import ctypes

    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _build.entry("randk", "l2_fetch_granularity")(ctypes.byref(out))
    _build.check(err, "cudaDeviceGetLimit(cudaLimitMaxL2FetchGranularity)")
    return out.value


def seeds_tensor(seeds, device) -> torch.Tensor:
    """uint32 seed values (a sequence, a numpy array or a tensor) → (n,)
    int32 tensor on ``device`` holding the same bit patterns."""
    if isinstance(seeds, torch.Tensor):
        return (seeds.reshape(-1).to(torch.int64) & 0xFFFFFFFF).to(device).to(torch.int32)
    arr = np.asarray(seeds, dtype=np.uint32).reshape(-1).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


@kernel_call
def randk_seeded_workers(x3d: torch.Tensor, seeds: torch.Tensor, kb: int,
                         scale: float):
    """Per-worker seeded RandK: (n, nblk, B) f32 + (n,) int32 seeds →
    values f32 and offsets int32, both (n, nblk, kb)."""
    n, nblk, B = x3d.shape
    _check_block(B)
    if not x3d.is_cuda:
        return _ref.randk_seeded_workers_ref(x3d, seeds, kb, scale)
    if x3d.dtype != torch.float32 or not x3d.is_contiguous():
        raise ValueError("randk_seeded_workers takes a contiguous f32 buffer")
    if seeds.dtype != torch.int32 or seeds.shape != (n,) or seeds.device != x3d.device:
        raise ValueError("seeds must be an (n,) int32 tensor on x's device")
    if not 1 <= kb <= B:
        raise ValueError(f"kb={kb} must lie in [1, {B}]")
    vals = torch.empty((n, nblk, kb), dtype=torch.float32, device=x3d.device)
    offs = torch.empty((n, nblk, kb), dtype=torch.int32, device=x3d.device)
    lib = _build.library("randk")
    err = lib.randk_seeded_workers(
        x3d.data_ptr(), seeds.data_ptr(), vals.data_ptr(), offs.data_ptr(),
        n, nblk, B, kb, float(scale), _stream(),
    )
    _build.check(err, "randk_seeded_workers")
    randk_seeded_workers.launches += 1
    return vals, offs


randk_seeded_workers.launches = 0


@kernel_call
def scatter_accum(values: torch.Tensor, offsets: torch.Tensor,
                  block: int) -> torch.Tensor:
    """(n, nblk, kb) f32 values + int32 offsets → (nblk, block) f32 mean over
    workers; duplicates add in the order w, then t. ``block`` is any row
    width up to :data:`MAX_SCATTER_WIDTH`: the flat engine's 1024, or a
    leaf's last dimension on the launch layer's per-leaf wire."""
    n, nblk, kb = values.shape
    _check_scatter_width(block)
    if not values.is_cuda:
        return _ref.scatter_accum_ref(values, offsets, block)
    _check_payload(values, offsets)
    out = torch.empty((nblk, block), dtype=torch.float32, device=values.device)
    lib = _build.library("randk")
    err = lib.scatter_accum(
        values.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, nblk, block,
        kb, _stream(),
    )
    _build.check(err, "scatter_accum")
    scatter_accum.launches += 1
    return out


scatter_accum.launches = 0


def _check_payload(values: torch.Tensor, offsets: torch.Tensor) -> None:
    if values.dtype != torch.float32 or offsets.dtype != torch.int32:
        raise ValueError("payloads are f32 values and int32 offsets")
    if values.shape != offsets.shape or offsets.device != values.device:
        raise ValueError("values and offsets must match in shape and device")
    if not (values.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("payloads must be contiguous")


def _check_gather(x2d: torch.Tensor, kb: int) -> None:
    nblk, B = x2d.shape
    if not 1 <= kb <= B:
        raise ValueError(f"kb={kb} must lie in [1, {B}]")
    if x2d.dtype not in X_SUFFIX:
        raise ValueError("the RandK gathers take an f32 or bf16 buffer")


@kernel_call
def randk_gather(x2d: torch.Tensor, offsets: torch.Tensor, scale: float) -> torch.Tensor:
    """Gather host-supplied offsets and scale: (nblk, B) f32 or bf16 +
    (nblk, kb) int32 offsets in [0, B) → (nblk, kb) ``x[b, off]·scale`` in
    x's dtype (the product in f32, rounded once)."""
    nblk, kb = offsets.shape
    _check_gather(x2d, kb)
    if x2d.shape[0] != nblk:
        raise ValueError(f"offsets {tuple(offsets.shape)} do not match x {tuple(x2d.shape)}")
    if not x2d.is_cuda:
        return _ref.randk_block_compress_ref(x2d, offsets, scale)
    if offsets.dtype != torch.int32 or offsets.device != x2d.device:
        raise ValueError("offsets must be an int32 tensor on x's device")
    if not (x2d.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("randk_gather takes contiguous tensors")
    vals = torch.empty((nblk, kb), dtype=x2d.dtype, device=x2d.device)
    lib = _build.library("randk")
    err = getattr(lib, f"randk_gather_{X_SUFFIX[x2d.dtype]}")(
        x2d.data_ptr(), offsets.data_ptr(), vals.data_ptr(), nblk, x2d.shape[1], kb,
        float(scale), _stream())
    _build.check(err, "randk_gather")
    randk_gather.launches += 1
    return vals


randk_gather.launches = 0


@kernel_call
def randk_seeded(x2d: torch.Tensor, seed: int, kb: int, scale: float):
    """Seeded RandK over one (nblk, B) f32 or bf16 buffer under one uint32
    seed: offsets ``murmur3(seed, b·kb + t) & (B − 1)`` (int32) and values
    ``x[b, off]·scale`` in x's dtype, both (nblk, kb)."""
    nblk, B = x2d.shape
    _check_block(B)
    _check_gather(x2d, kb)
    if nblk * kb > 2**32:
        raise ValueError("the counter b·kb + t must fit in 32 bits")
    if not x2d.is_cuda:
        return _ref.randk_seeded_ref(x2d, seed, kb, scale)
    if not x2d.is_contiguous():
        raise ValueError("randk_seeded takes a contiguous buffer")
    vals = torch.empty((nblk, kb), dtype=x2d.dtype, device=x2d.device)
    offs = torch.empty((nblk, kb), dtype=torch.int32, device=x2d.device)
    lib = _build.library("randk")
    err = getattr(lib, f"randk_seeded_{X_SUFFIX[x2d.dtype]}")(
        x2d.data_ptr(), int(seed) & 0xFFFFFFFF, vals.data_ptr(), offs.data_ptr(), nblk, B,
        kb, float(scale), _stream())
    _build.check(err, "randk_seeded")
    randk_seeded.launches += 1
    return vals, offs


randk_seeded.launches = 0
