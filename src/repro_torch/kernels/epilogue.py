"""Fused server epilogues: wrappers of the Hopper kernels in
``csrc/epilogue.cu``.

Ports ``repro.kernels.epilogue::scatter_epilogue`` (carry compressed
RandK rounds), ``::delta_epilogue`` (carry compressed PermK rounds, whose
aggregate is already dense), ``::qsgd_epilogue`` and ``::natural_epilogue``
(carry compressed rounds of the packed QSGD and natural wires, uplink or
downlink), ``::mean_epilogue`` (carry sync rounds) and the robust pair
``::trimmed_delta_epilogue`` / ``::trimmed_sync_epilogue`` (carry rounds
under a coordinate-wise trimmed mean or median): aggregate the worker
payloads, ``g' = g + δ`` in f32, and ``x' = (−γ)·g' + x`` rounded
separately, in x's dtype (f32 or bf16). A wrapper given CUDA tensors launches its kernel
(or raises); given CPU tensors it returns the plain version from
:mod:`repro_torch.kernels.ref`. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.roofline.memory import kernel_call

from . import _build
from . import ref as _ref
from .quantize import (
    check_cuda_buffers,
    check_natural_block,
    check_payload,
    check_qsgd_block,
)
from .randk import _check_payload, _stream

_X_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_gx(g2d: torch.Tensor, x2d: torch.Tensor, shape: tuple) -> str:
    if g2d.dtype != torch.float32 or tuple(g2d.shape) != shape:
        raise ValueError(f"g must be f32 of shape {shape}")
    if x2d.dtype not in _X_SUFFIX or tuple(x2d.shape) != shape:
        raise ValueError(f"x must be f32 or bf16 of shape {shape}")
    if not (g2d.is_contiguous() and x2d.is_contiguous()):
        raise ValueError("g and x must be contiguous")
    if g2d.device != x2d.device:
        raise ValueError("g and x must be on one device")
    return _X_SUFFIX[x2d.dtype]


def _neg_gamma(gamma: float) -> float:
    return float(np.float32(-gamma))


@kernel_call
def scatter_epilogue(values: torch.Tensor, offsets: torch.Tensor,
                     g2d: torch.Tensor, x2d: torch.Tensor, gamma: float):
    """Payloads (n, nblk, kb) ×2 + g (nblk, B) f32 + x (nblk, B) →
    (g' f32, x' x.dtype), scatter-mean and update in one sweep."""
    if not values.is_cuda:
        return _ref.scatter_epilogue_ref(values, offsets, g2d, x2d, gamma)
    n, nblk, kb = values.shape
    B = g2d.shape[-1]
    _check_payload(values, offsets)
    suffix = _check_gx(g2d, x2d, (nblk, B))
    if g2d.device != values.device:
        raise ValueError("payloads and buffers must be on one device")
    g_out = torch.empty_like(g2d)
    x_out = torch.empty_like(x2d)
    lib = _build.library("epilogue")
    err = getattr(lib, f"scatter_epilogue_{suffix}")(
        values.data_ptr(), offsets.data_ptr(), g2d.data_ptr(), x2d.data_ptr(),
        g_out.data_ptr(), x_out.data_ptr(), n, nblk, B, kb, _neg_gamma(gamma),
        _stream(),
    )
    _build.check(err, "scatter_epilogue")
    scatter_epilogue.launches += 1
    return g_out, x_out


scatter_epilogue.launches = 0


@kernel_call
def delta_epilogue(delta2d: torch.Tensor, g2d: torch.Tensor, x2d: torch.Tensor,
                   gamma: float):
    """Dense round delta (nblk, B) f32 + g (nblk, B) f32 + x (nblk, B) →
    (g' = g + δ f32, x' x.dtype)."""
    if not delta2d.is_cuda:
        return _ref.delta_epilogue_ref(delta2d, g2d, x2d, gamma)
    suffix = _check_gx(g2d, x2d, tuple(delta2d.shape))
    if delta2d.dtype != torch.float32 or not delta2d.is_contiguous():
        raise ValueError("delta must be a contiguous f32 buffer")
    if g2d.device != delta2d.device:
        raise ValueError("delta and buffers must be on one device")
    g_out = torch.empty_like(g2d)
    x_out = torch.empty_like(x2d)
    lib = _build.library("epilogue")
    err = getattr(lib, f"delta_epilogue_{suffix}")(
        delta2d.data_ptr(), g2d.data_ptr(), x2d.data_ptr(), g_out.data_ptr(),
        x_out.data_ptr(), delta2d.numel(), _neg_gamma(gamma), _stream(),
    )
    _build.check(err, "delta_epilogue")
    delta_epilogue.launches += 1
    return g_out, x_out


delta_epilogue.launches = 0


@kernel_call
def mean_epilogue(gbufs: torch.Tensor, x2d: torch.Tensor, gamma: float):
    """Packed worker gradients (n, nblk, B) f32 + x (nblk, B) →
    (g' = worker mean f32, x' x.dtype)."""
    if not gbufs.is_cuda:
        return _ref.mean_epilogue_ref(gbufs, x2d, gamma)
    n, nblk, B = gbufs.shape
    if gbufs.dtype != torch.float32 or not gbufs.is_contiguous():
        raise ValueError("gbufs must be a contiguous f32 buffer")
    if x2d.dtype not in _X_SUFFIX or tuple(x2d.shape) != (nblk, B):
        raise ValueError(f"x must be f32 or bf16 of shape {(nblk, B)}")
    if not x2d.is_contiguous() or x2d.device != gbufs.device:
        raise ValueError("x must be contiguous and on gbufs' device")
    g_out = torch.empty((nblk, B), dtype=torch.float32, device=gbufs.device)
    x_out = torch.empty_like(x2d)
    lib = _build.library("epilogue")
    err = getattr(lib, f"mean_epilogue_{_X_SUFFIX[x2d.dtype]}")(
        gbufs.data_ptr(), x2d.data_ptr(), g_out.data_ptr(), x_out.data_ptr(),
        n, nblk * B, _neg_gamma(gamma), _stream(),
    )
    _build.check(err, "mean_epilogue")
    mean_epilogue.launches += 1
    return g_out, x_out


mean_epilogue.launches = 0


@kernel_call
def qsgd_epilogue(levels: torch.Tensor, norms: torch.Tensor, g2d: torch.Tensor,
                  x2d: torch.Tensor, gamma: float, s: int):
    """QSGD payloads (n, nblk, B) int8 + (n, nblk) f32 + g (nblk, B) f32 + x
    (nblk, B) → (g' = g + dequantized mean f32, x' x.dtype)."""
    if not levels.is_cuda:
        return _ref.qsgd_epilogue_ref(levels, norms, g2d, x2d, gamma, s)
    n, nblk, B = levels.shape
    check_qsgd_block(B, nblk, s)
    check_payload(levels, norms)
    suffix = _check_gx(g2d, x2d, (nblk, B))
    check_cuda_buffers(levels, norms, g2d, x2d)
    g_out = torch.empty_like(g2d)
    x_out = torch.empty_like(x2d)
    lib = _build.library("epilogue")
    err = getattr(lib, f"qsgd_epilogue_{suffix}")(
        levels.data_ptr(), norms.data_ptr(), g2d.data_ptr(), x2d.data_ptr(),
        g_out.data_ptr(), x_out.data_ptr(), n, nblk, B, int(s), _neg_gamma(gamma),
        _stream(),
    )
    _build.check(err, "qsgd_epilogue")
    qsgd_epilogue.launches += 1
    return g_out, x_out


qsgd_epilogue.launches = 0


@kernel_call
def natural_epilogue(codes: torch.Tensor, scales: torch.Tensor, g2d: torch.Tensor,
                     x2d: torch.Tensor, gamma: float):
    """Natural payloads (n, nblk, B) int8 + (n, nblk) f32 + g (nblk, B) f32 +
    x (nblk, B) → (g' = g + decoded mean f32, x' x.dtype)."""
    if not codes.is_cuda:
        return _ref.natural_epilogue_ref(codes, scales, g2d, x2d, gamma)
    n, nblk, B = codes.shape
    check_natural_block(B, nblk)
    check_payload(codes, scales)
    suffix = _check_gx(g2d, x2d, (nblk, B))
    check_cuda_buffers(codes, scales, g2d, x2d)
    g_out = torch.empty_like(g2d)
    x_out = torch.empty_like(x2d)
    lib = _build.library("epilogue")
    err = getattr(lib, f"natural_epilogue_{suffix}")(
        codes.data_ptr(), scales.data_ptr(), g2d.data_ptr(), x2d.data_ptr(),
        g_out.data_ptr(), x_out.data_ptr(), n, nblk, B, _neg_gamma(gamma), _stream(),
    )
    _build.check(err, "natural_epilogue")
    natural_epilogue.launches += 1
    return g_out, x_out


natural_epilogue.launches = 0


#: the most worker rows the trimmed kernels take (a template parameter there)
TRIM_MAX_N = 16


def _check_trimmed(bufs: torch.Tensor, x2d: torch.Tensor, lo: int, hi: int) -> str:
    """Shape, dtype, layout and window checks of the trimmed kernels; returns
    the entry point's dtype suffix."""
    n, nblk, B = bufs.shape
    if not 1 <= n <= TRIM_MAX_N:
        raise ValueError(f"the trimmed kernels take 1..{TRIM_MAX_N} worker rows, not {n}")
    if not 0 <= lo < hi <= n:
        raise ValueError(f"trim window [{lo}, {hi}) invalid for n={n}")
    if bufs.dtype not in _X_SUFFIX or not bufs.is_contiguous():
        raise ValueError("bufs must be a contiguous f32 or bf16 buffer")
    if x2d.dtype not in _X_SUFFIX or tuple(x2d.shape) != (nblk, B):
        raise ValueError(f"x must be f32 or bf16 of shape {(nblk, B)}")
    if not x2d.is_contiguous() or x2d.device != bufs.device:
        raise ValueError("x must be contiguous and on bufs' device")
    return f"{_X_SUFFIX[bufs.dtype]}_{_X_SUFFIX[x2d.dtype]}"


@kernel_call
def trimmed_delta_epilogue(bufs: torch.Tensor, g2d: torch.Tensor, x2d: torch.Tensor,
                           gamma: float, lo: int, hi: int):
    """Per-worker dense rows (n, nblk, B) f32 or bf16 + g (nblk, B) f32 + x →
    (g' = g + trimmed mean over the rank window [lo, hi) f32, x' x.dtype)."""
    if not bufs.is_cuda:
        return _ref.trimmed_delta_epilogue_ref(bufs, g2d, x2d, gamma, lo, hi)
    suffix = _check_trimmed(bufs, x2d, lo, hi)
    _check_gx(g2d, x2d, tuple(x2d.shape))
    n, nblk, B = bufs.shape
    g_out = torch.empty_like(g2d)
    x_out = torch.empty_like(x2d)
    lib = _build.library("epilogue")
    err = getattr(lib, f"trimmed_delta_epilogue_{suffix}")(
        bufs.data_ptr(), g2d.data_ptr(), x2d.data_ptr(), g_out.data_ptr(),
        x_out.data_ptr(), n, nblk * B, int(lo), int(hi), _neg_gamma(gamma), _stream(),
    )
    _build.check(err, "trimmed_delta_epilogue")
    trimmed_delta_epilogue.launches += 1
    return g_out, x_out


trimmed_delta_epilogue.launches = 0


@kernel_call
def trimmed_sync_epilogue(bufs: torch.Tensor, x2d: torch.Tensor, gamma: float,
                          lo: int, hi: int):
    """Packed worker gradients (n, nblk, B) f32 or bf16 + x (nblk, B) →
    (g' = trimmed mean over the rank window [lo, hi) f32, x' x.dtype)."""
    if not bufs.is_cuda:
        return _ref.trimmed_sync_epilogue_ref(bufs, x2d, gamma, lo, hi)
    suffix = _check_trimmed(bufs, x2d, lo, hi)
    n, nblk, B = bufs.shape
    g_out = torch.empty((nblk, B), dtype=torch.float32, device=bufs.device)
    x_out = torch.empty_like(x2d)
    lib = _build.library("epilogue")
    err = getattr(lib, f"trimmed_sync_epilogue_{suffix}")(
        bufs.data_ptr(), x2d.data_ptr(), g_out.data_ptr(), x_out.data_ptr(), n,
        nblk * B, int(lo), int(hi), _neg_gamma(gamma), _stream(),
    )
    _build.check(err, "trimmed_sync_epilogue")
    trimmed_sync_epilogue.launches += 1
    return g_out, x_out


trimmed_sync_epilogue.launches = 0
