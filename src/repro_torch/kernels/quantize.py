"""Packed quantization wires: wrappers of the Hopper kernels in
``csrc/quantize.cu``.

Ports ``repro.kernels.quantize::qsgd_block_workers`` (blockwise s-level
QSGD uplink: int8 levels + one f32 norm per block), ``::qsgd_dequant_mean``
(the server's dequantize-and-mean), ``::nibble_pack`` / ``::nibble_unpack``
(the 4-bit wire: eight two's-complement nibbles per 32-bit word), the
natural wire (``::natural_block_workers``, ``::natural_dequant_mean``),
the serving engine's int8 KV-page rows (``::absmax_quant_rows``, also as
the in-place write of a layer's k and v pages, ``absmax_quant_write_pages``,
and ``::absmax_dequant_rows``) and the two-pass global-norm QSGD of the
flat-vector wire (``::block_sumsq``, ``::qsgd_quantize``,
``::qsgd_dequantize``). A wrapper
given CUDA tensors launches its kernel (or raises); given CPU tensors it
returns the plain version from :mod:`repro_torch.kernels.ref`. Each wrapper
counts its launches in ``<wrapper>.launches``.

The words are uint32 bit patterns held in int32 tensors (PyTorch's uint32
lacks the shifts and adds the plain versions need). The kernels take
contiguous tensors whose data start on a 16-byte boundary (every tensor
PyTorch allocates does) and blocks of 128 to 4096 coordinates.
"""

from __future__ import annotations

import torch

from repro_torch.roofline.memory import kernel_call

from . import _build
from . import ref as _ref
from .randk import X_SUFFIX as _X_SUFFIX
from .randk import _check_block, _stream, _stream_on


def check_cuda_buffers(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous, 16-byte aligned and on the
    first one's device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the quantize kernels take contiguous, 16-byte aligned tensors")
        if t.device != dev:
            raise ValueError("the quantize kernels take tensors on one device")


def check_qsgd_block(B: int, nblk: int, s: int) -> None:
    """Shapes the QSGD kernels take: one CTA of B/4 threads per block, the
    dither counter b·B + j in uint32, levels |l| ≤ s in int8."""
    _check_block(B)
    if not 128 <= B <= 4096:
        raise ValueError(f"block width {B} must lie in [128, 4096] for the kernels")
    if nblk * B > 2**32:
        raise ValueError("the dither counter b·B + j must fit in 32 bits")
    if not 1 <= s <= 127:
        raise ValueError(f"s={s} does not fit the int8 wire")


def check_payload(levels: torch.Tensor, norms: torch.Tensor) -> None:
    """int8 codes (n, nblk, B) with one f32 per (w, b) row: the QSGD levels
    and norms, or the natural codes and scales."""
    n, nblk, _ = levels.shape
    if levels.dtype != torch.int8 or norms.dtype != torch.float32:
        raise ValueError("quantized payloads are int8 codes and f32 row scales")
    if tuple(norms.shape) != (n, nblk):
        raise ValueError(f"row scales must have shape {(n, nblk)}")


def check_natural_block(B: int, nblk: int) -> None:
    """Shapes the natural kernels take: those of the QSGD kernels (one CTA of
    B/4 threads per block, the dither counter b·B + j in uint32)."""
    check_qsgd_block(B, nblk, 1)


@kernel_call
def qsgd_block_workers(x3d: torch.Tensor, seeds: torch.Tensor, s: int):
    """Per-worker blockwise QSGD: (n, nblk, B) f32 or bf16 + (n,) int32 seeds
    → levels (n, nblk, B) int8 and norms (n, nblk) f32."""
    n, nblk, B = x3d.shape
    if not x3d.is_cuda:
        return _ref.qsgd_block_workers_ref(x3d, seeds, s)
    check_qsgd_block(B, nblk, s)
    if x3d.dtype not in _X_SUFFIX:
        raise ValueError("qsgd_block_workers takes an f32 or bf16 buffer")
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (n,):
        raise ValueError("seeds must be an (n,) int32 tensor")
    check_cuda_buffers(x3d, seeds)
    levels = torch.empty((n, nblk, B), dtype=torch.int8, device=x3d.device)
    norms = torch.empty((n, nblk), dtype=torch.float32, device=x3d.device)
    lib = _build.library("quantize")
    err = getattr(lib, f"qsgd_block_workers_{_X_SUFFIX[x3d.dtype]}")(
        x3d.data_ptr(), seeds.data_ptr(), levels.data_ptr(), norms.data_ptr(),
        n, nblk, B, int(s), _stream(),
    )
    _build.check(err, "qsgd_block_workers")
    qsgd_block_workers.launches += 1
    return levels, norms


qsgd_block_workers.launches = 0


@kernel_call
def qsgd_dequant_mean(levels: torch.Tensor, norms: torch.Tensor, s: int) -> torch.Tensor:
    """Dequantize-and-mean of n QSGD payloads: (n, nblk, B) int8 + (n, nblk)
    f32 → (nblk, B) f32."""
    n, nblk, B = levels.shape
    if not levels.is_cuda:
        return _ref.qsgd_dequant_mean_ref(levels, norms, s)
    check_qsgd_block(B, nblk, s)
    check_payload(levels, norms)
    check_cuda_buffers(levels, norms)
    out = torch.empty((nblk, B), dtype=torch.float32, device=levels.device)
    lib = _build.library("quantize")
    err = lib.qsgd_dequant_mean(levels.data_ptr(), norms.data_ptr(), out.data_ptr(),
                                n, nblk, B, int(s), _stream())
    _build.check(err, "qsgd_dequant_mean")
    qsgd_dequant_mean.launches += 1
    return out


qsgd_dequant_mean.launches = 0


@kernel_call
def nibble_pack(q2d: torch.Tensor) -> torch.Tensor:
    """(rows, B) int8 levels in [−8, 7] → (rows, B/8) words (uint32 bit
    patterns in int32), level t of each 8 at bits [4t, 4t+4)."""
    rows, B = q2d.shape
    if B % 8:
        raise ValueError(f"block width {B} must pack into whole 32-bit words")
    if not q2d.is_cuda:
        return _ref.nibble_pack_ref(q2d)
    if q2d.dtype != torch.int8:
        raise ValueError("nibble_pack takes int8 levels")
    check_cuda_buffers(q2d)
    words = torch.empty((rows, B // 8), dtype=torch.int32, device=q2d.device)
    lib = _build.library("quantize")
    err = lib.nibble_pack(q2d.data_ptr(), words.data_ptr(), words.numel(), _stream())
    _build.check(err, "nibble_pack")
    nibble_pack.launches += 1
    return words


nibble_pack.launches = 0


@kernel_call
def nibble_unpack(words: torch.Tensor, block: int) -> torch.Tensor:
    """(rows, B/8) words → (rows, B) int8, each nibble sign-extended; the
    inverse of :func:`nibble_pack` on levels in [−8, 7]."""
    rows, nw = words.shape
    if nw * 8 != block:
        raise ValueError(f"{nw} words per row do not hold {block} levels")
    if not words.is_cuda:
        return _ref.nibble_unpack_ref(words, block)
    if words.dtype != torch.int32:
        raise ValueError("nibble_unpack takes the words as int32 bit patterns")
    check_cuda_buffers(words)
    q = torch.empty((rows, block), dtype=torch.int8, device=words.device)
    lib = _build.library("quantize")
    err = lib.nibble_unpack(words.data_ptr(), q.data_ptr(), words.numel(), _stream())
    _build.check(err, "nibble_unpack")
    nibble_unpack.launches += 1
    return q


nibble_unpack.launches = 0


@kernel_call
def natural_block_workers(x3d: torch.Tensor, seeds: torch.Tensor):
    """Per-worker blockwise natural compression: (n, nblk, B) f32 or bf16 +
    (n,) int32 seeds → codes (n, nblk, B) int8 and scales (n, nblk) f32."""
    n, nblk, B = x3d.shape
    if not x3d.is_cuda:
        return _ref.natural_block_workers_ref(x3d, seeds)
    check_natural_block(B, nblk)
    if x3d.dtype not in _X_SUFFIX:
        raise ValueError("natural_block_workers takes an f32 or bf16 buffer")
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (n,):
        raise ValueError("seeds must be an (n,) int32 tensor")
    check_cuda_buffers(x3d, seeds)
    codes = torch.empty((n, nblk, B), dtype=torch.int8, device=x3d.device)
    scales = torch.empty((n, nblk), dtype=torch.float32, device=x3d.device)
    lib = _build.library("quantize")
    err = getattr(lib, f"natural_block_workers_{_X_SUFFIX[x3d.dtype]}")(
        x3d.data_ptr(), seeds.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        n, nblk, B, _stream(),
    )
    _build.check(err, "natural_block_workers")
    natural_block_workers.launches += 1
    return codes, scales


natural_block_workers.launches = 0


@kernel_call
def natural_dequant_mean(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Decode-and-mean of n natural payloads: (n, nblk, B) int8 + (n, nblk)
    f32 → (nblk, B) f32."""
    n, nblk, B = codes.shape
    if not codes.is_cuda:
        return _ref.natural_dequant_mean_ref(codes, scales)
    check_natural_block(B, nblk)
    check_payload(codes, scales)
    check_cuda_buffers(codes, scales)
    out = torch.empty((nblk, B), dtype=torch.float32, device=codes.device)
    lib = _build.library("quantize")
    err = lib.natural_dequant_mean(codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
                                   n, nblk, B, _stream())
    _build.check(err, "natural_dequant_mean")
    natural_dequant_mean.launches += 1
    return out


natural_dequant_mean.launches = 0


#: KV-row widths the absmax kernels take: one warp per row, W/32 per lane
ABSMAX_WIDTHS = (32, 64, 128, 256)


@kernel_call
def absmax_quant_rows(x2d: torch.Tensor):
    """Per-row symmetric absmax int8: (R, W) f32 or bf16 → codes int8 (R, W)
    and scales f32 (R,), bit-equal to the plain version (the int8 KV-page
    write)."""
    R, W = x2d.shape
    if not x2d.is_cuda:
        return _ref.absmax_quant_rows_ref(x2d)
    if W not in ABSMAX_WIDTHS:
        raise ValueError(f"row width {W} must be one of {ABSMAX_WIDTHS} for the kernel")
    if x2d.dtype not in _X_SUFFIX:
        raise ValueError("absmax_quant_rows takes f32 or bf16 rows")
    check_cuda_buffers(x2d)
    codes = torch.empty((R, W), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((R,), dtype=torch.float32, device=x2d.device)
    if R == 0:
        return codes, scales
    lib = _build.library("quantize")
    err = getattr(lib, f"absmax_quant_rows_{_X_SUFFIX[x2d.dtype]}")(
        x2d.data_ptr(), codes.data_ptr(), scales.data_ptr(), R, W, _stream())
    _build.check(err, "absmax_quant_rows")
    absmax_quant_rows.launches += 1
    return codes, scales


absmax_quant_rows.launches = 0


#: dtypes of an int8 layer pool's kq, vq, k_scale, v_scale
_POOL_DTYPES = (torch.int8, torch.int8, torch.float32, torch.float32)


@kernel_call
def absmax_quant_write_pages(k_rows: torch.Tensor, v_rows: torch.Tensor, cache: dict,
                             page: torch.Tensor, row: torch.Tensor) -> None:
    """The int8 KV-page write of one layer, in place and in one launch: k
    and v rows (T, KV, W), f32 or bf16, quantized per (token, kv-head) row as
    :func:`absmax_quant_rows` does, the codes written straight into
    ``cache["kq"]`` / ``cache["vq"]`` (npage, P, KV, W) int8 at
    ``[page[t], row[t]]`` and the scales into ``cache["k_scale"]`` /
    ``cache["v_scale"]`` (npage, P, KV) f32; page and row are (T,) int32 on
    the card. Counted as a launch of ``absmax_quant_rows`` (one table row).

    Every row of pages ≥ 1 is bit-equal to
    :func:`~repro_torch.kernels.ref.absmax_quant_write_pages_ref`. Page 0,
    the null page that idle and padded tokens all write, holds codes and a
    scale from any of them (not necessarily one token's). The rows may have
    any token stride; each token's (KV, W) part must be contiguous. Called
    once per layer and serve step, so its host work is one pass of checks and
    the entry point bound once; it allocates nothing."""
    if not k_rows.is_cuda:
        _ref.absmax_quant_write_pages_ref(k_rows, v_rows, cache, page, row)
        return
    kq, vq, ks, vs = cache["kq"], cache["vq"], cache["k_scale"], cache["v_scale"]
    T, KV, W = k_rows.shape
    suffix = _X_SUFFIX.get(k_rows.dtype)
    if suffix is None or v_rows.dtype != k_rows.dtype:
        raise ValueError("absmax_quant_write_pages takes f32 or bf16 k and v rows of one dtype")
    if W not in ABSMAX_WIDTHS:
        raise ValueError(f"row width {W} must be one of {ABSMAX_WIDTHS} for the kernel")
    if v_rows.shape != k_rows.shape or T * KV >= 2**30:
        raise ValueError(f"v rows {tuple(v_rows.shape)} must match k rows {(T, KV, W)}")
    if (k_rows.stride(1), k_rows.stride(2), v_rows.stride(1), v_rows.stride(2)) != (W, 1, W, 1):
        raise ValueError("each token's (KV, W) rows must be contiguous for the kernel")
    if (kq.dtype, vq.dtype, ks.dtype, vs.dtype) != _POOL_DTYPES:
        raise ValueError("the int8 pools are int8 codes and f32 scales")
    npage, P = kq.shape[0], kq.shape[1]
    if (kq.shape[2:] != (KV, W) or vq.shape != kq.shape or ks.shape != kq.shape[:3]
            or vs.shape != ks.shape):
        raise ValueError(f"the pools must be (npage, P, {KV}, {W}) codes and (npage, P, {KV}) "
                         "scales")
    if page.dtype != torch.int32 or row.dtype != torch.int32 or page.shape != (T,) \
            or row.shape != (T,) or (T > 1 and (page.stride(0) != 1 or row.stride(0) != 1)):
        raise ValueError(f"page and row must be ({T},) contiguous int32")
    if not (kq.is_contiguous() and vq.is_contiguous() and ks.is_contiguous()
            and vs.is_contiguous()):
        raise ValueError("the page pools must be contiguous")
    d = k_rows.get_device()
    if any(t.get_device() != d for t in (v_rows, kq, vq, ks, vs, page, row)):
        raise ValueError("the quantize kernels take tensors on one device")
    if T == 0:
        return
    err = _build.entry("quantize", f"absmax_quant_write_pages_{suffix}")(
        k_rows.data_ptr(), v_rows.data_ptr(), k_rows.stride(0), v_rows.stride(0),
        page.data_ptr(), row.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), T, KV, W, npage, P, _stream_on(k_rows))
    _build.check(err, "absmax_quant_write_pages")
    absmax_quant_rows.launches += 1


@kernel_call
def absmax_dequant_rows(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(R, W) int8 codes + (R,) f32 scales → (R, W) f32 rows, code·scale
    (the int8 KV-page read). Called once per k and v, layer and decode step,
    so its host work is kept to the checks the kernel needs: one pass over
    the two tensors, the entry point bound once."""
    if not codes.is_cuda:
        return _ref.absmax_dequant_rows_ref(codes, scales)
    R, W = codes.shape
    if W % 4:
        raise ValueError(f"row width {W} must be a multiple of 4 for the kernel")
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError("absmax_dequant_rows takes int8 codes and f32 scales")
    if scales.dim() != 1 or scales.shape[0] != R:
        raise ValueError(f"scales must have shape {(R,)}")
    if R * W >= 2**34:  # 32-bit indices in the kernel; the f32 rows would not fit the card
        raise ValueError(f"{R}·{W} codes are beyond the kernel's 32-bit indices")
    cp, sp = codes.data_ptr(), scales.data_ptr()
    if not (codes.is_contiguous() and scales.is_contiguous()) or (cp | sp) % 16:
        raise ValueError("the quantize kernels take contiguous, 16-byte aligned tensors")
    if scales.get_device() != codes.get_device():
        raise ValueError("the quantize kernels take tensors on one device")
    out = codes.new_empty((R, W), dtype=torch.float32)
    if R == 0:
        return out
    err = _build.entry("quantize", "absmax_dequant_rows")(cp, sp, out.data_ptr(), R, W,
                                                          _stream_on(codes))
    _build.check(err, "absmax_dequant_rows")
    absmax_dequant_rows.launches += 1
    return out


absmax_dequant_rows.launches = 0


# ---------------------------------------------------------------------------
# Two-pass global-norm QSGD (the flat-vector wire, ``ops.py``)
# ---------------------------------------------------------------------------


def _check_flat_qsgd(x2d: torch.Tensor, s: "int | None" = None) -> None:
    """Shapes the global-norm QSGD kernels take: 4 coordinates per thread
    (B % 4 == 0), and for ``block_sumsq`` one CTA of B/4 threads per block."""
    if x2d.shape[1] % 4:
        raise ValueError(f"block width {x2d.shape[1]} must be a multiple of 4")
    if s is not None and not 1 <= s <= 126:
        raise ValueError(f"s={s} does not fit the int8 levels (|level| ≤ s + 1)")


@kernel_call
def block_sumsq(x2d: torch.Tensor) -> torch.Tensor:
    """Σx² of every block: (nblk, B) f32 or bf16 → (nblk,) f32, in the order
    of the blockwise norm (pass 1 of the global-norm QSGD)."""
    nblk, B = x2d.shape
    if not x2d.is_cuda:
        return _ref.block_sumsq_ref(x2d)
    if B % 128 or not 128 <= B <= 4096:
        raise ValueError(f"block width {B} must be a multiple of 128 in [128, 4096]")
    if x2d.dtype not in _X_SUFFIX:
        raise ValueError("block_sumsq takes an f32 or bf16 buffer")
    check_cuda_buffers(x2d)
    out = torch.empty((nblk,), dtype=torch.float32, device=x2d.device)
    lib = _build.library("quantize")
    err = getattr(lib, f"block_sumsq_{_X_SUFFIX[x2d.dtype]}")(
        x2d.data_ptr(), out.data_ptr(), nblk, B, _stream())
    _build.check(err, "block_sumsq")
    block_sumsq.launches += 1
    return out


block_sumsq.launches = 0


@kernel_call
def qsgd_quantize(x2d: torch.Tensor, u2d: torch.Tensor, norm: torch.Tensor,
                  s: int) -> torch.Tensor:
    """Pass 2: (nblk, B) f32 or bf16 x, (nblk, B) f32 dither u and the global
    norm (a 0-d f32 tensor) → (nblk, B) int8 levels ``sign(x)·⌊s·|x| / safe +
    u⌋``, safe = norm (1 where it is 0)."""
    _check_flat_qsgd(x2d, s)
    if tuple(u2d.shape) != tuple(x2d.shape):
        raise ValueError(f"dither {tuple(u2d.shape)} does not match x {tuple(x2d.shape)}")
    if not x2d.is_cuda:
        return _ref.qsgd_quantize_ref(x2d, u2d, norm, s)
    if x2d.dtype not in _X_SUFFIX or u2d.dtype != torch.float32:
        raise ValueError("qsgd_quantize takes f32 or bf16 x and an f32 dither")
    if norm.dtype != torch.float32 or norm.numel() != 1:
        raise ValueError("the norm is one f32 value")
    check_cuda_buffers(x2d, u2d, norm)
    q = torch.empty(x2d.shape, dtype=torch.int8, device=x2d.device)
    lib = _build.library("quantize")
    err = getattr(lib, f"qsgd_quantize_{_X_SUFFIX[x2d.dtype]}")(
        x2d.data_ptr(), u2d.data_ptr(), norm.data_ptr(), q.data_ptr(), x2d.numel(),
        int(s), _stream())
    _build.check(err, "qsgd_quantize")
    qsgd_quantize.launches += 1
    return q


qsgd_quantize.launches = 0


@kernel_call
def qsgd_dequantize(q2d: torch.Tensor, norm: torch.Tensor, s: int) -> torch.Tensor:
    """(nblk, B) int8 levels and the global norm (0-d f32) → (nblk, B) f32
    ``level·(norm / s)``."""
    _check_flat_qsgd(q2d, s)
    if not q2d.is_cuda:
        return _ref.qsgd_dequantize_ref(q2d, norm, s)
    if q2d.dtype != torch.int8:
        raise ValueError("qsgd_dequantize takes int8 levels")
    if norm.dtype != torch.float32 or norm.numel() != 1:
        raise ValueError("the norm is one f32 value")
    check_cuda_buffers(q2d, norm)
    out = torch.empty(q2d.shape, dtype=torch.float32, device=q2d.device)
    lib = _build.library("quantize")
    err = lib.qsgd_dequantize(q2d.data_ptr(), norm.data_ptr(), out.data_ptr(),
                              q2d.numel(), int(s), _stream())
    _build.check(err, "qsgd_dequantize")
    qsgd_dequantize.launches += 1
    return out


qsgd_dequantize.launches = 0
