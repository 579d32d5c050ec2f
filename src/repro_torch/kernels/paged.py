"""Paged-KV decode attention: the wrapper of the Hopper kernel in
``csrc/paged.cu`` and the int8-page route.

Ports ``repro.kernels.paged::paged_attn_decode`` (one-query GQA attention
over the KV pages a block table names) and ``::paged_attn_decode_q8``. A
wrapper given CUDA tensors launches its kernel (or raises); given CPU tensors
it returns the plain version from :mod:`repro_torch.kernels.ref`. The kernel
counts its launches in ``paged_attn_decode.launches``.

The kernel serves each (slot, kv-head) pair with a cluster of C CTAs that
split the slot's pages; :func:`launch_plan` picks C and the shared memory
from the static shape, and :func:`smem_bytes` / :func:`rank_pages` repeat
the kernel's layout and split, so the CPU tests hold them.

The int8 route is not a kernel in the reference either (a gather, a
dequantize of the gathered rows, then the plain attention): here the gathered
``(S·L·KV, hd)`` rows go through the ``absmax_dequant_rows`` kernel, the same
one multiply per element as the reference's ``kgf * ks[..., None]``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.roofline.memory import kernel_call

from . import _build
from . import quantize
from . import ref as _ref
from .randk import _stream_on

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: head widths and GQA group sizes (H / KV) the kernel is instantiated for;
#: hd 256 and H / KV > 8 are refused (no ported config pages them)
HEAD_DIMS = (32, 64, 128)
GROUPS = (1, 2, 3, 4, 5, 6, 7, 8)
#: the kernel's layout (csrc/paged.cu): positions per staged tile, tiles in
#: the ring, bytes of the max / sum exchange area, the shared memory one CTA
#: may use on the H100
TILE, STAGES, SMALL, SMEM_LIMIT = 32, 2, 512, 232_448
#: threads a CTA with f32 pages (each holds one float of the split sums)
F32_THREADS = 256
#: cluster sizes (the portable maximum is 8); a cluster is doubled while a
#: rank could hold more than ``RANK_POSITIONS`` positions or the grid would
#: hold fewer than ``FILL_CTAS`` CTAs (about four per SM of the H100's 132),
#: as tuned on the H100 (PERF.md, the kernel table)
CLUSTER_SIZES = (1, 2, 4, 8)
RANK_POSITIONS, FILL_CTAS = 512, 512


def smem_bytes(elt: int, hd: int, rep: int, P: int, maxp: int, C: int) -> int:
    """Dynamic shared memory of one CTA (csrc/paged.cu::paged_smem_bytes):
    a ring of ``STAGES`` tiles of rows padded by 16 bytes, the partial output
    and (f32) q and one float for each of the 256 threads' split sums, the
    exchange area, the slot's table row, the rank's logits (each head's row
    padded to a multiple of 4)."""
    ppr = -(-maxp // C)
    f32 = 4 * (rep * hd + F32_THREADS) if elt == 4 else 0
    return (STAGES * TILE * (hd * elt + 16) + 4 * rep * hd + f32 + SMALL
            + 16 * -(-maxp // 4) + 16 * rep * -(-ppr * P // 4))


def rank_pages(pages: int, C: int) -> list[tuple[int, int]]:
    """The pages [p0, p1) of a slot's block table that each rank of a
    cluster of C serves, as the kernel splits them: the ``pages`` =
    ceil(n_valid / P) pages that hold valid positions (n_valid clamped to
    max_pages·P, and all of them where n_valid ≤ 0), evenly."""
    return [(c * pages // C, (c + 1) * pages // C) for c in range(C)]


@functools.lru_cache(maxsize=None)
def launch_plan(S: int, KV: int, hd: int, rep: int, P: int, maxp: int,
                elt: int) -> tuple[int, int]:
    """(C, shared-memory bytes) for a launch: the smallest cluster size in
    ``CLUSTER_SIZES`` at which a rank holds at most ``RANK_POSITIONS``
    positions, the grid holds at least ``FILL_CTAS`` CTAs and the layout fits
    ``SMEM_LIMIT``, and no larger than max_pages. Raises where even C = 8
    does not fit the shared memory."""
    C = 1
    while 2 * C <= min(CLUSTER_SIZES[-1], maxp) and (
            -(-maxp // C) * P > RANK_POSITIONS or S * KV * C < FILL_CTAS
            or smem_bytes(elt, hd, rep, P, maxp, C) > SMEM_LIMIT):
        C *= 2
    smem = smem_bytes(elt, hd, rep, P, maxp, C)
    if smem > SMEM_LIMIT:
        raise ValueError(f"max_pages·P = {maxp * P} positions need {smem} bytes of shared "
                         f"memory per CTA at a cluster of {C}: the kernel takes at most "
                         f"{SMEM_LIMIT}")
    return C, smem


@functools.lru_cache(maxsize=None)
def _scale(hd: int) -> float:
    return _ref.attn_scale(hd)




def check_paged_shapes(q, kpages, vpages, tables, n_valid) -> None:
    """Raise unless the kernel takes these operands."""
    S, H, hd = q.shape
    P, KV = kpages.shape[1], kpages.shape[2]
    if kpages.shape != vpages.shape or kpages.shape[3] != hd:
        raise ValueError("k / v pages must both be (npage, P, KV, hd) with q's hd")
    if hd not in HEAD_DIMS or H % KV or H // KV not in GROUPS:
        raise ValueError(f"hd {hd} and H / KV = {H}/{KV} must lie in {HEAD_DIMS} "
                         f"and {GROUPS} for the kernel")
    if not (q.dtype == kpages.dtype == vpages.dtype) or q.dtype not in _SUFFIX:
        raise ValueError("q and the pages must share one dtype, f32 or bf16")
    if tables.dtype != torch.int32 or tables.dim() != 2 or tables.shape[0] != S:
        raise ValueError(f"tables must be an (S, max_pages) int32 tensor with S = {S}")
    if n_valid.dtype != torch.int32 or tuple(n_valid.shape) != (S,):
        raise ValueError(f"n_valid must be an ({S},) int32 tensor")
    if P < 1 or tables.shape[1] * P >= 2**31:
        raise ValueError("max_pages·P must fit in int32")
    for t in (q, kpages, vpages, tables, n_valid):
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != q.device:
            raise ValueError("the paged kernel takes contiguous, 16-byte aligned "
                             "tensors on one device")
    launch_plan(S, KV, hd, H // KV, P, tables.shape[1], q.element_size())


@kernel_call
def paged_attn_decode(q: torch.Tensor, kpages: torch.Tensor, vpages: torch.Tensor,
                      tables: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Block-table-gather single-query attention: q (S, H, hd); pages (npage,
    P, KV, hd); tables (S, max_pages) int32 (page 0 = null); n_valid (S,)
    int32 valid positions per slot, the current token included → (S, H, hd)
    in v's dtype."""
    if not q.is_cuda:
        return _ref.paged_attn_decode_ref(q, kpages, vpages, tables, n_valid)
    check_paged_shapes(q, kpages, vpages, tables, n_valid)
    S, H, hd = q.shape
    P, KV = kpages.shape[1], kpages.shape[2]
    maxp = tables.shape[1]
    C, smem = launch_plan(S, KV, hd, H // KV, P, maxp, q.element_size())
    out = torch.empty((S, H, hd), dtype=vpages.dtype, device=q.device)
    err = _build.entry("paged", f"paged_attn_decode_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), kpages.data_ptr(), vpages.data_ptr(), tables.data_ptr(),
        n_valid.data_ptr(), out.data_ptr(), S, H, KV, P, maxp, hd, _scale(hd), C, smem,
        _stream_on(q))
    _build.check(err, "paged_attn_decode")
    paged_attn_decode.launches += 1
    return out


paged_attn_decode.launches = 0


def paged_attn_decode_q8(q, kq, vq, k_scale, v_scale, tables, n_valid) -> torch.Tensor:
    """int8-page decode attention: gather the int8 pages (kq / vq (npage, P,
    KV, hd)) and their f32 scales ((npage, P, KV)) through the block tables,
    dequantize the gathered (S·L·KV, hd) rows with ``absmax_dequant_rows``,
    then the f32 attention of the plain version."""
    kg, vg = _ref.paged_gather_ref(kq, tables), _ref.paged_gather_ref(vq, tables)
    S, L, KV, hd = kg.shape
    ks = _ref.paged_gather_ref(k_scale, tables).reshape(-1)
    vs = _ref.paged_gather_ref(v_scale, tables).reshape(-1)
    k = quantize.absmax_dequant_rows(kg.reshape(-1, hd), ks)
    v = quantize.absmax_dequant_rows(vg.reshape(-1, hd), vs)
    return _ref.paged_attend_ref(q, k.reshape(S, L, KV, hd), v.reshape(S, L, KV, hd),
                                 n_valid)
