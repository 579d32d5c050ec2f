"""Random-gather yardsticks: wrappers of ``csrc/yardstick.cu`` and their
plain versions.

No path of the port calls them, and they port no TPU kernel.
``chip_smoke.py`` and ``scripts/serve_kernels_ab.py`` time them, bare
4-byte loads at random offsets, beside ``randk_seeded_workers``,
``randk_gather``, ``randk_seeded`` and ``permk_seeded_workers``, whose byte
bound counts 4 bytes a gathered value, which no card reaches: each such
load pulls at least a 32-byte sector. A yardstick's time is not a lower
bound: a gather whose offsets or pace of issue suit the memory better can
beat it.

* :func:`gather`: one load per flat index k < rows·kb inside row k // kb
  (B f32 a row, any B ≥ 2) at :func:`gather_ref`'s offsets, 8 bytes written
  a load (the value and the offset), as ``randk_seeded_workers`` writes;
* :func:`affine`: ``permk_seeded_workers``' gather done directly, the B/n
  slots of worker w at ``(a·t + c) & (B − 1)`` of row (w, b) (its values
  unscaled), where the kernel stages whole rows.

Each takes ``unroll`` (loads a thread issues before any store) and
``threads`` a CTA; a yardstick's time is the fastest over :data:`SWEEP`.
Given CPU tensors a wrapper returns its plain version.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as _ref
from .randk import _check_block, _stream

#: (unroll, threads a CTA) of every timed launch; the fastest is the time
SWEEP = tuple((u, t) for u in (1, 4, 8) for t in (128, 256))
_GOLDEN = 0x9E3779B9


def divide_magic(d: int) -> tuple[int, int]:
    """(m, e) for a division by d ≥ 2 as a 32-bit multiply-high: m =
    ceil(2^32 / d) and e = m·d − 2^32 < d. Then ⌊k·m / 2^32⌋ = ⌊k / d⌋ for
    every k with k·e < 2^32 (k = q·d + r: k·m / 2^32 = q + (r + k·e / 2^32) / d)."""
    m = -(-(1 << 32) // d)
    return m, m * d - (1 << 32)


def _check_launch(unroll: int, threads: int) -> None:
    if unroll not in (1, 4, 8) or threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"unroll {unroll} must be 1, 4 or 8 and threads {threads} a "
                         "multiple of 32 in [32, 1024]")


def gather_magic(rows: int, B: int, kb: int) -> int:
    """The multiply-high constant that finds row k // kb, after checking
    that the kernel's 32-bit flat index k and that division hold every
    k < rows·kb (0 for kb = 1)."""
    if B < 2 or B >= 2**31 or kb < 1 or rows * kb >= 2**31:
        raise ValueError(f"{rows}·{kb} gathers leave the yardstick's 32-bit index")
    if kb == 1:
        return 0
    magic, e = divide_magic(kb)
    if (rows * kb - 1) * e >= 2**32:
        raise ValueError(f"kb={kb}: the multiply-high is inexact over {rows * kb} gathers")
    return magic


def gather_offsets_ref(rows: int, B: int, kb: int, device=None) -> torch.Tensor:
    """(rows, kb) int32 offsets: for k = r·kb + t, ⌊h·B / 2^32⌋ of h =
    (k·k mod 2^32)·0x9E3779B9 mod 2^32 (the top lg(B) bits of h where B is
    a power of two)."""
    k = torch.arange(rows * kb, dtype=torch.int64, device=device)
    h = _ref._mul32((k * k) & 0xFFFFFFFF, _GOLDEN)  # k < 2^31: k·k fits int64
    return ((h * B) >> 32).to(torch.int32).reshape(rows, kb)  # h·B < 2^63


def gather_ref(x2d: torch.Tensor, kb: int):
    """(rows, B) f32 → values and offsets (rows, kb): x[r, off[r, t]]."""
    rows, B = x2d.shape
    offs = gather_offsets_ref(rows, B, kb, x2d.device)
    return torch.gather(x2d, 1, offs.to(torch.int64)), offs


def gather(x2d: torch.Tensor, kb: int, unroll: int = 4, threads: int = 256):
    """The gather yardstick on (rows, B) f32: values and int32 offsets
    (rows, kb), equal to :func:`gather_ref`."""
    rows, B = x2d.shape
    magic = gather_magic(rows, B, kb)
    _check_launch(unroll, threads)
    if not x2d.is_cuda:
        return gather_ref(x2d, kb)
    if x2d.dtype != torch.float32 or not x2d.is_contiguous():
        raise ValueError("the gather yardstick takes a contiguous f32 buffer")
    vals = torch.empty((rows, kb), dtype=torch.float32, device=x2d.device)
    offs = torch.empty((rows, kb), dtype=torch.int32, device=x2d.device)
    if rows:
        err = _build.library("yardstick").yardstick_gather(
            x2d.data_ptr(), vals.data_ptr(), offs.data_ptr(), rows, B, kb, magic, unroll,
            threads, _stream())
        _build.check(err, "yardstick_gather")
    return vals, offs


def affine_ref(x3d: torch.Tensor, seed):
    """(n, nblk, B) → values (unscaled, x's dtype) and int32 offsets, both
    (n, nblk, B/n), at ``permk_seeded_workers``' offsets."""
    n, nblk, B = x3d.shape
    offs = torch.stack([_ref.permk_offsets_ref(seed, nblk, B, n, w, x3d.device)
                        for w in range(n)])
    return torch.gather(x3d, 2, offs.to(torch.int64)), offs


def affine(x3d: torch.Tensor, seed: int, unroll: int = 4, threads: int = 256):
    """The affine yardstick on (n, nblk, B) f32 with B/n a power of two:
    values and int32 offsets (n, nblk, B/n), equal to :func:`affine_ref`."""
    n, nblk, B = x3d.shape
    _check_block(B)
    if n < 1 or B % n or (B // n) & (B // n - 1):
        raise ValueError(f"B/n = {B}/{n} must be a power of two")
    if nblk >= 2**31:
        raise ValueError("one CTA a block: nblk must fit a grid")
    _check_launch(unroll, threads)
    if not x3d.is_cuda:
        return affine_ref(x3d, seed)
    if x3d.dtype != torch.float32 or not x3d.is_contiguous():
        raise ValueError("the affine yardstick takes a contiguous f32 buffer")
    vals = torch.empty((n, nblk, B // n), dtype=torch.float32, device=x3d.device)
    offs = torch.empty((n, nblk, B // n), dtype=torch.int32, device=x3d.device)
    if nblk:
        err = _build.library("yardstick").yardstick_affine(
            x3d.data_ptr(), int(seed) & 0xFFFFFFFF, vals.data_ptr(), offs.data_ptr(), n,
            nblk, B, unroll, threads, _stream())
        _build.check(err, "yardstick_affine")
    return vals, offs
