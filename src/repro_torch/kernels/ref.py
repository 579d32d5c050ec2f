"""Plain PyTorch versions of the main-path kernels.

Each function is the semantic ground truth for its hand-written CUDA twin
(``randk.py`` / ``permk.py`` / ``quantize.py`` / ``epilogue.py``) and the
port of the same-named oracle in ``repro.kernels.ref``. The kernel wrappers call these only for tensors on the
CPU; on the card, ``chip_smoke.py`` and the card tests hold the kernels
against them on the same inputs.

Integer work is exact: the murmur3 hash runs in int64 masked to 32 bits
(PyTorch lacks ``>>`` and ``+`` for ``uint32`` on the CPU), with the 32-bit
constant multiplies split into 16-bit halves so no product overflows int64.
Float accumulations keep the oracle's order (workers 0..n−1, then slots
0..kb−1), so they are deterministic on every device. The one order the
reference does not fix — XLA's sum of squares behind a QSGD block norm — is
fixed here to the kernel's (:func:`qsgd_block_norms_ref`).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def div_n(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n as a true IEEE division. (On CUDA, PyTorch turns a division by a
    Python scalar into a multiply by its reciprocal, which is not exact for
    every n; a 0-d tensor divisor on x's device keeps the division.)"""
    return x / torch.tensor(float(n), dtype=x.dtype, device=x.device)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def murmur_bits_ref(seed, ctr: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over (seed, counter) → uint32 hash, as int64.

    ``seed`` is an int or an int64 tensor broadcastable against ``ctr``,
    both holding uint32 values."""
    x = (_mul32(ctr.to(torch.int64) & _MASK, 0x9E3779B9) + seed) & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _as_u32_int64(seeds: torch.Tensor) -> torch.Tensor:
    """int32 / int64 / uint32 seeds → int64 holding the uint32 bit pattern."""
    return seeds.to(torch.int64) & _MASK


def scale_values(gathered: torch.Tensor, scale: float) -> torch.Tensor:
    """``gathered · scale`` as the Pallas RandK bodies compute it: the
    product in f32 (the gathered value times f32(scale)), rounded once to
    the input's dtype. For f32 input this is also the reference oracle's
    product; for bf16 the oracle first rounds the scale to bf16 (ROADMAP C)."""
    return (gathered.to(torch.float32) * torch.tensor(
        scale, dtype=torch.float32, device=gathered.device)).to(gathered.dtype)


def randk_block_compress_ref(x2d: torch.Tensor, offsets: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """Gather host-supplied offsets and scale: x2d (nblk, B), offsets
    (nblk, kb) int32 in [0, B) → (nblk, kb) ``x[b, off] · scale`` in x's
    dtype (the plain version of ``randk_gather``)."""
    return scale_values(torch.gather(x2d, 1, offsets.to(torch.int64)), scale)


def randk_seeded_ref(x2d: torch.Tensor, seed, kb: int, scale: float):
    """Seeded RandK over one (nblk, B) buffer: offsets from the murmur3
    counter stream ``b·kb + t``, values ``x[b, off] · scale`` (the plain
    version of ``randk_seeded``)."""
    vals, offs = randk_seeded_workers_ref(
        x2d[None], torch.as_tensor([int(seed) & _MASK], device=x2d.device), kb, scale
    )
    return vals[0], offs[0]


def randk_seeded_workers_ref(x3d: torch.Tensor, seeds: torch.Tensor, kb: int,
                             scale: float):
    """Per-worker seeded RandK: x3d (n, nblk, B) + seeds (n,) → values and
    int32 offsets, both (n, nblk, kb). Each worker's counters restart at 0."""
    n, nblk, B = x3d.shape
    offs = seeded_offsets_ref(seeds.to(x3d.device), nblk, B, kb)
    vals = scale_values(torch.gather(x3d, 2, offs.to(torch.int64)), scale)
    return vals, offs


def seeded_offsets_ref(seeds: torch.Tensor, nblk: int, block: int, kb: int) -> torch.Tensor:
    """(m,) seeds → (m, nblk, kb) int32 offsets in [0, block): the murmur3
    counter stream ``b·kb + t`` of each seed, its counters restarting at 0
    (the offsets the seeded RandK kernels sample), on the seeds' device."""
    dev = seeds.device
    ctr = (
        torch.arange(kb, dtype=torch.int64, device=dev)[None, :]
        + (torch.arange(nblk, dtype=torch.int64, device=dev) * kb)[:, None]
    )
    bits = murmur_bits_ref(_as_u32_int64(seeds).view(-1, 1, 1), ctr[None])
    return (bits & (block - 1)).to(torch.int32)


def scatter_accum_ref(values: torch.Tensor, offsets: torch.Tensor,
                      block: int) -> torch.Tensor:
    """Mean over n workers of scatter-added payloads: (n, nblk, kb) ×2 →
    (nblk, block). Duplicates accumulate, in the order w = 0..n−1, then
    t = 0..kb−1; each ``scatter_add_`` call puts one index per row, so no
    call has a duplicate and the order is fixed on every device."""
    n, nblk, kb = values.shape
    out = torch.zeros((nblk, block), dtype=values.dtype, device=values.device)
    offs = offsets.to(torch.int64)
    for w in range(n):
        for t in range(kb):
            out.scatter_add_(1, offs[w, :, t : t + 1], values[w, :, t : t + 1])
    return div_n(out, n)


# ---------------------------------------------------------------------------
# PermK: one shared seeded affine permutation per block (disjoint supports)
# ---------------------------------------------------------------------------
#
# Everything after the murmur draw is taken mod B, and B (a power of two)
# divides 2^32, so the affine map and its inverse run mod B in int64: the
# products stay below B^2 and the results equal the reference's uint32
# values masked to B − 1.


def affine_perm_params_ref(seed, nblk: int, block: int, device=None):
    """Per-block affine bijection π_b(t) = (a_b·t + c_b) mod B: a_b forced
    odd, both from the murmur3 counter RNG at counters (2b, 2b+1).
    Returns a, c: (nblk,) int64 in [0, B)."""
    b = torch.arange(nblk, dtype=torch.int64, device=device)
    a = (murmur_bits_ref(int(seed) & _MASK, 2 * b) | 1) & (block - 1)
    c = murmur_bits_ref(int(seed) & _MASK, 2 * b + 1) & (block - 1)
    return a, c


def odd_inverse_ref(a: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of odd a modulo B (Newton iteration, exact after 5 steps:
    a is its own inverse mod 8 and each step doubles the correct bits)."""
    inv = a
    for _ in range(5):
        inv = (inv * ((2 - a * inv) & (block - 1))) & (block - 1)
    return inv


def permk_offsets_ref(seed, nblk: int, block: int, n: int, wid: int,
                      device=None) -> torch.Tensor:
    """Worker wid's support: int32 offsets (nblk, B/n) — the permuted slots
    [wid·C, (wid+1)·C), C = B/n; the n workers' supports partition every
    block."""
    if block % n:
        raise ValueError("worker count must divide the block width")
    chunk = block // n
    a, c = affine_perm_params_ref(seed, nblk, block, device)
    t = torch.arange(chunk, dtype=torch.int64, device=device) + int(wid) * chunk
    return ((a[:, None] * t[None, :] + c[:, None]) & (block - 1)).to(torch.int32)


def permk_seeded_workers_ref(x3d: torch.Tensor, seed):
    """PermK uplink with one shared seed: x3d (n, nblk, B) → values in x's
    dtype (scaled by n) and int32 offsets, both (n, nblk, B/n)."""
    n, nblk, B = x3d.shape
    offs = torch.stack([permk_offsets_ref(seed, nblk, B, n, w, x3d.device)
                        for w in range(n)])
    vals = torch.gather(x3d, 2, offs.to(torch.int64))
    return vals * torch.tensor(float(n), dtype=x3d.dtype, device=x3d.device), offs


def permk_concat_mean_ref(values: torch.Tensor, seed, block: int) -> torch.Tensor:
    """Mean of n PermK payloads (n, nblk, B/n) without a scatter: the chunks
    concatenate in slot order t = w·C + j and are gathered through the
    inverse permutation π⁻¹(s) = a⁻¹·(s − c) mod B, then ÷ n. Returns
    (nblk, B) f32, equal to :func:`scatter_accum_ref` on the same payloads
    (disjoint supports: no two adds meet)."""
    n, nblk, chunk = values.shape
    a, c = affine_perm_params_ref(seed, nblk, block, values.device)
    s = torch.arange(block, dtype=torch.int64, device=values.device)
    slot = s[None, :] - c[:, None]  # (nblk, B) int64, updated in place
    slot.mul_(odd_inverse_ref(a, block)[:, None]).bitwise_and_(block - 1)
    by_slot = values.permute(1, 0, 2).reshape(nblk, n * chunk)
    return div_n(torch.gather(by_slot, 1, slot).float(), n)


def _apply(g_new: torch.Tensor, x2d: torch.Tensor, gamma: float) -> torch.Tensor:
    """x' = (−γ)·g' + x in f32, the multiply and the add rounded separately,
    then cast to x's dtype (round to nearest even)."""
    neg = torch.tensor(-gamma, dtype=torch.float32, device=g_new.device)
    return (neg * g_new + x2d.float()).to(x2d.dtype)


def delta_epilogue_ref(delta2d, g2d, x2d, gamma: float):
    """Apply an already-dense round delta: g' = g + δ, x' = x − γ·g'."""
    g_new = g2d.float() + delta2d.float()
    return g_new, _apply(g_new, x2d, gamma)


def mean_epilogue_ref(gbufs: torch.Tensor, x2d: torch.Tensor, gamma: float):
    """Sync-round epilogue: g' = worker mean of the packed gradients (rows
    summed in order from zero, then ÷ n), x' = x − γ·g'."""
    n = gbufs.shape[0]
    acc = torch.zeros(gbufs.shape[1:], dtype=torch.float32, device=gbufs.device)
    for w in range(n):
        acc += gbufs[w].float()
    g_new = div_n(acc, n)
    return g_new, _apply(g_new, x2d, gamma)


def scatter_epilogue_ref(values, offsets, g2d, x2d, gamma: float):
    """Seeded-RandK epilogue: scatter-mean the n worker payloads into the
    round delta, then apply it."""
    delta = scatter_accum_ref(values.float(), offsets, g2d.shape[-1])
    return delta_epilogue_ref(delta, g2d, x2d, gamma)


# ---------------------------------------------------------------------------
# Coordinate-wise trimmed mean (and median) over the worker rows
# ---------------------------------------------------------------------------


def _compare_exchange(a: torch.Tensor, b: torch.Tensor):
    """(min, max) of two f32 tensors elementwise with −0 ordered below +0, as
    XLA's ``minimum`` / ``maximum`` order them (``torch.minimum(0., -0.)`` is
    +0). No NaN reaches here."""
    keep = (a < b) | ((a == b) & torch.signbit(a))
    return torch.where(keep, a, b), torch.where(keep, b, a)


def trimmed_mean_rows_ref(rows: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the worker axis: (n, …) → (…) f32.

    Per coordinate the n worker values (NaN replaced by +inf, so it sorts to
    the end) are sorted by an odd-even transposition network of n stages,
    and the window ``[lo, hi)`` is summed in sorted order from ``r[lo]``,
    then divided by ``hi − lo``. ``(f, n − f)`` is the f-trimmed mean; the
    median bounds of :meth:`ServerAggregator.trim_bounds` make it the
    coordinate-wise median. The network, the NaN rule and the sum order are
    those of ``repro.kernels.ref.trimmed_mean_rows_ref``; −0 sorts below +0,
    as XLA's min / max order them."""
    n = rows.shape[0]
    if not 0 <= lo < hi <= n:
        raise ValueError(f"trim window [{lo}, {hi}) invalid for n={n}")
    x = rows.float()
    x = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)
    r = list(x.unbind(0))
    for stage in range(n):
        for i in range(stage % 2, n - 1, 2):
            r[i], r[i + 1] = _compare_exchange(r[i], r[i + 1])
    acc = r[lo].clone()
    for i in range(lo + 1, hi):
        acc += r[i]
    return div_n(acc, hi - lo)


def trimmed_delta_epilogue_ref(bufs, g2d, x2d, gamma: float, lo: int, hi: int):
    """Robust compressed-round epilogue: g' = g + trimmed mean of the
    per-worker rows (n, nblk, B) f32 or bf16, x' = x − γ·g'."""
    return delta_epilogue_ref(trimmed_mean_rows_ref(bufs, lo, hi), g2d, x2d, gamma)


def trimmed_sync_epilogue_ref(bufs, x2d, gamma: float, lo: int, hi: int):
    """Robust sync-round epilogue: g' = trimmed mean of the packed worker
    gradients, x' = x − γ·g'."""
    g_new = trimmed_mean_rows_ref(bufs, lo, hi)
    return g_new, _apply(g_new, x2d, gamma)


# ---------------------------------------------------------------------------
# Packed quantization wire: blockwise QSGD and the 4-bit nibble words
# ---------------------------------------------------------------------------

#: rows of (nblk, B) processed at a time by the QSGD plain versions: bounds
#: their int64 hash temporaries at full model width (results do not depend
#: on it — every row is independent)
_ROW_CHUNK = 1 << 16


def uniform_from_bits_ref(bits: torch.Tensor) -> torch.Tensor:
    """uint32 hash bits (held in int64) → f32 uniform in [0, 1): (bits >> 8)
    < 2^24 converts exactly and the 2^-24 scale is exact."""
    return (bits >> 8).to(torch.float32) * 2.0**-24


def _sumsq_kernel_order(x3d: torch.Tensor) -> torch.Tensor:
    """Σx² of every (w, b) row of (n, nblk, B) in f32, in the kernels'
    order: thread t squares its 4 contiguous elements and adds them left to
    right, each warp of (up to) 32 threads adds its partials in a halving
    tree (p_i + p_{i+h}, h = 16, 8, …, 1), and the warps' sums are added in
    a halving tree in turn, zero-padded to a power of two (adding +0 to a
    sum of squares is exact). Returns (n, nblk) f32."""
    n, nblk, B = x3d.shape
    lanes = min(B // 4, 32)
    if B % 4 or (B // 4) % lanes or B // 4 // lanes > 32:
        raise ValueError(f"block width {B} must be a multiple of 4, and of 128 above 128, "
                         "with at most 32 warps")
    x = x3d.to(torch.float32)
    sq = x * x
    p = ((sq[..., 0::4] + sq[..., 1::4]) + sq[..., 2::4]) + sq[..., 3::4]
    p = p.reshape(n, nblk, B // 4 // lanes, lanes)
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    p = p[..., 0]
    warps = p.shape[-1]
    width = 1 << (warps - 1).bit_length()
    if width != warps:
        p = torch.nn.functional.pad(p, (0, width - warps))
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def qsgd_block_norms_ref(x3d: torch.Tensor) -> torch.Tensor:
    """ℓ2 norm of every (w, b) row of (n, nblk, B): the IEEE square root of
    :func:`_sumsq_kernel_order`'s Σx² (the kernel's fixed order). Returns
    (n, nblk) f32. (The reference sums with XLA's reduction, whose order is
    not specified: see ROADMAP C.)"""
    return torch.sqrt(_sumsq_kernel_order(x3d))


def qsgd_block_quantize_ref(x3d: torch.Tensor, norms: torch.Tensor,
                            seeds: torch.Tensor, s: int) -> torch.Tensor:
    """The quantize step of blockwise QSGD against given block norms:
    ``sign(x)·⌊s·|x| / safe + u⌋`` as int8, safe = norm (1 where it is 0),
    each operation rounded once (multiply, divide, add), with the dither u
    from worker w's murmur3 stream at counters b·B + j. x3d (n, nblk, B),
    norms (n, nblk), seeds (n,) → levels (n, nblk, B) int8."""
    n, nblk, B = x3d.shape
    dev = x3d.device
    out = torch.empty((n, nblk, B), dtype=torch.int8, device=dev)
    s_seeds = _as_u32_int64(seeds.to(dev))
    safe = torch.where(norms > 0, norms, torch.ones_like(norms)).to(torch.float32)
    j = torch.arange(B, dtype=torch.int64, device=dev)
    for b0 in range(0, nblk, _ROW_CHUNK):
        b1 = min(nblk, b0 + _ROW_CHUNK)
        ctr = torch.arange(b0, b1, dtype=torch.int64, device=dev)[:, None] * B + j
        for w in range(n):
            u = uniform_from_bits_ref(murmur_bits_ref(s_seeds[w], ctr))
            out[w, b0:b1] = _qsgd_levels(x3d[w, b0:b1], u, safe[w, b0:b1, None], s)
    return out


def _qsgd_levels(x: torch.Tensor, u: torch.Tensor, safe: torch.Tensor,
                 s: int) -> torch.Tensor:
    """``sign(x)·⌊(s·|x|) / safe + u⌋`` as int8, each operation rounded once."""
    x = x.to(torch.float32)
    level = torch.floor((x.abs() * float(s)) / safe + u)
    return (torch.sign(x) * level).to(torch.int8)


# -- the two-pass global-norm QSGD (the flat-vector wire, ``ops.py``) --------


def block_sumsq_ref(x2d: torch.Tensor) -> torch.Tensor:
    """Σx² of every block of (nblk, B) f32 / bf16, in f32 and in the order of
    :func:`qsgd_block_norms_ref` (the kernel's), without the square root:
    pass 1 of the global-norm QSGD. Returns (nblk,) f32."""
    return _sumsq_kernel_order(x2d[None])[0]


def qsgd_quantize_ref(x2d: torch.Tensor, u2d: torch.Tensor, norm: torch.Tensor,
                      s: int) -> torch.Tensor:
    """Pass 2 of the global-norm QSGD: ``sign(x)·⌊s·|x| / safe + u⌋`` as int8
    against ONE norm (a 0-d f32 tensor), safe = norm (1 where it is 0), with
    the host-supplied dither u2d (nblk, B) f32; each operation rounded once.
    x2d (nblk, B) f32 / bf16 → (nblk, B) int8."""
    nblk, _ = x2d.shape
    norm = norm.to(device=x2d.device, dtype=torch.float32)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    out = torch.empty(x2d.shape, dtype=torch.int8, device=x2d.device)
    for b0 in range(0, nblk, _ROW_CHUNK):
        b1 = min(nblk, b0 + _ROW_CHUNK)
        out[b0:b1] = _qsgd_levels(x2d[b0:b1], u2d[b0:b1], safe, s)
    return out


def qsgd_dequantize_ref(q2d: torch.Tensor, norm: torch.Tensor, s: int) -> torch.Tensor:
    """``level · (norm / s)`` in f32: the divide (a true one) and the multiply
    each rounded. q2d (nblk, B) int8 → (nblk, B) f32."""
    scale = norm.to(device=q2d.device, dtype=torch.float32) / torch.tensor(
        float(s), device=q2d.device)
    return q2d.to(torch.float32) * scale


def qsgd_block_workers_ref(x3d: torch.Tensor, seeds: torch.Tensor, s: int):
    """Per-worker blockwise s-level ℓ2 QSGD: (n, nblk, B) f32 / bf16 + (n,)
    seeds → (levels (n, nblk, B) int8, norms (n, nblk) f32). Each block is
    quantized against its own norm; every worker's counters restart at 0."""
    norms = qsgd_block_norms_ref(x3d)
    return qsgd_block_quantize_ref(x3d, norms, seeds, s), norms


def qsgd_block_ref(x2d: torch.Tensor, seed, s: int):
    """Single-worker :func:`qsgd_block_workers_ref`: (nblk, B) + one seed →
    (levels (nblk, B) int8, norms (nblk,) f32)."""
    levels, norms = qsgd_block_workers_ref(
        x2d[None], torch.as_tensor([int(seed) & _MASK], device=x2d.device), s)
    return levels[0], norms[0]


def qsgd_dequant_mean_ref(levels: torch.Tensor, norms: torch.Tensor,
                          s: int) -> torch.Tensor:
    """Dequantize-and-mean: (n, nblk, B) int8 + (n, nblk) f32 → (nblk, B)
    f32. From zero, worker by worker in order, ``acc + level·(norm_w / s)``
    (the divide, the multiply and the add each rounded), then ``acc / n``."""
    n = levels.shape[0]
    scale = norms.to(torch.float32) / torch.tensor(float(s), device=norms.device)
    acc = torch.zeros(levels.shape[1:], dtype=torch.float32, device=levels.device)
    for w in range(n):
        acc += levels[w].to(torch.float32) * scale[w, :, None]
    return div_n(acc, n)


def nibble_pack_ref(q2d: torch.Tensor) -> torch.Tensor:
    """(rows, B) int8 levels in [−8, 7] → (rows, B/8) words: level t of each
    group of 8 is a two's-complement nibble at bits [4t, 4t+4). The words
    are uint32 bit patterns held in int32 (PyTorch's uint32 lacks the ops)."""
    rows, B = q2d.shape
    if B % 8:
        raise ValueError(f"block width {B} must pack into whole 32-bit words")
    nib = (q2d.to(torch.int64) & 0xF).reshape(rows, B // 8, 8)
    word = nib[..., 0]
    for t in range(1, 8):
        word = word | (nib[..., t] << (4 * t))
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def nibble_unpack_ref(words: torch.Tensor, block: int) -> torch.Tensor:
    """(rows, B/8) words (uint32 bits in int32) → (rows, B) int8, each
    nibble sign-extended (8..15 → −8..−1); inverse of :func:`nibble_pack_ref`
    on levels in [−8, 7]."""
    rows, nw = words.shape
    if nw * 8 != block:
        raise ValueError(f"{nw} words per row do not hold {block} levels")
    w = words.to(torch.int64) & _MASK
    nib = torch.stack([(w >> (4 * t)) & 0xF for t in range(8)], dim=-1)
    return torch.where(nib >= 8, nib - 16, nib).to(torch.int8).reshape(rows, block)


def qsgd_epilogue_ref(levels, norms, g2d, x2d, gamma: float, s: int):
    """Packed-QSGD epilogue: the dequantize-and-mean of the n payloads as in
    :func:`qsgd_dequant_mean_ref`, then g' = g + δ and x' = x − γ·g'."""
    delta = qsgd_dequant_mean_ref(levels, norms, s)
    return delta_epilogue_ref(delta, g2d, x2d, gamma)


# ---------------------------------------------------------------------------
# Natural compression on the packed wire (Horváth et al. 2019)
# ---------------------------------------------------------------------------
#
# Powers of two are exact here: an exponent is read from the float's bits and
# 2^k is built from bits, never through log2 / exp2 (the reference's XLA
# versions of both are approximations: ROADMAP C). Magnitudes below 2^-126
# (subnormals) count as zero, on input and after decoding, as on the TPU and
# in XLA on the CPU, which flush them.

#: the smallest normal f32; below it a magnitude is flushed to zero
TINY = 2.0**-126


def pow2_ref(k: torch.Tensor) -> torch.Tensor:
    """2^k as f32 for integer k in [−126, 128] (int32 or int64), built from
    the exponent bits (k = 128 gives inf, as exp2 does)."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def float_exponent_ref(ax: torch.Tensor) -> torch.Tensor:
    """⌊log2 ax⌋ as int32 for normal positive f32 ax: the biased exponent
    bits minus 127 (the exact value, where XLA's log2 can be off by one)."""
    return (ax.view(torch.int32) >> 23) - 127


def _worker_row_chunks(x3d: torch.Tensor, seeds: torch.Tensor):
    """Yield (w, b0, b1, x, u): worker w's rows [b0, b1) of x3d as f32 and
    their dither u from w's murmur3 stream at counters b·B + j, in chunks of
    ``_ROW_CHUNK`` rows."""
    n, nblk, B = x3d.shape
    dev = x3d.device
    s_seeds = _as_u32_int64(seeds.to(dev))
    j = torch.arange(B, dtype=torch.int64, device=dev)
    for b0 in range(0, nblk, _ROW_CHUNK):
        b1 = min(nblk, b0 + _ROW_CHUNK)
        ctr = torch.arange(b0, b1, dtype=torch.int64, device=dev)[:, None] * B + j
        for w in range(n):
            u = uniform_from_bits_ref(murmur_bits_ref(s_seeds[w], ctr))
            yield w, b0, b1, x3d[w, b0:b1].to(torch.float32), u


def natural_exponents_ref(x: torch.Tensor):
    """The exponents natural compression quantizes against, for rows of B
    coordinates: per coordinate e = ⌊log2 |x|⌋ (int32; 0 where
    |x| < 2^-126) and per row e_ref = ⌊log2 max|x|⌋ + 1 (1 for a row of
    zeros). x (…, B) f32 or bf16 → (e (…, B), e_ref (…)), both int32."""
    ax = x.to(torch.float32).abs()
    ax = torch.where(ax >= TINY, ax, torch.zeros_like(ax))
    e = torch.where(ax > 0, float_exponent_ref(ax), 0)
    mx = ax.amax(dim=-1)
    e_ref = torch.where(mx > 0, float_exponent_ref(mx), 0) + 1
    return e, e_ref


def _natural_codes(x: torch.Tensor, u: torch.Tensor, e: torch.Tensor,
                   e_ref: torch.Tensor) -> torch.Tensor:
    """Codes of rows x (rows, B) f32 given the dither and the exponents."""
    ax = x.abs()
    keep = ax >= TINY
    ew = torch.where(keep, e.to(torch.int32), 0)
    lo = pow2_ref(ew)
    p_up = torch.where(keep, (ax - lo) / lo, torch.zeros_like(ax))
    delta = e_ref.to(torch.int32)[:, None] - (ew + (u < p_up).to(torch.int32))
    code = torch.where(x < 0, -(delta + 1), delta + 1)
    return torch.where(keep & (delta <= 126), code, 0).to(torch.int8)


def natural_quantize_ref(x3d: torch.Tensor, seeds: torch.Tensor, e: torch.Tensor,
                         e_ref: torch.Tensor) -> torch.Tensor:
    """The quantize step of blockwise natural compression given the
    exponents (e per coordinate, e_ref per row; integer or integral float
    tensors): with lo = 2^e, p_up = (|x| − lo) / lo (the subtraction and the
    division each rounded; both exact), the dither u from worker w's murmur3
    stream at counters b·B + j, e_q = e + [u < p_up] and delta = e_ref − e_q,
    the code is sign(x)·(delta + 1) as int8 — 0 where |x| < 2^-126 or
    delta > 126. x3d (n, nblk, B), seeds (n,) → codes (n, nblk, B) int8."""
    out = torch.empty(x3d.shape, dtype=torch.int8, device=x3d.device)
    for w, b0, b1, x, u in _worker_row_chunks(x3d, seeds):
        out[w, b0:b1] = _natural_codes(x, u, e[w, b0:b1], e_ref[w, b0:b1])
    return out


def natural_block_workers_ref(x3d: torch.Tensor, seeds: torch.Tensor):
    """Per-worker blockwise natural compression: (n, nblk, B) f32 / bf16 +
    (n,) seeds → (codes (n, nblk, B) int8, scales (n, nblk) f32). |x| is
    rounded to 2^e or 2^(e+1), up with probability (|x| − 2^e)/2^e (so
    E = |x|); the code is the exponent's distance below the row's reference
    scale 2^e_ref, e_ref = ⌊log2 max|x|⌋ + 1, as sign·(delta + 1)."""
    n, nblk, _ = x3d.shape
    codes = torch.empty(x3d.shape, dtype=torch.int8, device=x3d.device)
    e_refs = torch.empty((n, nblk), dtype=torch.int32, device=x3d.device)
    for w, b0, b1, x, u in _worker_row_chunks(x3d, seeds):
        e, e_refs[w, b0:b1] = natural_exponents_ref(x)
        codes[w, b0:b1] = _natural_codes(x, u, e, e_refs[w, b0:b1])
    return codes, pow2_ref(e_refs)


def natural_block_ref(x2d: torch.Tensor, seed):
    """Single-worker :func:`natural_block_workers_ref`: (nblk, B) + one seed
    → (codes (nblk, B) int8, scales (nblk,) f32)."""
    codes, scales = natural_block_workers_ref(
        x2d[None], torch.as_tensor([int(seed) & _MASK], device=x2d.device))
    return codes[0], scales[0]


def natural_decode_ref(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(…, B) int8 codes + (…) f32 scales → dense f32: sign(c)·scale·2^-(|c|−1),
    the product rounded once and flushed to 0 below 2^-126; 0 where c = 0."""
    a = codes.to(torch.int32).abs()
    mag = scales.to(torch.float32)[..., None] * pow2_ref(torch.clamp(1 - a, min=-126))
    mag = torch.where((a > 0) & (mag >= TINY), mag, torch.zeros_like(mag))
    return torch.where(codes < 0, -mag, mag)


def natural_dequant_mean_ref(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Decode-and-mean of n natural payloads: (n, nblk, B) int8 + (n, nblk)
    f32 → (nblk, B) f32, summed from zero in worker order, then ÷ n."""
    n = codes.shape[0]
    acc = torch.zeros(codes.shape[1:], dtype=torch.float32, device=codes.device)
    for w in range(n):
        acc += natural_decode_ref(codes[w], scales[w])
    return div_n(acc, n)


def natural_epilogue_ref(codes, scales, g2d, x2d, gamma: float):
    """Natural-compression epilogue: the decode-and-mean of
    :func:`natural_dequant_mean_ref`, then g' = g + δ and x' = x − γ·g'."""
    delta = natural_dequant_mean_ref(codes, scales)
    return delta_epilogue_ref(delta, g2d, x2d, gamma)


# ---------------------------------------------------------------------------
# RandK∘QSGD composition: the K-sized stage between the RandK kernels
# ---------------------------------------------------------------------------

#: dither counters of the composition's QSGD stage start here, so they never
#: meet the RandK index stream (b·kb + t) of the same seed
DITHER_CTR_OFFSET = 0x40000000


def randk_qsgd_norms_ref(vals: torch.Tensor) -> torch.Tensor:
    """ℓ2 norm of every (w, b) row of the sampled values (n, nblk, kb): the
    squares added left to right over the kb slots, then an IEEE square root
    (a fixed order on every device; the reference's XLA sum has none)."""
    v = vals.to(torch.float32)
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    for t in range(v.shape[-1]):
        acc += v[..., t] * v[..., t]
    return torch.sqrt(acc)


def qsgd_sampled_quantize_ref(vals: torch.Tensor, seeds: torch.Tensor, s: int,
                              norms: "torch.Tensor | None" = None):
    """QSGD stage of the composition on already-sampled values (n, nblk, kb):
    ``sign(v)·⌊s·|v| / safe + u⌋`` against the per-row norm of the sampled
    vector (``norms``, else :func:`randk_qsgd_norms_ref`), u from worker w's
    murmur3 stream at counters DITHER_CTR_OFFSET + b·kb + t. Returns
    (levels (n, nblk, kb) int8, norms (n, nblk) f32)."""
    n, nblk, kb = vals.shape
    dev = vals.device
    if norms is None:
        norms = randk_qsgd_norms_ref(vals)
    ctr = (torch.arange(kb, dtype=torch.int64, device=dev)[None, :]
           + (torch.arange(nblk, dtype=torch.int64, device=dev) * kb)[:, None]
           + DITHER_CTR_OFFSET)
    u = uniform_from_bits_ref(murmur_bits_ref(_as_u32_int64(seeds.to(dev)).view(n, 1, 1),
                                              ctr[None]))
    v = vals.to(torch.float32)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms)).to(torch.float32)
    level = torch.floor((v.abs() * float(s)) / safe[..., None] + u)
    return (torch.sign(v) * level).to(torch.int8), norms


def randk_qsgd_workers_ref(x3d: torch.Tensor, seeds: torch.Tensor, kb: int,
                           scale: float, s: int):
    """RandK∘QSGD uplink: seeded RandK keeps kb coordinates per block (scaled
    by ``scale``), then QSGD quantizes only those. Returns (levels int8,
    offsets int32, norms f32) of shapes (n, nblk, kb) ×2 and (n, nblk)."""
    vals, offs = randk_seeded_workers_ref(x3d, seeds, kb, scale)
    levels, norms = qsgd_sampled_quantize_ref(vals, seeds, s)
    return levels, offs, norms


def randk_qsgd_dequant_ref(levels: torch.Tensor, norms: torch.Tensor,
                           s: int) -> torch.Tensor:
    """Composition payload → f32 values for the scatter-mean: (n, nblk, kb)
    int8 + (n, nblk) f32 → levels·(norm / s), the divide and the multiply
    each rounded."""
    scale = norms.to(torch.float32) / torch.tensor(float(s), device=norms.device)
    return levels.to(torch.float32) * scale[..., None]


# ---------------------------------------------------------------------------
# Paged KV cache: block-table-gather attention and int8 page rows
# ---------------------------------------------------------------------------

#: masking sentinel, as in ``models/attention.py``: exp(−1e30 − m) is exactly
#: 0.0 in f32, so a masked position contributes an exact zero
NEG_INF = -1e30

#: f32(1/127) with numpy's bits: the double 1/127 rounded once to float (the
#: reference's ``jnp.float32(1.0 / 127.0)``, bit pattern 0x3C010204)
ABSMAX_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def attn_scale(hd: int) -> float:
    """The reference's ``1.0 / jnp.sqrt(hd)``: an f32 square root, then an
    f32 division (exact as a Python float)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))


def softmax_ref(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: the max, exp(l − m), the sum,
    then a true division."""
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def paged_gather_ref(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(npage, P, ...) pool + (S, max_pages) int32 tables → (S, max_pages·P,
    ...) per-slot flat cache views; token t of slot s lands at flat row t."""
    g = pages[tables.long()]                    # (S, maxp, P, ...)
    S, maxp, P = g.shape[:3]
    return g.reshape(S, maxp * P, *g.shape[3:])


def paged_attend_ref(q: torch.Tensor, k_flat: torch.Tensor, v_flat: torch.Tensor,
                     n_valid: torch.Tensor) -> torch.Tensor:
    """Single-query attention over gathered per-slot caches: q (S, H, hd),
    k_flat / v_flat (S, L, KV, hd), n_valid (S,) int32 valid positions per
    slot (the current token included). GQA repeat, f32 logits scaled by
    1/√hd, positions ≥ n_valid masked to −1e30, softmax, weights rounded to
    v's dtype, output in v's dtype."""
    S, H, hd = q.shape
    L, KV = k_flat.shape[1], k_flat.shape[2]
    rep = H // KV
    k_e = torch.repeat_interleave(k_flat, rep, dim=2) if rep > 1 else k_flat
    v_e = torch.repeat_interleave(v_flat, rep, dim=2) if rep > 1 else v_flat
    logits = torch.einsum("shd,skhd->shk", q, k_e).float() * attn_scale(hd)
    valid = torch.arange(L, device=q.device)[None, :] < n_valid.to(q.device)[:, None]
    logits = torch.where(valid[:, None, :], logits,
                         torch.tensor(NEG_INF, device=q.device))
    w = softmax_ref(logits)
    return torch.einsum("shk,skhd->shd", w.to(v_e.dtype), v_e)


def paged_attn_decode_ref(q: torch.Tensor, kpages: torch.Tensor, vpages: torch.Tensor,
                          tables: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Gather the pages through the block tables, then one-shot masked
    attention: q (S, H, hd); pages (npage, P, KV, hd); tables (S, max_pages)
    int32; n_valid (S,) int32 → (S, H, hd) in v's dtype."""
    return paged_attend_ref(q, paged_gather_ref(kpages, tables),
                            paged_gather_ref(vpages, tables), n_valid)


def absmax_quant_rows_ref(x2d: torch.Tensor):
    """Symmetric absmax int8 per row: (R, W) f32 / bf16 → codes int8 (R, W)
    and scales f32 (R,); scale = max|x|·f32(1/127) (a reciprocal multiply,
    as the reference), code = round-half-even(x / safe), safe = 1 where the
    scale is 0. The max is exact in any order, so codes and scales are
    bit-equal on every device."""
    x = x2d.to(torch.float32)
    scale = torch.amax(torch.abs(x), dim=1) * ABSMAX_INV127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(x / safe[:, None]).to(torch.int8), scale


def absmax_quant_write_pages_ref(k_rows, v_rows, cache, page, row) -> None:
    """The int8 KV-page write of one layer, in place: k / v rows (T, KV, hd)
    quantized per (token, kv-head) row by :func:`absmax_quant_rows_ref`, then
    the codes put at ``kq`` / ``vq[page[t], row[t]]`` and the scales at
    ``k_scale`` / ``v_scale[page[t], row[t]]`` (page, row (T,) integer
    indices). Tokens that share a (page, row), the null page's absorbed
    writes, leave one of them there, which is not specified."""
    T, KV, hd = k_rows.shape
    page, row = page.long(), row.long()
    kc, ks = absmax_quant_rows_ref(k_rows.reshape(T * KV, hd))
    vc, vs = absmax_quant_rows_ref(v_rows.reshape(T * KV, hd))
    cache["kq"][page, row] = kc.reshape(T, KV, hd)
    cache["vq"][page, row] = vc.reshape(T, KV, hd)
    cache["k_scale"][page, row] = ks.reshape(T, KV)
    cache["v_scale"][page, row] = vs.reshape(T, KV)


def absmax_dequant_rows_ref(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(R, W) int8 codes + (R,) f32 scales → (R, W) f32: one multiply."""
    return codes.to(torch.float32) * scales[:, None]


def paged_attn_decode_q8_ref(q, kq, vq, k_scale, v_scale, tables, n_valid):
    """int8-page decode attention: gather the int8 pages (kq / vq (npage, P,
    KV, hd)) and their f32 scales ((npage, P, KV)) through the block tables,
    dequantize only the gathered (S·L·KV, hd) rows, then the f32 attention
    of :func:`paged_attend_ref`."""
    kg, vg = paged_gather_ref(kq, tables), paged_gather_ref(vq, tables)
    S, L, KV, hd = kg.shape
    k = absmax_dequant_rows_ref(kg.reshape(-1, hd), paged_gather_ref(k_scale, tables).reshape(-1))
    v = absmax_dequant_rows_ref(vg.reshape(-1, hd), paged_gather_ref(v_scale, tables).reshape(-1))
    return paged_attend_ref(q, k.reshape(S, L, KV, hd), v.reshape(S, L, KV, hd), n_valid)
