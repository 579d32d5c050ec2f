"""threefry2x32 key derivation, bit for bit as ``jax.random`` draws it.

The MARINA round derives all of its randomness from a JAX-style PRNG key:
``c_k ~ Be(p)`` from ``split`` + ``bernoulli``, the per-worker uint32 kernel
seeds from ``split`` + ``bits``, PP-MARINA's cohort from ``randint`` or
``permutation``, and the per-step key from ``fold_in(PRNGKey(seed), step)``, the ``garbage`` fault's noise from
``normal`` and the simulated round times from ``normal`` or
``exponential``. For the port to reproduce the reference
trajectory under the same keys, these draws must agree to the bit. This
module reimplements them under JAX 0.9's defaults (``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``).

Keys and most draws are tiny host-side values (the per-round work is a
handful of hashes), so the arithmetic runs in numpy ``uint32``, whose
wrap-around arithmetic is exact; the results are numpy arrays. A key is a
``(2,)`` ``uint32`` array, a stack of keys ``(..., 2)``.

Sampling at a temperature draws ``categorical``: the Gumbel-max trick over
``gumbel``'s noise, whose uniforms (``uniform`` with ``minval`` = tiny) are
bit-equal to JAX's.

``bits``, ``uniform``, ``randint`` and ``gumbel`` also draw on a device
(``device=...``): the flat-vector wire needs one dither or offset per
coordinate of a full model (``kernels/ops.py``), where the host arrays would
take minutes and tens of GB. There the cipher runs in PyTorch ``int64``
masked to 32 bits (PyTorch's ``uint32`` lacks ``+`` and ``>>`` on the CPU),
in chunks of the counter range, and returns tensors bit-equal to the numpy
draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over x1/x2.

    Mirrors ``jax._src.prng._threefry2x32_lowering``."""
    k1 = np.asarray(k1, _U32)
    k2 = np.asarray(k2, _U32)
    shape = np.broadcast_shapes(np.shape(x1), np.shape(x2), k1.shape, k2.shape)
    x = [
        np.array(np.broadcast_to(np.asarray(x1, _U32), shape)).reshape(-1),
        np.array(np.broadcast_to(np.asarray(x2, _U32), shape)).reshape(-1),
    ]
    k1 = np.broadcast_to(k1, shape).reshape(-1)
    k2 = np.broadcast_to(k2, shape).reshape(-1)
    ks = [k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA)]
    x[0] = x[0] + ks[0]
    x[1] = x[1] + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0].reshape(shape), x[1].reshape(shape)


def _iota_2x32(shape: tuple):
    """(hi, lo) uint32 halves of a row-major uint64 iota of ``shape``."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is taken
    as a 32-bit integer, so the key is ``[0, seed mod 2^32]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` → ``(num, 2)`` keys (fold-like split)."""
    key = np.asarray(key, _U32)
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: hash of the counter pair (0, data)."""
    key = np.asarray(key, _U32)
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([b1[0], b2[0]], _U32)


def bits(key, shape: tuple = (), device=None):
    """``jax.random.bits(key, shape, uint32)``: a numpy uint32 array, or with
    ``device`` an int64 tensor on it holding the uint32 values."""
    if device is not None:
        return _device_draw(key, shape, device, torch.int64, lambda b: b)
    key = np.asarray(key, _U32)
    shape = tuple(shape)
    if shape:
        hi, lo = _iota_2x32(shape)
    else:
        hi = lo = np.zeros((), _U32)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key, shape: tuple = (), minval: float = 0.0, maxval: float = 1.0, device=None):
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32: the
    top 23 bits become the mantissa of a float f in [1, 2); then
    ``max(min, (f − 1)·(max − min) + min)`` in float32, the multiply-add
    rounded once, as XLA fuses it under ``jit`` (an exact product in
    float64). A numpy array, or with ``device`` a tensor on it
    (bit-equal)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    if device is not None:
        return _device_draw(key, shape, device, torch.float32,
                            lambda b: _uniform_from_bits_t(b, float(lo), float(hi)))
    b = bits(key, shape)
    f = ((b >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma_f32(f, hi - lo, lo))


#: ``jnp.finfo(float32).tiny``: the lower end of the Gumbel draw's uniforms
TINY = float(np.finfo(np.float32).tiny)


def gumbel(key, shape: tuple = (), device=None):
    """``jax.random.gumbel(key, shape)`` in its default mode "low":
    −log(−log(u)) of ``uniform(key, shape, minval=tiny, maxval=1)``. The
    uniforms are bit-equal to JAX's; the two logarithms are taken in
    float64 and rounded once to float32 (host: numpy; ``device``: PyTorch),
    where XLA takes them in float32 with its own approximate ``log``: within
    2 units of ulp(max(|g|, 1)) of JAX's value (ROADMAP C). A numpy array,
    or with ``device`` a tensor on it."""
    if device is not None:
        u = uniform(key, shape, TINY, 1.0, device=device).double()
        return (-torch.log(-torch.log(u))).float()
    u = uniform(key, shape, TINY, 1.0).astype(np.float64)
    return (-np.log(-np.log(u))).astype(np.float32)


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis (mode
    "low", the Gumbel-max trick): the first index of the largest
    ``logits + gumbel(key, logits.shape)``. ``logits`` float32, a tensor
    (the draw on its device) or a numpy array."""
    if isinstance(logits, torch.Tensor):
        if logits.dtype != torch.float32:
            raise ValueError(f"categorical draws float32 Gumbel noise; logits are {logits.dtype}")
        return torch.argmax(gumbel(key, tuple(logits.shape), device=logits.device) + logits,
                            dim=-1)
    logits = np.asarray(logits)
    if logits.dtype != np.float32:
        raise ValueError(f"categorical draws float32 Gumbel noise; logits are {logits.dtype}")
    return np.argmax(gumbel(key, logits.shape) + logits, axis=-1)


def bernoulli(key, p: float, shape: tuple = ()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < float32(p)``."""
    return uniform(key, shape) < np.float32(p)


def randint(key, shape: tuple, minval: int, maxval: int, device=None):
    """``jax.random.randint(key, shape, minval, maxval)`` in int32: two
    ``bits`` streams reduced modulo the span, the high one through the
    multiplier ``(2^16 mod span)^2 mod span``, all in wrapping uint32. A
    numpy array, or with ``device`` a tensor on it."""
    if not -(2**31) <= minval <= maxval <= 2**31 - 1:
        raise ValueError("minval and maxval must be int32 values, minval <= maxval")
    shape = tuple(shape)
    k1, k2 = split(key)
    if device is not None:
        return _device_randint(k1, k2, shape, minval, maxval, device)
    hi = bits(k1, shape).reshape(-1).astype(np.uint64)
    lo = bits(k2, shape).reshape(-1).astype(np.uint64)
    span = max(maxval - minval, 1)  # JAX returns minval when maxval <= minval
    m = 2**16 % span
    mult = np.uint64(((m * m) & 0xFFFFFFFF) % span)
    mask = np.uint64(0xFFFFFFFF)
    off = (((hi % np.uint64(span)) * mult) & mask) + lo % np.uint64(span)
    off = (off & mask) % np.uint64(span)
    out = (off.astype(np.int64) + minval + 2**31) % 2**32 - 2**31  # int32 wrap
    return out.astype(np.int32).reshape(shape)


# ---------------------------------------------------------------------------
# Device draws: the same cipher in int64 tensors, chunk by chunk
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
#: counters per chunk of a device draw: bounds its int64 temporaries
#: (results do not depend on it — every counter is hashed on its own)
_CHUNK = 1 << 23


def _threefry2x32_t(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """:func:`threefry2x32` on int64 tensors of uint32 values, every sum
    masked to 32 bits; x1 and x2 are overwritten."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = x1.add_(ks[0]).bitwise_and_(_M32)
    x1 = x2.add_(ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            x1 = (x1 << r).bitwise_and_(_M32).bitwise_or_(x1 >> (32 - r))
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def _bits_chunk(key, c0: int, c1: int, device) -> torch.Tensor:
    """``bits`` of the flat counters [c0, c1) as int64 uint32 values."""
    return _bits_at(key, torch.arange(c0, c1, dtype=torch.int64, device=device))


def _bits_at(key, idx: torch.Tensor) -> torch.Tensor:
    """``bits`` of the flat counters ``idx`` (int64) as int64 uint32 values."""
    key = np.asarray(key, _U32)
    b1, b2 = _threefry2x32_t(int(key[0]), int(key[1]), idx >> 32, idx & _M32)
    return b1.bitwise_xor_(b2)


def _device_draw(key, shape: tuple, device, dtype, finish) -> torch.Tensor:
    """A draw of ``shape`` on ``device``: ``finish`` maps each chunk's bits
    to the output values."""
    shape = tuple(shape)
    n = math.prod(shape)
    if torch.device(device).type == "meta":     # shapes only: nothing to hash
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.empty((n,), dtype=dtype, device=device)
    for c0 in range(0, n, _CHUNK):
        c1 = min(n, c0 + _CHUNK)
        out[c0:c1] = finish(_bits_chunk(key, c0, c1, device))
    return out.reshape(shape)


def _uniform_from_bits_t(b: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """uniform's float32 from int64 uint32 bits: mantissa bits → [1, 2) − 1,
    then ·(hi − lo) + lo rounded once to float32 and max(lo, ·) (lo, hi
    float32 values)."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if (lo, hi) != (0.0, 1.0):  # the multiply-add rounded once (uniform)
        f = (f.double() * float(np.float32(hi) - np.float32(lo)) + lo).float()
    return torch.clamp_min(f, lo)


def _mul32_t(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 x in [0, 2^32) and c < 2^32, the constant
    split into 16-bit halves so no product overflows int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _device_randint(k1, k2, shape: tuple, minval: int, maxval: int, device):
    """:func:`randint` on ``device`` from its two subkeys."""
    n = math.prod(shape)
    if torch.device(device).type == "meta":     # shapes only: nothing to hash
        return torch.empty(shape, dtype=torch.int32, device=device)
    out = torch.empty((n,), dtype=torch.int32, device=device)
    for c0 in range(0, n, _CHUNK):
        c1 = min(n, c0 + _CHUNK)
        out[c0:c1] = randint_at(k1, k2, torch.arange(c0, c1, dtype=torch.int64,
                                                     device=device), minval, maxval)
    return out.reshape(shape)


def randint_at(k1, k2, counters: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """:func:`randint`'s int32 values at the flat ``counters`` (int64) of a
    draw whose key splits into ``k1``, ``k2``, on the counters' device: a
    draw's elements without the rest of it."""
    span = max(maxval - minval, 1)
    m = 2**16 % span
    mult = ((m * m) & _M32) % span
    hi = _bits_at(k1, counters)
    lo = _bits_at(k2, counters)
    off = ((_mul32_t(hi % span, mult) + lo % span) & _M32) % span
    return ((off + minval + 2**31) % 2**32 - 2**31).to(torch.int32)


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int32) reordered by
    ``ceil(3·ln n / ln(2^32 − 1))`` rounds of a stable sort on fresh ``bits``
    keys, each round splitting its own subkey."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    key = np.asarray(key, _U32)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(bits(sub, (n,)), kind="stable")]
    return x


#: XLA's float32 ``erf_inv`` (Giles' single-precision approximation): the
#: polynomial's coefficients in w = −log1p(−x²), for w < 5 and w ≥ 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """log1p of float32 values, correctly rounded to float32 (through
    float64). XLA's own log1p is an approximation within 1 ulp of it."""
    return np.log1p(x.astype(np.float64)).astype(np.float32)


def _fma_f32(a, b, c) -> np.ndarray:
    """a·b + c of float32 values rounded once to float32, as XLA's fused
    multiply-add on the CPU: the product is exact in float64."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``: the polynomial in w evaluated with fused
    multiply-adds, as XLA compiles it on the CPU; ±1 map to ±inf."""
    f32 = np.float32
    x = x.astype(f32)
    with np.errstate(divide="ignore", invalid="ignore"):  # x = ±1: w = inf
        w = -_log1p_f32(-(x * x))
        small = w < f32(5.0)
        w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
        coef = lambda i: np.where(small, f32(_ERFINV_LT5[i]), f32(_ERFINV_GE5[i]))
        p = coef(0)
        for i in range(1, len(_ERFINV_LT5)):
            p = _fma_f32(p, w, coef(i))
        return np.where(np.abs(x) == f32(1.0), x * f32(np.inf), (p * x).astype(f32))


def normal(key, shape: tuple = ()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: ``√2·erf_inv(u)`` with u
    uniform on (−1, 1) (``uniform``'s bits, scaled by (1 − lo) and shifted by
    lo = nextafter(−1, 0)). Every step up to the logarithm is bit-equal to
    JAX's; XLA's log1p is an approximation within 1 ulp of the correctly
    rounded one used here, so a value may differ from JAX's by a few ulp
    (≤ 3 over the parity sweep)."""
    f32 = np.float32
    lo = np.nextafter(f32(-1.0), f32(0.0))
    b = bits(key, shape)
    floats = ((b >> _U32(9)) | _U32(0x3F800000)).view(f32) - f32(1.0)
    u = np.maximum(lo, (floats * (f32(1.0) - lo) + lo).astype(f32))
    return (f32(np.sqrt(2)) * _erf_inv_f32(u)).astype(f32)


def exponential(key, shape: tuple = ()) -> np.ndarray:
    """``jax.random.exponential(key, shape)`` in float32: −log1p(−u) of
    ``uniform``. Within 1 ulp of JAX's (its log1p is an approximation)."""
    return -_log1p_f32(-uniform(key, shape))


def key_to_seed(key) -> int:
    """PRNG key → uint32 seed for the counter-based kernel RNG
    (``repro.core.flat.key_to_seed``)."""
    return int(bits(key))
