"""The random-gather yardsticks' plain versions and host-side checks, and
the QSGD dequant-mean's order of operations, on the CPU.

``kernels/yardstick.py`` times 4-byte loads at random offsets on the card:
no path calls it; ``chip_smoke.py`` prints the RandK and PermK gathers'
times beside its time. Here: its row index by a multiply-high is exact over
every shape it accepts, its gather offsets spread over a row's sectors as a
random draw (and row 1's murmur3 offsets) does, and its affine gather takes
``permk_seeded_workers``' offsets (the JAX reference's). Then the order of
``csrc/packed.cuh::packed_sum_kernel`` under ``qsgd_dequant_mean``'s tail,
emulated (each warp's norm_w / s computed once, ÷ n as a multiply by the
exact 1/n for n a power of two), against the plain version bit for bit and
the JAX reference within its rounding bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.kernels import ref as jref
from repro_torch.kernels import yardstick
from repro_torch.kernels import ref as tref

U = 2.0**-24


def _murmur(seed, ctr):
    x = (ctr.astype(np.uint64) * 0x9E3779B9 + np.uint64(seed)) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x


@pytest.mark.parametrize("kbs", [range(2, 257), range(257, 1025), [1536, 2047, 3000, 4095]],
                         ids=["2-256", "257-1024", "large"])
def test_gather_multiply_high_is_exact_over_every_index(kbs):
    """The gather yardstick finds row k // kb as ⌊k·m / 2^32⌋: exact over
    every k < rows·kb of a shape ``gather_magic`` accepts."""
    for kb in kbs:
        rows = 4000 // kb + 3
        m, e = yardstick.divide_magic(kb)
        assert yardstick.gather_magic(rows, 4096, kb) == m and 0 <= e < kb
        k = np.arange(rows * kb, dtype=np.uint64)
        np.testing.assert_array_equal((k * np.uint64(m)) >> np.uint64(32), k // kb)
    # row 1's production shape: e = 4 for kb = 20, so k·e stays below 2^32
    assert yardstick.divide_magic(20) == (214748365, 4)
    assert yardstick.gather_magic(4 * 453113, 1024, 20) == 214748365


def _distinct(offs, shift):
    ids = np.sort(offs >> shift, axis=1)
    return float((1 + (np.diff(ids, axis=1) != 0).sum(1)).mean())


def test_gather_yardstick_offsets_spread_like_a_random_draw():
    """A row of 20 gathers touches as many 32-byte sectors and 64-byte
    segments as a random draw (and row 1's murmur3 offsets) would, within
    1 %; one multiply of k alone would touch a distinct sector every time."""
    rows, B, kb = 20000, 1024, 20
    offs = yardstick.gather_offsets_ref(rows, B, kb).numpy()
    assert offs.min() >= 0 and offs.max() < B
    k = np.arange(rows * kb, dtype=np.uint64)
    row1 = (_murmur(12345, k) & (B - 1)).reshape(rows, kb).astype(np.int64)
    fib = (((k * 0x9E3779B9) & 0xFFFFFFFF) >> 22).reshape(rows, kb).astype(np.int64)
    for shift, cells in ((3, 128), (4, 64)):
        drawn = cells * (1 - (1 - 1 / cells) ** kb)
        assert _distinct(offs, shift) == pytest.approx(drawn, rel=0.01)
        assert _distinct(row1, shift) == pytest.approx(drawn, rel=0.01)
    assert _distinct(fib, 3) == kb


@pytest.mark.parametrize("B", [2, 64, 1024, 2048])
def test_gather_offsets_are_the_top_bits_at_a_power_of_two(B):
    """The multiply-high ⌊h·B / 2^32⌋ is the top lg(B) bits of h where B is a
    power of two: the offsets the row-1 and wire shapes have always used."""
    k = np.arange(5000 * 7, dtype=np.uint64)
    h = ((k * k) & 0xFFFFFFFF) * 0x9E3779B9 & 0xFFFFFFFF
    top = (h >> np.uint64(32 - (B.bit_length() - 1))).reshape(5000, 7).astype(np.int64)
    np.testing.assert_array_equal(yardstick.gather_offsets_ref(5000, B, 7).numpy(), top)


def test_gather_yardstick_at_the_transport_width():
    """Rows of 2816 f32 (the transport's Qwen1.5-0.5B MLP leaf, kb = 22):
    offsets fill [0, 2816) and touch as many of a row's 352 sectors as a
    random draw would, within 1 %."""
    rows, B, kb = 20000, 2816, 22
    offs = yardstick.gather_offsets_ref(rows, B, kb).numpy()
    assert offs.min() == 0 and offs.max() == B - 1
    assert yardstick.gather_magic(98_304, B, kb) > 0
    for shift, cells in ((3, B // 8), (4, B // 16)):
        drawn = cells * (1 - (1 - 1 / cells) ** kb)
        assert _distinct(offs, shift) == pytest.approx(drawn, rel=0.01)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((5, B), dtype=np.float32))
    v, o = yardstick.gather(x, kb)
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(x.numpy(), o.numpy(), 1))


def test_gather_yardstick_plain_version_and_its_refusals():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((9, 256), dtype=np.float32))
    v, o = yardstick.gather(x, 33)  # CPU tensors: the plain version
    rows = np.arange(9 * 33) // 33
    np.testing.assert_array_equal(v.numpy().ravel(), x.numpy()[rows, o.numpy().ravel()])
    with pytest.raises(ValueError):
        yardstick.gather_magic(2**27, 1024, 20)  # 2^31 gathers
    with pytest.raises(ValueError):
        yardstick.gather_magic(2**11, 1024, 2**20 - 1)  # k·e reaches 2^32
    with pytest.raises(ValueError):
        yardstick.gather(x, 33, unroll=2)


@pytest.mark.parametrize("shape", [(4, 9, 1024), (2, 5, 128), (8, 3, 256)], ids=str)
def test_affine_yardstick_gathers_permk_offsets(shape):
    n, nblk, B = shape
    x = np.random.default_rng(B).standard_normal(shape, dtype=np.float32)
    seed = 2**31 + 12345
    jv, jo = jref.permk_seeded_workers_ref(jnp.asarray(x), jnp.uint32(seed), n)
    v, o = yardstick.affine(torch.from_numpy(x), seed)  # CPU tensors: the plain version
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(v.numpy() * np.float32(n), np.asarray(jv))
    with pytest.raises(ValueError):
        yardstick.affine(torch.zeros((3, 2, 128)), seed)  # B/n not a power of two


@pytest.mark.parametrize("n", [1, 2, 4, 8, 64])
def test_multiply_by_exact_inverse_is_the_division(n):
    """For n a power of two, a·(1/n) and a / n round the same real number:
    bit-identical on normals, subnormals, ±0, ±inf and NaN."""
    rng = np.random.default_rng(n)
    a = np.concatenate([rng.standard_normal(100000).astype(np.float32) * np.float32(1e3),
                        (rng.standard_normal(1000) * 1e-39).astype(np.float32),
                        np.array([0.0, -0.0, np.inf, -np.inf, 3e38, 1.4e-45], np.float32)])
    inv = np.float32(1.0) / np.float32(n)
    np.testing.assert_array_equal((a * inv).view(np.int32), (a / np.float32(n)).view(np.int32))


def test_multiply_by_inverse_is_not_the_division_for_other_n():
    a = np.random.default_rng(0).standard_normal(100000).astype(np.float32)
    for n in (3, 5):
        inv = np.float32(1.0) / np.float32(n)
        assert ((a * inv).view(np.int32) != (a / np.float32(n)).view(np.int32)).any()


def _emulate_dequant_mean(lv, nm, s):
    """packed_sum_kernel's order under the mean_row tail (qsgd_dequant_mean):
    a warp's 32 quads (128 coordinates) in one block, lane w's norm_w / s
    shared, acc + l·scale from +0 in worker order, then ×(1/n) for n a power
    of two, else ÷ n."""
    n, nblk, B = lv.shape
    scale = nm / np.float32(s)  # one divide per (w, b): the warp's shared value
    acc = np.zeros((nblk, B), np.float32)
    for w in range(n):
        acc = acc + lv[w].astype(np.float32) * scale[w][:, None]
    if n & (n - 1) == 0:
        return acc * (np.float32(1.0) / np.float32(n))
    return acc / np.float32(n)


@pytest.mark.parametrize("B", [128, 1024, 4096])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_dequant_mean_order_equals_plain_version_and_reference(n, B):
    s = 7
    rng = np.random.default_rng(n * 10 + B)
    lv = rng.integers(-s, s + 1, size=(n, 3, B)).astype(np.int8)
    lv[0, 1], lv[-1, 2] = s, -s
    nm = (rng.random((n, 3)) * 2.0 ** rng.integers(-30, 30, (n, 3))).astype(np.float32)
    nm[-1, 0] = 0.0
    got = _emulate_dequant_mean(lv, nm, s)
    plain = tref.qsgd_dequant_mean_ref(torch.from_numpy(lv), torch.from_numpy(nm), s)
    np.testing.assert_array_equal(got.view(np.int32), plain.numpy().view(np.int32))
    want = np.asarray(jref.qsgd_dequant_mean_ref(jnp.asarray(lv), jnp.asarray(nm), s))
    terms = np.abs(lv.astype(np.float64)) * (nm.astype(np.float64) / s)[..., None]
    bound = 2 * (n + 3) * U * terms.sum(0) / n  # XLA fuses norm·(1/s) and an FMA a worker
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()
