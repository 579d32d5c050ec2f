"""The packed QSGD wire's plain PyTorch versions against the reference's
(``repro.kernels.ref`` and the Pallas kernels in interpret mode) on the same
numpy inputs.

Contract, and where it differs from 1 ulp (ROADMAP C):

* nibble words and unpacked levels bit-equal;
* block norms within ``NORM_ULP`` = 5 ulp of XLA's: the port fixes the
  order of the sum of squares to its kernel's (4 per thread, a warp tree,
  a tree over warps), XLA's order is unspecified. 5 ulp is the largest
  distance measured over 192,000 rows (B = 128 and 1024, normal and
  heavy-tailed data, scales 1e-3 to 50);
* levels bit-equal when quantized against the reference's own norms; with
  the port's norms, a level may differ only where the reference's floor
  argument lies within ``FLIP_ULP`` ulp of an integer — the flips are
  counted;
* the dequantize-and-mean: XLA compiles the reference's loop body into a
  reciprocal multiply (norm·(1/s)) and an FMA; the port keeps the Pallas
  kernel's divide, multiply and add, each rounded. Each side is replayed
  bit-exactly in numpy, and they differ by at most the rounding bound
  ``2(n+3)·2^-24·Σ|terms|/n``;
* the epilogue: g' within that bound plus 1 ulp, x' within 1 ulp of the
  reference's own update applied to the port's g'.

On the CPU every kernel wrapper returns its plain version and launches
nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, ulp_diff  # noqa: F401
from repro.kernels import epilogue as jepi
from repro.kernels import quantize as jquant
from repro.kernels import ref as jref
from repro_torch import kernels as tk
from repro_torch.kernels import ref as tref

NORM_ULP = 5
FLIP_ULP = 16
U = 2.0**-24


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _seeds(rng, n):
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _levels(rng, n, nblk, B, s):
    """Levels in [−s, s] with sign and zeros, and positive norms."""
    lv = rng.integers(-s, s + 1, size=(n, nblk, B)).astype(np.int8)
    nm = (rng.random((n, nblk)) * 5 + 0.1).astype(np.float32)
    return lv, nm


# ---------------------------------------------------------------------------
# 4-bit words
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nblk,B", [(1, 128), (3, 256), (5, 1024)])
def test_nibble_roundtrip_identity_and_bit_equal(nblk, B):
    q = np.random.default_rng(nblk).integers(-8, 8, size=(nblk, B)).astype(np.int8)
    want = np.asarray(jref.nibble_pack_ref(jnp.asarray(q)))
    pal = np.asarray(jquant.nibble_pack(jnp.asarray(q), backend="pallas_interpret"))
    words = tref.nibble_pack_ref(_t(q))
    assert words.dtype == torch.int32 and words.shape == (nblk, B // 8)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(pal, want)
    back = tref.nibble_unpack_ref(words, B)
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(
        np.asarray(jref.nibble_unpack_ref(jnp.asarray(want), B)), back.numpy())
    assert torch.equal(tk.quantize.nibble_pack(_t(q)), words)
    assert torch.equal(tk.quantize.nibble_unpack(words, B), back)


def test_nibble_words_are_genuinely_packed():
    """Eight levels per 32-bit word, two's-complement nibbles at bits
    [4t, 4t+4); nibbles 8..15 unpack to −8..−1."""
    q = torch.tensor([[1, -1, 7, -8, 0, 2, -3, 5]], dtype=torch.int8)
    w = int(tref.nibble_pack_ref(q)[0, 0]) & 0xFFFFFFFF
    nibs = [1, 0xF, 7, 0x8, 0, 2, 0xD, 5]
    assert w == sum(nib << (4 * t) for t, nib in enumerate(nibs))
    assert torch.equal(tref.nibble_unpack_ref(tref.nibble_pack_ref(q), 8), q)


# ---------------------------------------------------------------------------
# Blockwise QSGD uplink
# ---------------------------------------------------------------------------


def _floor_arg(x, norms, seeds, s):
    """The reference's floor argument s·|x|/safe + u in f32, per coordinate."""
    n, nblk, B = x.shape
    ctr = (np.arange(nblk, dtype=np.uint32)[:, None] * np.uint32(B)
           + np.arange(B, dtype=np.uint32)[None, :])
    u = np.stack([np.asarray(jref.uniform_from_bits_ref(
        jref.murmur_bits_ref(jnp.uint32(sd), jnp.asarray(ctr)))) for sd in seeds])
    safe = np.where(norms > 0, norms, np.float32(1)).astype(np.float32)
    return (np.float32(s) * np.abs(x) / safe[..., None] + u).astype(np.float32)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [3, 7, 15])
@pytest.mark.parametrize("n", [1, 4])
def test_qsgd_block_workers_matches_reference(n, s, xdtype):
    rng = np.random.default_rng(10 * n + s)
    x32 = rng.standard_normal((n, 24, 256), dtype=np.float32) * 2.0
    x32[0, 0, :9] = 0.0  # exact zeros (and −0.0 below) store level 0
    x32[0, 0, 9:13] = -0.0
    x32[-1, 1] = 0.0     # an all-zero block: norm 0, safe 1
    jx = jnp.asarray(x32).astype(xdtype)
    tx = torch.from_numpy(x32).to(getattr(torch, xdtype))
    seeds = _seeds(rng, n)
    tseeds = _t(seeds.view(np.int32))
    jl, jn = jref.qsgd_block_workers_ref(jx, jnp.asarray(seeds), s)
    pl_l, pl_n = jquant.qsgd_block_workers(jx, jnp.asarray(seeds), s,
                                           backend="pallas_interpret")
    np.testing.assert_array_equal(np.asarray(pl_l), np.asarray(jl))
    np.testing.assert_array_equal(np.asarray(pl_n), np.asarray(jn))

    tl, tn = tref.qsgd_block_workers_ref(tx, tseeds, s)
    assert tl.dtype == torch.int8 and tn.dtype == torch.float32
    assert ulp_diff(tn, jn) <= NORM_ULP
    assert int(tl.abs().max()) <= s
    # the quantize step alone, fed the reference's norms: bit-equal
    tq = tref.qsgd_block_quantize_ref(tx, _t(np.asarray(jn)), tseeds, s)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jl))
    # with the port's own norms: flips only next to an integer, counted
    arg = _floor_arg(np.asarray(jx.astype(jnp.float32)), np.asarray(jn), seeds, s)
    near = np.abs(arg - np.round(arg)) <= FLIP_ULP * np.spacing(arg)
    flips = tl.numpy() != np.asarray(jl)
    assert not (flips & ~near).any()
    assert flips.sum() <= near.sum()
    # the wrapper on a CPU tensor is the plain version
    wl, wn = tk.quantize.qsgd_block_workers(tx, tseeds, s)
    assert torch.equal(wl, tl) and torch.equal(wn, tn)


def test_qsgd_block_norm_order_is_the_kernels():
    """The plain norm adds in the kernel's order — per thread 4 in a row,
    then a halving tree over each warp's 32 partials, then over the warps —
    replayed here in numpy f32, one rounding per add."""
    x = np.random.default_rng(3).standard_normal((2, 5, 1024), dtype=np.float32)
    sq = x * x
    p = ((sq[..., 0::4] + sq[..., 1::4]) + sq[..., 2::4]) + sq[..., 3::4]
    p = p.reshape(2, 5, 8, 32)
    for h in (16, 8, 4, 2, 1):
        p = p[..., :h] + p[..., h:2 * h]
    q = p[..., 0]
    for h in (4, 2, 1):
        q = q[..., :h] + q[..., h:2 * h]
    want = np.sqrt(q[..., 0])
    np.testing.assert_array_equal(tref.qsgd_block_norms_ref(_t(x)).numpy(), want)


# ---------------------------------------------------------------------------
# Dequantize-and-mean and the epilogue
# ---------------------------------------------------------------------------


def _replay_port(lv, nm, s):
    """The port's order in numpy f32: from 0, acc + level·(norm/s), ÷ n."""
    acc = np.zeros(lv.shape[1:], np.float32)
    for w in range(lv.shape[0]):
        acc = acc + lv[w].astype(np.float32) * (nm[w] / np.float32(s))[:, None]
    return acc / np.float32(lv.shape[0])


def _replay_xla(lv, nm, s):
    """What XLA compiles the reference's loop into: norm·(1/s) and one FMA
    per worker (exact in f64, rounded once), then ÷ n."""
    acc = np.zeros(lv.shape[1:], np.float32)
    for w in range(lv.shape[0]):
        sc = (nm[w] * np.float32(1.0 / s)).astype(np.float32)
        acc = (acc.astype(np.float64)
               + lv[w].astype(np.float64) * sc.astype(np.float64)[:, None]
               ).astype(np.float32)
    return acc / np.float32(lv.shape[0])


def _rounding_bound(lv, nm, s):
    n = lv.shape[0]
    terms = np.abs(lv.astype(np.float64)) * (nm.astype(np.float64) / s)[..., None]
    return 2 * (n + 3) * U * terms.sum(0) / n


@pytest.mark.parametrize("s", [3, 7, 15])
@pytest.mark.parametrize("n", [1, 3, 4])
def test_qsgd_dequant_mean_matches_reference(n, s):
    lv, nm = _levels(np.random.default_rng(n * 100 + s), n, 12, 256, s)
    want = np.asarray(jref.qsgd_dequant_mean_ref(jnp.asarray(lv), jnp.asarray(nm), s))
    pal = np.asarray(jquant.qsgd_dequant_mean(jnp.asarray(lv), jnp.asarray(nm), s,
                                              backend="pallas_interpret"))
    got = tref.qsgd_dequant_mean_ref(_t(lv), _t(nm), s)
    np.testing.assert_array_equal(got.numpy(), _replay_port(lv, nm, s))
    np.testing.assert_array_equal(want, _replay_xla(lv, nm, s))
    bound = _rounding_bound(lv, nm, s)
    for ref_out in (want, pal):
        assert (np.abs(got.numpy().astype(np.float64) - ref_out) <= bound).all()
    assert torch.equal(tk.quantize.qsgd_dequant_mean(_t(lv), _t(nm), s), got)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 4])
def test_qsgd_epilogue_matches_reference(n, xdtype):
    s, gamma = 7, 0.0371
    rng = np.random.default_rng(40 + n)
    lv, nm = _levels(rng, n, 10, 256, s)
    g = rng.standard_normal((10, 256), dtype=np.float32)
    x = rng.standard_normal((10, 256), dtype=np.float32)
    jx = jnp.asarray(x).astype(xdtype)
    tx = torch.from_numpy(x).to(getattr(torch, xdtype))
    args = (jnp.asarray(lv), jnp.asarray(nm), jnp.asarray(g), jx)
    tg, tx2 = tref.qsgd_epilogue_ref(_t(lv), _t(nm), _t(g), tx, gamma, s)
    assert tg.dtype == torch.float32 and tx2.dtype == tx.dtype
    bound = _rounding_bound(lv, nm, s) + np.spacing(np.abs(g) + nm.max())
    for jg, jx2 in (jref.qsgd_epilogue_ref(*args, gamma, s),
                    jepi.qsgd_epilogue(*args, gamma, s, backend="pallas_interpret")):
        assert (np.abs(tg.numpy().astype(np.float64) - np.asarray(jg)) <= bound).all()
        _, jx_from_tg = jref.delta_epilogue_ref(
            jnp.zeros_like(jg), jnp.asarray(tg.numpy()), jx, gamma)
        assert ulp_diff(tx2, jx_from_tg) <= 1
    delta = tref.qsgd_dequant_mean_ref(_t(lv), _t(nm), s)
    dg, dx = tref.delta_epilogue_ref(delta, _t(g), tx, gamma)
    assert torch.equal(tg, dg) and torch.equal(tx2, dx)
    wg, wx = tk.epilogue.qsgd_epilogue(_t(lv), _t(nm), _t(g), tx, gamma, s)
    assert torch.equal(wg, tg) and torch.equal(wx, tx2)


def test_quantize_wrappers_launch_nothing_on_cpu():
    tk.reset_launch_counts()
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 3, 128), dtype=np.float32))
    lv, nm = tk.quantize.qsgd_block_workers(x, _t(np.array([1, 2], np.int32)), 7)
    words = tk.quantize.nibble_pack(lv.reshape(6, 128))
    lv = tk.quantize.nibble_unpack(words, 128).reshape(2, 3, 128)
    tk.quantize.qsgd_dequant_mean(lv, nm, 7)
    tk.epilogue.qsgd_epilogue(lv, nm, torch.zeros(3, 128), torch.zeros(3, 128), 0.1, 7)
    counts = tk.launch_counts()
    assert len(counts) == 24 and not any(counts.values())
