"""The flat-vector wire of the port against the reference: the five plain
versions of rows 10, 11 and 19–21 (``randk_gather``, ``randk_seeded``,
``block_sumsq``, ``qsgd_quantize``, ``qsgd_dequantize``), the device draws
of ``prng``, ``kernels/ops.py`` and the module-level block primitives of
``core/flat.py``, on the same numpy inputs.

Tolerances (ROADMAP C):

* Offsets, seeded offsets, levels and integer draws are bit-equal.
* Gathered values follow the Pallas bodies (the product in f32, rounded
  once to x's dtype): bit-equal to the interpret-mode kernels, and to the
  oracle for f32 x; for bf16 x within one bf16 ulp of the oracle (it rounds
  the scale to bf16 first: 1024/20 = 51.2 becomes 51.25).
* Σx² per block follows the kernel's fixed order: within ``SUMSQ_ULP`` of
  XLA's, and its square root is the blockwise QSGD norm bit for bit.
* The global norm sums the blocks in float64: within ``NORM_ULP`` of XLA's
  float32 sum; levels are bit-equal given the reference's norm and dither,
  and with the port's own norm differ only where the floor argument lies
  within ``FLIP_ULP`` ulp of an integer.
* The dequantize divides norm / s (a true division) and multiplies: bit-equal
  to the eager oracle, within ``DEQ_ULP`` of the interpret-mode kernel and
  the reference's jitted ``ops.qsgd_decompress`` (XLA multiplies by f32(1/s)
  there: the scale is 1 ulp off, and the product's rounding can add one).

The gathers' parity inputs are finite and hold no −0: the interpret-mode
kernel's one-hot matmul turns a gathered −0 into +0 and spreads an inf or a
NaN of the block to every gathered value; the port gathers exactly, as the
oracle does (``test_randk_gather_is_exact_where_the_pallas_matmul_is_not``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, to_np, ulp_diff  # noqa: F401
from repro.core import flat as jflat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quantize import block_sumsq as j_block_sumsq
from repro.kernels.quantize import qsgd_dequantize as j_qsgd_dequantize
from repro.kernels.quantize import qsgd_quantize as j_qsgd_quantize
from repro.kernels.randk import randk_gather as j_randk_gather
from repro.kernels.randk import randk_seeded as j_randk_seeded
from repro_torch import kernels as tk
from repro_torch import prng
from repro_torch.core import flat as tflat
from repro_torch.core import wire
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(1, 128), (2, 256), (4, 1024), (3, 384)]  # tests/test_kernels.py's
DTYPES = ["float32", "bfloat16"]
SUMSQ_ULP = 4
NORM_ULP = 2
FLIP_ULP = 8
DEQ_ULP = 2


def _x(nblk, B, dtype, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((nblk, B)) * scale).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# the five plain versions against the Pallas kernels and the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nblk,B", SHAPES)
def test_randk_gather_plain_matches_pallas_and_oracle(nblk, B, dtype):
    jx, tx = _x(nblk, B, dtype, seed=nblk * B)
    for kb in (max(8, B // 16), 20):
        offs = np.random.default_rng(B + kb).integers(0, B, (nblk, kb)).astype(np.int32)
        want_p = j_randk_gather(jx, jnp.asarray(offs), B / kb, interpret=True)
        want_o = jref.randk_block_compress_ref(jx, jnp.asarray(offs), B / kb)
        got = tref.randk_block_compress_ref(tx, torch.from_numpy(offs), B / kb)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(to_np(got), to_np(want_p))
        assert ulp_diff(got, want_o) <= (0 if dtype == "float32" else 1)
        wrapped = tk.randk.randk_gather(tx, torch.from_numpy(offs), B / kb)
        np.testing.assert_array_equal(to_np(wrapped), to_np(got))


def test_randk_gather_is_exact_where_the_pallas_matmul_is_not():
    """A gathered −0 stays −0 and an inf elsewhere in the block leaves the
    other values alone (the oracle's gather); the interpret-mode kernel's
    one-hot matmul gives +0 and NaN there."""
    x = np.zeros((1, 128), np.float32)
    x[0, 3], x[0, 9], x[0, 50] = -0.0, 2.0, np.inf
    offs = np.array([[3, 9]], np.int32)
    got = tref.randk_block_compress_ref(torch.from_numpy(x), torch.from_numpy(offs), 16.0)
    want_o = jref.randk_block_compress_ref(jnp.asarray(x), jnp.asarray(offs), 16.0)
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want_o).view(np.int32))
    assert np.signbit(got.numpy()[0, 0]) and got.numpy()[0, 1] == 32.0
    pallas = np.asarray(j_randk_gather(jnp.asarray(x), jnp.asarray(offs), 16.0, interpret=True))
    assert np.isnan(pallas).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nblk,B,kb", [(1, 128, 16), (2, 256, 32), (3, 512, 8), (4, 1024, 20)])
def test_randk_seeded_plain_matches_pallas_and_oracle(nblk, B, kb, dtype):
    jx, tx = _x(nblk, B, dtype, seed=kb)
    for seed in (7, 2**31 + 5, 2**32 - 1):
        pv, po = j_randk_seeded(jx, jnp.uint32(seed).astype(jnp.int32), kb, B / kb,
                                interpret=True)
        ov, oo = jref.randk_seeded_ref(jx, jnp.uint32(seed), kb, B / kb)
        tv, to = tref.randk_seeded_ref(tx, seed, kb, B / kb)
        np.testing.assert_array_equal(to.numpy(), np.asarray(po))
        np.testing.assert_array_equal(to.numpy(), np.asarray(oo))
        np.testing.assert_array_equal(to_np(tv), to_np(pv))
        assert ulp_diff(tv, ov) <= (0 if dtype == "float32" else 1)
        wv, wo = tk.randk.randk_seeded(tx, seed, kb, B / kb)
        assert torch.equal(wo, to) and np.array_equal(to_np(wv), to_np(tv))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nblk,B", SHAPES)
def test_block_sumsq_in_the_kernel_order(nblk, B, dtype):
    jx, tx = _x(nblk, B, dtype, seed=3, scale=3.0)
    got = tref.block_sumsq_ref(tx)
    assert got.dtype == torch.float32 and got.shape == (nblk,)
    assert ulp_diff(got, j_block_sumsq(jx, backend="pallas_interpret")) <= SUMSQ_ULP
    assert ulp_diff(got, jref.block_sumsq_ref(jx)) <= SUMSQ_ULP
    # one order for the blockwise and the global-norm QSGD
    assert torch.equal(torch.sqrt(got), tref.qsgd_block_norms_ref(tx[None])[0])
    assert torch.equal(tk.quantize.block_sumsq(tx), got)


def _edge_levels_input():
    """x, u against norm 7 at s = 7 (the floor argument is |x| + u exactly):
    exact ties m + 0.5 + 0.5, |x| = norm and zeros."""
    m = np.arange(7, dtype=np.float32)
    x = np.concatenate([m + 0.5, -(m + 0.5), [7.0, -7.0, 0.0, -0.0]]).astype(np.float32)
    u = np.concatenate([np.full(14, 0.5), [0.999, 0.999, 0.5, 0.5]]).astype(np.float32)
    return x[None], u[None]


@pytest.mark.parametrize("nblk,B", SHAPES)
@pytest.mark.parametrize("s", [1, 4, 7, 15])
def test_qsgd_quantize_and_dequantize_bit_equal_given_norm_and_dither(nblk, B, s):
    rng = np.random.default_rng(B + s)
    x = (rng.standard_normal((nblk, B)) * 3).astype(np.float32)
    u = rng.random((nblk, B), dtype=np.float32)
    # a zero norm (safe = 1) with s ≤ 4 keeps s·|x| + u inside int8 here
    for norm in (np.float32(np.linalg.norm(x)), np.float32(0.0))[:2 if s <= 4 else 1]:
        jq = np.asarray(jref.qsgd_quantize_ref(jnp.asarray(x), jnp.asarray(u), norm, s))
        pq = np.asarray(j_qsgd_quantize(jnp.asarray(x), jnp.asarray(u), jnp.asarray(norm), s,
                                        backend="pallas_interpret"))
        tq = tref.qsgd_quantize_ref(torch.from_numpy(x), torch.from_numpy(u),
                                    torch.tensor(norm), s)
        np.testing.assert_array_equal(tq.numpy(), jq)
        np.testing.assert_array_equal(tq.numpy(), pq)
        td = tref.qsgd_dequantize_ref(tq, torch.tensor(norm), s)
        np.testing.assert_array_equal(
            td.numpy().view(np.int32),
            np.asarray(jref.qsgd_dequantize_ref(jnp.asarray(jq), norm, s)).view(np.int32))
        assert ulp_diff(td, j_qsgd_dequantize(jnp.asarray(jq), jnp.asarray(norm), s,
                                              backend="pallas_interpret")) <= DEQ_ULP
        assert torch.equal(tk.quantize.qsgd_quantize(torch.from_numpy(x), torch.from_numpy(u),
                                                     torch.tensor(norm), s), tq)
        assert torch.equal(tk.quantize.qsgd_dequantize(tq, torch.tensor(norm), s), td)


@pytest.mark.parametrize("dtype", DTYPES)
def test_qsgd_quantize_edges_bit_equal(dtype):
    x, u = _edge_levels_input()
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for norm in (np.float32(7.0), np.float32(0.0)):
        jq = np.asarray(jref.qsgd_quantize_ref(jx, jnp.asarray(u), norm, 7))
        tq = tref.qsgd_quantize_ref(tx, torch.from_numpy(u), torch.tensor(norm), 7)
        np.testing.assert_array_equal(tq.numpy(), jq)
    want = np.concatenate([np.arange(1, 8), -np.arange(1, 8), [7, -7, 0, 0]])
    tq = tref.qsgd_quantize_ref(tx, torch.from_numpy(u), torch.tensor(7.0), 7)
    np.testing.assert_array_equal(tq.numpy()[0], want)


# ---------------------------------------------------------------------------
# device draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(), (5,), (3, 7), (2500,)], ids=str)
def test_device_draws_bit_equal_to_jax_random(shape, monkeypatch):
    """``bits``, ``uniform`` and ``randint`` on a device, in chunks of 1000
    counters here (2500 is not a multiple of the chunk), against the numpy
    draws and ``jax.random``."""
    monkeypatch.setattr(prng, "_CHUNK", 1000)
    for seed in (0, 11):
        key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
        b = prng.bits(key, shape, device="cpu")
        assert b.dtype == torch.int64 and tuple(b.shape) == shape
        np.testing.assert_array_equal(b.numpy(), prng.bits(key, shape).astype(np.int64))
        np.testing.assert_array_equal(
            b.numpy(), np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))
        u = prng.uniform(key, shape, device="cpu")
        np.testing.assert_array_equal(u.numpy().view(np.int32),
                                      np.asarray(jax.random.uniform(jkey, shape)).view(np.int32))
        for lo, hi in ((0, 51), (-7, 1000), (0, 2**31 - 1), (-(2**31), 2**31 - 1), (3, 3)):
            r = prng.randint(key, shape, lo, hi, device="cpu")
            assert r.dtype == torch.int32
            np.testing.assert_array_equal(
                r.numpy(), np.asarray(jax.random.randint(jkey, shape, lo, hi)))


# ---------------------------------------------------------------------------
# kernels/ops.py
# ---------------------------------------------------------------------------


def _flat(d, seed):
    return np.random.default_rng(seed).standard_normal(d).astype(np.float32)


@pytest.mark.parametrize("d,block,kb", [(700, 256, 16), (3000, 256, 32), (5000, 1024, 20)])
def test_randk_ops_match_reference(d, block, kb):
    """``jittered_offsets``, ``randk_compress`` (the reference runs the
    Pallas gather in interpret mode here) and ``randk_decompress_mean``."""
    x = _flat(d, d)
    key, jkey = prng.PRNGKey(d), jax.random.PRNGKey(d)
    nblk = -(-d // block)
    np.testing.assert_array_equal(
        tops.jittered_offsets(key, nblk, block, kb, device="cpu").numpy(),
        np.asarray(jops.jittered_offsets(jkey, nblk, block, kb)))
    np.testing.assert_array_equal(tops.pad_to_blocks(torch.from_numpy(x), block).numpy(),
                                  np.asarray(jops.pad_to_blocks(jnp.asarray(x), block)))
    jv, jo = jops.randk_compress(jnp.asarray(x), jkey, kb, block=block)
    for backend in ("auto", "ref"):
        tv, to = tops.randk_compress(torch.from_numpy(x), key, kb, block, backend)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        # each stride holds one offset: distinct, scaled by block/kb
        assert (to // (block // kb) == torch.arange(kb, dtype=torch.int32)).all()
    jd = jops.randk_decompress_mean(jv[None], jo[None], d, block=block)
    td = tops.randk_decompress_mean(tv[None], to[None], d, block)
    assert td.shape == (d,) and ulp_diff(td, jd) == 0


def _floor_arg(x, norm, u, s):
    """The reference's floor argument s·|x| / norm + u, rounded as in f32."""
    f = np.float32
    return ((f(s) * np.abs(x).astype(f)) / f(norm) + u).astype(f)


@pytest.mark.parametrize("d,block,s", [(700, 256, 4), (3000, 256, 7), (5000, 1024, 7),
                                       (20000, 1024, 15)])
def test_qsgd_ops_match_reference(d, block, s):
    """``qsgd_compress`` / ``qsgd_decompress``: the norm within NORM_ULP of
    XLA's, the levels bit-equal where the floor argument is not within
    FLIP_ULP ulp of an integer, the decompress within DEQ_ULP of the jitted
    reference's on the same levels."""
    x = _flat(d, d + s) * 3
    key, jkey = prng.PRNGKey(d), jax.random.PRNGKey(d)
    jq, jn = jops.qsgd_compress(jnp.asarray(x), jkey, s, block=block)
    tq, tn = tops.qsgd_compress(torch.from_numpy(x), key, s, block)
    assert tq.dtype == torch.int8 and tq.shape == tuple(jq.shape) and tn.shape == ()
    assert ulp_diff(tn.reshape(1), np.asarray(jn).reshape(1)) <= NORM_ULP
    u = np.asarray(jax.random.uniform(jkey, jq.shape))
    x2d = np.asarray(jops.pad_to_blocks(jnp.asarray(x), block))
    arg = _floor_arg(x2d, np.asarray(jn), u, s)
    near = np.abs(arg - np.round(arg)) <= FLIP_ULP * np.spacing(arg)
    flips = tq.numpy() != np.asarray(jq)
    assert not (flips & ~near).any()
    assert int(np.abs(tq.numpy()).max()) <= s
    # the levels against the reference's own norm: bit-equal
    tq2 = tref.qsgd_quantize_ref(torch.from_numpy(x2d.copy()), torch.from_numpy(u.copy()),
                                 torch.tensor(np.asarray(jn)), s)
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq))
    jd = jops.qsgd_decompress(jq, jn, s, d, block=block)
    td = tops.qsgd_decompress(torch.from_numpy(np.array(jq)), torch.tensor(np.asarray(jn)),
                              s, d, block)
    assert td.shape == (d,) and ulp_diff(td, jd) <= DEQ_ULP
    assert torch.equal(tops.qsgd_compress(torch.from_numpy(x), key, s, block, "ref")[0], tq)


def test_backend_cuda_refuses_cpu_tensors():
    x = torch.zeros(300)
    with pytest.raises(ValueError, match="CUDA"):
        tops.randk_compress(x, prng.PRNGKey(0), 8, 128, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tflat.block_gather(x.reshape(3, 100), torch.zeros((3, 2), dtype=torch.int32), 1.0,
                           "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        tops.qsgd_compress(x, prng.PRNGKey(0), 7, 128, "pallas")


# ---------------------------------------------------------------------------
# core/flat.py's module-level block primitives
# ---------------------------------------------------------------------------


def _workers(n, nblk, B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nblk, B)).astype(np.float32)
    seeds = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return x, seeds


@pytest.mark.parametrize("jbackend", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_randk_block_primitives_match_reference(backend, jbackend):
    n, nblk, B, kb = 3, 5, 256, 16
    x, seeds = _workers(n, nblk, B)
    scale = B / kb
    for w in range(n):
        jv, jo = jflat.block_compress(jnp.asarray(x[w]), jnp.asarray(seeds[w]), kb, scale,
                                      jbackend)
        tv, to = tflat.block_compress(torch.from_numpy(x[w]), int(seeds[w]), kb, scale,
                                      backend)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            to.numpy(), tflat.seeded_offsets(int(seeds[w]), nblk, B, kb, device="cpu").numpy())
        gv = tflat.block_gather(torch.from_numpy(x[w]), to, scale, backend)
        np.testing.assert_array_equal(
            gv.numpy(), np.asarray(jflat.block_gather(jnp.asarray(x[w]), jo, scale, jbackend)))
        assert torch.equal(gv, tv)
    jv, jo = jflat.block_compress_workers(jnp.asarray(x), jnp.asarray(seeds), kb, scale,
                                          jbackend)
    tv, to = tflat.block_compress_workers(torch.from_numpy(x), seeds, kb, scale, backend)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tv2, _ = tflat.block_compress_workers(torch.from_numpy(x),
                                          torch.from_numpy(seeds.astype(np.int64)), kb, scale,
                                          backend)
    assert torch.equal(tv2, tv)
    jm = jflat.block_scatter_mean(jv, jo, B, jbackend)
    tm = tflat.block_scatter_mean(tv, to, B, backend)
    assert ulp_diff(tm, jm) <= 1
    assert tflat.key_to_seed(prng.PRNGKey(9)) == int(jflat.key_to_seed(jax.random.PRNGKey(9)))
    assert tflat.seeded_payload_bits(nblk, kb) == jflat.seeded_payload_bits(nblk, kb) \
        == wire.seeded_randk_bits(nblk, kb)


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_permk_block_primitives_match_reference(backend):
    n, nblk, B = 4, 3, 128
    x, _ = _workers(n, nblk, B, seed=1)
    seed = 2**31 + 77
    jv, jo = jflat.block_permk_workers(jnp.asarray(x), jnp.uint32(seed), "ref")
    tv, to = tflat.block_permk_workers(torch.from_numpy(x), seed, backend)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jm = jflat.permk_concat_mean(jv, jnp.uint32(seed), B)
    tm = tflat.permk_concat_mean(tv, seed, B, backend)
    assert ulp_diff(tm, jm) <= 1


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_quantized_block_primitives_match_reference(backend):
    """QSGD: norms within 5 ulp of XLA's (ROADMAP C), levels bit-equal given
    the reference's norms; the dequant-mean within the rounding bound of
    ``test_torch_quantize.py``. Natural: scales and codes bit-equal on these
    inputs, the decode-and-mean within 1 ulp. Each primitive equals the
    port's plain version bit for bit."""
    n, nblk, B, s = 3, 4, 256, 7
    x, seeds = _workers(n, nblk, B, seed=2)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    jl, jn = jflat.block_qsgd_workers(jx, jnp.asarray(seeds), s, "ref")
    tl, tn = tflat.block_qsgd_workers(tx, seeds, s, backend)
    tseeds = torch.from_numpy(seeds.view(np.int32))
    rl, rn = tref.qsgd_block_workers_ref(tx, tseeds, s)
    assert torch.equal(tl, rl) and torch.equal(tn, rn)
    assert ulp_diff(tn, jn) <= 5
    np.testing.assert_array_equal(
        tref.qsgd_block_quantize_ref(tx, torch.tensor(np.asarray(jn)), tseeds, s).numpy(),
        np.asarray(jl))
    jd = np.asarray(jflat.block_qsgd_dequant_mean(jl, jn, s, "ref"), np.float64)
    td = tflat.block_qsgd_dequant_mean(torch.tensor(np.asarray(jl)),
                                       torch.tensor(np.asarray(jn)), s, backend)
    terms = np.abs(np.asarray(jl, np.float64)) * np.asarray(jn, np.float64)[..., None] / s
    bound = 2 * (n + 3) * 2.0**-24 * terms.sum(0) / n
    assert (np.abs(td.numpy() - jd) <= bound + 1e-30).all()
    jc, js = jflat.block_natural_workers(jx, jnp.asarray(seeds), "ref")
    tc, ts = tflat.block_natural_workers(tx, seeds, backend)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jdm = jflat.block_natural_dequant_mean(jc, js, "ref")
    tdm = tflat.block_natural_dequant_mean(tc, ts, backend)
    assert ulp_diff(tdm, jdm) <= 1


# ---------------------------------------------------------------------------
# statistics (ports of tests/test_kernels.py's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,seed", [(10, 0), (257, 3), (1000, 7), (3000, 2**31 - 2)])
def test_randk_roundtrip_unbiased_support(d, seed):
    """ops-level: padding + jittered offsets + gather + scatter; every
    nonzero is x·B/kb at its coordinate."""
    block, kb = 256, 32
    x = torch.from_numpy(_flat(d, seed))
    vals, offs = tops.randk_compress(x, prng.PRNGKey(seed + 1), kb, block)
    dense = tops.randk_decompress_mean(vals[None], offs[None], d, block)
    assert dense.shape == (d,)
    nz = dense != 0
    assert torch.equal(dense[nz], tref.scale_values(x[nz], block / kb))


def test_randk_roundtrip_is_unbiased_mc():
    d, block, kb, trials = 500, 128, 16, 2000
    x = torch.from_numpy(_flat(d, 0))
    acc = torch.zeros(d, dtype=torch.float64)
    for key in prng.split(prng.PRNGKey(1), trials):
        vals, offs = tops.randk_compress(x, key, kb, block)
        acc += tops.randk_decompress_mean(vals[None], offs[None], d, block)
    rel = float(torch.linalg.norm(acc / trials - x) / torch.linalg.norm(x))
    # E‖mean − x‖² = ω‖x‖²/trials, ω = block/kb − 1 = 7
    assert rel < 2.0 * np.sqrt(7 / trials)


def test_seeded_sampler_statistics():
    nblk, B, kb, trials = 2, 256, 32, 4000
    x2d = torch.from_numpy(_flat(nblk * B, 1).reshape(nblk, B))
    acc = torch.zeros((nblk, B), dtype=torch.float64)
    for t in range(trials):
        seed = (t * 2654435761) & 0xFFFFFFFF
        vals, offs = tflat.block_compress(x2d, seed, kb, B / kb)
        acc += tflat.block_scatter_mean(vals[None], offs[None], B)
    rel = float(torch.linalg.norm(acc / trials - x2d) / torch.linalg.norm(x2d))
    assert rel < 2.0 * np.sqrt((B / kb) / trials)


def test_qsgd_ops_roundtrip_unbiased():
    d, s, trials = 700, 4, 1000
    x = torch.from_numpy(_flat(d, 2))
    acc = torch.zeros(d, dtype=torch.float64)
    for key in prng.split(prng.PRNGKey(1), trials):
        q, norm = tops.qsgd_compress(x, key, s, 256)
        acc += tops.qsgd_decompress(q, norm, s, d, 256)
    omega = min(d / s**2, np.sqrt(d) / s)
    rel = float(torch.linalg.norm(acc / trials - x) / torch.linalg.norm(x))
    assert rel < 2.0 * np.sqrt(omega / trials)
