"""The natural-compression wire and the RandK∘QSGD composition of the port
against the reference (``repro.kernels.ref``, the Pallas kernels in
interpret mode, ``repro.core``) on the same numpy inputs.

Contract, and where it differs from bit-equality (ROADMAP C):

* the port reads an exponent from the float's bits and builds 2^k from
  bits. The reference's ``floor(log2(·))`` and ``exp2`` are XLA's, which
  approximate: ``floor(log2(2^13))`` is 12, and ``exp2(k)`` on an integer k
  is exact only for |k| ≤ 12 on the CPU (up to 67 ulp off beyond, and
  ``exp2(−126)`` is 0). So:

  - codes are bit-equal when the port's quantize step is fed XLA's own
    exponents (``natural_quantize_ref``) wherever XLA's ``exp2(e)`` is
    2^e; elsewhere a code may differ, and every difference lies where it is
    not;
  - decoded values (and scales) are bit-equal on inputs whose exponents lie
    where XLA's ``exp2`` is exact, except just below a power of two, where
    XLA's log2 rounds up: there XLA always rounds |x| up to the power, the
    port only when its dither says so — every such coordinate is listed;
  - XLA's decode is replayed bit for bit in numpy from its own ``exp2``
    table (a multiply, then the flush of subnormals), the port's from exact
    powers of two: the two differ only where XLA's table is inexact;
  - XLA's dequant-mean divides by n as ``acc·(1/n)`` (replayed): the port
    keeps the Pallas kernel's true division, so the two are bit-equal for n
    a power of two and within 1 ulp otherwise;

* subnormals are zero on input and after decoding, on both sides (XLA on
  the CPU flushes them; the port flushes in code);
* ``randk_qsgd``: levels bit-equal given the reference's norms, norms within
  ``NORM_ULP`` ulp (XLA's sum order is unspecified, the port's left to
  right); the engines' aggregates and rounds equal except for counted
  level flips within one quantization step;
* MARINA × natural, × randk_qsgd and × a natural downlink, binclass (eq. 11)
  and the small LM, both round shapes, held round by round from the
  reference's state: c_k, up and down ledgers equal; params and g within
  rtol 1e-5 / atol 1e-6 (binclass) or 1e-4 of the leaf's scale (LM) except
  at flagged coordinates, which lie within one quantization step and number
  at most ``FLIP_SHARE`` of all.

On the CPU every kernel wrapper returns its plain version and launches
nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close_except_flips, one_torch_thread, ulp_diff  # noqa: F401
from repro.core import BlockNatural as JBlockNatural
from repro.core import BlockRandK as JBlockRandK
from repro.core import Marina as JMarina
from repro.core import NaturalCompression as JNaturalCompression
from repro.core.flat import make_downlink as j_make_downlink
from repro.core.flat import make_engine as j_make_engine
from repro.core.problems import make_synthetic_binclass as j_make_binclass
from repro.core.problems import nonconvex_binclass_loss as j_loss
from repro.data import HeterogeneousLMData as JData
from repro.data import worker_batches as j_worker_batches
from repro.kernels import epilogue as jepi
from repro.kernels import quantize as jquant
from repro.kernels import ref as jref
from repro.models import init_params as j_init_params
from repro.models import lm_loss as j_lm_loss
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import dense_stack as j_dense_stack
from repro_torch import kernels as tk
from repro_torch import prng
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import (
    BlockNatural,
    BlockRandK,
    Marina,
    NaturalCompression,
    make_compressor,
    make_downlink,
    make_engine,
)
from repro_torch.core import flat as tflat
from repro_torch.core.problems import binclass_grad
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.kernels import ref as tref
from repro_torch.models import ModelConfig, dense_stack, lm_loss

NORM_ULP = 5
FLIP_SHARE = 1e-3
TINY = np.float32(2.0**-126)

_exp2 = jax.jit(jnp.exp2)


@jax.jit
def _xla_exponents(x):
    """XLA's e and e_ref, as ``repro.kernels.ref.natural_block_ref`` computes
    them."""
    ax = jnp.abs(x.astype(jnp.float32))
    e = jnp.floor(jnp.log2(jnp.where(ax > 0, ax, 1.0)))
    mx = jnp.max(ax, axis=-1)
    return e, jnp.floor(jnp.log2(jnp.where(mx > 0, mx, 1.0))) + 1.0


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _seeds(rng, n):
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _pow2(k) -> np.ndarray:
    return np.ldexp(np.float32(1.0), np.asarray(k, np.int64)).astype(np.float32)


def _xla_exp2_exact(k) -> np.ndarray:
    """Where XLA's exp2 of the integer k is 2^k."""
    k = np.asarray(k, np.float32)
    return np.asarray(_exp2(jnp.asarray(k))) == _pow2(k)


def _exact_exponent(x) -> np.ndarray:
    ax = np.abs(np.asarray(x, np.float32))
    return np.where(ax >= TINY, np.frexp(np.where(ax >= TINY, ax, 1))[1] - 1, 0)


def _octaves(rng, shape, lo, hi, sweep=True):
    """Signed values |x| = m·2^k, m ∈ [1, 2), k uniform in [lo, hi); with
    ``sweep``, exact powers of two and the floats just above and below them
    from 2^(lo+1) to 2^(hi−1) written first."""
    k = rng.integers(lo, hi, size=shape)
    x = (rng.random(shape) + 1.0) * np.ldexp(1.0, k) * rng.choice([-1.0, 1.0], shape)
    x = x.astype(np.float32)
    if not sweep:
        return x
    pw = _pow2(np.arange(lo + 1, hi))
    sweep = np.concatenate([pw, np.nextafter(pw, np.float32(0)),
                            np.nextafter(pw, np.float32(np.inf)), -pw])
    flat = x.reshape(-1)
    flat[:sweep.size] = sweep[:flat.size]
    return x


def _as(x, xdtype):
    j = jnp.asarray(x).astype(xdtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, xdtype))


# ---------------------------------------------------------------------------
# The quantize step, the decode and the decode-and-mean
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,nblk,B", [(1, 3, 128), (3, 5, 256), (4, 2, 1024)])
def test_natural_codes_bit_equal_given_xla_exponents(n, nblk, B, xdtype):
    """On exponents where XLA's exp2 is exact (−11 ≤ e ≤ 11), with exact
    powers of two and their neighbours, zeros and −0.0: codes and scales
    bit-equal to the reference's and the Pallas kernel's."""
    rng = np.random.default_rng(100 * n + B)
    x = _octaves(rng, (n, nblk, B), -11, 11)
    x[0, -1, :7] = 0.0
    x[-1, 0, 7:11] = -0.0
    jx, tx = _as(x, xdtype)
    seeds = _seeds(rng, n)
    jc, js = jax.jit(jref.natural_block_workers_ref)(jx, jnp.asarray(seeds))
    pc, ps = jquant.natural_block_workers(jx, jnp.asarray(seeds), backend="pallas_interpret")
    np.testing.assert_array_equal(np.asarray(pc), np.asarray(jc))
    np.testing.assert_array_equal(np.asarray(ps), np.asarray(js))
    e, e_ref = _xla_exponents(jx)
    tc = tref.natural_quantize_ref(tx, _t(seeds.view(np.int32)), _t(e), _t(e_ref))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tref.pow2_ref(_t(e_ref)).numpy(), np.asarray(js))


def test_natural_code_mismatches_lie_where_xla_exp2_is_inexact():
    """Over exponents −60..60, fed XLA's own exponents: every code that
    differs sits where XLA's exp2(e) is not 2^e (its p_up moved)."""
    rng = np.random.default_rng(7)
    x = _octaves(rng, (2, 64, 256), -60, 60)
    seeds = _seeds(rng, 2)
    jc, _ = jax.jit(jref.natural_block_workers_ref)(jnp.asarray(x), jnp.asarray(seeds))
    e, e_ref = _xla_exponents(jnp.asarray(x))
    tc = tref.natural_quantize_ref(_t(x), _t(seeds.view(np.int32)), _t(e), _t(e_ref))
    differ = tc.numpy() != np.asarray(jc)
    inexact = ~_xla_exp2_exact(np.asarray(e))
    assert not (differ & ~inexact).any()
    assert differ.sum() <= 1e-3 * differ.size  # listed: a handful of coordinates


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,nblk,B", [(2, 4, 128), (4, 3, 1024)])
def test_natural_block_workers_decoded_values_match_reference(n, nblk, B, xdtype):
    """The whole uplink on its own exponents, over 11 octaves (so every code's
    exponent −(|c| − 1) ≥ −12, where XLA's exp2 is exact): decoded values
    bit-equal,
    except just below a power of two where XLA's log2 rounds up — there XLA
    decodes the power itself and the port the power below (its dither fell
    at or above p_up). Those coordinates are the only mismatches."""
    rng = np.random.default_rng(200 * n + B)
    x = _octaves(rng, (n, nblk, B), -5, 6)  # |c| − 1 ≤ 12: XLA's exp2 exact
    jx, tx = _as(x, xdtype)
    seeds = _seeds(rng, n)
    jc, js = jax.jit(jref.natural_block_workers_ref)(jx, jnp.asarray(seeds))
    jdec = np.asarray(jax.jit(jax.vmap(jref.natural_decode_ref))(jc, js))
    tc, ts = tref.natural_block_workers_ref(tx, _t(seeds.view(np.int32)))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    tdec = tref.natural_decode_ref(tc, ts).numpy()
    xf = np.asarray(jx.astype(jnp.float32))
    log2_up = np.asarray(_xla_exponents(jx)[0]) != _exact_exponent(xf)
    differ = tdec != jdec
    assert not (differ & ~log2_up).any()
    # listed and explained: XLA rounded up to 2^(e+1), the port down to 2^e
    np.testing.assert_array_equal(np.abs(jdec[differ]), 2 * np.abs(tdec[differ]))
    wc, ws = tk.quantize.natural_block_workers(tx, _t(seeds.view(np.int32)))
    assert torch.equal(wc, tc) and torch.equal(ws, ts)


def test_natural_decode_replays_xla_exp2_and_flushes_subnormals():
    """Arbitrary codes under scales from 2^-120 to 2^20: XLA's decode is the
    numpy replay from its own exp2 table with subnormal products flushed,
    the port's the same replay from exact powers of two; they agree
    wherever XLA's table entry is exact. One boundary is XLA's own: a
    product of exactly 2^-126 decodes to 0 at some coordinates and to 2^-126
    at others there (listed), where the port keeps the smallest normal."""
    rng = np.random.default_rng(3)
    codes = rng.integers(-127, 128, size=(40, 256)).astype(np.int8)
    scales = _pow2(rng.integers(-120, 21, size=40))
    jdec = np.asarray(jax.jit(jref.natural_decode_ref)(jnp.asarray(codes),
                                                       jnp.asarray(scales)))
    tdec = tref.natural_decode_ref(_t(codes), _t(scales)).numpy()
    a = np.abs(codes.astype(np.int64))
    xla_table = np.asarray(_exp2(-jnp.arange(0, 127, dtype=jnp.float32)))

    def replay(table):
        mag = (scales[:, None].astype(np.float64) * table[np.maximum(a - 1, 0)]).astype(np.float32)
        mag = np.where((a > 0) & (mag >= TINY), mag, np.float32(0))
        return np.where(codes < 0, -mag, mag)

    boundary = np.abs(replay(xla_table)) == TINY
    np.testing.assert_array_equal(jdec[~boundary], replay(xla_table)[~boundary])
    assert np.isin(np.abs(jdec[boundary]), [0, TINY]).all()
    assert (np.abs(tdec[boundary]) == TINY).all()
    np.testing.assert_array_equal(tdec, replay(_pow2(-np.arange(0, 127))))
    exact = _xla_exp2_exact(-np.maximum(a - 1, 0)) & ~boundary
    np.testing.assert_array_equal(tdec[exact], jdec[exact])
    assert ((tdec == 0) & (codes != 0)).any()  # products below 2^-126 flushed


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_natural_dequant_mean_and_epilogue_match_reference(n, xdtype):
    """Codes with |c| ≤ 13 (XLA's exp2 exact): the decode-and-mean equals the
    reference's and the Pallas kernel's bit for bit for n a power of two
    and within 1 ulp for n = 3 (under jit XLA multiplies by 1/n; replayed);
    the
    epilogue's g' likewise, x' within 1 ulp of the reference's update
    applied to the port's g'."""
    gamma = 0.0371
    rng = np.random.default_rng(50 + n)
    codes = rng.integers(-13, 14, size=(n, 6, 256)).astype(np.int8)
    scales = _pow2(rng.integers(-10, 11, size=(n, 6)))
    g = rng.standard_normal((6, 256), dtype=np.float32)
    x = rng.standard_normal((6, 256), dtype=np.float32)
    jx, tx = _as(x, xdtype)
    tdm = tref.natural_dequant_mean_ref(_t(codes), _t(scales))
    acc = np.zeros((6, 256), np.float32)
    for w in range(n):
        acc = acc + tref.natural_decode_ref(_t(codes[w]), _t(scales[w])).numpy()
    # replayed: the reference divides acc / n eagerly; under jit XLA
    # multiplies by 1/n
    jargs = (jnp.asarray(codes), jnp.asarray(scales))
    np.testing.assert_array_equal(acc / np.float32(n),
                                  np.asarray(jref.natural_dequant_mean_ref(*jargs)))
    np.testing.assert_array_equal(acc * (np.float32(1) / np.float32(n)),
                                  np.asarray(jax.jit(jref.natural_dequant_mean_ref)(*jargs)))
    for jdm in (jax.jit(jref.natural_dequant_mean_ref)(*jargs),
                jquant.natural_dequant_mean(*jargs, backend="pallas_interpret")):
        assert ulp_diff(tdm, jdm) <= (0 if n in (1, 2, 4) else 1)
    tg, tx2 = tref.natural_epilogue_ref(_t(codes), _t(scales), _t(g), tx, gamma)
    assert tg.dtype == torch.float32 and tx2.dtype == tx.dtype
    args = (jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(g), jx)
    # g' = g + δ: δ's last bit (n = 3) survives the add as at most one
    # spacing of δ plus the add's own rounding
    tol = (np.spacing(np.abs(tdm.numpy())) + np.spacing(np.abs(tg.numpy()))
           if n == 3 else 0.0)
    for jg, _ in (jref.natural_epilogue_ref(*args, gamma),
                  jepi.natural_epilogue(*args, gamma, backend="pallas_interpret")):
        assert (np.abs(tg.numpy() - np.asarray(jg)) <= tol).all()
        _, jx_from_tg = jref.delta_epilogue_ref(jnp.zeros_like(jg),
                                                jnp.asarray(tg.numpy()), jx, gamma)
        assert ulp_diff(tx2, jx_from_tg) <= 1
    wdm = tk.quantize.natural_dequant_mean(_t(codes), _t(scales))
    wg, wx = tk.epilogue.natural_epilogue(_t(codes), _t(scales), _t(g), tx, gamma)
    assert torch.equal(wdm, tdm) and torch.equal(wg, tg) and torch.equal(wx, tx2)


def test_subnormals_and_tiny_blocks_match_reference():
    """Subnormal inputs encode as 0 on both sides; an all-subnormal row gets
    scale 2 (e_ref = 1) on both; a row whose max is near 2^-100 keeps its
    codes, given XLA's exponents, except where XLA's exp2 is inexact, and
    its decode is 0 exactly where the reference's is."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 128)).astype(np.float32)
    x[0, 0, :40] = rng.choice([1e-40, -2e-39, 1e-45, 5e-39], 40).astype(np.float32)
    x[0, 1] = np.float32(1e-39)
    x[1, 2] = (rng.standard_normal(128) * 2.0**-100).astype(np.float32)
    x[1, 3, :64] = (rng.standard_normal(64) * 2.0**-120).astype(np.float32)
    seeds = _seeds(rng, 2)
    jc, js = jax.jit(jref.natural_block_workers_ref)(jnp.asarray(x), jnp.asarray(seeds))
    jc, js = np.asarray(jc), np.asarray(js)
    tc, ts = tref.natural_block_workers_ref(_t(x), _t(seeds.view(np.int32)))
    tc, ts = tc.numpy(), ts.numpy()
    sub = np.abs(x) < TINY
    assert (jc[sub] == 0).all() and (tc[sub] == 0).all()
    assert js[0, 1] == ts[0, 1] == 2.0
    e, e_ref = _xla_exponents(jnp.asarray(x))
    tq = tref.natural_quantize_ref(_t(x), _t(seeds.view(np.int32)), _t(e), _t(e_ref))
    differ = tq.numpy() != jc
    assert not (differ & _xla_exp2_exact(np.asarray(e))).any()
    jdec = np.asarray(jax.vmap(jref.natural_decode_ref)(jnp.asarray(jc), jnp.asarray(js)))
    tdec = tref.natural_decode_ref(_t(jc), _t(js)).numpy()
    np.testing.assert_array_equal(jdec == 0, tdec == 0)


# ---------------------------------------------------------------------------
# RandK∘QSGD helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,nblk,B,kb", [(1, 3, 128, 8), (4, 9, 256, 20), (3, 5, 1024, 64)])
def test_randk_qsgd_levels_bit_equal_given_reference_norms(n, nblk, B, kb):
    s = 7
    rng = np.random.default_rng(n * kb)
    x = rng.standard_normal((n, nblk, B), dtype=np.float32)
    x[0, 0] = 0.0  # an all-zero sampled row: norm 0, safe 1
    seeds = _seeds(rng, n)
    jl, joff, jn = jax.jit(jref.randk_qsgd_workers_ref, static_argnums=(2, 3, 4))(
        jnp.asarray(x), jnp.asarray(seeds), kb, B / kb, s)
    tseeds = _t(seeds.view(np.int32))
    tl, toff, tn = tref.randk_qsgd_workers_ref(_t(x), tseeds, kb, B / kb, s)
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    assert ulp_diff(tn, jn) <= NORM_ULP
    vals, _ = tref.randk_seeded_workers_ref(_t(x), tseeds, kb, B / kb)
    given, _ = tref.qsgd_sampled_quantize_ref(vals, tseeds, s, norms=_t(np.asarray(jn)))
    np.testing.assert_array_equal(given.numpy(), np.asarray(jl))
    flips = tl.numpy() != np.asarray(jl)
    assert (np.abs(tl.numpy().astype(int) - np.asarray(jl).astype(int)) <= 1).all()
    assert flips.sum() <= 1e-3 * flips.size + 1
    td = tref.randk_qsgd_dequant_ref(tl, tn, s)
    jd = jref.randk_qsgd_dequant_ref(jnp.asarray(tl.numpy()), jnp.asarray(tn.numpy()), s)
    assert ulp_diff(td, jd) <= 1  # XLA may multiply by 1/s


# ---------------------------------------------------------------------------
# The flat engine's natural and randk_qsgd samplers, the compressors
# ---------------------------------------------------------------------------


def _engines(sampler, nblk=6, B=128, kb=8):
    tree = {"v": np.zeros((nblk * B - 5,), np.float32)}
    jeng = j_make_engine(jax.tree.map(jnp.asarray, tree), block=B, kb=kb, backend="ref",
                         sampler=sampler, s=7)
    teng = make_engine(params_from_jax(tree, device="cpu"), block=B, kb=kb, device="cpu",
                       sampler=sampler, s=7)
    return jeng, teng


def _agree(got, want, sampler, step):
    """natural: bit-equal. randk_qsgd: within NORM_ULP + 2 ulp (the norms'
    last bits scale every dequantized value), except level flips, which lie
    within one quantization step ``step``; returns the flips."""
    got, want = got.numpy(), np.asarray(want)
    if sampler == "natural":
        np.testing.assert_array_equal(got, want)
        return 0
    err = np.abs(got.astype(np.float64) - want)
    flip = err > (NORM_ULP + 2) * np.spacing(np.abs(want))
    assert (err[flip] <= step * (1 + 1e-6)).all()
    return int(flip.sum())


@pytest.mark.parametrize("sampler", ["natural", "randk_qsgd"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_engine_aggregate_and_fused_round_equal_reference(sampler, n):
    """Data over 11 octaves (XLA's exp2 exact on every code): the natural
    engine's aggregate and fused round's g' equal the reference's; the
    randk_qsgd engine's agree as :func:`_agree` states. x' within 1 ulp of
    the reference's update applied to the port's g'."""
    nblk, B, kb, s = 6, 128, 8, 7
    jeng, teng = _engines(sampler, nblk, B, kb)
    rng = np.random.default_rng(n + 17)
    bufs = _octaves(rng, (n, nblk, B), -5, 6, sweep=False)
    g = rng.standard_normal((nblk, B), dtype=np.float32)
    x = rng.standard_normal((nblk, B), dtype=np.float32)
    flips = 0
    for k in range(3):
        jkey, tkey = jax.random.PRNGKey(k), prng.PRNGKey(k)
        seeds = _t(teng.worker_seeds(tkey, n).view(np.int32))
        norms = tref.randk_qsgd_workers_ref(_t(bufs), seeds, kb, B / kb, s)[2]
        step = float(norms.max()) / (s * n)
        ja = jeng.aggregate(jkey, jnp.asarray(bufs), n)
        flips += _agree(teng.aggregate(tkey, _t(bufs), n), ja, sampler, step)
        jg, _ = jeng.fused_round(jkey, jnp.asarray(bufs), n, jnp.asarray(g),
                                 jnp.asarray(x), 0.05)
        tg, tx2 = teng.fused_round(tkey, _t(bufs), n, _t(g), _t(x), 0.05)
        flips += _agree(tg, jg, sampler, step)
        _, jx_from_tg = jref.delta_epilogue_ref(jnp.zeros_like(jg), jnp.asarray(tg.numpy()),
                                                jnp.asarray(x), 0.05)
        assert ulp_diff(tx2, jx_from_tg) <= 1
    assert flips <= FLIP_SHARE * 6 * nblk * B
    pal = j_make_engine(jnp.zeros((nblk * B - 5,)), block=B, kb=kb,
                        backend="pallas_interpret", sampler=sampler, s=s)
    _agree(teng.aggregate(prng.PRNGKey(0), _t(bufs), n),
           pal.aggregate(jax.random.PRNGKey(0), jnp.asarray(bufs), n), sampler, np.inf)


def test_natural_downlink_fused_round_equals_reference():
    """A RandK uplink under a natural downlink: the broadcast payload (n = 1)
    and the carry epilogue equal the reference's."""
    jeng, teng = _engines("randk")
    jdown, tdown = j_make_downlink(jeng, sampler="natural"), make_downlink(teng, "natural")
    assert tdown.sampler == "natural" and tdown.payload_bits(1) == jdown.payload_bits(1)
    rng = np.random.default_rng(5)
    bufs = _octaves(rng, (3, 6, 128), -5, 6, sweep=False)
    g = rng.standard_normal((6, 128), dtype=np.float32)
    x = rng.standard_normal((6, 128), dtype=np.float32)
    jg, _ = jeng.fused_round(jax.random.PRNGKey(1), jnp.asarray(bufs), 3, jnp.asarray(g),
                             jnp.asarray(x), 0.05, down=jdown,
                             down_key=jax.random.PRNGKey(2))
    tg, _ = teng.fused_round(prng.PRNGKey(1), _t(bufs), 3, _t(g), _t(x), 0.05,
                             down=tdown, down_key=prng.PRNGKey(2))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    v = bufs.reshape(-1)[:6 * 128 - 5]
    jr = jdown.roundtrip_worker(jax.random.PRNGKey(4), {"v": jnp.asarray(v)})
    tr = tdown.roundtrip_worker(prng.PRNGKey(4), {"v": _t(v)})
    np.testing.assert_array_equal(tr["v"].numpy(), np.asarray(jr["v"]))


@pytest.mark.parametrize("nblk,B,kb", [(1, 128, 8), (453_113, 1024, 20), (37, 256, 64)])
def test_natural_and_randk_qsgd_wire_accounting_and_omega_equal_reference(nblk, B, kb):
    for sampler in ("natural", "randk_qsgd"):
        jeng = j_make_engine(jnp.zeros((B,)), block=B, kb=kb, backend="ref",
                             sampler=sampler, s=7)
        teng = make_engine(torch.zeros(B), block=B, kb=kb, device="cpu",
                           sampler=sampler, s=7)
        jeng = dataclasses.replace(jeng, layout=dataclasses.replace(jeng.layout, nblk=nblk))
        teng = dataclasses.replace(teng, layout=dataclasses.replace(teng.layout, nblk=nblk))
        assert teng.payload_bits() == jeng.payload_bits()
        assert teng.omega == jeng.omega


def test_block_natural_and_natural_compression_equal_reference():
    """``BlockNatural``'s payload equals the reference's on data where XLA's
    exp2 is exact; ``NaturalCompression`` (per-leaf, the coin from
    ``bernoulli``) likewise, except just below a power of two where XLA's
    log2 rounds up (there the reference always rounds up). ω, bits and p."""
    rng = np.random.default_rng(9)
    x = _octaves(rng, (1000,), -5, 6)
    d = x.size
    for B in (128, 256):
        jc, tc = JBlockNatural(block=B), make_compressor("block_natural", block=B)
        assert isinstance(tc, BlockNatural)
        jp = jc.compress(jax.random.PRNGKey(3), jnp.asarray(x))
        tp = tc.compress(prng.PRNGKey(3), _t(x))
        np.testing.assert_array_equal(tp["q"].numpy(), np.asarray(jp["q"]))
        np.testing.assert_array_equal(tp["scales"].numpy(), np.asarray(jp["scales"]))
        np.testing.assert_array_equal(tc.decompress(tp, d).numpy(),
                                      np.asarray(jc.decompress(jp, d)))
        assert (tc.payload_bits(d), tc.default_p(d), tc.omega(d)) == (
            jc.payload_bits(d), jc.default_p(d), jc.omega(d))
    jn, tn = JNaturalCompression(), make_compressor("natural")
    assert isinstance(tn, NaturalCompression)
    jq = np.asarray(jn(jax.random.PRNGKey(5), jnp.asarray(x)))
    tq = tn(prng.PRNGKey(5), _t(x)).numpy()
    log2_up = np.asarray(_xla_exponents(jnp.asarray(x)[None])[0][0]) != _exact_exponent(x)
    differ = tq != jq
    assert not (differ & ~log2_up).any()
    np.testing.assert_array_equal(np.abs(jq[differ]), 2 * np.abs(tq[differ]))
    assert (tn.payload_bits(d), tn.omega(d), tn.expected_density(d)) == (
        jn.payload_bits(d), jn.omega(d), jn.expected_density(d))


def test_natural_wrappers_launch_nothing_on_cpu():
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((2, 3, 128), dtype=np.float32))
    seeds = _t(_seeds(rng, 2).view(np.int32))
    g = torch.zeros(3, 128)
    tk.reset_launch_counts()
    codes, scales = tk.quantize.natural_block_workers(x, seeds)
    tk.quantize.natural_dequant_mean(codes, scales)
    tk.epilogue.natural_epilogue(codes, scales, g, g, 0.1)
    assert not any(tk.launch_counts().values())
    assert len(tk.KERNELS) == 24


# ---------------------------------------------------------------------------
# MARINA on the natural, randk_qsgd and natural-downlink wires, round by round
# ---------------------------------------------------------------------------

N, M, D = 4, 32, 512
ROUNDS = 16


@pytest.fixture(scope="module")
def binclass():
    jdata = j_make_binclass(jax.random.PRNGKey(0), N, M, D)
    return jdata, params_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")


def _wire_engines(params_j, params_t, wire_kind, B):
    """(reference engine, down), (port engine, down), and the compressors."""
    sampler = {"natural": "natural", "randk_qsgd": "randk_qsgd",
               "downnatural": "randk"}[wire_kind]
    jeng = j_make_engine(params_j, kb=8, block=B, backend="ref", sampler=sampler, s=7)
    teng = make_engine(params_t, kb=8, block=B, device="cpu", sampler=sampler, s=7)
    jdown = tdown = None
    if wire_kind == "downnatural":
        jdown, tdown = j_make_downlink(jeng, sampler="natural"), make_downlink(teng, "natural")
    if wire_kind == "natural":
        return (jeng, jdown, JBlockNatural(block=B)), (teng, tdown, BlockNatural(block=B))
    return ((jeng, jdown, JBlockRandK(kb=8, block=B)),
            (teng, tdown, BlockRandK(kb=8, block=B)))


def _recording_steps(monkeypatch):
    """One quantization step per payload of the port's round, recorded as
    the round runs: a natural code that flips moves one worker's value by at
    most half its block scale, a randk_qsgd level by norm / s; the mean
    divides by the payload count."""
    steps = []
    natural = tflat.FlatEngine._natural_payloads
    sampled = tref.qsgd_sampled_quantize_ref

    def rec_natural(self, key, bufs, n):
        codes, scales = natural(self, key, bufs, n)
        steps.append(float(scales.max()) / (2 * n))
        return codes, scales

    def rec_sampled(vals, seeds, s, norms=None):
        levels, norms = sampled(vals, seeds, s, norms)
        steps.append(float(norms.max()) / (s * vals.shape[0]))
        return levels, norms

    monkeypatch.setattr(tflat.FlatEngine, "_natural_payloads", rec_natural)
    monkeypatch.setattr(tref, "qsgd_sampled_quantize_ref", rec_sampled)
    return steps


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("wire_kind", ["natural", "randk_qsgd", "downnatural"])
def test_binclass_marina_rounds_match_reference_round_by_round(binclass, wire_kind, carry,
                                                               monkeypatch):
    jdata, tdata = binclass
    (jeng, jdown, jc), (teng, tdown, tc) = _wire_engines(jnp.zeros((D,)), torch.zeros(D),
                                                          wire_kind, 128)
    jm = JMarina(jax.grad(j_loss), jc, gamma=0.5, p=0.3, engine=jeng, carry=carry,
                 down_engine=jdown)
    tm = Marina(binclass_grad, tc, gamma=0.5, p=0.3, engine=teng, carry=carry,
                down_engine=tdown)
    steps = _recording_steps(monkeypatch)
    js = jm.init(jnp.zeros((D,)), jdata)
    jstep = jax.jit(jm.step)
    kinds, flagged, compared = set(), 0, 0
    for k in range(ROUNDS):
        ts = state_from_jax(np.asarray(js.params), np.asarray(js.g), k,
                            None if js.h is None else np.asarray(js.h), device="cpu")
        steps.clear()
        js, jmet = jstep(js, jax.random.PRNGKey(100 + k), jdata)
        ts, tmet = tm.step(ts, prng.PRNGKey(100 + k), tdata)
        assert (tmet.sync_round, tmet.bits_per_worker, tmet.down_bits, tmet.oracle_calls) == (
            int(jmet.sync_round), float(jmet.bits_per_worker), float(jmet.down_bits),
            float(jmet.oracle_calls))
        kinds.add(tmet.sync_round)
        assert bool(steps) == (not tmet.sync_round)
        step = sum(steps)
        flagged += close_except_flips(ts.params.numpy(), js.params, 0.5 * step, 1e-5)
        flagged += close_except_flips(np.asarray(ts.g).reshape(-1)[:D],
                                       np.asarray(js.g).reshape(-1)[:D], step, 1e-5)
        compared += 2 * D
    assert kinds == {0, 1}
    assert flagged <= FLIP_SHARE * compared


CFG_KW = dict(name="tiny-dense", arch_type="dense", d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=256, qkv_bias=True,
              tie_embeddings=True, rope_theta=1_000_000.0, remat=False)
JCFG = JModelConfig(segments=j_dense_stack(2), **CFG_KW)
TCFG = ModelConfig(segments=dense_stack(2), **CFG_KW)


@pytest.fixture(scope="module")
def lm():
    jparams = j_init_params(jax.random.PRNGKey(0), JCFG)
    data = JData(n_workers=2, vocab_size=256, seq_len=16, seed=3)
    fn = jax.jit(lambda s: j_worker_batches(data, s, 2))
    return jparams, [np.asarray(fn(s)) for s in range(5)]


def _tgrad(params, batch):
    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = lm_loss(tree_unflatten(treedef, leaves), TCFG, batch["tokens"])
    return tree_unflatten(treedef, torch.autograd.grad(loss, leaves))


_jgrad = jax.grad(lambda p, b: j_lm_loss(p, JCFG, b["tokens"]))


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("wire_kind", ["natural", "randk_qsgd"])
def test_lm_marina_rounds_match_reference_round_by_round(lm, wire_kind, carry, monkeypatch):
    """4 rounds of the small LM (2 workers), held round by round from the
    reference's state: ledgers equal, params and g leafwise within 1e-4 of
    the leaf's scale except at flagged coordinates within one step."""
    jparams, tokens = lm
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    (jeng, _, jc), (teng, _, tc) = _wire_engines(jparams, tp, wire_kind, 128)
    gamma = 0.05
    jm = JMarina(_jgrad, jc, gamma=gamma, p=0.4, engine=jeng, carry=carry)
    tm = Marina(_tgrad, tc, gamma=gamma, p=0.4, engine=teng, carry=carry)
    steps = _recording_steps(monkeypatch)
    js = jax.jit(jm.init)(jparams, {"tokens": jnp.asarray(tokens[0])})
    jstep = jax.jit(jm.step)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    kinds, flagged, compared = set(), 0, 0
    for k in range(4):
        ts = state_from_jax(np_tree(js.params), np_tree(js.g), k,
                            None if js.h is None else np_tree(js.h), device="cpu")
        steps.clear()
        key = jax.random.fold_in(jax.random.PRNGKey(7), k)
        js, jmet = jstep(js, key, {"tokens": jnp.asarray(tokens[k + 1])})
        ts, tmet = tm.step(ts, prng.fold_in(prng.PRNGKey(7), k),
                           {"tokens": torch.tensor(tokens[k + 1])})
        assert (tmet.sync_round, tmet.bits_per_worker, tmet.down_bits) == (
            int(jmet.sync_round), float(jmet.bits_per_worker), float(jmet.down_bits))
        kinds.add(tmet.sync_round)
        step = sum(steps)
        for a, b in zip(tree_leaves(ts.params), jax.tree.leaves(js.params)):
            flagged += close_except_flips(a.numpy(), b, gamma * step, 1e-4, atol_scale=True)
            compared += a.numel()
        for a, b in zip(tree_leaves(ts.g), jax.tree.leaves(js.g)):
            flagged += close_except_flips(a.numpy(), b, step, 1e-4, atol_scale=True)
            compared += a.numel()
    assert kinds == {0, 1}
    assert flagged <= FLIP_SHARE * compared
