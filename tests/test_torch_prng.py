"""The port's threefry key derivation and counter RNGs are bit-equal to the
reference's: ``jax.random`` (PRNGKey / split / fold_in / bits / uniform /
bernoulli / randint / permutation), PP-MARINA's cohort draws, the murmur3
kernel hash, and the flat engine's worker seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, ulp_diff  # noqa: F401
from repro.core.flat import FlatEngine as JFlatEngine
from repro.core.marina import pp_sample_cohort as j_pp_sample_cohort
from repro.core.flat import make_layout as j_make_layout
from repro.kernels import ref as jref
from repro_torch import prng
from repro_torch.core.flat import make_engine, seeded_offsets
from repro_torch.core.marina import pp_sample_cohort
from repro_torch.kernels import ref as tref

SEEDS = [0, 1, 7, 42, 2**16 + 3, 2**31 - 1, 2**31 + 5, 2**32 - 1]
SHAPES = [(), (1,), (5,), (3, 4), (2, 3, 5)]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bit_equal(seed):
    k = jax.random.PRNGKey(seed)
    kk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(k), kk)
    for n in (1, 2, 3, 8):
        np.testing.assert_array_equal(np.asarray(jax.random.split(k, n)),
                                      prng.split(kk, n))
    for data in (0, 1, 5, 0x0D0C, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(k, data)),
                                      prng.fold_in(kk, data))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli_bit_equal(shape):
    for seed in SEEDS[:5]:
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        kk = prng.fold_in(prng.PRNGKey(seed), 3)
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(k, shape, jnp.uint32)), prng.bits(kk, shape))
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(k, shape)), prng.uniform(kk, shape))
        for p in (0.05, 0.3, 0.5, 0.97):
            np.testing.assert_array_equal(
                np.asarray(jax.random.bernoulli(k, p, shape)),
                prng.bernoulli(kk, p, shape))


def test_marina_round_draws_bit_equal():
    """The exact draw sequence of one MARINA round over many steps: the
    trainer's step key, the (k_bern, k_q) split, c_k, the worker seeds."""
    base, tbase = jax.random.PRNGKey(11), prng.PRNGKey(11)
    jeng = JFlatEngine(layout=j_make_layout(jnp.zeros((300,)), block=128), kb=8,
                       backend="ref")
    teng = make_engine({"x": torch.zeros(300)}, kb=8, block=128, device="cpu")
    for step in range(40):
        key = jax.random.fold_in(base, step)
        tkey = prng.fold_in(tbase, step)
        k_bern, k_q = jax.random.split(key)
        tk_bern, tk_q = prng.split(tkey)
        assert bool(jax.random.bernoulli(k_bern, 0.3)) == bool(
            prng.bernoulli(tk_bern, 0.3))
        np.testing.assert_array_equal(np.asarray(jeng.worker_seeds(k_q, 4)),
                                      teng.worker_seeds(tk_q, 4))


@pytest.mark.parametrize("seed", [0, 99, 2**31 + 17, 2**32 - 1])
def test_murmur_bits_and_seeded_offsets_bit_equal(seed):
    ctr = np.arange(0, 5000, 7, dtype=np.uint32)
    ctr = np.concatenate([ctr, np.array([2**31, 2**32 - 1], np.uint32)])
    want = np.asarray(jref.murmur_bits_ref(jnp.uint32(seed), jnp.asarray(ctr)))
    got = tref.murmur_bits_ref(seed, torch.from_numpy(ctr.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    from repro.core.flat import seeded_offsets as j_seeded_offsets

    np.testing.assert_array_equal(
        seeded_offsets(seed, 7, 256, 16, device="cpu").numpy(),
        np.asarray(j_seeded_offsets(jnp.uint32(seed), 7, 256, 16)))


@pytest.mark.parametrize("n", [1, 2, 4, 7, 64])
def test_randint_and_permutation_bit_equal(n):
    """int32 draws of ``jax.random.randint`` / ``permutation`` under JAX
    0.9's defaults, over keys, shapes and spans (n = 64: one sort round;
    the 2000-long permutation: two)."""
    for seed in SEEDS[:5]:
        for data in (0, 3):
            k = jax.random.fold_in(jax.random.PRNGKey(seed), data)
            kk = prng.fold_in(prng.PRNGKey(seed), data)
            for shape in [(), (1,), (5,), (3, 4)]:
                want = np.asarray(jax.random.randint(k, shape, 0, n))
                got = prng.randint(kk, shape, 0, n)
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                prng.randint(kk, (6,), -3, n + 70_000),
                np.asarray(jax.random.randint(k, (6,), -3, n + 70_000)))
            want = np.asarray(jax.random.permutation(k, n))
            got = prng.permutation(kk, n)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    k, kk = jax.random.PRNGKey(n), prng.PRNGKey(n)
    np.testing.assert_array_equal(prng.permutation(kk, 2000),
                                  np.asarray(jax.random.permutation(k, 2000)))


@pytest.mark.parametrize("replace", [True, False], ids=["iid", "distinct"])
def test_pp_cohort_draws_bit_equal(replace):
    """PP-MARINA's cohort under the trainer's step keys and the round's
    (k_bern, k_sel, k_q) split, in both sampling modes."""
    for n, r in ((4, 2), (7, 3), (16, 16)):
        for step in range(25):
            key = jax.random.fold_in(jax.random.PRNGKey(0), step)
            k_sel = jax.random.split(key, 3)[1]
            tk_sel = prng.split(prng.fold_in(prng.PRNGKey(0), step), 3)[1]
            want = np.asarray(j_pp_sample_cohort(k_sel, n, r, replace)).tolist()
            assert pp_sample_cohort(tk_sel, n, r, replace) == want
    # the repeated client of the trainer's step 1 at seed 0 (n = 4, r = 2)
    if replace:
        assert pp_sample_cohort(prng.split(prng.fold_in(prng.PRNGKey(0), 1), 3)[1],
                                4, 2, True) == [0, 0]


@pytest.mark.parametrize("shape", SHAPES + [(4096,)], ids=str)
def test_normal_and_exponential_within_their_ulp_bounds(shape):
    """``prng.normal`` replays XLA's float32 erf_inv (its fused multiply-adds
    included) on JAX's own uniform bits; only the log1p inside differs (XLA
    approximates it, the port rounds it correctly), so a value may lie a few
    ulp from ``jax.random.normal``'s: ≤ 3 over this sweep. ``exponential``
    is −log1p(−u): ≤ 1 ulp."""
    for seed in SEEDS:
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 0xFA17)
        kk = prng.fold_in(prng.PRNGKey(seed), 0xFA17)
        z, jz = prng.normal(kk, shape), np.asarray(jax.random.normal(k, shape))
        e, je = prng.exponential(kk, shape), np.asarray(jax.random.exponential(k, shape))
        assert z.shape == jz.shape == shape and z.dtype == jz.dtype == np.float32
        assert e.shape == shape and e.dtype == np.float32
        assert ulp_diff(z, jz) <= 3 and ulp_diff(e, je) <= 1
    edge = np.asarray([-1.0, np.nextafter(np.float32(-1), np.float32(0)), 0.0, 0.5, 1.0],
                      np.float32)
    np.testing.assert_array_equal(prng._erf_inv_f32(edge)[[0, 2, 4]],
                                  np.asarray(jax.lax.erf_inv(jnp.asarray(edge)))[[0, 2, 4]])
