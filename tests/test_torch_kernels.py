"""The plain PyTorch versions of the six main-path kernels against the
reference's oracles (``repro.kernels.ref``) on the same numpy inputs.

Contract (DESIGN.md §4.4 carried across frameworks): offsets bit-equal, RandK
and PermK values bit-equal (one gather, one multiply), scatter / epilogue
outputs within 1 ulp on the bit patterns, x in f32 and bf16, with a
forced-duplicates case (kb = B/2). On the CPU every kernel wrapper returns
its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, ordered_scatter_mean, to_np, ulp_diff  # noqa: F401
from repro.kernels import ref as jref
from repro_torch import kernels as tk
from repro_torch.kernels import ref as tref

SHAPES = [  # (n, nblk, B, kb)
    (4, 9, 128, 8),
    (3, 5, 256, 128),   # kb = B/2: many duplicate offsets
    (1, 4, 1024, 20),
]
IDS = ["n4", "dups", "n1"]


def _payloads(n, nblk, B, kb, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nblk, B), dtype=np.float32)
    seeds = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return x, seeds


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_randk_seeded_workers_bit_equal(shape):
    n, nblk, B, kb = shape
    x, seeds = _payloads(*shape)
    jv, jo = jref.randk_seeded_workers_ref(jnp.asarray(x), jnp.asarray(seeds), kb, B / kb)
    tv, to = tref.randk_seeded_workers_ref(
        torch.from_numpy(x), tk.randk.seeds_tensor(seeds, "cpu"), kb, B / kb)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the wrapper on a CPU tensor is the plain version
    wv, wo = tk.randk.randk_seeded_workers(
        torch.from_numpy(x), tk.randk.seeds_tensor(seeds, "cpu"), kb, B / kb)
    assert torch.equal(wv, tv) and torch.equal(wo, to)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_scatter_accum_within_one_ulp(shape):
    n, nblk, B, kb = shape
    x, seeds = _payloads(*shape, seed=1)
    jv, jo = jref.randk_seeded_workers_ref(jnp.asarray(x), jnp.asarray(seeds), kb, B / kb)
    want = jref.scatter_accum_ref(jv, jo, B)
    tv, to = torch.tensor(np.asarray(jv)), torch.tensor(np.asarray(jo))
    got = tref.scatter_accum_ref(tv, to, B)
    assert ulp_diff(got, want) <= 1
    assert torch.equal(tk.randk.scatter_accum(tv, to, B), got)


@pytest.mark.parametrize("shape", SHAPES + [(33, 3, 8, 8)], ids=IDS + ["n33"])
def test_scatter_accum_duplicates_match_reference(shape):
    """Offsets drawn from [0, 4): every block's n·kb adds pile onto four
    coordinates, so any change in the order of duplicate adds shows. The
    plain version, the reference's oracle and a numpy loop in (w, t) order
    agree bit for bit."""
    n, nblk, B, kb = shape
    rng = np.random.default_rng(5)
    v = rng.standard_normal((n, nblk, kb), dtype=np.float32)
    o = rng.integers(0, 4, (n, nblk, kb)).astype(np.int32)
    want = jref.scatter_accum_ref(jnp.asarray(v), jnp.asarray(o), B)
    got = tref.scatter_accum_ref(torch.from_numpy(v), torch.from_numpy(o), B)
    assert ulp_diff(got, want) == 0
    assert ulp_diff(got, ordered_scatter_mean(v, o, B)) == 0
    assert torch.equal(tk.randk.scatter_accum(torch.from_numpy(v), torch.from_numpy(o), B),
                       got)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_scatter_epilogue_within_one_ulp(shape, xdtype):
    n, nblk, B, kb = shape
    x, seeds = _payloads(*shape, seed=2)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((nblk, B), dtype=np.float32)
    xx = rng.standard_normal((nblk, B), dtype=np.float32)
    gamma = 0.0371
    jv, jo = jref.randk_seeded_workers_ref(jnp.asarray(x), jnp.asarray(seeds), kb, B / kb)
    jx = jnp.asarray(xx).astype(xdtype)
    jg2, jx2 = jref.scatter_epilogue_ref(jv, jo, jnp.asarray(g), jx, gamma)
    tx = torch.from_numpy(xx).to(getattr(torch, xdtype))
    args = (torch.tensor(np.asarray(jv)), torch.tensor(np.asarray(jo)),
            torch.from_numpy(g), tx, gamma)
    tg2, tx2 = tref.scatter_epilogue_ref(*args)
    assert tx2.dtype == tx.dtype and tg2.dtype == torch.float32
    assert ulp_diff(tg2, jg2) <= 1
    assert ulp_diff(tx2, jx2) <= 1
    wg, wx = tk.epilogue.scatter_epilogue(*args)
    assert torch.equal(wg, tg2) and torch.equal(wx, tx2)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3, 4])
def test_mean_epilogue_within_one_ulp(n, xdtype):
    """g' within 1 ulp of the reference; x' within 1 ulp of the reference's
    own update applied to the port's g'. (XLA computes the reference's
    worker mean as sum·(1/n); for n = 3 that can move g' by 1 ulp, and x'
    = x − γ·g' inherits it magnified where x' nearly cancels. For n a
    power of two the reciprocal is exact and x' is held directly.)"""
    rng = np.random.default_rng(4 + n)
    gb = rng.standard_normal((n, 6, 256), dtype=np.float32)
    gb[:, 0, :7] = -0.0  # signed zeros sum like the reference
    xx = rng.standard_normal((6, 256), dtype=np.float32)
    gamma = 0.1
    jx = jnp.asarray(xx).astype(xdtype)
    jg2, jx2 = jref.mean_epilogue_ref(jnp.asarray(gb), jx, gamma)
    tx = torch.from_numpy(xx).to(getattr(torch, xdtype))
    tg2, tx2 = tref.mean_epilogue_ref(torch.from_numpy(gb), tx, gamma)
    assert ulp_diff(tg2, jg2) <= 1
    _, jx_from_tg = jref.delta_epilogue_ref(
        jnp.zeros_like(jg2), jnp.asarray(tg2.numpy()), jx, gamma)
    assert ulp_diff(tx2, jx_from_tg) <= 1
    if n in (1, 4):
        assert ulp_diff(tx2, jx2) <= 1
    wg, wx = tk.epilogue.mean_epilogue(torch.from_numpy(gb), tx, gamma)
    assert torch.equal(wg, tg2) and torch.equal(wx, tx2)


def test_launch_counts_untouched_on_cpu():
    """CPU calls run the plain version and launch nothing."""
    tk.reset_launch_counts()
    x, seeds = _payloads(2, 3, 128, 8)
    v, o = tk.randk.randk_seeded_workers(torch.from_numpy(x),
                                         tk.randk.seeds_tensor(seeds, "cpu"), 8, 16.0)
    tk.randk.scatter_accum(v, o, 128)
    pv, _ = tk.permk.permk_seeded_workers(torch.from_numpy(x), 7)
    tk.epilogue.delta_epilogue(pv[0].contiguous(), pv[1].contiguous(), pv[0], 0.1)
    assert tk.launch_counts() == dict.fromkeys(tk.KERNELS, 0)
    assert len(tk.KERNELS) == 24
    assert to_np(o).dtype == np.int32


SEED32 = [0, 5, 2**31 + 7, 2**32 - 1]


@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("nblk", [1, 3, 257])
def test_affine_perm_params_and_inverse_bit_equal(nblk, B):
    """a, c equal the reference's; the inverse mod B is its uint32 inverse
    masked to B − 1 and undoes a."""
    for seed in SEED32:
        ja, jc = jref.affine_perm_params_ref(jnp.uint32(seed), nblk, B)
        ta, tc = tref.affine_perm_params_ref(seed, nblk, B)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int64))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
        inv = tref.odd_inverse_ref(ta, B)
        np.testing.assert_array_equal(
            inv.numpy(), np.asarray(jref.odd_inverse_ref(ja)).astype(np.int64) & (B - 1))
        assert torch.all((inv * ta) & (B - 1) == 1)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("nblk", [1, 3, 257])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_permk_seeded_workers_bit_equal(n, nblk, B, xdtype):
    rng = np.random.default_rng(n * 1000 + nblk + B)
    x = rng.standard_normal((n, nblk, B), dtype=np.float32)
    jx = jnp.asarray(x).astype(xdtype)
    tx = torch.from_numpy(x).to(getattr(torch, xdtype))
    for seed in SEED32[1:3]:
        jv, jo = jref.permk_seeded_workers_ref(jx, jnp.uint32(seed), n)
        tv, to = tref.permk_seeded_workers_ref(tx, seed)
        assert tv.dtype == tx.dtype and to.dtype == torch.int32
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(to_np(tv), to_np(jv))
        for w in (0, n - 1):
            np.testing.assert_array_equal(
                tref.permk_offsets_ref(seed, nblk, B, n, w).numpy(),
                np.asarray(jref.permk_offsets_ref(jnp.uint32(seed), nblk, B, n, w)))
        # the n supports partition every block
        assert torch.equal(to.permute(1, 0, 2).reshape(nblk, B).sort(dim=1).values,
                           torch.arange(B, dtype=torch.int32).expand(nblk, B))
        wv, wo = tk.permk.permk_seeded_workers(tx, seed)
        assert torch.equal(wv, tv) and torch.equal(wo, to)
        # offsets=False: the same values, no offsets
        for fn in (tref.permk_seeded_workers_ref, tk.permk.permk_seeded_workers):
            nv, no = fn(tx, seed, offsets=False)
            assert no is None and torch.equal(nv, tv)
        # a subset of the fleet's rows, unsorted, the last worker first: each
        # row is its worker's row of the reference's n-row output
        sub = list(dict.fromkeys([n - 1, n // 2 - 1 if n > 1 else 0, 0]))
        for workers in (sub, torch.tensor(sub, dtype=torch.int32)):
            for fn in (tref.permk_seeded_workers_ref, tk.permk.permk_seeded_workers):
                sv, so = fn(tx[sub], seed, workers=workers, n=n)
                np.testing.assert_array_equal(so.numpy(), np.asarray(jo)[sub])
                np.testing.assert_array_equal(to_np(sv), to_np(jv)[sub])
                sv2, so2 = fn(tx[sub], seed, workers=workers, n=n, offsets=False)
                assert so2 is None and torch.equal(sv2, sv)


def test_permk_seeded_workers_refuses_bad_rows():
    """A worker index outside [0, n), an n that does not divide B (or a
    missing one), a count of indices other than the rows', and a workers
    tensor on another device than x are refused by the plain version and
    the wrapper alike."""
    x = torch.zeros((2, 3, 128))
    for fn in (tref.permk_seeded_workers_ref, tk.permk.permk_seeded_workers):
        for kw in ({"workers": [0, 4], "n": 4}, {"workers": [-1, 1], "n": 4},
                   {"workers": [0, 1], "n": 3}, {"workers": [0, 1]},
                   {"workers": [0], "n": 4}, {"n": 4},
                   {"workers": torch.tensor([0, 1], device="meta"), "n": 4}):
            with pytest.raises(ValueError):
                fn(x, 7, **kw)
        with pytest.raises(ValueError):
            fn(torch.zeros((3, 3, 128)), 7)  # 3 workers do not divide 128
    v, o = tref.permk_seeded_workers_ref(x, 7, workers=torch.tensor([3, 0]), n=4)
    assert v.shape == o.shape == (2, 3, 32)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_permk_concat_mean_equals_reference_and_scatter(n, xdtype):
    """The scatter-free aggregate equals the reference's, and the port's own
    scatter-mean of the same payloads (disjoint supports: no collisions)."""
    nblk, B, seed = 9, 128, 2**31 + 7
    x = np.random.default_rng(n).standard_normal((n, nblk, B), dtype=np.float32)
    jv, jo = jref.permk_seeded_workers_ref(jnp.asarray(x).astype(xdtype),
                                           jnp.uint32(seed), n)
    want = jref.permk_concat_mean_ref(jv, jnp.uint32(seed), B)
    tv = torch.from_numpy(x).to(getattr(torch, xdtype))
    tv, to = tref.permk_seeded_workers_ref(tv, seed)
    got = tref.permk_concat_mean_ref(tv, seed, B)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tref.scatter_accum_ref(tv.float(), to, B))


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_delta_epilogue_within_one_ulp(xdtype):
    rng = np.random.default_rng(11)
    delta, g, xx = (rng.standard_normal((7, 256), dtype=np.float32) for _ in range(3))
    delta[0, :5] = -0.0
    gamma = 0.0371
    jx = jnp.asarray(xx).astype(xdtype)
    jg2, jx2 = jref.delta_epilogue_ref(jnp.asarray(delta), jnp.asarray(g), jx, gamma)
    args = (torch.from_numpy(delta), torch.from_numpy(g),
            torch.from_numpy(xx).to(getattr(torch, xdtype)), gamma)
    tg2, tx2 = tref.delta_epilogue_ref(*args)
    assert tg2.dtype == torch.float32 and tx2.dtype == args[2].dtype
    assert ulp_diff(tg2, jg2) <= 1 and ulp_diff(tx2, jx2) <= 1
    wg, wx = tk.epilogue.delta_epilogue(*args)
    assert torch.equal(wg, tg2) and torch.equal(wx, tx2)


@pytest.mark.parametrize("B", [3, 100, 1001, 2816, 25600])
def test_scatter_accum_takes_the_transport_widths(B):
    """Any row width a leaf's last dimension gives the launch layer's wire
    (not only powers of two): the wrapper on CPU tensors equals the
    reference's oracle bit for bit, duplicates included."""
    rng = np.random.default_rng(B)
    n, R, kb = 4, 3, max(1, B // 128)
    v = rng.standard_normal((n, R, kb), dtype=np.float32)
    o = rng.integers(0, B, size=(n, R, kb)).astype(np.int32)
    want = jref.scatter_accum_ref(jnp.asarray(v), jnp.asarray(o), B)
    got = tk.randk.scatter_accum(torch.from_numpy(v), torch.from_numpy(o), B)
    assert ulp_diff(got, want) == 0


def test_scatter_accum_refuses_rows_past_shared_memory():
    """A row wider than one CTA's shared memory holds (227 KiB of f32) is
    refused with its width named, on the CPU as on the card."""
    W = tk.randk.MAX_SCATTER_WIDTH
    assert W == 58112
    v = torch.zeros((1, 2, 4))
    o = torch.zeros((1, 2, 4), dtype=torch.int32)
    assert tk.randk.scatter_accum(v, o, W).shape == (2, W)
    for bad in (W + 1, 0):
        with pytest.raises(ValueError, match=f"width {bad} "):
            tk.randk.scatter_accum(v, o, bad)
